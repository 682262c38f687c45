"""Welch PSD (counterpart of gps_jamming_tpu.ops.spectral).

Two-sided Welch PSD with a periodic Hann window, per-segment complex-mean
detrend and density scaling, natural FFT order: the contract of
scipy.signal.welch(x, fs, nperseg=..., return_onesided=False).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import cuda_psd
from .iq import frame, remove_dc


@functools.lru_cache(maxsize=16)
def _hann(nperseg: int) -> np.ndarray:
    # the periodic (fftbins=True) Hann window scipy's welch uses
    n = np.arange(nperseg)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / nperseg)).astype(np.float32)


def welch_psd(x: torch.Tensor, sample_rate: float, nperseg: int = 1024,
              overlap_frac: float = 0.5, detrend: bool = True) -> torch.Tensor:
    """Welch PSD of complex64 x (..., n) -> float32 (..., nperseg).

    On a CUDA tensor, a 1-D input with 50 % overlap, n >= 2*nperseg and an
    nperseg the kernel takes (`cuda_psd.supported`: every size the JAX
    package's Pallas kernel takes up to 16384) runs the fused kernel
    (`cuda_psd.welch_psd_fused`), where the JAX package runs its Pallas
    kernel.
    """
    if (x.is_cuda and x.dim() == 1 and overlap_frac == 0.5
            and x.shape[-1] >= 2 * nperseg and cuda_psd.supported(nperseg)):
        return cuda_psd.welch_psd_fused(x, sample_rate, nperseg, detrend)
    return welch_psd_plain(x, sample_rate, nperseg, overlap_frac, detrend)


def welch_psd_plain(x: torch.Tensor, sample_rate: float, nperseg: int = 1024,
                    overlap_frac: float = 0.5,
                    detrend: bool = True) -> torch.Tensor:
    """The plain torch.fft Welch PSD (any device, batched over leading
    dims): frame -> detrend -> window -> |FFT|^2 -> mean -> scale."""
    hop = int(nperseg * (1.0 - overlap_frac))
    win = torch.from_numpy(_hann(nperseg)).to(x.device)
    segs = frame(x, nperseg, hop)
    if detrend:
        segs = remove_dc(segs, dim=-1)
    spec = torch.fft.fft(segs * win, dim=-1)
    p = spec.real * spec.real + spec.imag * spec.imag
    scale = 1.0 / (sample_rate * float(np.sum(_hann(nperseg).astype(
        np.float64) ** 2)))
    return p.mean(dim=-2) * scale


def psd_db_shifted(pxx: torch.Tensor) -> torch.Tensor:
    """fftshift + 10*log10(P + 1e-15)."""
    return 10.0 * torch.log10(torch.fft.fftshift(pxx, dim=-1) + 1e-15)
