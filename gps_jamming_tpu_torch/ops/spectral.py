"""Welch PSD and the spectrogram (counterpart of gps_jamming_tpu.ops.spectral).

Two-sided Welch PSD with a periodic Hann window, per-segment complex-mean
detrend and density scaling, natural FFT order: the contract of
scipy.signal.welch(x, fs, nperseg=..., return_onesided=False). The
spectrogram is the reference's per-second loop (`skrypty/widmo_plot.py`)
as one batched call: a Welch PSD per non-overlapping chunk, in shifted dB.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

from ..device import as_device
from . import cuda_psd
from .iq import bytes_to_iq_f32, frame, remove_dc


@functools.lru_cache(maxsize=16)
def _hann(nperseg: int) -> np.ndarray:
    # the periodic (fftbins=True) Hann window scipy's welch uses
    n = np.arange(nperseg)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / nperseg)).astype(np.float32)


def welch_psd(x: torch.Tensor, sample_rate: float, nperseg: int = 1024,
              overlap_frac: float = 0.5, detrend: bool = True) -> torch.Tensor:
    """Welch PSD of complex64 x (..., n) -> float32 (..., nperseg).

    On a CUDA tensor the fused kernel B2 (`cuda_psd.welch_psd_fused`) runs
    wherever it takes the input: 50 % overlap, n >= 2*nperseg and an
    nperseg of `cuda_psd.supported`, which is every size the JAX package's
    Pallas kernel takes (up to 16384 one block per segment, 20480 to
    131072 on the four-step FFT). A 1-D input is one launch; any leading
    dims are flattened into rows, one launch per row (the spectrogram's
    chunks, which the JAX package computes in XLA because its kernel is
    1-D only). Every other CUDA input takes the plain torch.fft version,
    where the JAX package computes XLA too: another overlap, n <
    2*nperseg, or an nperseg the Pallas kernel does not take (above
    131072, or 73728 = 9 * 8192).
    """
    n = x.shape[-1]
    if (x.is_cuda and overlap_frac == 0.5
            and n >= 2 * nperseg and cuda_psd.supported(nperseg)):
        if x.dim() <= 2:
            return cuda_psd.welch_psd_fused(x, sample_rate, nperseg, detrend)
        rows = x.reshape(-1, n).contiguous()
        out = cuda_psd.welch_psd_fused(rows, sample_rate, nperseg, detrend)
        return out.reshape(x.shape[:-1] + (nperseg,))
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


def spectrogram(x: torch.Tensor, sample_rate: float, chunk_samples: int,
                nperseg: int = 1024,
                overlap_frac: float = 0.5) -> torch.Tensor:
    """Waterfall: the Welch PSD of each non-overlapping chunk of
    `chunk_samples`, in shifted dB: complex64 (..., n) -> float32
    (..., n // chunk_samples, nperseg). Each chunk's complex mean is
    removed (widmo_plot.py:44) before the per-segment detrend; the tail
    that fills no chunk is dropped."""
    n_chunks = x.shape[-1] // chunk_samples
    xc = x[..., : n_chunks * chunk_samples].reshape(
        x.shape[:-1] + (n_chunks, chunk_samples))
    pxx = welch_psd(remove_dc(xc, dim=-1), sample_rate, nperseg,
                    overlap_frac)
    return psd_db_shifted(pxx)


def freq_axis_mhz(sample_rate: float, nperseg: int) -> np.ndarray:
    """Shifted frequency axis in MHz (widmo_plot.py:76)."""
    return np.linspace(-sample_rate / 2 / 1e6, sample_rate / 2 / 1e6, nperseg)


def mean_spectrum_db(spectrogram_db):
    """Mean over time of the dB spectrogram (widmo_plot.py:75): a tensor
    gives a tensor, an array an array."""
    if isinstance(spectrogram_db, torch.Tensor):
        return spectrogram_db.mean(dim=-2)
    return np.mean(spectrogram_db, axis=-2)


def spectrogram_file(path: str, sample_rate: float, chunk_samples: int,
                     nperseg: int = 1024, overlap_frac: float = 0.5,
                     max_samples: int | None = None,
                     batch_chunks: int = 16, device=None) -> np.ndarray:
    """Bounded-memory waterfall of a capture FILE on `device` (None: the
    card), as a (n_chunks, nperseg) float32 array.

    Reads `batch_chunks` chunks at a time (host and device memory hold one
    batch whatever the capture's length) in the 'normalized' convention,
    converted from the bytes on the device. Chunking, the per-chunk DC
    removal and the Welch segments all live inside a chunk, so the rows
    are the same whatever `batch_chunks` is, and equal `spectrogram` of
    the whole capture."""
    dev = as_device(device)
    n_total = os.path.getsize(path) // 2
    if max_samples is not None:
        n_total = min(n_total, int(max_samples))
    n_chunks = n_total // chunk_samples
    end = n_chunks * chunk_samples
    rows = []
    g0 = 0
    while g0 < end:
        m = min(batch_chunks * chunk_samples, end - g0)
        raw = np.fromfile(path, dtype=np.uint8, count=2 * m,
                          offset=2 * g0)
        if raw.size < 2:
            break
        raw = raw[: raw.size - raw.size % 2]
        x = bytes_to_iq_f32(torch.from_numpy(raw).to(dev), centered=True,
                            scale=127.5)
        rows.append(spectrogram(x, sample_rate, chunk_samples, nperseg,
                                overlap_frac).cpu().numpy())
        g0 += x.shape[-1]
    if not rows:
        return np.zeros((0, nperseg), np.float32)
    return np.concatenate(rows, axis=0)
