"""Kernel B2: the fused Welch PSD (`csrc/welch_psd.cu`), its wrapper and
its plain version.

Replaces gps_jamming_tpu/ops/pallas_psd.py (`welch_psd_fused` -> `_run` ->
`_make_kernel`). Same contract: two-sided Welch PSD of a 1-D complex64
signal, 50 % overlap, periodic Hann window, per-segment detrend, density
scaling, natural FFT order.

A CPU tensor takes the plain version (`welch_psd_reference`); a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import check_tensor
from ..kernels import build

# Kernel launches made by `welch_psd_fused` (one per call on a CUDA tensor).
LAUNCHES = 0

# Target number of segment tiles (thread blocks); fixed, so the reduction
# order, and with it the result, does not depend on the card.
_TILES = 256


def supported(nperseg: int) -> bool:
    """Power-of-two nperseg in [64, 8192]."""
    return 64 <= nperseg <= 8192 and nperseg & (nperseg - 1) == 0


def welch_psd_reference(x: torch.Tensor, sample_rate: float,
                        nperseg: int = 1024,
                        detrend: bool = True) -> torch.Tensor:
    """Plain version of the kernel: the torch.fft Welch at 50 % overlap."""
    from .spectral import welch_psd_plain
    return welch_psd_plain(x, sample_rate, nperseg, 0.5, detrend)


@functools.lru_cache(maxsize=16)
def _window(nperseg: int, device: torch.device) -> tuple[torch.Tensor, float]:
    """The float32 Hann window on `device` (bit-equal to spectral._hann) and
    sum(w^2) in float64."""
    from .spectral import _hann
    w = _hann(nperseg)
    return (torch.from_numpy(w).to(device),
            float(np.sum(w.astype(np.float64) ** 2)))


def welch_psd_fused(x: torch.Tensor, sample_rate: float, nperseg: int = 1024,
                    detrend: bool = True) -> torch.Tensor:
    """Welch PSD of a 1-D complex64 signal -> (nperseg,) float32."""
    global LAUNCHES
    if x.device.type == "cpu":
        return welch_psd_reference(x, sample_rate, nperseg, detrend)
    if x.device.type != "cuda":
        raise ValueError(f"welch_psd_fused: unsupported device {x.device}")
    if not supported(nperseg):
        raise ValueError(f"welch_psd_fused: nperseg {nperseg} is not a "
                         "power of two in [64, 8192]")
    check_tensor(x, "x", torch.complex64, (None,))
    n = x.shape[0]
    if n < nperseg:
        raise ValueError(f"welch_psd_fused: {n} samples < nperseg {nperseg}")
    hop = nperseg // 2
    n_segs = 1 + (n - nperseg) // hop
    per_tile = -(-n_segs // _TILES)
    n_tiles = -(-n_segs // per_tile)
    win, wsum2 = _window(nperseg, x.device)
    tw = build.twiddles(nperseg, x.device)
    partial = torch.empty((n_tiles, nperseg), dtype=torch.float32,
                          device=x.device)
    out = torch.empty(nperseg, dtype=torch.float32, device=x.device)
    scale = 1.0 / (sample_rate * wsum2) / n_segs
    lib = build.load()
    with torch.cuda.device(x.device):
        err = lib.gjt_welch_psd(
            x.data_ptr(), win.data_ptr(), tw.data_ptr(), partial.data_ptr(),
            out.data_ptr(), nperseg, hop, n_segs, per_tile, n_tiles,
            int(detrend), scale, torch.cuda.current_stream().cuda_stream)
    build.check(err, "gjt_welch_psd")
    LAUNCHES += 1
    return out
