"""Kernel B2: the fused Welch PSD (`csrc/welch_psd.cu`), its wrapper and
its plain version.

Replaces gps_jamming_tpu/ops/pallas_psd.py (`welch_psd_fused` -> `_run` ->
`_make_kernel`). Same contract: two-sided Welch PSD of a 1-D complex64
signal, 50 % overlap, periodic Hann window, per-segment detrend, density
scaling, natural FFT order; every nperseg the TPU kernel takes up to 16384
(and 64), in one launch per signal. The wrapper also takes (rows, n), one
launch per row (the spectrogram's chunks).

A CPU tensor takes the plain version (`welch_psd_reference`); a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import check_tensor
from ..kernels import build

# Kernel launches made by `welch_psd_fused` (one per row on a CUDA tensor).
LAUNCHES = 0

# The mixed-radix nperseg of the TPU kernel up to 16384
# (`pallas_psd.supported`: 128 * 2^a * {3, 5, 7}); the C gate of
# csrc/welch_psd.cu lists the same sizes, each a schedule of the register
# FFT (csrc/fft_reg.cuh, `fft_plan.SCHEDULES`).
MIXED_NPERSEG = (384, 640, 768, 896, 1280, 1536, 1792, 2560, 3072, 3584,
                 5120, 6144, 7168, 10240, 12288, 14336)


def supported(nperseg: int) -> bool:
    """A power of two in [64, 16384] or one of MIXED_NPERSEG."""
    return (64 <= nperseg <= 16384 and nperseg & (nperseg - 1) == 0) \
        or nperseg in MIXED_NPERSEG


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


@functools.lru_cache(maxsize=16)
def _scratch(nperseg: int, device: torch.device, stream: int) -> torch.Tensor:
    """The kernel's scratch, kept per (nperseg, device, stream), sized by
    the kernel (`gjt_welch_scratch_bytes`): its slice tickets, which it
    leaves at zero after every call (so calls on one stream may reuse
    them; another stream gets its own), and the clusters' partial rows.
    The number of tiles is a constant of the kernel, so the reduction
    order, and with it the result, does not depend on the card."""
    n_bytes = build.load().gjt_welch_scratch_bytes(nperseg)
    return torch.zeros(n_bytes, dtype=torch.uint8, device=device)


def welch_psd_fused(x: torch.Tensor, sample_rate: float, nperseg: int = 1024,
                    detrend: bool = True) -> torch.Tensor:
    """Welch PSD of a complex64 signal (n,) -> (nperseg,) float32, or of
    each row of (rows, n) -> (rows, nperseg).

    On the card each row is one launch on the current stream, writing its
    own row of the output; the rows share the scratch, whose tickets each
    launch leaves at zero, and launches on one stream run in order."""
    global LAUNCHES
    if x.device.type == "cpu":
        return welch_psd_reference(x, sample_rate, nperseg, detrend)
    if x.device.type != "cuda":
        raise ValueError(f"welch_psd_fused: unsupported device {x.device}")
    if not supported(nperseg):
        raise ValueError(f"welch_psd_fused: nperseg {nperseg} is neither a "
                         "power of two in [64, 16384] nor one of "
                         f"{MIXED_NPERSEG}")
    if x.dim() not in (1, 2):
        raise ValueError(f"welch_psd_fused: expected (n,) or (rows, n), "
                         f"got {tuple(x.shape)}")
    check_tensor(x, "x", torch.complex64, (None,) * x.dim())
    n = x.shape[-1]
    if n < nperseg:
        raise ValueError(f"welch_psd_fused: {n} samples < nperseg {nperseg}")
    rows = 1 if x.dim() == 1 else x.shape[0]
    n_segs = 1 + (n - nperseg) // (nperseg // 2)
    win, wsum2 = _window(nperseg, x.device)
    tab = build.reg_twiddles(nperseg, x.device)
    out = torch.empty(x.shape[:-1] + (nperseg,), dtype=torch.float32,
                      device=x.device)
    scale = 1.0 / (sample_rate * wsum2) / n_segs
    lib = build.load()
    x_row, out_row = n * x.element_size(), nperseg * out.element_size()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        scratch = _scratch(nperseg, x.device, stream)
        for r in range(rows):
            err = lib.gjt_welch_psd(
                x.data_ptr() + r * x_row, win.data_ptr(), tab.data_ptr(),
                scratch.data_ptr(), out.data_ptr() + r * out_row, nperseg,
                n_segs, int(detrend), scale, stream)
            build.check(err, "gjt_welch_psd")
            LAUNCHES += 1
    return out
