"""Kernel B2: the fused Welch PSD (`csrc/welch_psd.cu`), its wrapper and
its plain version.

Replaces gps_jamming_tpu/ops/pallas_psd.py (`welch_psd_fused` -> `_run` ->
`_make_kernel`). Same contract: two-sided Welch PSD of a 1-D complex64
signal, 50 % overlap, periodic Hann window, per-segment detrend, density
scaling, natural FFT order; every nperseg the TPU kernel takes (and 64),
in one launch per signal: up to 16384 one block per segment, above it
(20480 ... 131072) each segment on the four-step FFT of
csrc/fft_large.cuh through scratch in device memory. The wrapper also
takes (rows, n), one launch per row (the spectrogram's chunks).

A CPU tensor takes the plain version (`welch_psd_reference`); a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import check_tensor, runs_kernel
from ..kernels import build, gates
from ..kernels.gates import MIXED_NPERSEG
from ..runtime import profiling

# The sizes the kernel takes: kernels/gates.py.
supported = gates.psd_supported


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
    """Welch PSD of a complex64 signal (n,) -> (nperseg,) float32, or of
    each row of (rows, n) -> (rows, nperseg).

    On the card each row is one launch on the current stream, writing its
    own row of the output; the rows share the scratch, whose tickets each
    launch leaves at zero, and launches on one stream run in order. The
    card's host side, from the checks to the last launch, runs in the
    `gjt.b2.launch` span (`runtime.profiling.span`)."""
    if not runs_kernel(x, "welch_psd_fused"):
        return welch_psd_reference(x, sample_rate, nperseg, detrend)
    with profiling.span("gjt.b2.launch"):
        if not supported(nperseg):
            raise ValueError(f"welch_psd_fused: nperseg {nperseg} is "
                             "neither a power of two in [64, 16384], one of "
                             f"{MIXED_NPERSEG} nor a size above 16384 that "
                             "the TPU kernel takes")
        if x.dim() not in (1, 2):
            raise ValueError(f"welch_psd_fused: expected (n,) or (rows, n), "
                             f"got {tuple(x.shape)}")
        check_tensor(x, "x", torch.complex64, (None,) * x.dim())
        n = x.shape[-1]
        if n < nperseg:
            raise ValueError(f"welch_psd_fused: {n} samples < nperseg "
                             f"{nperseg}")
        rows = 1 if x.dim() == 1 else x.shape[0]
        n_segs = 1 + (n - nperseg) // (nperseg // 2)
        win, wsum2 = _window(nperseg, x.device)
        tab = build.reg_twiddles(nperseg, x.device)
        out = torch.empty(x.shape[:-1] + (nperseg,), dtype=torch.float32,
                          device=x.device)
        scale = 1.0 / (sample_rate * wsum2) / n_segs
        x_row, out_row = n * x.element_size(), nperseg * out.element_size()
        if nperseg > build.FFT_MAX_N:
            _welch_large(x, win, tab, out, rows, nperseg, n_segs, detrend,
                         scale, x_row, out_row)
            return out
        # the scratch, sized by the kernel: the slice tickets and the
        # clusters' partial rows. The number of tiles is a constant of the
        # kernel, so the reduction order, and with it the result, does not
        # depend on the card.
        scratch = build.Scratch("gjt_welch_scratch_bytes", (nperseg,))
        for r in range(rows):
            build.launch("gjt_welch_psd", x.device, x.data_ptr() + r * x_row,
                         win.data_ptr(), tab.data_ptr(), scratch,
                         out.data_ptr() + r * out_row, nperseg, n_segs,
                         int(detrend), scale)
        return out


def large_seg_chunk(nperseg: int, n_segs: int) -> int:
    """Segments per pass above 16384 points: each takes a complex64 and a
    float32 row of scratch (12 bytes a point), within
    `gates.LARGE_SCRATCH_BYTES` (and a grid's 65535 rows)."""
    return max(1, min(n_segs, 65535,
                      gates.LARGE_SCRATCH_BYTES // (12 * nperseg)))


def _welch_large(x, win, tab, out, rows, nperseg, n_segs, detrend, scale,
                 x_row, out_row) -> None:
    """The rows of `welch_psd_fused` above 16384 points, one launch of
    `gjt_welch_psd_large` per row; the rows share one set of scratch."""
    chunk = large_seg_chunk(nperseg, n_segs)
    dev = x.device
    A = torch.empty((chunk, nperseg), dtype=torch.complex64, device=dev)
    pw = torch.empty((chunk, nperseg), dtype=torch.float32, device=dev)
    half = torch.empty(n_segs + 1, dtype=torch.complex64, device=dev)
    acc = torch.empty(nperseg, dtype=torch.float32, device=dev)
    tw2 = build.large_row_twiddles(nperseg, dev)
    for r in range(rows):
        build.launch("gjt_welch_psd_large", dev, x.data_ptr() + r * x_row,
                     win.data_ptr(), tw2.data_ptr(), tab.data_ptr(),
                     A.data_ptr(), pw.data_ptr(), half.data_ptr(),
                     acc.data_ptr(), out.data_ptr() + r * out_row, nperseg,
                     n_segs, chunk, int(detrend), scale)
