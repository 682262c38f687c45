"""Kernel B3: the per-Doppler ("std") acquisition search (`csrc/caf_std.cu`),
its wrapper and its plain version.

Replaces gps_jamming_tpu/ops/pallas_caf.py's three TPU layouts of one
computation: `caf_accumulate_fused` (v1, `_make_kernel`),
`caf_accumulate_fused_v2` (`_make_kernel_v2`) and `caf_accumulate_fused_v3`
(`_make_kernel_v3`). For each Doppler bin f and code period b the block is
mixed down by e^{-j2pi f t/fs}, transformed, multiplied by every PRN's conj
replica spectrum, transformed back, and |.|^2 is summed over the periods:

    out[p, f, :] = sum_b |IFFT(FFT(x_b * osc_f) * rep[p])|^2

The phasor rows osc_f come from one (F, n) table per (freqs, rate, n,
device), computed in float64 on the host and cast to complex64; the kernel
and its plain version read the same table. A CPU tensor takes the plain
version (`caf_accumulate_reference`); a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import check_tensor, runs_kernel
from ..kernels import build, fft_plan, gates

# The sizes the kernel takes: kernels/gates.py.
supported = gates.std_supported
unsupported_reason = gates.std_unsupported_reason


def large_chunks(n: int, nb: int, n_freq: int, n_prn: int) -> tuple[int, int]:
    """(bins, cells) per pass above 16384 lags. Where the correlate stage
    runs in one thread-block cluster per cell (`fft_plan.cluster_split`,
    up to 131072) it needs no scratch (cells 0), and the forward spectra
    of a chunk of Doppler bins take up to `gates.LARGE_SCRATCH_BYTES`;
    else they take at most half of it and the two-pass correlate stage's
    cells (p, f), nb n-point complex64 rows each, the rest; each at least
    one."""
    row = nb * n * 8
    if fft_plan.cluster_split(n) is not None:
        return max(1, min(n_freq, gates.LARGE_SCRATCH_BYTES // row)), 0
    bins = max(1, min(n_freq, gates.LARGE_SCRATCH_BYTES // 2 // row))
    cells = (gates.LARGE_SCRATCH_BYTES - bins * row) // row
    return bins, max(1, min(n_prn * bins, cells))


@functools.lru_cache(maxsize=8)
def _phasors(freqs: tuple, sample_rate: float, n: int,
             device: torch.device) -> torch.Tensor:
    t = np.arange(n, dtype=np.float64) / sample_rate
    osc = np.exp(-2j * np.pi * np.asarray(freqs, np.float64)[:, None]
                 * t[None, :])
    return torch.from_numpy(osc.astype(np.complex64)).to(device)


def phasors(freqs, sample_rate: float, n: int,
            device: torch.device) -> torch.Tensor:
    """(F, n) complex64 e^{-j2pi f t/fs}, t = 0..n-1, computed in float64.
    Cached per (freqs, rate, n, device): callers share one read-only
    tensor (9.3 MB at Galileo's 71 x 16384)."""
    key = tuple(float(f) for f in np.asarray(freqs).reshape(-1))
    return _phasors(key, float(sample_rate), int(n), torch.device(device))


def caf_accumulate_reference(blocks: torch.Tensor, replica: torch.Tensor,
                             freqs, sample_rate: float) -> torch.Tensor:
    """Plain version of the kernel, with torch.fft.

    blocks: (nb, n) complex64; replica: (P, n) complex64 conj spectra;
    freqs: (F,) Doppler bins [Hz]. Returns the (P, F, n) float32 surface.
    The blocks are added one at a time, so the peak memory is one (P, F, n)
    complex product (335 MB at Galileo's 36 x 71 x 16384).
    """
    osc = phasors(freqs, sample_rate, blocks.shape[-1], blocks.device)
    out = None
    for xb in blocks:
        v = torch.fft.ifft(replica[:, None, :]
                           * torch.fft.fft(xb * osc, dim=-1)[None], dim=-1)
        p = v.real * v.real + v.imag * v.imag
        out = p if out is None else out.add_(p)
    return out


def caf_accumulate_fused(blocks: torch.Tensor, replica: torch.Tensor, freqs,
                         sample_rate: float) -> torch.Tensor:
    """The std search of `caf_accumulate_reference`, as kernel B3 on CUDA.

    blocks (nb, n) and replica (P, n) complex64 on one device; freqs a
    concrete (F,) array of Doppler bins [Hz]. Returns (P, F, n) float32.
    """
    if not runs_kernel(blocks, "caf_accumulate_fused"):
        return caf_accumulate_reference(blocks, replica, freqs, sample_rate)
    nb, n = blocks.shape
    if not supported(n):
        raise ValueError(f"kernel B3 (std CAF): {unsupported_reason(n)}")
    check_tensor(blocks, "blocks", torch.complex64, (nb, n))
    check_tensor(replica, "replica", torch.complex64, (None, n),
                 blocks.device)
    osc = phasors(freqs, sample_rate, n, blocks.device)
    n_freq, n_prn = osc.shape[0], replica.shape[0]
    out = torch.empty((n_prn, n_freq, n), dtype=torch.float32,
                      device=blocks.device)
    if n > build.FFT_MAX_N:
        bins, cells = large_chunks(n, nb, n_freq, n_prn)
        Y = torch.empty((bins * nb, n), dtype=torch.complex64,
                        device=blocks.device)
        Bs = torch.empty((cells * nb, n), dtype=torch.complex64,
                         device=blocks.device) if cells else None
        tw2 = build.large_row_twiddles(n, blocks.device)
        twn = build.reg_twiddles(n, blocks.device)
        build.launch("gjt_caf_std_large", blocks.device, blocks.data_ptr(),
                     osc.data_ptr(), Y.data_ptr(),
                     Bs.data_ptr() if cells else None, replica.data_ptr(),
                     tw2.data_ptr(), twn.data_ptr(), out.data_ptr(), n_freq,
                     nb, n_prn, n, bins, cells)
        return out
    Y = torch.empty((n_freq * nb, n), dtype=torch.complex64,
                    device=blocks.device)
    tw = build.row_twiddles(n, blocks.device)
    build.launch("gjt_caf_std", blocks.device, blocks.data_ptr(),
                 osc.data_ptr(), Y.data_ptr(), replica.data_ptr(),
                 tw.data_ptr(), out.data_ptr(), n_freq, nb, n_prn, n)
    return out
