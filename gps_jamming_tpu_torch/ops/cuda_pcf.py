"""Kernel B1: the PCF acquisition search (`csrc/pcf.cu`), its wrapper and
its plain version.

Replaces gps_jamming_tpu/ops/pallas_caf.py's single-launch PCF
(`caf_accumulate_pcf_fused` -> `_pcf_single_launch` -> `_make_kernel_v3`),
in its three modes: the surface, the in-kernel acquisition statistics
(`stats_excl >= 0`) and peak-only (`stats_excl = -1`).

The prologue stays in torch, as it stayed in XLA on the TPU: the blocks are
combined in the time domain into y[(s, f), g](t) =
e^{-j2pi s*set_off*t} * sum_{b in g} w[s, f, b] x_b(t), one small einsum.
`pcf_search` then runs the forward FFT of every row, the product with the
coarse-shifted replica, the inverse FFT, |.|^2 and the group sum.

A CPU tensor takes the plain version (`pcf_search_reference`); a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import check_tensor, runs_kernel
from ..kernels import build, gates
from ..runtime import profiling

# The sizes the kernel takes: kernels/gates.py.
supported = gates.pcf_supported
unsupported_reason = gates.pcf_unsupported_reason


def n_coarse(sample_rate: float, n: int, max_doppler_hz: float) -> int:
    """Number of integer FFT-bin shifts covering +/- max_doppler_hz."""
    return 2 * int(np.floor(max_doppler_hz / (sample_rate / n))) + 1


@functools.lru_cache(maxsize=16)
def _prologue_consts(nb: int, n: int, sample_rate: float, n_sets: int,
                     fine_hz: tuple, n_groups: int, device: torch.device):
    """Group weights w (S, F, G, gl) and sub-bin mixes (S, n), complex64,
    computed in float64."""
    gl = nb // n_groups
    set_off = sample_rate / n / n_sets
    fine = np.asarray(fine_hz, np.float64)
    sets = np.arange(n_sets, dtype=np.float64) * set_off
    wf = fine[None, :] + sets[:, None]                          # (S, F)
    b_t = np.arange(nb, dtype=np.float64) * (n / sample_rate)
    w = np.exp(-2j * np.pi * wf[:, :, None] * b_t[None, None, :])
    t = np.arange(n, dtype=np.float64) / sample_rate
    mix = np.exp(-2j * np.pi * sets[:, None] * t[None, :])      # (S, n)
    w = w.reshape(n_sets, fine.size, n_groups, gl).astype(np.complex64)
    return (torch.from_numpy(w).to(device),
            torch.from_numpy(mix.astype(np.complex64)).to(device))


def pcf_prologue(blocks: torch.Tensor, sample_rate: float, n_sets: int = 2,
                 fine_hz=(-200.0, 0.0, 200.0),
                 n_groups: int = 2) -> torch.Tensor:
    """(B, n) blocks -> (S*F*G, n) complex64 combined group signals, rows
    ordered (s, f, g)."""
    nb, n = blocks.shape
    if nb % n_groups:
        raise ValueError(f"n_blocks {nb} not divisible by {n_groups} groups")
    w, mix = _prologue_consts(nb, n, float(sample_rate), n_sets,
                              tuple(float(f) for f in fine_hz), n_groups,
                              blocks.device)
    xg = blocks.reshape(n_groups, nb // n_groups, n)
    y = torch.einsum("sfgb,gbn->sfgn", w, xg) * mix[:, None, None, :]
    return y.reshape(-1, n).contiguous()


def surface_stats(surf: torch.Tensor, excl: int) -> tuple[torch.Tensor, ...]:
    """(max, arglag, excluded_max, total_sum, window_sum) over the lag axis
    of a (P, rows, n) surface; the lowest lag wins ties. excl < 0 is
    peak-only: the last three are zeros."""
    max1, arg = surf.max(dim=-1)
    if excl < 0:
        z = torch.zeros_like(max1)
        return max1, arg.to(torch.float32), z, z, z
    n = surf.shape[-1]
    d = (torch.arange(n, device=surf.device) - arg[..., None]) % n
    ex = torch.minimum(d, n - d) <= excl
    exmax = surf.masked_fill(ex, float("-inf")).amax(dim=-1)
    wsum = torch.where(ex, surf, torch.zeros_like(surf)).sum(dim=-1)
    return max1, arg.to(torch.float32), exmax, surf.sum(dim=-1), wsum


def pcf_search_reference(y: torch.Tensor, replica: torch.Tensor, n_c: int,
                         n_rows: int, n_groups: int,
                         stats_excl: int | None = None):
    """Plain version of the kernel, with torch.fft.

    y: (n_rows*n_groups, n) from `pcf_prologue`; replica: (P, n) natural-
    order conj spectra. Returns the (P, n_c*n_rows, n) surface, row index
    c*n_rows + r, or `surface_stats` of it when stats_excl is not None.
    """
    n = y.shape[-1]
    Y = torch.fft.fft(y, dim=-1).reshape(n_rows, n_groups, n)
    k = torch.arange(n, device=y.device)
    shifts = torch.arange(n_c, device=y.device) - n_c // 2
    repc = replica[:, (k[None, :] - shifts[:, None]) % n]      # (P, C, n)
    v = torch.fft.ifft(repc[:, :, None, None, :] * Y[None, None], dim=-1)
    surf = (v.real * v.real + v.imag * v.imag).sum(dim=3)      # (P, C, R, n)
    surf = surf.reshape(replica.shape[0], n_c * n_rows, n)
    return surf if stats_excl is None else surface_stats(surf, stats_excl)


def pcf_search(y: torch.Tensor, replica: torch.Tensor, n_c: int,
               n_rows: int, n_groups: int, stats_excl: int | None = None):
    """The PCF search of `pcf_search_reference`, as kernel B1 on CUDA,
    whose host side, from the checks to the launch's error check, runs in
    the `gjt.b1.launch` span (`runtime.profiling.span`)."""
    n = y.shape[-1]
    if n_c % 2 == 0 or n_c // 2 >= n:
        raise ValueError(f"pcf_search: n_c {n_c} must be odd, with "
                         f"n_c // 2 < n = {n}")
    if stats_excl is not None and not -1 <= stats_excl < n // 2:
        raise ValueError(f"pcf_search: stats_excl {stats_excl} outside "
                         f"[-1, {n // 2})")
    if not runs_kernel(y, "pcf_search"):
        return pcf_search_reference(y, replica, n_c, n_rows, n_groups,
                                    stats_excl)
    with profiling.span("gjt.b1.launch"):
        if not supported(n):
            raise ValueError(f"pcf_search: {unsupported_reason(n)}")
        check_tensor(y, "y", torch.complex64, (n_rows * n_groups, n))
        check_tensor(replica, "replica", torch.complex64, (None, n), y.device)
        n_prn = replica.shape[0]
        Y = torch.empty_like(y)
        if stats_excl is None:
            out = torch.empty((n_prn, n_c * n_rows, n), dtype=torch.float32,
                              device=y.device)
        else:
            out = torch.empty((5, n_prn, n_c * n_rows), dtype=torch.float32,
                              device=y.device)
        modes = (n_rows, n_groups, n_c, n_prn, n, int(stats_excl is not None),
                 0 if stats_excl is None else stats_excl)
        if n > build.FFT_MAX_N:
            tw2 = build.large_row_twiddles(n, y.device)
            twn = build.reg_twiddles(n, y.device)
            build.launch("gjt_pcf_large", y.device, y.data_ptr(),
                         Y.data_ptr(), replica.data_ptr(), tw2.data_ptr(),
                         twn.data_ptr(), out.data_ptr(), *modes)
        else:
            tw = build.row_twiddles(n, y.device)
            build.launch("gjt_pcf", y.device, y.data_ptr(), Y.data_ptr(),
                         replica.data_ptr(), tw.data_ptr(), out.data_ptr(),
                         *modes)
        return out if stats_excl is None else tuple(out.unbind(0))


def caf_accumulate_pcf_fused(blocks: torch.Tensor, replica: torch.Tensor,
                             sample_rate: float,
                             max_doppler_hz: float = 7000.0,
                             n_sets: int = 2,
                             fine_hz=(-200.0, 0.0, 200.0),
                             n_groups: int = 2, *,
                             stats_excl: int | None = None):
    """PCF acquisition through the prologue and `pcf_search`.

    Same contract as `caf.caf_accumulate_pcf`: the (P, n_c*S*F, n) surface
    with the Doppler axis ordered (coarse, set, fine) as
    `caf.pcf_doppler_hz`; or, with stats_excl, the 5-tuple of
    `surface_stats`, each (P, n_c*S*F), in the order of
    `pallas_caf.caf_accumulate_pcf_fused`.
    """
    n = blocks.shape[-1]
    y = pcf_prologue(blocks, sample_rate, n_sets, fine_hz, n_groups)
    return pcf_search(y, replica, n_coarse(sample_rate, n, max_doppler_hz),
                      n_sets * len(fine_hz), n_groups, stats_excl)
