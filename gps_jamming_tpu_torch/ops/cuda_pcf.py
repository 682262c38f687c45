"""Kernel B1: the PCF acquisition search (`csrc/pcf.cu`), its wrapper and
its plain version.

Replaces gps_jamming_tpu/ops/pallas_caf.py's single-launch PCF
(`caf_accumulate_pcf_fused` -> `_pcf_single_launch` -> `_make_kernel_v3`),
in its three modes: the surface, the in-kernel acquisition statistics
(`stats_excl >= 0`) and peak-only (`stats_excl = -1`); and a fourth, the
per-PRN peak (`pcf_peak_per_prn`, `pcf_search(per_prn=True)`).

The kernel takes the code periods themselves. The prologue, which stayed
in XLA on the TPU, combines the periods in the time domain into
y[(s, f), g](t) = e^{-j2pi s*set_off*t} * sum_{b in g} w[s, f, b] x_b(t);
kernel B1 builds each such row as its forward FFT loads it, from the
cached weights and mixes of `prologue_consts`, then runs the product with
the coarse-shifted replica, the inverse FFT, |.|^2 and the group sum. The
plain version builds y with `fold` (one small einsum; `pcf_prologue`) and
searches it with `pcf_search_reference`.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
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
def prologue_consts(nb: int, n: int, sample_rate: float, n_sets: int,
                    fine_hz: tuple, n_groups: int, device: torch.device):
    """Group weights w (S, F, G, gl) and sub-bin mixes (S, n), complex64,
    computed in float64; cached per shape and device, read-only."""
    if nb % n_groups:
        raise ValueError(f"n_blocks {nb} not divisible by {n_groups} groups")
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


def _consts(blocks: torch.Tensor, n: int, sample_rate: float, n_sets: int,
            fine_hz, n_groups: int, nb: int | None = None):
    """`prologue_consts` for nb periods (default blocks.shape[0]) of n
    samples, on blocks' device."""
    return prologue_consts(blocks.shape[0] if nb is None else nb, n,
                           float(sample_rate), n_sets,
                           tuple(float(f) for f in fine_hz), n_groups,
                           blocks.device)


def fold(blocks: torch.Tensor, w: torch.Tensor,
         mix: torch.Tensor) -> torch.Tensor:
    """(G*gl, n) code periods -> (S*F*G, n) complex64 rows
    y[(s, f, g)] = mix[s] * sum_b w[s, f, g, b] * blocks[g*gl + b], the
    rows that kernel B1's forward builds as it loads them."""
    n_sets, n_fine, n_groups, gl = w.shape
    n = blocks.shape[-1]
    xg = blocks.reshape(n_groups, gl, n)
    y = torch.einsum("sfgb,gbn->sfgn", w, xg) * mix[:, None, None, :]
    return y.reshape(-1, n).contiguous()


def pcf_prologue(blocks: torch.Tensor, sample_rate: float, n_sets: int = 2,
                 fine_hz=(-200.0, 0.0, 200.0),
                 n_groups: int = 2) -> torch.Tensor:
    """(B, n) blocks -> (S*F*G, n) complex64 combined group signals, rows
    ordered (s, f, g): `fold` with the weights of `prologue_consts`."""
    w, mix = _consts(blocks, blocks.shape[-1], sample_rate, n_sets, fine_hz,
                     n_groups)
    return fold(blocks, w, mix)


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


def _check_periods(blocks: torch.Tensor, nb: int, n: int) -> None:
    """Raise ValueError unless `blocks` holds nb code periods of n samples:
    (nb, n), or 1-D with at least nb * n samples."""
    if tuple(blocks.shape) == (nb, n) or (blocks.dim() == 1
                                          and blocks.numel() >= nb * n):
        return
    raise ValueError(f"blocks: shape {tuple(blocks.shape)}, expected {nb} "
                     f"periods of {n}")


def pcf_search(blocks: torch.Tensor, replica: torch.Tensor, n_c: int,
               w: torch.Tensor, mix: torch.Tensor,
               stats_excl: int | None = None, *, per_prn: bool = False):
    """The PCF search over the code periods `blocks`: kernel B1 on CUDA,
    whose host side, from the checks to the launch's error check, runs in
    the `gjt.b1.launch` span (`runtime.profiling.span`); the plain version
    (`fold`, then `pcf_search_reference`) on the CPU.

    blocks: (G*gl, n) complex64 code periods, or a 1-D signal whose first
    G*gl*n samples are they; replica: (P, n) natural-order conj spectra;
    w (S, F, G, gl), mix (S, n): `prologue_consts`. Returns the
    (P, n_c*S*F, n) surface; with stats_excl, the five (P, n_c*S*F)
    statistics of `surface_stats`; with per_prn, the (P,) peak, the max
    of the surface over its rows and lags.
    """
    n_sets, n_fine, n_groups, gl = w.shape
    nb, n = n_groups * gl, replica.shape[-1]
    n_rows = n_sets * n_fine
    if n_c % 2 == 0 or n_c // 2 >= n:
        raise ValueError(f"pcf_search: n_c {n_c} must be odd, with "
                         f"n_c // 2 < n = {n}")
    if stats_excl is not None and not -1 <= stats_excl < n // 2:
        raise ValueError(f"pcf_search: stats_excl {stats_excl} outside "
                         f"[-1, {n // 2})")
    if per_prn and stats_excl is not None:
        raise ValueError("pcf_search: per_prn returns the peak alone; "
                         "give no stats_excl")
    _check_periods(blocks, nb, n)
    if not runs_kernel(blocks, "pcf_search"):
        periods = blocks.reshape(-1)[: nb * n].reshape(nb, n)
        surf = pcf_search_reference(fold(periods, w, mix), replica, n_c,
                                    n_rows, n_groups, stats_excl)
        return surf.amax(dim=(-2, -1)) if per_prn else surf
    with profiling.span("gjt.b1.launch"):
        if not supported(n):
            raise ValueError(f"pcf_search: {unsupported_reason(n)}")
        dev = blocks.device
        check_tensor(blocks, "blocks", torch.complex64)
        check_tensor(replica, "replica", torch.complex64, (None, n), dev)
        check_tensor(w, "w", torch.complex64, None, dev)
        check_tensor(mix, "mix", torch.complex64, (n_sets, n), dev)
        n_prn = replica.shape[0]
        Y = torch.empty((n_rows * n_groups, n), dtype=torch.complex64,
                        device=dev)
        if per_prn:
            out = torch.empty(n_prn, dtype=torch.float32, device=dev)
        elif stats_excl is None:
            out = torch.empty((n_prn, n_c * n_rows, n), dtype=torch.float32,
                              device=dev)
        else:
            out = torch.empty((5, n_prn, n_c * n_rows), dtype=torch.float32,
                              device=dev)
        mode = 2 if per_prn else int(stats_excl is not None)
        args = (n_rows, n_sets, n_groups, gl, n_c, n_prn, n, mode,
                0 if stats_excl is None else stats_excl)
        ptrs = (blocks.data_ptr(), w.data_ptr(), mix.data_ptr(),
                Y.data_ptr(), replica.data_ptr())
        if n > build.FFT_MAX_N:
            build.launch("gjt_pcf_large", dev, *ptrs,
                         build.large_row_twiddles(n, dev).data_ptr(),
                         build.reg_twiddles(n, dev).data_ptr(),
                         out.data_ptr(), *args)
        else:
            build.launch("gjt_pcf", dev, *ptrs,
                         build.row_twiddles(n, dev).data_ptr(),
                         out.data_ptr(), *args)
        return out if stats_excl is None else tuple(out.unbind(0))


def caf_accumulate_pcf_fused(blocks: torch.Tensor, replica: torch.Tensor,
                             sample_rate: float,
                             max_doppler_hz: float = 7000.0,
                             n_sets: int = 2,
                             fine_hz=(-200.0, 0.0, 200.0),
                             n_groups: int = 2, *,
                             stats_excl: int | None = None):
    """PCF acquisition of the (B, n) code periods `blocks`, `pcf_search`
    with the weights and mixes of `prologue_consts`.

    Same contract as `caf.caf_accumulate_pcf`: the (P, n_c*S*F, n) surface
    with the Doppler axis ordered (coarse, set, fine) as
    `caf.pcf_doppler_hz`; or, with stats_excl, the 5-tuple of
    `surface_stats`, each (P, n_c*S*F), in the order of
    `pallas_caf.caf_accumulate_pcf_fused`. The kernel reads the periods in
    place, so a view that is not contiguous is copied first.
    """
    n = blocks.shape[-1]
    w, mix = _consts(blocks, n, sample_rate, n_sets, fine_hz, n_groups)
    return pcf_search(blocks.contiguous(), replica,
                      n_coarse(sample_rate, n, max_doppler_hz), w, mix,
                      stats_excl)


def pcf_peak_per_prn(x: torch.Tensor, replica: torch.Tensor,
                     sample_rate: float, periods: int,
                     max_doppler_hz: float = 7000.0, n_sets: int = 2,
                     fine_hz=(-200.0, 0.0, 200.0),
                     n_groups: int = 2) -> torch.Tensor:
    """The (P,) peak of the PCF search (`caf_accumulate_pcf_fused`) over
    the first `periods` code periods of the 1-D signal x (n =
    replica.shape[-1] samples each): the max over every Doppler row and
    lag, per replica row. On CUDA, one launch of kernel B1 and no other
    operator."""
    n = replica.shape[-1]
    w, mix = _consts(x, n, sample_rate, n_sets, fine_hz, n_groups, periods)
    return pcf_search(x, replica, n_coarse(sample_rate, n, max_doppler_hz),
                      w, mix, per_prn=True)
