"""Acquisition surfaces (counterpart of gps_jamming_tpu.ops.caf:
`doppler_bins`, `caf_surface`, `caf_accumulate`, `caf_pair`, `caf_peak`,
`pcf_doppler_hz`, `pcf_profitable`, `caf_accumulate_pcf`,
`caf_accumulate_pcf_fdma`).

The per-Doppler ("std") search, `caf_accumulate`, is the reference's
non-coherent sum over code periods of one (Doppler, all-lags) correlation
per bin; it is kernel B3. The post-correlation-FFT (PCF) search factorizes
the Doppler axis into integer FFT-bin shifts of the replica (coarse),
n_sets sub-bin mixes (sets) and a small DFT across the blocks of each
coherent group (fine); it is kernel B1, and its FDMA form
(`caf_accumulate_pcf_fdma`, GLONASS) stays in torch.fft, as it stayed in
XLA on the TPU.

The JAX package's TPU precision policy (`fused_dispatch`,
`resolve_acq_precision`, `set_acq_precision`, `precision=`) is not ported:
the port computes in float32/complex64 only.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..kernels.gates import tpu_kernel_takes
from . import codes, cuda_caf, cuda_pcf


def doppler_bins(max_hz: float, step_hz: float) -> np.ndarray:
    """Symmetric Doppler grid (71 bins at +/-7 kHz, 200 Hz)."""
    n = int(round(2 * max_hz / step_hz)) + 1
    return (np.arange(n) * step_hz - max_hz).astype(np.float32)


def caf_surface(x: torch.Tensor, replica: torch.Tensor, freqs,
                sample_rate: float) -> torch.Tensor:
    """CAF power surface of a block against code replicas, in plain torch.

    x: (n,) or (batch, n) complex64; replica: (P, n) conj(FFT(replica));
    freqs: (F,) Doppler bins [Hz]. Returns float32 (..., P, F, n): one
    circular-lag row per (code, Doppler).

    The phase ramp -2pi f t is float32, computed in the order of the JAX
    package's `_doppler_mix_p`. At GLONASS's FDMA offsets (up to 3.9 MHz
    over a 1 ms period) float32 rounding reaches 1e-3 rad, which moves the
    noise floor by ~1e-4 relative; keeping the reference's arithmetic keeps
    the two packages' GLONASS std searches equal to that level.
    """
    mf = torch.fft.fft(_doppler_mix(x, freqs, sample_rate), dim=-1)
    v = torch.fft.ifft(mf[..., None, :, :] * replica[:, None, :], dim=-1)
    return v.real * v.real + v.imag * v.imag


def _doppler_mix(x: torch.Tensor, freqs, sample_rate: float) -> torch.Tensor:
    """x (..., n) mixed down by each Doppler bin: (..., F, n), out[f, k] =
    x[k] e^{-j2pi f k/fs}, the float32 phase in the order of the JAX
    package's `_doppler_mix_p`."""
    t = codes.sample_times(x.shape[-1], sample_rate, x.device)
    f = torch.as_tensor(np.asarray(freqs, np.float32), device=x.device)
    phase = (-2.0 * math.pi) * f[:, None] * t[None, :]
    return x[..., None, :] * torch.polar(torch.ones_like(phase), phase)


def plain_on_card(blocks: torch.Tensor, n_prn: int, pcf: bool) -> bool:
    """Does a search on these blocks compute its plain surface on the card?

    Only where neither the port's kernel (`cuda_pcf.supported` for the PCF
    search, `cuda_caf.supported` for std) nor any of the JAX package's
    Pallas kernels (`tpu_kernel_takes`; both rules in kernels/gates.py)
    takes n, so that the reference computes XLA there (n = 2062 = 2 *
    1031; above 32768 for PCF). Up to 262144 the port's kernels take every
    n a Pallas kernel takes; above it (std, which v1 takes there: 2 * 128
    * 1031 ...) the search goes to the kernel's wrapper, which raises with
    its `unsupported_reason`.
    """
    n = int(blocks.shape[-1])
    ours = cuda_pcf.supported(n) if pcf else cuda_caf.supported(n)
    return (blocks.is_cuda and not ours
            and not tpu_kernel_takes(n, int(n_prn), pcf))


def caf_accumulate(blocks: torch.Tensor, replica: torch.Tensor, freqs,
                   sample_rate: float) -> torch.Tensor:
    """Non-coherent sum of the CAF power over code periods: the
    reference's `intg`-fold loop of `sdraqcuisition` (sdracq.c:15-27).

    blocks: (n_blocks, n) complex64, one code period each; replica: (P, n)
    complex64; freqs: concrete (F,) Doppler bins [Hz]. Returns float32
    (P, F, n). This is kernel B3 through `cuda_caf.caf_accumulate_fused`:
    on a CUDA tensor it launches the kernel, or computes the plain surface
    where the JAX package computes XLA (`plain_on_card`); a CPU tensor runs
    the kernel's plain version.
    """
    if plain_on_card(blocks, replica.shape[0], pcf=False):
        return cuda_caf.caf_accumulate_reference(blocks, replica, freqs,
                                                 sample_rate)
    return cuda_caf.caf_accumulate_fused(blocks, replica, freqs, sample_rate)


def caf_pair(a: torch.Tensor, b: torch.Tensor, freqs,
             sample_rate: float) -> torch.Tensor:
    """Signal-vs-signal CAF (delay x Doppler) for one antenna pair, in
    plain torch (no TPU kernel computes it).

    out[f] = |IFFT(FFT(a * e^{-j2pi f t}) * conj(FFT(b)))|^2 over circular
    lags, both FFTs zero-padded to 2n so that lags are linear within +/- n.
    a, b: (n,) complex64; freqs: (F,) Doppler bins [Hz]. Returns (F, 2n)
    float32.
    """
    nfft = 2 * a.shape[-1]
    af = torch.fft.fft(_doppler_mix(a, freqs, sample_rate), n=nfft, dim=-1)
    bf = torch.fft.fft(b, n=nfft, dim=-1)
    v = torch.fft.ifft(af * bf.conj()[..., None, :], dim=-1)
    return v.real * v.real + v.imag * v.imag


def caf_peak(power: torch.Tensor):
    """Peak of a (..., n_freq, n_lag) surface: (freq_idx, lag_idx,
    peak_val), the lowest flat index winning ties."""
    nf, nl = power.shape[-2], power.shape[-1]
    flat = power.reshape(power.shape[:-2] + (nf * nl,))
    idx = flat.argmax(dim=-1)
    return idx // nl, idx % nl, flat.gather(-1, idx[..., None])[..., 0]


def pcf_doppler_hz(sample_rate: float, n: int, max_doppler_hz: float,
                   n_sets: int = 2,
                   fine_hz=(-200.0, 0.0, 200.0)) -> np.ndarray:
    """The (n_coarse * n_sets * n_fine,) Doppler grid of caf_accumulate_pcf,
    ordered (coarse, set, fine) like the surface's Doppler axis."""
    bin_hz = sample_rate / n
    n_c = cuda_pcf.n_coarse(sample_rate, n, max_doppler_hz)
    cvals = (np.arange(n_c) - n_c // 2) * bin_hz
    sets = np.arange(n_sets) * (bin_hz / n_sets)
    fine = np.asarray(fine_hz, np.float64)
    d = (cvals[:, None, None] + sets[None, :, None] + fine[None, None, :])
    return d.reshape(-1).astype(np.float32)


def pcf_profitable(n: int, n_blocks: int, sample_rate: float,
                   max_doppler_hz: float, n_freq_std: int,
                   n_sets: int = 2, n_fine: int = 3,
                   n_groups: int = 2) -> bool:
    """Does the PCF factorization run fewer inverse-FFT rows than the
    per-Doppler search for this geometry?

    PCF runs n_coarse * n_sets * n_fine * n_groups rows, std
    n_freq_std * n_blocks. GPS (2048 lags at 2.048 MS/s, 1 kHz bins): 15
    coarse bins, 180 rows against 710, so PCF. Galileo E1B (16384 lags at
    4.096 MS/s, 250 Hz bins): 57 coarse bins, 684 rows against 71 per
    block, so PCF at the default 10 blocks and std only at n_blocks <= 9.
    """
    n_c = cuda_pcf.n_coarse(sample_rate, n, max_doppler_hz)
    return n_c * n_sets * n_fine * n_groups < n_freq_std * n_blocks


def caf_accumulate_pcf(blocks: torch.Tensor, replica_fft_conj: torch.Tensor,
                       sample_rate: float, max_doppler_hz: float = 7000.0,
                       n_sets: int = 2, fine_hz=(-200.0, 0.0, 200.0),
                       n_groups: int = 2) -> torch.Tensor:
    """Acquisition surface by the PCF search.

    blocks: (n_blocks, n) complex64, one code period each, n_blocks a
    multiple of n_groups. replica_fft_conj: (n_prn, n) complex64. Returns
    float32 (n_prn, n_coarse*n_sets*n_fine, n); the Doppler of axis-1 index
    i is pcf_doppler_hz(...)[i].

    This is kernel B1 through `cuda_pcf.caf_accumulate_pcf_fused`: on a
    CUDA tensor it launches the kernel, or runs the prologue and the plain
    search where the JAX package computes XLA (`plain_on_card`); a CPU
    tensor runs the prologue and the kernel's plain version.
    """
    if plain_on_card(blocks, replica_fft_conj.shape[0], pcf=True):
        n = blocks.shape[-1]
        y = cuda_pcf.pcf_prologue(blocks, sample_rate, n_sets, fine_hz,
                                  n_groups)
        return cuda_pcf.pcf_search_reference(
            y, replica_fft_conj, cuda_pcf.n_coarse(sample_rate, n,
                                                   max_doppler_hz),
            n_sets * len(fine_hz), n_groups)
    return cuda_pcf.caf_accumulate_pcf_fused(
        blocks, replica_fft_conj, sample_rate, max_doppler_hz=max_doppler_hz,
        n_sets=n_sets, fine_hz=fine_hz, n_groups=n_groups)


def caf_accumulate_pcf_fdma(blocks: torch.Tensor, replica: torch.Tensor,
                            offsets_hz, sample_rate: float,
                            max_doppler_hz: float = 7000.0, n_sets: int = 2,
                            fine_hz=(-200.0, 0.0, 200.0),
                            n_groups: int = 2) -> torch.Tensor:
    """PCF acquisition over FDMA channels that share one code (GLONASS).

    Each channel offset splits into an integer FFT-bin part coarse_c and a
    sub-bin part sub_c. Only the (channel, set) rows are mixed, by
    e^{-j2pi (sub_c + s*bin/n_sets) t}; the Doppler rides on integer shifts
    coarse_c + d (|d| <= max_doppler/bin) of the shared replica spectrum,
    and the fine grid is a DFT across the blocks of each coherent group,
    whose weights carry the mix's inter-block phase.

    blocks: (n_blocks, n) complex64, n_blocks a multiple of n_groups;
    replica: (1, n) complex64 conj spectrum; offsets_hz: (C,) static
    offsets. Returns float32 (C, n_coarse*n_sets*n_fine, n); the Doppler of
    axis-1 index i, relative to the channel's carrier, is
    pcf_doppler_hz(sample_rate, n, max_doppler_hz, n_sets, fine_hz)[i].
    Plain torch.fft (cuFFT on the card), as the JAX package left it to
    XLA.
    """
    nb, n = blocks.shape
    if nb % n_groups:
        raise ValueError(f"n_blocks {nb} not divisible by {n_groups}")
    dev = blocks.device
    gl = nb // n_groups
    bin_hz = sample_rate / n
    set_off = bin_hz / n_sets
    offs = np.asarray(offsets_hz, np.float64).reshape(-1)
    coarse_c = np.floor(offs / bin_hz).astype(np.int64)
    sub_c = offs - coarse_c * bin_hz                     # [0, bin)
    d_max = int(np.floor(max_doppler_hz / bin_hz))
    dvals = np.arange(-d_max, d_max + 1)
    fine = np.asarray(fine_hz, np.float64)
    n_ch = offs.size

    # 1. (channel, set) sub-bin mixes + forward FFTs: (C, S, B, n)
    mix_f = sub_c[:, None] + np.arange(n_sets)[None, :] * set_off
    osc = cuda_caf.phasors(mix_f.reshape(-1), sample_rate, n, dev)
    mf = torch.fft.fft(osc.reshape(n_ch, n_sets, 1, n) * blocks, dim=-1)

    # 2. cross-block fine DFT inside each coherent group; the weights carry
    # the mix row's inter-block phase (the group sum is coherent)
    b_t = np.arange(nb, dtype=np.float64) * (n / sample_rate)
    wf = fine[None, None, :] + mix_f[:, :, None]         # (C, S, F)
    w = np.exp(-2j * np.pi * wf[..., None] * b_t)        # (C, S, F, B)
    w = torch.from_numpy(w.reshape(n_ch, n_sets, fine.size, n_groups, gl)
                         .astype(np.complex64)).to(dev)
    y = torch.einsum("csfgb,csgbk->csfgk", w,
                     mf.reshape(n_ch, n_sets, n_groups, gl, n))

    # 3. per-channel shifts of the shared replica:
    # repc[c, d, k] = rep[(k - (coarse_c + d)) mod n]
    shift = torch.from_numpy(coarse_c[:, None] + dvals[None, :]).to(dev)
    k_idx = (torch.arange(n, device=dev) - shift[..., None]) % n
    repc = replica.reshape(n)[k_idx]                     # (C, n_c, n)

    # 4. product -> inverse -> |.|^2, summed over the groups
    surf = None
    for g in range(n_groups):
        v = torch.fft.ifft(repc[:, :, None, None, :]
                           * y[:, None, :, :, g, :], dim=-1)
        p = v.real * v.real + v.imag * v.imag            # (C, n_c, S, F, n)
        surf = p if surf is None else surf.add_(p)
    return surf.reshape(n_ch, dvals.size * n_sets * fine.size, n)
