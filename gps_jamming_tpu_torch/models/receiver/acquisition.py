"""GNSS acquisition (counterpart of gps_jamming_tpu.models.receiver.acquisition).

A cold search of every PRN over (Doppler x lag), then the peak-ratio test
of the reference's `checkacquisition` (sdracq.c:52-81) vectorized over
PRNs, and the fine-Doppler estimate that hands a channel over to tracking
(`refine_doppler`). Two searches:
- 'std', the reference-shaped per-Doppler search (71 bins x 10 code
  periods, non-coherently summed): kernel B3 on a CUDA tensor, its surface
  reduced here;
- 'pcf', the post-correlation-FFT search: kernel B1 in its statistics mode
  on a CUDA tensor, so the delay x Doppler surface never reaches device
  memory; on the CPU the surface is materialized and reduced here.

Two behaviours of the reference are kept exactly where it has them:
- `acquisition_test` takes the peak at the lowest flat (Doppler, lag) index
  among ties (first-occurrence argmax); the kernel's statistics give the
  lowest lag of a row, and `acquisition_test_from_stats` the lowest row.
- `acquisition_test_from_stats` divides the excluded sum by
  n - (2*excl + 1), where `corr.mean_excluded` counts the mask. The two
  agree only while excl < n//2, so every entry here checks that first.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ...config import AcquisitionConfig
from ...utils import constants as C
from ...ops import caf as caf_ops
from ...ops import codes as codes_ops
from ...ops import corr as corr_ops
from ...ops import cuda_pcf


class AcquisitionResult(NamedTuple):
    """Per-PRN acquisition outputs (all tensors shape (n_prn,))."""
    acquired: torch.Tensor     # peak ratio > threshold
    code_phase: torch.Tensor   # samples (lag of code start in the block)
    doppler_hz: torch.Tensor
    peak_ratio: torch.Tensor
    cn0_dbhz: torch.Tensor
    peak_power: torch.Tensor


def exclusion_half_width(n: int, cfg: AcquisitionConfig,
                         code_len_chips: float = 1023.0) -> int:
    """checkacquisition's +/- window in samples; raises ValueError unless it
    is < n//2 (where the two excluded-mean counts agree)."""
    nsampchip = max(int(round(n / code_len_chips)), 1)
    excl = int(cfg.exclude_chips * nsampchip)
    if not 0 <= excl < n // 2:
        raise ValueError(f"exclusion half-width {excl} samples must be in "
                         f"[0, n//2 = {n // 2})")
    return excl


def gps_replica_table(sample_rate: float, n_samples: int,
                      device=None) -> torch.Tensor:
    """(32, n) complex64 conj-FFT replicas of every GPS PRN at the capture
    rate, on `device` (None: the card): `codes.gps_replica_table`."""
    return codes_ops.gps_replica_table(sample_rate, n_samples, device)


def gps_replica_table_host(sample_rate: float,
                           n_samples: int) -> tuple[np.ndarray, np.ndarray]:
    """(32, n) conj-FFT replica planes (re, im), numpy float32:
    `codes.gps_replica_table_host`."""
    return codes_ops.gps_replica_table_host(sample_rate, n_samples)


def sbas_replica_table_host(sample_rate: float,
                            n_samples: int) -> tuple[np.ndarray, np.ndarray]:
    """(19, n) conj-FFT replica planes of the SBAS C/A PRNs 120..138."""
    return codes_ops.sampled_code_fft_conj_host(
        codes_ops.sbas_ca_table(), C.GPS_CA_CHIP_RATE_HZ, sample_rate,
        n_samples)


def acquire_all(blocks: torch.Tensor, replica_fft_conj: torch.Tensor,
                sample_rate: float, cfg: AcquisitionConfig,
                code_period_s: float = C.GPS_CA_PERIOD_S,
                code_len_chips: float = 1023.0,
                method: str = "std") -> AcquisitionResult:
    """Acquire every PRN from n_integration code-period blocks.

    blocks: (n_intg, n) complex64, one code period each; replica_fft_conj:
    (n_prn, n) complex64 on the same device. method 'std' is the
    reference's per-Doppler non-coherent search (kernel B3 on CUDA); 'pcf'
    the PCF search (kernel B1); 'auto' takes pcf where it runs fewer
    inverse-FFT rows (`caf.pcf_profitable`): GPS at 2048 lags, and Galileo
    E1B at 16384 lags over the default 10 periods; std only where
    n_blocks <= 9 at 16384 lags and +/-7 kHz.

    On a CUDA tensor an n that neither kernels B1 and B3 nor the JAX
    package's Pallas kernels take (`caf.plain_on_card`: 2062 = 2 * 1031)
    runs the plain surfaces on the card, as the reference computes XLA
    there. Above 16384 (Galileo E1B at 8.192 MS/s: 32768) B1 and B3 run
    the four-step FFT; an n that a TPU kernel takes and they do not (a
    prime factor above 127, or std above 131072) raises from the kernel's
    wrapper.

    The JAX package's `precision=` argument is left out: the port has no
    precision option and computes in float32/complex64.
    """
    nb, n = blocks.shape[-2], blocks.shape[-1]
    if method == "auto":
        nf = caf_ops.doppler_bins(cfg.doppler_max_hz,
                                  cfg.doppler_step_hz).size
        method = "pcf" if caf_ops.pcf_profitable(
            int(n), int(nb), float(sample_rate),
            float(cfg.doppler_max_hz), int(nf)) else "std"
    if method == "std":
        freqs = caf_ops.doppler_bins(cfg.doppler_max_hz, cfg.doppler_step_hz)
        surf = caf_ops.caf_accumulate(blocks, replica_fft_conj, freqs,
                                      sample_rate)
        return acquisition_test(surf, torch.from_numpy(freqs).to(
            blocks.device), sample_rate, cfg, code_period_s, code_len_chips)
    if method != "pcf":
        raise ValueError(f"unknown acquisition method {method!r}")
    # the PCF surface sums gl code periods coherently, so C/N0 uses the
    # coherent integration time gl * Tcode
    t_coh = code_period_s * max(nb // 2, 1)
    excl = exclusion_half_width(n, cfg, code_len_chips)
    freqs = torch.from_numpy(caf_ops.pcf_doppler_hz(
        sample_rate, int(n), cfg.doppler_max_hz)).to(blocks.device)
    if blocks.is_cuda and not caf_ops.plain_on_card(
            blocks, replica_fft_conj.shape[0], pcf=True):
        stats = cuda_pcf.caf_accumulate_pcf_fused(
            blocks, replica_fft_conj, sample_rate,
            max_doppler_hz=cfg.doppler_max_hz, stats_excl=excl)
        return acquisition_test_from_stats(stats, freqs, int(n), cfg, t_coh,
                                           code_len_chips)
    surf = caf_ops.caf_accumulate_pcf(blocks, replica_fft_conj, sample_rate,
                                      max_doppler_hz=cfg.doppler_max_hz)
    return acquisition_test(surf, freqs, sample_rate, cfg, t_coh,
                            code_len_chips)


def acquisition_test(surf: torch.Tensor, freqs: torch.Tensor,
                     sample_rate: float, cfg: AcquisitionConfig,
                     code_period_s: float,
                     code_len_chips: float = 1023.0) -> AcquisitionResult:
    """checkacquisition over the PRN axis of a (n_prn, n_freq, n) surface.

    Peak over (Doppler, lag), lowest flat index on ties; second peak and
    mean over the peak's Doppler row outside the circular +/-excl window;
    C/N0 = 10*log10(peak/mean/Tcode); acquired when peak/second > threshold.
    """
    del sample_rate                 # kept for the reference's signature
    n_prn, n_freq, n = surf.shape
    excl = exclusion_half_width(n, cfg, code_len_chips)
    flat = surf.reshape(n_prn, n_freq * n)
    idx = flat.argmax(dim=-1)
    freq_i = idx // n
    code_i = idx % n
    peak = flat.gather(-1, idx[:, None])[:, 0]
    rows = surf[torch.arange(n_prn, device=surf.device), freq_i]
    second = corr_ops.second_peak_excluded(rows, code_i, excl)
    mean = corr_ops.mean_excluded(rows, code_i, excl)
    ratio = peak / second.clamp(min=1e-30)
    cn0 = 10.0 * torch.log10(peak / mean.clamp(min=1e-30) / code_period_s)
    return AcquisitionResult(
        acquired=ratio > cfg.peak_ratio_threshold,
        code_phase=code_i.to(torch.int32),
        doppler_hz=freqs[freq_i],
        peak_ratio=ratio,
        cn0_dbhz=cn0,
        peak_power=peak,
    )


def acquisition_test_from_stats(stats, freqs: torch.Tensor, n: int,
                                cfg: AcquisitionConfig, code_period_s: float,
                                code_len_chips: float = 1023.0
                                ) -> AcquisitionResult:
    """`acquisition_test` from per-(PRN, Doppler-row) statistics.

    stats: (max, arglag, excluded_max, total_sum, window_sum), each
    (n_prn, n_rows), as `cuda_pcf.caf_accumulate_pcf_fused(stats_excl=...)`
    returns them. The lowest row wins ties. The excluded mean divides by
    n - (2*excl + 1), as the reference does here.
    """
    max1, arg1, exmax, tot, wsum = stats
    excl = exclusion_half_width(n, cfg, code_len_chips)
    freq_i = max1.argmax(dim=-1)

    def take(a):
        return a.gather(-1, freq_i[:, None])[:, 0]

    peak = take(max1)
    mean = (take(tot) - take(wsum)) / max(n - (2 * excl + 1), 1)
    ratio = peak / take(exmax).clamp(min=1e-30)
    cn0 = 10.0 * torch.log10(peak / mean.clamp(min=1e-30) / code_period_s)
    return AcquisitionResult(
        acquired=ratio > cfg.peak_ratio_threshold,
        code_phase=take(arg1).to(torch.int32),
        doppler_hz=freqs[freq_i],
        peak_ratio=ratio,
        cn0_dbhz=cn0,
        peak_power=peak,
    )


def refine_doppler(xp: torch.Tensor, code_table: np.ndarray, lag_samples,
                   doppler_hz, sample_rate: float, chip_rate: float,
                   carrier_hz=C.GPS_L1_FREQ_HZ, nominal_offset_hz=0.0,
                   n_blocks: int = 32, n_sub: int = 4) -> torch.Tensor:
    """Fine-Doppler estimate after coarse acquisition, before handover.

    The 200 Hz grid leaves up to half a bin of error, and a tracking FLL
    with epoch T is unambiguous only within +/-1/(2T) (125 Hz at Galileo's
    4 ms). Per channel this takes n_blocks code periods starting at the
    acquired code boundary, wipes off code and coarse carrier, splits each
    period into n_sub sub-correlations, and averages the phase advance
    between neighbours: unambiguous over +/- n_sub/(2T), a few Hz accurate.

    xp: (n,) complex64 baseband. code_table: (n_ch, code_len) host chips.
    lag_samples, doppler_hz: per channel; doppler_hz is the effective
    baseband frequency (an FDMA offset included); carrier_hz and
    nominal_offset_hz (scalars or per channel) set the code Doppler from
    the true carrier Doppler. The input is zero-padded by the window length
    so a lag near the end keeps its window start at the code boundary, as
    the reference does. Returns the refined doppler (n_ch,) float32; sums
    are float32 (complex64).
    """
    dev = xp.device
    n_ch, code_len = code_table.shape
    n_code = int(round(sample_rate * code_len / chip_rate))
    n_sub_len = n_code // n_sub
    n_win = n_blocks * n_sub * n_sub_len
    n = xp.shape[-1]
    lag = torch.as_tensor(lag_samples, device=dev).to(torch.int64)
    dopp = torch.as_tensor(doppler_hz, device=dev).to(torch.float32)
    xp = torch.cat([xp, xp.new_zeros(n_win)])
    start = lag.reshape(-1).clamp(0, n)
    win = xp[start[:, None] + torch.arange(n_win, device=dev)]  # (C, n_win)
    t = codes_ops.sample_times(n_win, sample_rate, dev)
    phase = (-2.0 * math.pi) * dopp[:, None] * t[None, :]
    osc = torch.polar(torch.ones_like(phase), phase)
    offs = torch.as_tensor(nominal_offset_hz, dtype=torch.float32,
                           device=dev).expand(n_ch)
    carr = torch.as_tensor(carrier_hz, dtype=torch.float32,
                           device=dev).expand(n_ch)
    fcode = chip_rate * (1.0 + (dopp - offs) / carr)
    chips = codes_ops.resample_code(
        torch.as_tensor(code_table, dtype=torch.float32, device=dev), fcode,
        sample_rate, n_win)
    z = (win * osc * chips).reshape(n_ch, n_blocks, n_sub,
                                    n_sub_len).sum(-1)
    s = (z[..., 1:] * z[..., :-1].conj()).sum(dim=(-2, -1))
    tau = n_sub_len / sample_rate
    return (dopp + torch.atan2(s.imag, s.real) / (2.0 * math.pi * tau)).to(
        torch.float32)
