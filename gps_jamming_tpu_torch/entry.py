"""Entry points of the port's flagship step: detect + acquire.

- entry(device): (forward, example_args), the counterpart of
  `__graft_entry__.entry`: int8 I/Q block -> Welch PSD + chunk power flags +
  the PCF acquisition surface over 32 PRNs x 90 Doppler rows x 2048 lags
  (GPS L1 C/A at 2.048 MS/s).
- detect_acquire_step(raw_i8, method=..., plan=...): the measured chain of
  `bench.py`, one block -> (psd, pm, flags, peak_per_prn) for the system
  that `plan` names. `GPS` (the default): GPS L1 C/A at 2.048 MS/s, 32
  PRNs, 2048 lags; `GALILEO_E1B_8M192`: Galileo E1B at 8.192 MS/s, 36
  PRNs, 32768 lags (kernel B1 above 16384, in its thread-block cluster).
  method 'pcf' reduces the PCF search to its per-PRN peak inside kernel B1
  (its per-PRN mode, which reads the block's code periods itself); 'std'
  is the r1/r2 chain (`bench.py:58-61`, acq_method='std'): the
  reference-shaped search over 200 Hz bins (71 at +/-7 kHz) and 10
  periods of kernel B3, reduced to its per-PRN peak.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .config import DEFAULT_CONFIG as CFG
from .device import as_device
from .models.receiver import galileo
from .ops import caf, codes, cuda_front, cuda_pcf, iq, spectral
from .runtime import profiling

FS = CFG.frontend.sample_rate_hz
N_CODE = 2048                  # one C/A period at 2.048 MS/s
N_INTG = 10                    # code periods per acquisition
MAX_DOPPLER_HZ = 7000.0
CHUNK = 32768                  # power chunk, samples


@dataclasses.dataclass(frozen=True)
class Plan:
    """What one monitor step searches and measures: the system's sample
    rate, one code period in samples, the code periods of a search (two
    coherent groups), its Doppler span, the power chunk, the Welch
    segment and the PRNs of the replica table (`replica_table`)."""
    system: str                # 'gps' | 'galileo'
    sample_rate_hz: float
    code_samples: int
    periods: int
    max_doppler_hz: float
    chunk: int
    nperseg: int
    prns: tuple[int, ...]


GPS = Plan("gps", FS, N_CODE, N_INTG, MAX_DOPPLER_HZ, CHUNK,
           CFG.spectral.nperseg, tuple(range(1, 33)))
# E1B's 4 ms period at 8.192 MS/s: 32768 samples, at the HackRF One's
# rate (its documentation recommends 8 Msps or more); 4.096 MS/s would
# already hold BOC(1,1)'s two main lobes (+/-2.046 MHz)
GALILEO_E1B_8M192 = Plan("galileo", 8.192e6, 32768, N_INTG, MAX_DOPPLER_HZ,
                         CHUNK, CFG.spectral.nperseg, tuple(range(1, 37)))


@functools.lru_cache(maxsize=8)
def replica_table(plan: Plan, device: torch.device) -> torch.Tensor:
    """(len(plan.prns), plan.code_samples) complex64 conj-FFT replicas of
    the plan's PRNs on `device`, cached: callers share one tensor and must
    not write to it."""
    if plan.system == "gps":
        table = codes.gps_replica_table(plan.sample_rate_hz,
                                        plan.code_samples, device)
        return table[[p - 1 for p in plan.prns]]
    if plan.system == "galileo":
        return galileo.replica_table(plan.sample_rate_hz, plan.code_samples,
                                     device, plan.prns)
    raise ValueError(f"no replica table for system {plan.system!r}")


def _front(raw_i8: torch.Tensor, plan: Plan = GPS):
    """(x, pm, flags) of one block: complex baseband, chunk power and the
    +6 dB flags over the 5th-percentile baseline (kernel F1 on the card)."""
    with profiling.span("gjt.step.ingest"):
        return cuda_front.block_front(raw_i8, plan.chunk,
                                      CFG.detector.baseline_percentile,
                                      CFG.detector.power_rise_db)


def _detect(x: torch.Tensor, plan: Plan = GPS) -> torch.Tensor:
    """Welch PSD of one block."""
    with profiling.span("gjt.step.psd"):
        return spectral.welch_psd(x, plan.sample_rate_hz, plan.nperseg)


def entry(device=None):
    """(forward, (raw_i8,)) for one 128k-sample block on `device` (None:
    the card; raises RuntimeError where there is none).

    forward(raw_i8) takes (2n,) int8 interleaved I/Q (uint8 - 128) and
    returns (psd, pm, flags, surf).
    """
    device = as_device(device)
    n_block = 1 << 17
    replica = codes.gps_replica_table(FS, N_CODE, device)

    def forward(raw_i8: torch.Tensor):
        x, pm, flags = _front(raw_i8)
        psd = _detect(x)
        blocks = x[: N_INTG * N_CODE].reshape(N_INTG, N_CODE)
        surf = caf.caf_accumulate_pcf(blocks, replica, FS,
                                      max_doppler_hz=MAX_DOPPLER_HZ)
        return psd, pm, flags, surf

    rng = np.random.default_rng(0)
    raw_u8 = rng.integers(0, 256, 2 * n_block, dtype=np.uint8)
    raw = torch.from_numpy(iq.uint8_np_to_int8(raw_u8)).to(device)
    return forward, (raw,)


def detect_acquire_step(raw_i8: torch.Tensor,
                        replica: torch.Tensor | None = None,
                        method: str = "pcf", plan: Plan = GPS):
    """One block of the flagship chain -> (psd, pm, flags, peak_per_prn).

    raw_i8: (2n,) int8 I/Q, n >= plan.periods code periods (GPS: 512k
    samples in the benchmark, Galileo E1B at 8.192 MS/s 2M). A full cold
    search of the plan's PRNs over +/-plan.max_doppler_hz and
    plan.periods periods of plan.code_samples lags runs on every block, by
    the PCF method (kernel B1; above 16384 lags its four-step FFT and
    thread-block cluster) or, with method='std', by the per-Doppler
    search over 200 Hz bins (kernel B3), after the block's front (kernel
    F1, plan.chunk-sample chunks) and Welch PSD (kernel B2,
    plan.nperseg); replica (len(plan.prns), plan.code_samples), None for
    `replica_table(plan, raw_i8.device)`; peak_per_prn (P,) is the
    search's maximum per replica row. Its stages run inside the spans of
    `runtime.profiling.SPANS` (`gjt.step` and its children).
    """
    with profiling.span("gjt.step"):
        if replica is None:
            replica = replica_table(plan, raw_i8.device)
        fs, n = plan.sample_rate_hz, plan.code_samples
        x, pm, flags = _front(raw_i8, plan)
        psd = _detect(x, plan)
        with profiling.span("gjt.step.acquire"):
            if method == "pcf":
                # one call, on CUDA one launch: B1 reads x's first periods
                peak = cuda_pcf.pcf_peak_per_prn(
                    x, replica, fs, plan.periods,
                    max_doppler_hz=plan.max_doppler_hz)
            elif method == "std":
                blocks = x[: plan.periods * n].reshape(plan.periods, n)
                freqs = caf.doppler_bins(plan.max_doppler_hz, 200.0)
                peak = caf.caf_accumulate(blocks, replica, freqs,
                                          fs).amax(dim=(-2, -1))
            else:
                raise ValueError(f"unknown acquisition method {method!r}")
    return psd, pm, flags, peak
