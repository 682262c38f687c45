"""Entry points of the port's flagship step: detect + acquire.

- entry(device): (forward, example_args), the counterpart of
  `__graft_entry__.entry`: int8 I/Q block -> Welch PSD + chunk power flags +
  the PCF acquisition surface over 32 PRNs x 90 Doppler rows x 2048 lags.
- detect_acquire_step(raw_i8, method=...): the measured chain of
  `bench.py`, one 512k-sample block -> (psd, pm, flags, peak_per_prn).
  method 'pcf' reduces the PCF search to its per-PRN peak inside kernel B1
  (peak-only mode); 'std' is the r1/r2 chain (`bench.py:58-61`,
  acq_method='std'): the reference-shaped 71-bin x 10-period search of
  kernel B3, reduced to its per-PRN peak.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import DEFAULT_CONFIG as CFG
from .device import as_device
from .ops import caf, codes, cuda_front, cuda_pcf, iq, spectral
from .runtime import profiling

FS = CFG.frontend.sample_rate_hz
N_CODE = 2048                  # one C/A period at 2.048 MS/s
N_INTG = 10                    # code periods per acquisition
MAX_DOPPLER_HZ = 7000.0
STD_FREQS = caf.doppler_bins(MAX_DOPPLER_HZ, 200.0)      # 71 bins
CHUNK = 32768                  # power chunk, samples


def _front(raw_i8: torch.Tensor):
    """(x, pm, flags) of one block: complex baseband, chunk power and the
    +6 dB flags over the 5th-percentile baseline (kernel F1 on the card)."""
    with profiling.span("gjt.step.ingest"):
        return cuda_front.block_front(raw_i8, CHUNK,
                                      CFG.detector.baseline_percentile,
                                      CFG.detector.power_rise_db)


def _detect(x: torch.Tensor) -> torch.Tensor:
    """Welch PSD of one block."""
    with profiling.span("gjt.step.psd"):
        return spectral.welch_psd(x, FS, CFG.spectral.nperseg)


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
                        method: str = "pcf"):
    """One block of the flagship chain -> (psd, pm, flags, peak_per_prn).

    raw_i8: (2n,) int8 I/Q, n >= 10 code periods (512k samples in the
    benchmark). A full cold 32-PRN x +/-7 kHz x 10-period search runs on
    every block, by the PCF method (kernel B1) or, with method='std', by
    the per-Doppler search over 71 bins (kernel B3), after the block's
    front (kernel F1) and Welch PSD (kernel B2); peak_per_prn (32,) is
    the search's maximum per PRN. Its stages run inside the spans of
    `runtime.profiling.SPANS` (`gjt.step` and its children).
    """
    with profiling.span("gjt.step"):
        if replica is None:
            replica = codes.gps_replica_table(FS, N_CODE, raw_i8.device)
        x, pm, flags = _front(raw_i8)
        psd = _detect(x)
        with profiling.span("gjt.step.acquire"):
            blocks = x[: N_INTG * N_CODE].reshape(N_INTG, N_CODE)
            if method == "pcf":
                peak = cuda_pcf.caf_accumulate_pcf_fused(
                    blocks, replica, FS, max_doppler_hz=MAX_DOPPLER_HZ,
                    stats_excl=-1)[0].amax(dim=-1)
            elif method == "std":
                peak = caf.caf_accumulate(blocks, replica, STD_FREQS,
                                          FS).amax(dim=(-2, -1))
            else:
                raise ValueError(f"unknown acquisition method {method!r}")
    return psd, pm, flags, peak
