"""GLONASS L1OF FDMA acquisition (counterpart of the acquisition half of
gps_jamming_tpu.models.receiver.glonass; the GNAV string codec is not
ported yet).

All 14 FDMA channels share one 511-chip code and differ by carrier
(k * 562.5 kHz, k = -7..6, sdrinit.c:391-399). Two searches over
(channel x Doppler x lag), both plain torch (cuFFT on the card), as the
JAX package left both to XLA:
- 'pcf': `caf.caf_accumulate_pcf_fdma`, sub-bin mixes per channel and
  integer shifts of the shared replica spectrum;
- 'std': `caf.caf_surface` over one flattened (channel, Doppler) frequency
  axis, summed over the code periods.
"""
from __future__ import annotations

import numpy as np
import torch

from ...config import AcquisitionConfig
from ...utils import constants as C
from ...ops import caf as caf_ops
from ...ops import codes as codes_ops
from . import acquisition as acq_mod

# the reference's 14 channels (sdrinit.c:41-107): frequency numbers -7..+6
FREQ_CHANNELS = tuple(range(-7, 7))


def channel_offsets_hz(center_freq_hz: float = C.GLO_G1_BASE_FREQ_HZ,
                       channels=FREQ_CHANNELS) -> np.ndarray:
    """Baseband carrier offset of each FDMA channel after the front end
    mixes down by `center_freq_hz`."""
    return np.array([C.GLO_G1_BASE_FREQ_HZ + k * C.GLO_G1_CH_SPACING_HZ
                     - center_freq_hz for k in channels], np.float64)


def replica_table_host(sample_rate: float,
                       n_samples: int) -> tuple[np.ndarray, np.ndarray]:
    """(1, n) conj-FFT replica planes of the shared 511-chip code."""
    return codes_ops.sampled_code_fft_conj_host(
        codes_ops.glonass_code()[None, :], C.GLO_CHIP_RATE_HZ, sample_rate,
        n_samples)


def acquire_all(blocks: torch.Tensor, sample_rate: float,
                cfg: AcquisitionConfig,
                center_freq_hz: float = C.GLO_G1_BASE_FREQ_HZ,
                channels=FREQ_CHANNELS,
                method: str = "auto") -> acq_mod.AcquisitionResult:
    """Acquisition over (FDMA channel x Doppler x lag).

    blocks: (n_intg, n) complex64 at `sample_rate`, centred on
    `center_freq_hz`. method 'auto' takes 'pcf' when the blocks split into
    two coherent groups and the configured step is at least 100 Hz (the
    PCF grid's worst interior spacing), else 'std'. Returns an
    AcquisitionResult over `channels`, with doppler_hz relative to each
    channel's carrier. A channel at the same lag as a far stronger acquired
    one is that channel's sidelobe leakage and is vetoed (`_nearfar_veto`).
    """
    nb, n = blocks.shape
    offsets = channel_offsets_hz(center_freq_hz, channels)
    rep = codes_ops.replica_tensor(replica_table_host(sample_rate, n),
                                   blocks.device)
    n_groups = 2
    if method == "auto":
        method = ("pcf" if nb % n_groups == 0
                  and cfg.doppler_step_hz >= 100.0 else "std")
    if method == "pcf":
        surf = caf_ops.caf_accumulate_pcf_fdma(
            blocks, rep, offsets, sample_rate,
            max_doppler_hz=cfg.doppler_max_hz, n_groups=n_groups)
        freqs = torch.from_numpy(caf_ops.pcf_doppler_hz(
            sample_rate, n, cfg.doppler_max_hz)).to(blocks.device)
        res = acq_mod.acquisition_test(
            surf, freqs, sample_rate, cfg,
            code_period_s=1e-3 * max(nb // n_groups, 1),
            code_len_chips=511.0)
        return _nearfar_veto(res, n)
    if method != "std":
        raise ValueError(f"unknown acquisition method {method!r}")
    dopp = caf_ops.doppler_bins(cfg.doppler_max_hz, cfg.doppler_step_hz)
    freqs = (offsets[:, None] + dopp[None, :]).astype(np.float32).ravel()
    surf = caf_ops.caf_surface(blocks, rep, freqs, sample_rate)
    surf = surf.sum(dim=0)[0].reshape(len(channels), dopp.size, n)
    res = acq_mod.acquisition_test(
        surf, torch.from_numpy(dopp).to(blocks.device), sample_rate, cfg,
        code_period_s=1e-3, code_len_chips=511.0)
    return _nearfar_veto(res, n)


def _nearfar_veto(res: acq_mod.AcquisitionResult, n: int,
                  dominance: float = 100.0,
                  lag_chips: float = 6.0) -> acq_mod.AcquisitionResult:
    """Drop FDMA near-far ghosts: a channel whose peak is `dominance` times
    below an acquired channel's at (circularly) the same lag, within
    `lag_chips`, is that channel's leakage through the shared code."""
    lag_samps = lag_chips * n / 511.0
    acq = res.acquired
    peak = res.peak_power
    lag = res.code_phase.to(torch.float32)
    d = (lag[:, None] - lag[None, :]).abs()
    circ = torch.minimum(d, n - d)
    dominated = (acq[None, :] & (peak[None, :] > peak[:, None] * dominance)
                 & (circ < lag_samps))
    return res._replace(acquired=acq & ~dominated.any(dim=1))
