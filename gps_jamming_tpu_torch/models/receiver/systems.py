"""Per-constellation receiver adapters: Galileo E1B and GLONASS L1OF
observables and satellite state, and the SBAS message channel, plugged
into the generic acquisition / tracking / PVT chain (`receiver.
run_receiver`).

NumPy copy of `gps_jamming_tpu.models.receiver.systems`;
tests/test_torch_systems.py holds the two equal. The reference spreads the
per-system differences over `sdrinit.c`'s channel plans, the
`sdrnav_{gps,gal,glo,sbs}.c` decoders and `sdrpvt.c:440-575`'s satPos;
here each system is a thin host adapter over the same device stages:

- Galileo: a 4 ms epoch is one E1B primary-code period, so each tracking
  epoch's prompt I is one 250 sps I/NAV symbol (no bit sync); page sync
  and CRC anchor the transmit time (the sdrnav_gal.c role).
- GLONASS: 1 ms epochs, 10 per 100 sps line symbol (the meander layer);
  the time mark anchors the transmit time (sdrnav_glo.c); the satellite
  state is an RK4 extrapolation of the broadcast pos/vel/acc
  (sdrpvt.c:528-575), not a Kepler solve.
- SBAS: 2 ms symbols through the continuous FEC to CRC-valid messages.
"""
from __future__ import annotations

import numpy as np

from ...utils import constants as C
from . import ephemeris as eph_mod
from . import galileo as gal
from . import glonass as glo
from . import observables as obs_mod
from . import sbas


# ---------------------------------------------------------------------------
# Galileo
# ---------------------------------------------------------------------------

def build_galileo_observables(prn: int, i_prompt: np.ndarray,
                              code_rem: np.ndarray, carr_freq: np.ndarray,
                              cn0: np.ndarray, skip_epochs: int,
                              sample_offset: float = 0.0,
                              epoch_samples: int = 0,
                              ) -> obs_mod.ChannelObservables | None:
    """One E1B channel: prompt signs -> I/NAV decode -> chip-count anchor.

    Epochs are 4 ms (one code period of 8184 BOC half-chips at 2.046 Mcps);
    epoch k's prompt is the symbol transmitted from that epoch's
    window-start code boundary, so a page anchor at symbol s maps to the
    code-period boundary at epoch skip_epochs + s.
    """
    ip = np.asarray(i_prompt, np.float64)
    sym01 = (ip[skip_epochs:] < 0.0).astype(np.float64)   # sign -> symbol
    eph, anchors = gal.decode_inav_stream(sym01, prn=prn)
    if not anchors or not gal.inav_complete(eph):
        return None
    chips = obs_mod.accumulate_chips(code_rem, code_len=gal.BOC_LEN)
    pos, tow = anchors[0]
    e_b = skip_epochs + int(pos)
    anchor_chip = gal.BOC_LEN * round(chips[e_b] / gal.BOC_LEN)
    return obs_mod.ChannelObservables(
        prn=prn, eph=eph, chips=chips, anchor_chip=float(anchor_chip),
        anchor_tow=float(tow), cn0_dbhz=np.asarray(cn0, np.float64),
        doppler_hz=np.asarray(carr_freq, np.float64),
        sync_quality=1.0, chip_rate_hz=gal.BOC_RATE,
        sample_offset=sample_offset, epoch_samples=epoch_samples)


# ---------------------------------------------------------------------------
# GLONASS
# ---------------------------------------------------------------------------

def build_glonass_observables(freq_ch: int, i_prompt: np.ndarray,
                              code_rem: np.ndarray, carr_freq: np.ndarray,
                              cn0: np.ndarray, skip_epochs: int,
                              min_sync_quality: float = 0.8,
                              sample_offset: float = 0.0,
                              epoch_samples: int = 0,
                              ) -> obs_mod.ChannelObservables | None:
    """One L1OF channel: symbol sync (10 epochs per 100 sps symbol) ->
    GNAV string decode -> chip-count anchor at the time-mark edge."""
    phase, quality = obs_mod.bit_sync(i_prompt, start_epoch=skip_epochs,
                                      bit_epochs=10)
    if quality < min_sync_quality:
        return None
    bits01, starts, _ = obs_mod.extract_bits(i_prompt, phase, bit_epochs=10)
    # +I transmits symbol 0 (the simulator's 0 -> +1); the two-sided
    # time-mark match in the decoder resolves the polarity
    sym01 = 1 - bits01
    eph, anchors = glo.decode_gnav_stream(sym01, freq_ch=freq_ch)
    if not anchors or not eph.complete:
        return None
    chips = obs_mod.accumulate_chips(code_rem, code_len=C.GLO_CODE_LEN)
    pos, tk = anchors[0]
    e_b = int(starts[pos])
    anchor_chip = C.GLO_CODE_LEN * round(chips[e_b] / C.GLO_CODE_LEN)
    return obs_mod.ChannelObservables(
        prn=freq_ch, eph=eph, chips=chips, anchor_chip=float(anchor_chip),
        anchor_tow=float(tk), cn0_dbhz=np.asarray(cn0, np.float64),
        doppler_hz=np.asarray(carr_freq, np.float64),
        sync_quality=quality, chip_rate_hz=C.GLO_CHIP_RATE_HZ,
        sample_offset=sample_offset, epoch_samples=epoch_samples)


def glonass_sat_pos_clock(gephs: list[glo.GloEphemeris], t_tx: np.ndarray
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Satellite ECEF positions (n, 3) and clock offsets (n,) at per-sat
    transmit times.

    One RK4 extrapolation of the broadcast state from tb, batched over the
    satellites (the sdrpvt.c:528-575 role); clock = -tau + gamma*(t - tb)
    (ICD sign: tau is the SV-ahead-of-system offset, subtracted like
    sdrnav_glo.c's taun). An empty list gives empty (0, 3) and (0,)
    arrays, where the JAX package's `np.stack` raises (ROADMAP C9).
    """
    t_tx = np.asarray(t_tx, np.float64)
    if not gephs:
        return np.zeros((0, 3)), np.zeros(0)
    pos0 = np.stack([np.asarray(g.pos_m, np.float64) for g in gephs])
    vel0 = np.stack([np.asarray(g.vel_mps, np.float64) for g in gephs])
    acc = np.stack([np.asarray(g.acc_mps2, np.float64) for g in gephs])
    dt = t_tx - np.array([g.tb_s for g in gephs], np.float64)
    pos = eph_mod.glonass_extrapolate(pos0, vel0, acc, dt)
    clk = (np.array([-g.tau_s for g in gephs], np.float64)
           + np.array([g.gamma for g in gephs], np.float64) * dt)
    return pos, clk


# ---------------------------------------------------------------------------
# SBAS
# ---------------------------------------------------------------------------

def decode_sbas_channel(i_prompt: np.ndarray, skip_epochs: int = 1000,
                        min_sync_quality: float = 0.5
                        ) -> list[sbas.SbasMessage]:
    """One SBAS L1 channel: prompt I -> 500 sps symbols -> FEC messages.

    Symbols are 2 ms (2 tracking epochs); symbol sync is the sign-flip
    histogram (checksync, sdrnav.c:126-144, at the SBAS symbol length).
    The rate-1/2 K=7 coder is continuous and transparent (both generators
    have odd weight), so the data polarity and the symbol-pair alignment
    are resolved by trial: the four (polarity x pair phase) hypotheses are
    decoded in turn and the first with CRC-valid messages wins
    (predecodefec + findpreamble, sdrnav.c:194-236, :284-328; the MT12
    fields of sdrnav_sbs.c:47-97).
    """
    phase, quality = obs_mod.bit_sync(i_prompt, start_epoch=skip_epochs,
                                      bit_epochs=2)
    if quality < min_sync_quality:
        return []
    _, _, sums = obs_mod.extract_bits(i_prompt, phase, bit_epochs=2)
    scale = np.median(np.abs(sums))
    if scale <= 0 or sums.size < 2 * sbas.MSG_BITS:
        return []
    # soft probability of a '1' symbol from the normalized correlator sum
    soft = np.clip(0.5 + sums / (4.0 * scale), 0.0, 1.0)
    for cand in (soft, soft[1:], 1.0 - soft, 1.0 - soft[1:]):
        cand = cand[: cand.size - cand.size % 2]
        msgs = sbas.decode_stream(cand)
        if msgs:
            return msgs
    return []
