"""The GNSS receiver chain: acquisition -> tracking -> decode -> PVT
(counterpart of gps_jamming_tpu.models.receiver.receiver).

The reference's per-channel threads and sync thread (`sdrmain.c:248-400`,
`sdrsync.c:3-208`) collapse, as in the JAX package, into
  1. one batched acquisition over (PRN x Doppler x lag) on the device
     (`acquire_all`; on a CUDA tensor 'auto' takes kernel B1 in its
     statistics mode for GPS, SBAS and Galileo E1B; GLONASS's FDMA search
     is plain torch, as it was XLA);
  2. one fine-Doppler pass (`refine_doppler`) and one batched tracking run
     over every selected channel on the device (`tracking.make_tracker`);
  3. host bit sync, nav decode and pseudoranges in float64 NumPy;
  4. host WLS (or EKF) PVT at the `outms` cadence (sdrinit.c:111).

The device does the sample-rate work; the host the bit- and fix-rate work.
`system` selects GPS L1 C/A, Galileo E1B, GLONASS L1OF (the reference's
-g/-a/-l modes, sdrmain.c:37-55) or SBAS L1 (message monitoring, no fix);
one system per run. The per-system parts (code tables, epoch length, FDMA
carrier offsets, nav decode, satellite state) are the adapters of
`systems.py`; the device stages are shared.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ...config import AcquisitionConfig, TrackingConfig
from ...device import as_device
from ...utils import constants as C
from ...ops import codes as codes_ops
from . import acquisition as acq_mod
from . import ephemeris as eph_mod
from . import galileo as gal
from . import glonass as glo
from . import observables, pvt, systems, tracking


@dataclasses.dataclass
class ChannelResult:
    prn: int                     # PRN (GPS, SBAS, Galileo) or FDMA freq_ch
    acquired: bool
    doppler_hz: float
    code_phase_samples: float
    peak_ratio: float
    cn0_dbhz: float
    obs: observables.ChannelObservables | None = None
    messages: list | None = None     # SBAS: decoded SbasMessage records


@dataclasses.dataclass
class ReceiverResult:
    channels: list[ChannelResult]
    fixes: list[pvt.PvtSolution]
    fix_epochs: list[int]        # milliseconds into the capture
    system: str = "gps"
    epoch_ms: float = 1.0
    filter_name: str = "WLS"     # telemetry FILTER| field
    # mean tracked C/N0 per epoch over the decoded channels, and
    # (sat_id, start_epoch, end_epoch) tracking spans
    cn0_epochs: np.ndarray | None = None
    tracked_spans: list[tuple[int, int, int]] | None = None
    # (start_epoch, ChannelObservables) per decoded tracking interval
    obs_spans: list[tuple[int, object]] | None = None
    # host seconds of each stage, each ending in a read of its result:
    # 'acquire', 'refine', 'track', 'decode', 'pvt' (the port's own field)
    stage_seconds: dict | None = None

    @property
    def best_fix(self) -> pvt.PvtSolution | None:
        valid = [f for f in self.fixes if f.valid]
        return valid[-1] if valid else None


def _system_setup(system: str, sample_rate: float,
                  acq_cfg: AcquisitionConfig):
    """Per-system inputs: ids, host replica planes (None for GLONASS,
    whose `acquire_all` builds its own), n_code, epoch_ms, code_len,
    chip_rate, code_period_s, code_len_chips."""
    if system in ("gps", "sbas"):
        # SBAS L1: C/A-family codes of PRN 120..138 with GPS's 1 ms period
        # (its 500 sps symbols are 2 code periods)
        n_code = int(round(sample_rate * C.GPS_CA_PERIOD_S))
        gps = system == "gps"
        return dict(
            ids=(list(range(1, 33)) if gps
                 else sorted(codes_ops._SBAS_G2_DELAY)),
            replica=(codes_ops.gps_replica_table_host(sample_rate, n_code)
                     if gps else acq_mod.sbas_replica_table_host(
                         sample_rate, n_code)),
            n_code=n_code, epoch_ms=1.0,
            code_len=C.GPS_CA_CODE_LEN, chip_rate=C.GPS_CA_CHIP_RATE_HZ,
            code_period_s=C.GPS_CA_PERIOD_S, code_len_chips=1023.0)
    if system == "galileo":
        n_code = int(round(sample_rate * gal.PERIOD_S))
        return dict(
            ids=list(range(1, C.GAL_NUM_PRN + 1)),
            replica=gal.replica_table_host(sample_rate, n_code),
            n_code=n_code, epoch_ms=gal.PERIOD_S * 1e3,
            code_len=gal.BOC_LEN, chip_rate=gal.BOC_RATE,
            code_period_s=gal.PERIOD_S, code_len_chips=float(gal.BOC_LEN))
    if system == "glonass":
        n_code = int(round(sample_rate * 1e-3))
        return dict(
            ids=list(glo.FREQ_CHANNELS), replica=None,
            n_code=n_code, epoch_ms=1.0,
            code_len=C.GLO_CODE_LEN, chip_rate=C.GLO_CHIP_RATE_HZ,
            code_period_s=1e-3, code_len_chips=float(C.GLO_CODE_LEN))
    raise ValueError(f"unknown system {system!r}")


def _tracking_inputs(system: str, ids: list[int]):
    """(code table, carrier_hz, nominal_offset_hz) of the tracked ids: the
    carrier and the FDMA offset are scalars, or float32 per channel for
    GLONASS."""
    if system == "gps":
        return (np.stack([codes_ops.gps_ca_code(i) for i in ids]),
                C.GPS_L1_FREQ_HZ, 0.0)
    if system == "sbas":
        return (np.stack([codes_ops.sbas_ca_code(i) for i in ids]),
                C.GPS_L1_FREQ_HZ, 0.0)
    if system == "galileo":                          # E1 = L1 1575.42 MHz
        return (np.stack([gal.e1b_boc_code(i) for i in ids]).astype(
            np.float32), C.GPS_L1_FREQ_HZ, 0.0)
    return (np.tile(codes_ops.glonass_code()[None, :],
                    (len(ids), 1)).astype(np.float32),
            np.array([codes_ops.glonass_carrier_hz(i) for i in ids],
                     np.float32),
            np.asarray(glo.channel_offsets_hz(channels=ids), np.float32))


def run_receiver(x, sample_rate: float,
                 acq_cfg: AcquisitionConfig | None = None,
                 trk_cfg: TrackingConfig | None = None,
                 system: str = "gps",
                 max_channels: int = 12,
                 pvt_interval_ms: int = 200,
                 skip_epochs: int | None = None,
                 min_cn0_dbhz: float = 25.0,
                 pvt_filter: str = "wls") -> ReceiverResult:
    """Run the complete chain over a capture.

    x: (n,) complex64 baseband at `sample_rate`, a tensor (which keeps its
    device: a CPU tensor runs on the CPU) or an array (sent to the card;
    raises RuntimeError where there is none). On a CUDA tensor acquisition
    and tracking run on the card; decode and PVT run on the host.
    system: 'gps' | 'galileo' | 'glonass' | 'sbas' (one per run,
    sdrmain.c:37-55); SBAS decodes messages (`ChannelResult.messages`) and
    forms no fix. Any other system raises ValueError. pvt_filter: 'wls' (blsFilter parity) or 'ekf' (pvt.PvtEkf, seeded by
    the first WLS fix). Returns per-channel status and a PVT fix series at
    the 200 ms cadence; fix_epochs are in milliseconds.
    """
    acq_cfg = acq_cfg or AcquisitionConfig()
    trk_cfg = trk_cfg or TrackingConfig()
    su = _system_setup(system, sample_rate, acq_cfg)
    xp = (x if isinstance(x, torch.Tensor)
          else torch.as_tensor(x, device=as_device(None))).to(
              torch.complex64)
    dev = xp.device
    n_code = su["n_code"]
    ids = su["ids"]
    if skip_epochs is None:
        # 1 s of loop pull-in regardless of epoch length
        skip_epochs = max(int(round(1000.0 / su["epoch_ms"])), 1)
    secs: dict[str, float] = {}

    # --- 1. batched acquisition over the whole constellation -------------
    t0 = time.perf_counter()
    n_intg = acq_cfg.n_integration
    blocks = xp[: n_intg * n_code].reshape(n_intg, n_code)
    if system == "glonass":
        res = glo.acquire_all(blocks, sample_rate, acq_cfg)
    else:
        res = acq_mod.acquire_all(blocks, codes_ops.replica_tensor(
            su["replica"], dev), sample_rate, acq_cfg,
            code_period_s=su["code_period_s"],
            code_len_chips=su["code_len_chips"],
            method=getattr(acq_cfg, "method", "std"))
    acquired = res.acquired.cpu().numpy()
    ratios = res.peak_ratio.cpu().numpy()
    dopp_acq = res.doppler_hz.cpu().numpy()
    lag_acq = res.code_phase.cpu().numpy()
    cn0_acq = res.cn0_dbhz.cpu().numpy()
    secs["acquire"] = time.perf_counter() - t0
    order = np.argsort(-ratios)
    sel = [int(i) for i in order if acquired[i]][:max_channels]

    channels = [ChannelResult(
        prn=ids[i], acquired=bool(acquired[i]),
        doppler_hz=float(dopp_acq[i]),
        code_phase_samples=float(lag_acq[i]),
        peak_ratio=float(ratios[i]),
        cn0_dbhz=float(cn0_acq[i]))
        for i in range(acquired.size)]
    if not sel:
        return ReceiverResult(channels, [], [], system, su["epoch_ms"],
                              stage_seconds=secs)

    # --- 2. fine Doppler, then one batched tracking run ------------------
    # The coarse 200 Hz bins can false-lock the loops where the epoch is
    # long (Galileo's 4 ms: a +/-125 Hz FLL ambiguity); one batched
    # sub-correlation pass takes the error to a few Hz for every system.
    # refine_doppler works on the effective baseband frequency (FDMA
    # offset included); float32 throughout, as the JAX package.
    t0 = time.perf_counter()
    table, carrier_v, offset_v = _tracking_inputs(system,
                                                  [ids[i] for i in sel])
    offset32 = np.asarray(offset_v, np.float32)
    offsets = np.array([channels[i].code_phase_samples for i in sel],
                       np.float32).astype(np.int32)
    eff = np.array([channels[i].doppler_hz for i in sel],
                   np.float32) + offset32
    dopp_fine = acq_mod.refine_doppler(
        xp, table, offsets, eff, sample_rate, su["chip_rate"],
        carrier_hz=carrier_v,
        nominal_offset_hz=offset_v).cpu().numpy() - offset32
    secs["refine"] = time.perf_counter() - t0

    # code-phase-aligned per-channel windows: each channel's epoch grid
    # starts at its acquired code boundary, so the code phase at window
    # start is 0 chips and data-symbol edges stay out of the windows
    t0 = time.perf_counter()
    _, run, n_epoch = tracking.make_tracker(
        table, sample_rate, trk_cfg, code_len=su["code_len"],
        chip_rate=su["chip_rate"], carrier_hz=carrier_v,
        epoch_ms=su["epoch_ms"], nominal_offset_hz=offset_v)
    st = tracking.init_state(
        len(sel), dopp_fine, np.zeros(len(sel)), sample_rate,
        code_len=su["code_len"], chip_rate=su["chip_rate"],
        carrier_hz=carrier_v, nominal_offset_hz=offset_v, device=dev)
    _, outs = run(st, xp, start_offsets=offsets)
    ip = outs.i_prompt.cpu().numpy()          # (n_epochs, n_ch)
    rem = outs.code_rem_chips.cpu().numpy()
    cf = outs.carr_freq_hz.cpu().numpy()
    cn0 = outs.cn0_dbhz.cpu().numpy()
    n_epochs = ip.shape[0]
    secs["track"] = time.perf_counter() - t0

    # --- 3. host decode per channel --------------------------------------
    t0 = time.perf_counter()
    live: list[observables.ChannelObservables] = []
    for c, i in enumerate(sel):
        if np.median(cn0[-200:, c]) < min_cn0_dbhz:
            continue
        if system == "sbas":
            channels[i].messages = systems.decode_sbas_channel(
                ip[:, c], skip_epochs=skip_epochs)
            continue
        kw = dict(i_prompt=ip[:, c], code_rem=rem[:, c], carr_freq=cf[:, c],
                  cn0=cn0[:, c], skip_epochs=skip_epochs,
                  sample_offset=float(offsets[c]), epoch_samples=n_epoch)
        if system == "gps":
            obs = observables.build_channel_observables(prn=ids[i], **kw)
        elif system == "galileo":
            obs = systems.build_galileo_observables(prn=ids[i], **kw)
        else:
            obs = systems.build_glonass_observables(freq_ch=ids[i], **kw)
        channels[i].obs = obs
        if obs is not None and _eph_complete(system, obs.eph):
            live.append(obs)
    secs["decode"] = time.perf_counter() - t0

    # --- 4. PVT at the measurement cadence -------------------------------
    t0 = time.perf_counter()
    fixes: list[pvt.PvtSolution] = []
    fix_epochs: list[int] = []
    interval_ep = max(int(round(pvt_interval_ms / su["epoch_ms"])), 1)
    if len(live) >= 4:
        if system != "glonass":
            batch = eph_mod.stack_ephemeris([ch.eph for ch in live])
        x0 = None
        ekf = pvt.PvtEkf() if pvt_filter == "ekf" else None
        for m in range(skip_epochs + interval_ep, n_epochs, interval_ep):
            pr, t_tx = observables.form_pseudoranges(live, m)
            if system == "glonass":
                pos, clk = systems.glonass_sat_pos_clock(
                    [ch.eph for ch in live], t_tx)
                weeks = np.full(len(live), 2400)
            else:
                pos, clk = eph_mod.sat_pos_clock(batch, t_tx)
                # 10-bit GPS week rollover / GST WN -> full GPS week
                weeks = np.array([ch.eph.week for ch in live]) + (
                    2048 if system == "gps" else 1024)
            snr = np.array([ch.cn0_dbhz[m] for ch in live])
            mask = pvt.precheck_mask(
                snr_dbhz=snr, week=weeks, tow_s=t_tx, pr_m=pr,
                eph_complete=[_eph_complete(system, ch.eph) for ch in live])
            if ekf is not None and ekf.initialized:
                sol = ekf.step(pos, pr, clk, mask=mask,
                               dt_s=interval_ep * su["epoch_ms"] * 1e-3)
            else:
                if mask.sum() < 4:
                    continue
                sol = pvt.solve_wls(pos, pr, clk, mask=mask, x0=x0)
                if ekf is not None and sol.valid:
                    ekf.initialize(sol)
            sol = sol._replace(prns=np.array([ch.prn for ch in live]))
            fixes.append(sol)
            fix_epochs.append(int(round(m * su["epoch_ms"])))
            if sol.valid:
                x0 = np.concatenate([sol.pos_ecef, [sol.clock_bias_m]])
    secs["pvt"] = time.perf_counter() - t0
    # telemetry sources: batch channels track the whole capture
    live_cols = [c for c, i in enumerate(sel) if channels[i].obs is not None]
    cn0_epochs = (cn0[:, live_cols].mean(axis=-1) if live_cols
                  else cn0.mean(axis=-1) if cn0.size else None)
    spans = [(ids[i], 0, n_epochs) for i in sel]
    obs_spans = [(0, channels[i].obs) for i in sel
                 if channels[i].obs is not None]
    return ReceiverResult(channels, fixes, fix_epochs, system,
                          su["epoch_ms"],
                          "EKF" if pvt_filter == "ekf" else "WLS",
                          cn0_epochs=cn0_epochs, tracked_spans=spans,
                          obs_spans=obs_spans, stage_seconds=secs)


def _eph_complete(system: str, eph) -> bool:
    """Has a channel decoded the ephemeris a fix needs? GPS: subframes
    1-3; Galileo: I/NAV words 1-4; GLONASS: strings 1-4."""
    if system == "galileo":
        return gal.inav_complete(eph)
    return eph.complete
