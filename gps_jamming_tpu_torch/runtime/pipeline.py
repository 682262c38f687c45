"""End-to-end analysis pipeline (counterpart of
gps_jamming_tpu.runtime.pipeline).

The reference's GPSAnalysisThread (`app/worker.py`) as one in-process
pipeline over the device and host decode:

  1. full-capture power pre-scan -> F1 ranges     (worker.py:198-275)
  2. GNSS receiver chain -> per-100 ms telemetry  (gnssdec's role)
  3. 4-flag detector -> confirmed events          (worker.py:363-458)
  4. on events: RSSI triangulation + TDOA         (worker.py:567-611)
  5. telemetry records, sdrout.c JSON schema      (worker.py:277-361)

`analyze_capture(streaming=True)`, the default, is the product path: the
file pre-scan in bounded memory and the self-healing segmented receiver
(`rx_stream.StreamingReceiver.process_file`), with live telemetry sinks
and a detect-level checkpoint. `streaming=False` reads the whole capture
and runs the acquire-once batch receiver.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import time
from typing import Sequence

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, FrameworkConfig, FrontendConfig, \
    GnssSystem
from ..device import as_device
from ..models import detector, rssi, tdoa
from ..models.receiver import observables as obs_mod
from ..models.receiver import receiver as rx_mod
from ..ops import iq as iq_ops
from . import rx_stream, telemetry

TELEMETRY_MS = 100             # status cadence (sdrmain.c:210)


@dataclasses.dataclass
class AnalysisResult:
    power_ranges: list[tuple[int, int]]
    events: list[dict]
    flags_trace: dict
    receiver: "rx_mod.ReceiverResult | None"
    telemetry: telemetry.TelemetryLog
    localization: dict | None
    tdoa_result: dict | None
    last_safe_fix: dict | None
    elapsed_s: float
    # host seconds of each stage, each ending in a read of its result:
    # 'prescan', 'receiver', 'detector', 'records', 'rssi', 'tdoa' (the
    # port's own field)
    stage_seconds: dict | None = None


def build_telemetry_frames(res: "rx_mod.ReceiverResult | None",
                           n_epochs: int, n_epoch_samples: int,
                           cfg: FrameworkConfig) -> detector.TelemetryFrames:
    """Receiver outputs -> per-100 ms TelemetryFrames for the detector.

    Mirrors process_incoming_data (worker.py:277-361): C/N0 averaged over
    tracked sats, residual median/bad-count and height from the most
    recent fix, buffcnt = byte offset of the frame in the capture (int64).
    """
    n_frames = n_epochs // TELEMETRY_MS
    t = (np.arange(n_frames, dtype=np.float64) + 1) * TELEMETRY_MS * 1e-3
    buffcnt = ((np.arange(n_frames, dtype=np.int64) + 1)
               * TELEMETRY_MS * n_epoch_samples * 2)
    cn0 = np.zeros(n_frames)
    res_med = np.zeros(n_frames)
    bad = np.zeros(n_frames)
    hgt = np.zeros(n_frames)
    nsat = np.zeros(n_frames)

    epoch_ms = res.epoch_ms if res is not None else 1.0
    cn0_series = res.cn0_epochs if res is not None else None
    live = ([c.obs for c in res.channels if c.obs is not None]
            if res is not None and cn0_series is None else [])
    for f in range(n_frames):
        m = min((f + 1) * TELEMETRY_MS, n_epochs - 1)
        e = int(m / epoch_ms)
        if cn0_series is not None and cn0_series.size:
            cn0[f] = float(cn0_series[min(e, cn0_series.size - 1)])
        elif live:
            vals = [ch.cn0_dbhz[min(e, ch.cn0_dbhz.size - 1)]
                    for ch in live]
            cn0[f] = float(np.mean(vals))
    if res is not None and res.fixes:
        fix_ep = np.asarray(res.fix_epochs)
        for f in range(n_frames):
            m = (f + 1) * TELEMETRY_MS
            k = int(np.searchsorted(fix_ep, m, side="right")) - 1
            if k < 0 or m - fix_ep[k] > 300:
                continue
            sol = res.fixes[k]
            r = np.abs(sol.residuals_m[np.asarray(sol.residuals_m) != 0.0])
            res_med[f] = float(np.median(r)) if r.size else 0.0
            bad[f] = int(np.sum(r > cfg.detector.residual_single_sat_m))
            hgt[f] = sol.height_m if sol.valid else 0.0
            nsat[f] = sol.nsat if sol.valid else 0
    return detector.TelemetryFrames(
        time_s=t,
        buffcnt=buffcnt,
        cn0_avg=cn0.astype(np.float32),
        residual_median=res_med.astype(np.float32),
        residual_bad_count=bad.astype(np.float32),
        hgt=hgt.astype(np.float32),
        nsat=nsat.astype(np.float32))


def _week_adjust(system: str) -> int:
    """10-bit GPS week rollover / GST WN offset -> full GPS week (the same
    adjustment the PVT path applies before the precheck week gate)."""
    return {"gps": 2048, "galileo": 1024}.get(system, 0)


def frame_observations(res: "rx_mod.ReceiverResult", frame_ms: int,
                       fix) -> list[dict]:
    """Per-satellite observation rows for one telemetry frame.

    The reference emits observations[{prn,tow,week,snr,doppler,az,el,
    residual,innovation}] in every 100 ms record (sdrout.c:213-325, built
    from the obs_v matrix sdrsync.c:97-124). snr/doppler/tow come from the
    channel's decoded epoch series, az/el/residual/innovation from the
    frame's current PVT solution (mapped back by PvtSolution.prns).
    """
    rows: list[dict] = []
    if res is None:
        return rows
    fix_prns = (list(np.asarray(fix.prns)) if fix is not None
                and fix.prns is not None else [])
    wk_adj = _week_adjust(res.system)
    epoch_g = int(frame_ms / res.epoch_ms)
    # decoded intervals: (start_epoch, obs) spans; the batch receiver's
    # start at 0 and cover the capture
    spans = res.obs_spans
    if spans is None:
        spans = [(0, c.obs) for c in res.channels if c.obs is not None]
    seen: dict[int, tuple] = {}
    for st0, obs in spans:
        local = epoch_g - st0
        if obs is None or obs.cn0_dbhz.size == 0:
            continue
        size = min(obs.cn0_dbhz.size, obs.chips.size)
        if local < 0:
            continue           # not tracked yet: a clipped row here would
            # report data from the future
        covers = local < size
        if not covers:
            # hold the last snapshot after the span ends, but only for the
            # reference's obs-staleness bound (checkObsDelay resets
            # channels whose obs go stale > 90 s, sdrmain.c:464-511)
            stale_epochs = int(90_000.0 / res.epoch_ms)
            if obs.prn in seen or local - size > stale_epochs:
                continue
            local = size - 1
        elif obs.prn in seen and not seen[obs.prn][0]:
            pass                               # covering span wins
        elif obs.prn in seen:
            continue
        seen[obs.prn] = (covers, obs, local)
    for prn, (covers, obs, local) in sorted(seen.items()):
        az = el = resid = innov = 0.0
        if prn in fix_prns:
            k = fix_prns.index(prn)
            az = float(fix.azimuth_deg[k])
            el = float(fix.elevation_deg[k])
            resid = float(fix.residuals_m[k])
            if fix.innovations_m is not None:
                innov = float(fix.innovations_m[k])
        week = int(getattr(obs.eph, "week", 0) or 0)
        rows.append(telemetry.make_observation(
            prn=prn, tow=float(obs.transmit_time(local)),
            week=week + wk_adj if week else 0,
            snr=float(obs.cn0_dbhz[local]),
            doppler=float(obs.doppler_hz[min(local,
                                             obs.doppler_hz.size - 1)]),
            az=az, el=el, residual=resid, innovation=innov))
    return rows


def iter_records(res: "rx_mod.ReceiverResult", frames, hold: bool,
                 hold_filt: "telemetry.HoldPositionFilter",
                 start_frame: int = 0):
    """Yield (frame_idx, record, fix) telemetry records for
    frames[start_frame:], the sdrout.c:83-334 100 ms status records. Pass
    the same HoldPositionFilter across calls to carry the hold state."""
    fix_ep = np.asarray(res.fix_epochs) if res.fix_epochs else None
    acq_prns = [c.prn for c in res.channels if c.acquired]
    trk = [c.prn for c in res.channels if c.obs is not None]
    dec = [c.prn for c in res.channels
           if c.obs is not None
           and rx_mod._eph_complete(res.system, c.obs.eph)]

    def frame_lists(epoch_g: int):
        """TRACKED|/DECODED| vary with time when the receiver reports
        tracking spans (the batch receiver's cover the capture)."""
        if res.tracked_spans is None:
            return trk, dec
        t = sorted({s for s, a, b in res.tracked_spans
                    if a <= epoch_g < b})
        d = []
        if res.obs_spans is not None:
            d = sorted({o.prn for st0, o in res.obs_spans
                        if st0 <= epoch_g < st0 + o.cn0_dbhz.size
                        and rx_mod._eph_complete(res.system, o.eph)})
        return t, d

    anchor = None          # (week, tow_offset): TIME = elapsed + offset
    for f in range(start_frame, len(np.asarray(frames.time_s))):
        m = (f + 1) * TELEMETRY_MS
        fix = None
        if fix_ep is not None:
            k = int(np.searchsorted(fix_ep, m, side="right")) - 1
            # a fix is current only within one PVT cadence + one frame;
            # a stale fix must not pass for live telemetry
            if (k >= 0 and res.fixes[k].valid
                    and m - fix_ep[k] <= 300):
                fix = res.fixes[k]
        is_hold = False
        if fix is not None:
            h_lat, h_lon, h_hgt, is_hold = hold_filt.apply(
                fix.lat_deg, fix.lon_deg, fix.height_m)
            if hold and is_hold:
                fix = fix._replace(lat_deg=h_lat, lon_deg=h_lon,
                                   height_m=h_hgt)
        trk_f, dec_f = frame_lists(int(m / res.epoch_ms))
        obs_rows = frame_observations(res, m, fix)
        # TIME| is real GPS time once a channel has decoded (the reference
        # renders the 1980 epoch before the first decode, sdrout.c:
        # 205-212). The receive-time anchor is set once, from the first
        # frame with a decoded week (min transmit ToW + the PTIMING nominal
        # transit, the PVT's t_rx convention), and then advances with
        # elapsed time.
        week, tow = 0, float(frames.time_s[f])
        if anchor is None:
            wk_rows = [o for o in obs_rows if o["week"]]
            if wk_rows:
                t_rx = (min(o["tow"] for o in wk_rows)
                        + obs_mod.PTIMING_S)
                anchor = (wk_rows[0]["week"],
                          t_rx - float(frames.time_s[f]))
        if anchor is not None:
            week = anchor[0]
            tow = float(frames.time_s[f]) + anchor[1]
        rec = telemetry.make_record(
            elapsed_s=float(frames.time_s[f]),
            time_s=tow if week else float(frames.time_s[f]),
            buffcnt=int(frames.buffcnt[f]),
            acq_prns=acq_prns, tracked_prns=trk_f,
            decoded_prns=dec_f,
            fix=fix, hold=is_hold, filter_name=res.filter_name,
            observations=obs_rows, week=week)
        yield f, rec, fix


def analyze_capture(paths: Sequence[str],
                    antenna_positions: Sequence[tuple[float, float]]
                    | None = None,
                    cfg: FrameworkConfig = DEFAULT_CONFIG,
                    run_receiver: bool = True,
                    localize: bool = True,
                    max_seconds: float | None = None,
                    system: str = "gps",
                    hold: bool = False,
                    sample_rate: float | None = None,
                    pvt_filter: str = "wls",
                    streaming: bool = True,
                    segment_s: float = 4.0,
                    sink=None,
                    emit_every_s: float = 8.0,
                    wire_bits: int | str = "auto",
                    checkpoint_path: str | None = None,
                    checkpoint_every_s: float = 60.0,
                    resume: bool = False,
                    device=None) -> AnalysisResult:
    """Analyze 1-3 antenna captures end to end (start_analysis flow,
    ui_mainwindow.py:653 -> worker.py:477-547), on `device` (None: the
    card; raises RuntimeError where there is none).

    streaming=True (the default, the product path): the file pre-scan in
    bounded memory, then the self-healing segmented receiver
    (`rx_stream.StreamingReceiver.process_file`: channel health resets,
    re-acquisition after jamming, ephemeris reuse; sdrmain.c:248-400 and
    :417-511), whose device memory stays at a segment window whatever
    the capture's length; then the detector and the telemetry records on
    the host, and on an event with >= 2 antennas the streamed RSSI and
    TDOA localization (`triangulate_files`, `localize_files`).
    streaming=False: the whole first capture goes to the device and
    through the acquire-once batch receiver (`run_receiver`); sink,
    wire_bits, segment_s, emit_every_s and the checkpoint options are
    then ignored, as in the JAX package.

    system: 'gps', 'galileo', 'glonass' or 'sbas' (messages only, no fix);
    another raises ValueError. hold: freeze the REPORTED position while the
    fix is held (sdrout.c:141-183). sample_rate: default the per-system
    front-end rate (10 MS/s for GLONASS, else 2.048 MS/s). pvt_filter:
    'wls' or 'ekf'. segment_s: the streaming receiver's segment length.
    sink: callable(record), the live telemetry: records are built and
    pushed every ~emit_every_s of capture while segments still process
    (the frame at the covered edge is held back to the next emission);
    the result still carries the authoritative log. wire_bits: "auto", 8,
    4, 2 or 1, the receiver's upload width (`process_file`).
    checkpoint_path: persist the power profile and ranges, the
    receiver's state (chained at <path>.rx, every checkpoint_every_s)
    and the emission cursor, so that a killed run resumed with
    resume=True gives the same events and records as an uninterrupted
    one; a checkpoint of another invocation raises ValueError. Live
    emission on resume is at-least-once. A TDOA failure (no onset, too
    short) leaves tdoa_result None, as in the reference.

    stage_seconds holds the host time of each stage ('prescan',
    'receiver', 'detector', 'records', 'rssi', 'tdoa'); the streaming
    receiver's own split is its result's stage_seconds
    (`StreamingReceiver.last_profile`).
    """
    dev = as_device(device)
    t_start = time.time()
    secs: dict[str, float] = {}
    ck_state: dict | None = None
    if checkpoint_path is not None and streaming:
        meta = {"paths": list(paths), "system": system,
                "max_seconds": max_seconds}
        if resume and os.path.exists(checkpoint_path):
            with open(checkpoint_path, "rb") as f:
                ck_state = pickle.load(f)
            if ck_state["meta"] != meta:
                raise ValueError(
                    f"detect checkpoint was written for "
                    f"{ck_state['meta']}, not this invocation")
        else:
            ck_state = {"profile": None, "ranges": None, "emitted": 0,
                        "meta": meta}
    if sample_rate is not None:
        fs = float(sample_rate)
    elif system == "glonass":
        fs = FrontendConfig.for_system(GnssSystem.GLONASS).sample_rate_hz
    else:
        fs = cfg.frontend.sample_rate_hz
    n_epoch = int(round(fs * 1e-3))

    n_samples = os.path.getsize(paths[0]) // 2
    if max_seconds is not None:
        n_samples = min(n_samples, int(max_seconds * fs))

    # 1. power pre-scan (F1 map)
    t0 = time.perf_counter()
    x = None
    if ck_state is not None and ck_state["profile"] is not None:
        ranges = ck_state["ranges"]        # resume: skip the file re-scan
    else:
        if streaming:
            prof = detector.power_profile_file(
                paths[0], cfg.detector, max_samples=n_samples, device=dev)
        else:
            raw = np.fromfile(paths[0], dtype=np.uint8, count=2 * n_samples)
            x = iq_ops.int8_to_complex(
                torch.from_numpy(iq_ops.uint8_np_to_int8(raw)).to(dev))
            del raw
            prof = detector.power_profile(x, cfg.detector)
        ranges = detector.power_profile_ranges(prof, cfg.detector)
        if ck_state is not None:
            ck_state["profile"] = {f: getattr(prof, f).cpu().numpy()
                                   for f in prof._fields}
            ck_state["ranges"] = ranges
            rx_stream.save_atomic(checkpoint_path, ck_state)
    ranges_pad, n_ranges = detector.ranges_to_padded(ranges)
    secs["prescan"] = time.perf_counter() - t0

    # 2. receiver chain
    res = None
    if run_receiver:
        t0 = time.perf_counter()
        if streaming:
            srx = rx_stream.StreamingReceiver(
                fs, system=system, segment_s=segment_s,
                pvt_filter=pvt_filter, device=dev)
            segment_cb = None
            if sink is not None:
                live_hold = telemetry.HoldPositionFilter()
                emitted = [ck_state["emitted"] if ck_state else 0]
                emit_frames = max(int(emit_every_s * 1000 / TELEMETRY_MS),
                                  1)

                def segment_cb(done, n_total, snapshot):
                    ms_cov = int(done * srx.seg_epochs * srx.su["epoch_ms"])
                    n_frames = ms_cov // TELEMETRY_MS
                    if n_frames == 0 or (n_frames - emitted[0] < emit_frames
                                         and done < n_total):
                        return
                    part = snapshot()          # decode + PVT so far
                    pf = build_telemetry_frames(part, ms_cov, n_epoch, cfg)
                    # the flags of the frames so far: the detector is a
                    # causal loop, so it needs none of the JAX package's
                    # padding to a bucket (`_detector_trace_bucketed`,
                    # which keeps XLA from compiling per length)
                    _, ptrace = detector.run_detector(
                        pf, ranges_pad, n_ranges, cfg.detector)
                    pjam = np.asarray(ptrace.is_jamming)
                    # hold back the boundary frame mid-run: its epoch sits
                    # at the covered edge, where its TRACKED/DECODED lists
                    # are empty here but not in the final log
                    stop = n_frames - 1 if done < n_total else n_frames
                    for f, rec, fix in iter_records(
                            part, pf, hold, live_hold,
                            start_frame=emitted[0]):
                        if f >= stop:
                            break
                        rec["jamming"] = bool(pjam[f]) \
                            if f < pjam.size else False
                        sink(rec)
                    emitted[0] = stop
                    if ck_state is not None:
                        ck_state["emitted"] = stop
                        rx_stream.save_atomic(checkpoint_path, ck_state)

            try:
                res = srx.process_file(
                    paths[0], convention="centered",
                    max_samples=(None if max_seconds is None
                                 else int(max_seconds * fs)),
                    segment_cb=segment_cb, wire_bits=wire_bits,
                    checkpoint_path=(checkpoint_path + ".rx"
                                     if ck_state is not None else None),
                    checkpoint_every_s=checkpoint_every_s, resume=resume)
            finally:
                # also when the sink raised (a dashboard's stop): the
                # workers must not outlive the run
                srx.close()
            res.stage_seconds = dict(srx.last_profile)
        else:
            res = rx_mod.run_receiver(x, fs, system=system,
                                      pvt_filter=pvt_filter)
        secs["receiver"] = time.perf_counter() - t0
    del x
    n_epochs = n_samples // n_epoch

    # 3. telemetry frames + detector
    t0 = time.perf_counter()
    frames = build_telemetry_frames(res, n_epochs, n_epoch, cfg)
    final, trace = detector.run_detector(frames, ranges_pad, n_ranges,
                                         cfg.detector)
    events = detector.events_to_list(final)
    secs["detector"] = time.perf_counter() - t0

    # telemetry records + last safe fix (worker.py:339-346)
    t0 = time.perf_counter()
    log = telemetry.TelemetryLog()
    hold_filt = telemetry.HoldPositionFilter()
    last_safe = None
    jam_trace = np.asarray(trace.is_jamming)
    if res is not None:
        for f, rec, fix in iter_records(res, frames, hold, hold_filt):
            log.append(rec)
            if fix is not None and f < jam_trace.size and not jam_trace[f]:
                last_safe = {"lat": fix.lat_deg, "lon": fix.lon_deg,
                             "hgt": fix.height_m,
                             "time": float(frames.time_s[f])}
    secs["records"] = time.perf_counter() - t0

    # 4. localization on detected jamming
    loc = None
    td = None
    if localize and events and antenna_positions is not None \
            and len(paths) >= 2:
        t0 = time.perf_counter()
        if streaming:
            loc = rssi.triangulate_files(paths, antenna_positions,
                                         cfg=cfg.rssi, device=dev)
        else:
            caps = [iq_ops.read_iq_file(p, convention="normalized")
                    for p in paths]
            loc = rssi.triangulate(caps, antenna_positions, cfg=cfg.rssi,
                                   device=dev)
            del caps
        secs["rssi"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        try:
            if streaming:
                td = tdoa.localize_files(paths, antenna_positions, fs,
                                         cfg=cfg.tdoa, device=dev)
            else:
                td = tdoa.localize(
                    [iq_ops.read_iq_file(p, convention="centered")
                     for p in paths], antenna_positions, fs, cfg=cfg.tdoa,
                    device=dev)
        except ValueError:
            td = None          # no onset, or too few samples after it
        secs["tdoa"] = time.perf_counter() - t0

    return AnalysisResult(
        power_ranges=ranges, events=events,
        flags_trace={
            "f1": np.asarray(trace.f1), "f2": np.asarray(trace.f2),
            "f3": np.asarray(trace.f3), "f4": np.asarray(trace.f4),
            "jamming": jam_trace,
        },
        receiver=res, telemetry=log, localization=loc, tdoa_result=td,
        last_safe_fix=last_safe, elapsed_s=time.time() - t_start,
        stage_seconds=secs)
