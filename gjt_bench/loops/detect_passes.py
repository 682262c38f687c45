"""Closed loop of whole `detect` passes: `runtime.pipeline.analyze_capture`
over the scene's antenna files at its defaults (streaming receiver, 4 s
segments), each pass a new call on the same files, the next started when
the previous returns.

Set-up renders the scene on the card, writes one RTL-SDR .bin per antenna
under TMPDIR, and warms up with one pass over `warmup_seconds` cut from
`warmup_from_s` (one receiver segment, the jam's onset inside it, so that
the pre-scan, acquisition, tracking, detector, RSSI and TDOA all run), which
also builds the kernels and the capture reader. The window runs from the
first pass's start to the end of the first pass that ends after
`seconds`; the rate counts whole passes only. Every pass's answers are
kept and checked against the plain reference, computed from the same
bytes once the window has closed. Each pass's per-slot tracking outputs
are the program's own record of them (`StreamingReceiver.last_intervals`),
taken as the pass's receiver returns.
"""
from __future__ import annotations

import functools
import math
import os
import time
from pathlib import Path

import numpy as np
import torch

from gjt_bench import render
from gjt_bench import trace as trace_mod
from gjt_bench.reference import detect as ref
from gjt_bench.reference import track as ref_track

# The reference's acquisition ratio (see reference/detect.py) of the scenes'
# satellites reads 5.0-17.4 on GPS and 8.4-16.1 on GLONASS, and at most 1.51
# on a satellite the scene lacks (4 seeds each): a satellite at STRONG_RATIO
# or above must be acquired, one under PRESENT_RATIO is not there.
STRONG_RATIO = 4.0
PRESENT_RATIO = 2.5
# An acquisition answer is right within one chip of code phase and within
# 250 Hz (a 200 Hz search bin and a half) of the reference's Doppler, which
# reads within 13 Hz of the scene's.
DOPPLER_TOL_HZ = 250.0
CODE_TOL_CHIPS = 1.0


def _intervals_box() -> list:
    """The list that each pass's per-slot tracking outputs are appended
    to: the program keeps them in `StreamingReceiver.last_intervals`; a
    wrapper of its `process_file`, installed once per process, copies the
    list out as the call returns."""
    from gps_jamming_tpu_torch.runtime import rx_stream
    cls = rx_stream.StreamingReceiver
    box = getattr(cls.process_file, "gjt_intervals", None)
    if box is not None:
        return box
    real = cls.process_file
    box = []

    @functools.wraps(real)
    def process_file(self, *a, **k):
        out = real(self, *a, **k)
        box.append(list(self.last_intervals or []))
        return out
    process_file.gjt_intervals = box
    cls.process_file = process_file
    return box


def _program_matches(cfg: dict) -> None:
    """The program's receiver and detector must run what the configuration
    states; a run that departs from it is no sound run."""
    from gps_jamming_tpu_torch.config import DEFAULT_CONFIG
    trk, det = DEFAULT_CONFIG.tracking, DEFAULT_CONFIG.detector
    got = {"tracking.n_taps": trk.n_taps,
           "tracking.tap_spacing_samples": trk.tap_spacing_samples,
           "tracking.cn0_smooth_ms": trk.snr_smooth_ms,
           "tracking.pullin_ms": trk.pullin_ms,
           "detector.power_chunk_samples": det.power_chunk_samples,
           "detector.baseline_percentile": det.baseline_percentile,
           "detector.power_rise_db": det.power_rise_db,
           "detector.cn0_drop_db": det.cn0_drop_db,
           "detector.confirm_s": det.confirm_duration_s,
           "detector.clear_s": det.clear_duration_s}
    want = {k: cfg[k.split(".")[0]][k.split(".")[1]] for k in got}
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    if bad:
        raise RuntimeError(f"the program departs from the configuration: "
                           f"{bad} (program, configuration)")


def _workdir(cell) -> Path:
    """The run's capture files: under TMPDIR, else inside the checkout."""
    tmp = os.environ.get("TMPDIR")
    base = Path(tmp) if tmp else Path(__file__).resolve().parents[1] / "_work"
    d = base / f"gjt_bench_{cell.name}"
    d.mkdir(parents=True, exist_ok=True)
    return d


def _write(arrays, paths) -> None:
    for a, p in zip(arrays, paths):
        a.tofile(p)


def setup(cell) -> dict:
    from gps_jamming_tpu_torch.runtime import pipeline

    tr, cfg = cell.traffic, cell.config
    _program_matches(cfg)
    box = _intervals_box()
    scene = tr["scene"]
    if scene["antennas_m"] != cfg["antennas_m"] \
            or scene["sample_rate_hz"] != cfg["sample_rate_hz"]:
        raise RuntimeError("the traffic's scene and the configuration "
                           "disagree on antennas or sample rate")
    u8 = render.render_scene(scene, cell.seed, cell.device)
    raws = [a.cpu().numpy() for a in u8]
    del u8
    work = _workdir(cell)
    paths = [str(work / f"ant{i}.bin") for i in range(len(raws))]
    _write(raws, paths)
    fs = float(cfg["sample_rate_hz"])
    w0 = 2 * int(round(tr["warmup_from_s"] * fs))
    w1 = w0 + 2 * int(round(tr["warmup_seconds"] * fs))
    warm = [str(work / f"warm{i}.bin") for i in range(len(raws))]
    _write([r[w0:w1] for r in raws], warm)
    positions = [tuple(p) for p in cfg["antennas_m"]]
    system = cfg["system"]

    def one_pass(files):
        box.clear()
        res = pipeline.analyze_capture(files, antenna_positions=positions,
                                       system=system, streaming=True,
                                       device=cell.device)
        res.gjt_intervals = box[-1] if box else []
        return res

    one_pass(warm)
    for p in warm:
        os.remove(p)
    return {"cell": cell, "raws": raws, "paths": paths, "fs": fs,
            "one_pass": one_pass, "passes": []}


def _summary(res) -> dict:
    """What a pass answers, on the host."""
    rx = res.receiver
    loc = res.localization
    return {
        "ranges": [tuple(int(v) for v in r) for r in res.power_ranges],
        "events": [(int(e["start_sample"]), int(e["end_sample"]),
                    float(e["start_time"]), float(e["end_time"]))
                   for e in res.events],
        "channels": [] if rx is None else [
            (int(c.prn), float(c.code_phase_samples), float(c.doppler_hz))
            for c in rx.channels if c.acquired],
        "spans": [] if rx is None else [
            tuple(int(v) for v in s) for s in (rx.tracked_spans or [])],
        # per slot: (id, first epoch, first sample, C/N0 and carrier
        # frequency of each epoch)
        "slots": [(int(iv.sat_id), int(iv.start_epoch),
                   float(iv.sample_offset), iv.cn0, iv.carr_freq)
                  for iv in getattr(res, "gjt_intervals", [])
                  if iv.n_epochs and iv.cn0 is not None],
        "cn0_epochs": None if rx is None or rx.cn0_epochs is None
        else np.asarray(rx.cn0_epochs, np.float32),
        "distances": None if not loc else loc.get("distances"),
        "location": None if not loc or not loc.get("success")
        else list(loc["location_meters"]),
        "elapsed_s": float(res.elapsed_s),
        "scan_s": None if rx is None or not rx.stage_seconds
        else float(rx.stage_seconds.get("scan", 0.0)),
    }


def _capture_s(st: dict) -> float:
    return st["raws"][0].size / 2 / st["fs"]


def window(st: dict, seconds: float) -> dict:
    t0 = time.perf_counter()
    while True:
        st["passes"].append(_summary(st["one_pass"](st["paths"])))
        dt = time.perf_counter() - t0
        if dt >= seconds:
            break
    n = len(st["passes"])
    return {"metrics": {"detect_realtime_x": n * _capture_s(st) / dt},
            "attempted": n, "failed": 0}


def traced(st: dict, dev) -> dict:
    """One pass under the profiler, its device records only; the program's
    own counters of that pass."""
    box: dict = {}
    with trace_mod.traced(dev, box, host_ops=False):
        res = st["one_pass"](st["paths"])
    p = _summary(res)
    st["passes"].append(p)
    n_epoch = int(round(st["fs"] * 1e-3))
    seg = int(round(4.0 * st["fs"]))
    n_seg = (st["raws"][0].size // 2 - n_epoch) // seg
    return {"trace": box["trace"],
            "counters": {"scan_s": p["scan_s"], "elapsed_s": p["elapsed_s"],
                         "epochs": n_seg * 4000 if res.receiver else 0},
            "attempted": 1, "failed": 0}


def release(st: dict) -> None:
    st.pop("one_pass", None)
    for p in st.get("paths", []):
        if os.path.exists(p):
            os.remove(p)


def _circ(a: float, b: float, n: int) -> float:
    d = abs(a - b) % n
    return min(d, n - d)


def _gap(a: float, b: float) -> float:
    """|a - b|, and infinity where either is not a number."""
    d = abs(float(a) - float(b))
    return d if math.isfinite(d) else math.inf


def _epochs(st: dict) -> tuple[int, int]:
    """(samples per 1 ms epoch, whole epochs in the capture)."""
    n_epoch = int(round(st["fs"] * 1e-3))
    return n_epoch, st["raws"][0].size // 2 // n_epoch


def _settle_epochs(cfg: dict) -> int:
    """Epochs after a slot's start before its loop owes a locked reading:
    the pull-in, then two time constants of the C/N0 average."""
    trk = cfg["tracking"]
    return int(trk["pullin_ms"] + 2 * trk["cn0_smooth_ms"])


def _ref_at(R: dict, sid: int, samples) -> np.ndarray:
    """The reference's C/N0 of satellite `sid` in the code period holding
    each sample position (NaN outside the capture's whole periods)."""
    q0, series = R["cn0"][sid]
    sat = R["truth"][sid]
    q = ref_track.period_at(sat, R["system"],
                            np.asarray(samples, np.float64) / R["fs"]) - q0
    ok = (q >= 0) & (q < series.size)
    return np.where(ok, series[np.clip(q, 0, series.size - 1)], np.nan)


def _own_telemetry(R: dict, n_frames: int, n_epoch: int) -> np.ndarray:
    """The reference's own C/N0 telemetry: per 100 ms frame, the mean over
    the satellites it acquires of its C/N0 at the frame's epoch."""
    out = np.zeros(n_frames, np.float32)
    sids = [s for s in R["cn0"] if s in R["present"]]
    for f in range(n_frames):
        pos = ((f + 1) * 100 + 0.5) * n_epoch
        vals = [float(_ref_at(R, s, [pos])[0]) for s in sids]
        vals = [v for v in vals if math.isfinite(v)]
        out[f] = np.mean(vals) if vals else 0.0
    return out


def reference(st: dict, precision: str = "float64") -> dict:
    """The reference's own answers from the bytes: pre-scan ranges,
    acquisitions at each clean segment start, each of the scene's
    satellites' C/N0 along its true trajectory, the detector's events on
    its own C/N0 telemetry, and the RSSI answer."""
    cell = st["cell"]
    cfg = cell.config
    raws, fs = st["raws"], st["fs"]
    system = cfg["system"]
    ids = list(range(1, 33)) if system == "gps" else \
        list(range(cfg["frequency_channels"][0],
                   cfg["frequency_channels"][1] + 1))
    ranges = ref.prescan_ranges(raws[0], precision=precision)
    n_code = int(round(fs * 1e-3))
    seg = int(round(4.0 * fs))
    n_seg = (raws[0].size // 2 - n_code) // seg
    acq = {}
    for k in range(n_seg):
        s = k * seg
        b0, b1 = 2 * s, 2 * (s + 10 * n_code)
        if any(r0 < b1 and b0 < r1 for r0, r1 in ranges):
            continue                  # jammed: no answer is due there
        acq[s] = ref.acquire(raws[0], s, system, ids, fs,
                             max_hz=cfg["acquisition"]["max_doppler_hz"])
    trk = cfg["tracking"]
    truth = {s["id"]: s for s in
             render.draw_satellites(cell.traffic["scene"], cell.seed)}
    out = {"ranges": ranges, "acq": acq, "n_code": n_code, "fs": fs,
           "system": system, "truth": truth,
           "chip_samples": fs / (1.023e6 if system == "gps" else 0.511e6),
           # the program reports a GLONASS channel's Doppler with its FDMA
           # offset from the centre frequency included
           "offset_hz": 0.0 if system == "gps" else 562.5e3,
           "present": {sid for a in acq.values() for sid, v in a.items()
                       if v[0] >= PRESENT_RATIO},
           "cn0": {sid: ref_track.cn0_series(
               raws[0], sat, system, fs,
               tap=trk["n_taps"] * trk["tap_spacing_samples"],
               smooth_ms=trk["cn0_smooth_ms"], precision=precision,
               device=cell.device) for sid, sat in truth.items()}}
    det = cfg["detector"]
    n_epoch, n_epochs = _epochs(st)
    out["own_events"] = ref.detector_events(
        ranges, _own_telemetry(out, n_epochs // 100, n_epoch), n_epoch,
        det["confirm_s"], det["clear_s"], det["cn0_drop_db"])
    if len(raws) >= 2:
        r = cfg["rssi"]
        out["rssi"] = ref.rssi(raws, cfg["antennas_m"], r["tx_power_dbm"],
                               r["path_loss_exponent"], r["frequency_mhz"],
                               r["signal_threshold"], r["grid_density"],
                               r["search_range_multiplier"], precision)
    return out


def _owed_until(R: dict, start_epoch: int, n_epoch: int) -> int:
    """The first epoch at or after `start_epoch` that a pre-scan range
    touches (the capture's end where none does): a loop owes a locked
    reading before it, not after a jam that may break its lock."""
    ends = [r0 // 2 // n_epoch for r0, r1 in R["ranges"]
            if r1 // 2 // n_epoch >= start_epoch]
    return min(ends) if ends else 1 << 62


def _tracking(p: dict, R: dict, st: dict) -> dict:
    """The tracking numbers of one pass: the widest C/N0 gap (per slot, and
    of the telemetry's mean over the slots), the widest gap of a frame's
    mean carrier frequency to the true Doppler, and the frames owed by a
    strong satellite that no slot of it covers; over the 100 ms frames in
    which a slot owes a locked reading. "per_slot" holds each slot's own
    widest gaps, {id: (C/N0 dB, Doppler Hz)}, for the readings."""
    n_epoch, n_epochs = _epochs(st)
    settle = _settle_epochs(st["cell"].config)
    frames = np.arange(100, n_epochs, 100)          # each frame's epoch
    per_slot = {}
    owed_by = {}                        # frame epoch -> [ref C/N0 per slot]
    for sid, start, off, cn0, carr in p["slots"]:
        if sid not in R["truth"]:
            continue                    # not in the scene: tracked_wrong
        until = _owed_until(R, start, n_epoch)
        g = frames[(frames >= start + settle) & (frames + 2 < until)
                   & (frames < start + cn0.size)]
        if g.size == 0:
            continue
        k = g - start
        want = _ref_at(R, sid, off + (k + 0.5) * n_epoch)
        c_gap = d_gap = 0.0
        for gi, got, w in zip(g, cn0[k], want):
            c_gap = max(c_gap, _gap(got, w))
            owed_by.setdefault(int(gi), []).append(w)
        sat = R["truth"][sid]
        for ki in k:
            mean_hz = float(np.mean(carr[ki - 99: ki + 1], dtype=np.float64))
            t_mid = (off + (ki - 49.5) * n_epoch) / st["fs"]
            d_gap = max(d_gap, _gap(mean_hz - sid * R["offset_hz"],
                                    ref_track.doppler_hz(sat, t_mid)))
        c0, d0 = per_slot.get(sid, (0.0, 0.0))
        per_slot[sid] = (max(c0, c_gap), max(d0, d_gap))
    cn0_gap = max([c for c, _ in per_slot.values()], default=0.0)
    dopp_gap = max([d for _, d in per_slot.values()], default=0.0)
    # the telemetry the detector reads: the mean over the slots
    tel = p["cn0_epochs"]
    for gi, want in owed_by.items():
        covering = sum(1 for _, start, _, cn0, _ in p["slots"]
                       if start <= gi < start + cn0.size)
        if tel is not None and covering == len(want) and gi < tel.size:
            cn0_gap = max(cn0_gap, _gap(tel[gi], np.mean(want)))
    missing = 0
    strong0 = {sid for sid, v in R["acq"].get(0, {}).items()
               if v[0] >= STRONG_RATIO and sid in R["truth"]}
    until0 = _owed_until(R, 0, n_epoch)
    for sid in strong0:
        for gi in frames[(frames >= settle) & (frames + 2 < until0)]:
            missing += int(not any(
                s == sid and start + settle <= gi < start + cn0.size
                for s, start, _, cn0, _ in p["slots"]))
    return {"trk_cn0_gap": cn0_gap, "trk_dopp_gap": dopp_gap,
            "trk_missing": missing, "per_slot": per_slot}


def slot_readings(st: dict) -> list:
    """Each pass's per-slot widest gaps, {id: [C/N0 dB, Doppler Hz]}: what
    `readings.py` records beside the check's numbers."""
    R = reference(st)
    return [{str(k): [round(v, 3) for v in vals] for k, vals in
             _tracking(p, R, st)["per_slot"].items()} for p in st["passes"]]


def compare(st: dict, passes: list[dict], R: dict) -> list:
    """The check's numbers over every pass (see PERF.md: what `correct`
    compares)."""
    cfg = st["cell"].config
    det = cfg["detector"]
    n_epoch, n_epochs = _epochs(st)
    n_code, tol = R["n_code"], CODE_TOL_CHIPS * R["chip_samples"]
    strong0 = {sid for sid, v in R["acq"].get(0, {}).items()
               if v[0] >= STRONG_RATIO}
    got = {"ranges_wrong": 0, "acq_wrong": 0, "acq_missed": 0,
           "tracked_wrong": 0, "trk_cn0_gap": 0.0, "trk_dopp_gap": 0.0,
           "trk_missing": 0, "onsets_wrong": 0, "events_wrong": 0}
    multi = "rssi" in R
    if multi:
        got.update(rssi_gap=0.0, rssi_loc_wrong=0)
    for p in passes:
        got["ranges_wrong"] += int(p["ranges"] != R["ranges"])
        acquired = set()
        for sid, lag, dopp in p["channels"]:
            acquired.add(sid)
            dopp -= sid * R["offset_hz"]
            ok = any(sid in a and a[sid][0] >= PRESENT_RATIO
                     and _circ(lag, a[sid][1], n_code) <= tol
                     and abs(dopp - a[sid][2]) <= DOPPLER_TOL_HZ
                     for a in R["acq"].values())
            got["acq_wrong"] += int(not ok)
        got["acq_missed"] += len(strong0 - acquired)
        got["tracked_wrong"] += sum(1 for s in p["spans"]
                                    if s[0] not in R["present"])
        t = _tracking(p, R, st)
        got["trk_cn0_gap"] = max(got["trk_cn0_gap"], t["trk_cn0_gap"])
        got["trk_dopp_gap"] = max(got["trk_dopp_gap"], t["trk_dopp_gap"])
        got["trk_missing"] += t["trk_missing"]
        # each event's onset: the detector on the reference's own C/N0
        own = R["own_events"]
        got["onsets_wrong"] += int(len(own) != len(p["events"]) or any(
            e[0] != q[0] or abs(e[2] - q[2]) >= 1e-9
            for e, q in zip(own, p["events"])))
        # every event whole: the detector on the pass's own C/N0
        # telemetry, which the reference cannot follow after a jam that
        # broke a loop's lock (PERF.md)
        cn0 = ref.frame_cn0(p["cn0_epochs"], n_epochs)
        events = ref.detector_events(R["ranges"], cn0, n_epoch,
                                     det["confirm_s"], det["clear_s"],
                                     det["cn0_drop_db"])
        same = len(events) == len(p["events"]) and all(
            e[0] == q[0] and e[1] == q[1] and abs(e[2] - q[2]) < 1e-9
            and abs(e[3] - q[3]) < 1e-9 for e, q in zip(events, p["events"]))
        got["events_wrong"] += int(not same)
        if multi and events:
            dists, loc = R["rssi"]
            pd = p["distances"]
            if pd is None or p["location"] is None or loc is None \
                    or len(pd) != len(dists):
                got["rssi_loc_wrong"] += 1
                continue
            pd = np.asarray([np.nan if d is None else d for d in pd])
            gap = np.abs(pd - dists) / dists
            got["rssi_gap"] = max(got["rssi_gap"],
                                  float(np.nanmax(gap)) if np.isfinite(
                                      gap).any() else 0.0)
            got["rssi_loc_wrong"] += int(bool(np.isnan(gap).any()
                                              != np.isnan(dists).any()))
            step = 2.0 * cfg["rssi"]["search_range_multiplier"] \
                * np.nanmax(dists) / (cfg["rssi"]["grid_density"] - 1)
            got["rssi_loc_wrong"] += int(np.hypot(
                *(np.asarray(p["location"]) - loc)) > 1.5 * step)
    lim = st["cell"].limits
    return [{"name": k, "value": v, "limit": lim[k]} for k, v in got.items()]


def check(st: dict) -> list:
    return compare(st, st["passes"], reference(st))


def _control_slots(p: dict, low: dict, st: dict) -> list:
    """The program's slots, each epoch's C/N0 and carrier frequency taken
    from the reference in bfloat16 along the same satellite."""
    n_epoch, _ = _epochs(st)
    out = []
    for sid, start, off, cn0, carr in p["slots"]:
        if sid not in low["truth"]:
            out.append((sid, start, off, cn0, carr))
            continue
        k = np.arange(cn0.size)
        pos = off + (k + 0.5) * n_epoch
        c = _ref_at(low, sid, pos).astype(np.float32)
        d = ref_track.doppler_hz(low["truth"][sid], pos / st["fs"])
        f = np.asarray([ref_track._bf16(float(v)) for v in d]) \
            + sid * low["offset_hz"]
        out.append((sid, start, off, c, f.astype(np.float32)))
    return out


def control(st: dict) -> list:
    """The check's numbers with the control in the program's place: the
    reference in bfloat16, the precision below the float32 that the
    configuration states. Its pre-scan ranges, each slot's C/N0 and carrier
    frequency along the program's slots, its detector events (on each
    pass's own C/N0 telemetry) and its RSSI answer."""
    R = reference(st)
    low = reference(st, "bfloat16")
    cfg = st["cell"].config
    n_epoch, n_epochs = _epochs(st)
    det = cfg["detector"]
    passes = []
    for p in st["passes"]:
        q = dict(p, ranges=low["ranges"], slots=_control_slots(p, low, st))
        q["events"] = ref.detector_events(
            low["ranges"], ref.frame_cn0(p["cn0_epochs"], n_epochs),
            n_epoch, det["confirm_s"], det["clear_s"], det["cn0_drop_db"])
        if "rssi" in low:
            q["distances"] = [float(d) for d in low["rssi"][0]]
            q["location"] = None if low["rssi"][1] is None \
                else list(low["rssi"][1])
        passes.append(q)
    return compare(st, passes, R)
