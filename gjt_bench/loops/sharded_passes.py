"""Closed loop of whole `detect --devices N` passes over a recorded set of
receiver files: `runtime.sharded.analyze_capture_sharded(paths,
n_devices=N, cfg=...)` on the configuration's cards (the card given,
repeated), the next pass started when the previous returns.

Set-up renders the scene on the card, longer than a file by the largest
receiver start offset, cuts each antenna's file from it at its receiver's
offset (receivers started by hand, unsynchronised), writes the files
under TMPDIR (else `gjt_bench/_work`) and runs one pass, which builds the
kernels and warms every shape. Later passes read the files from the page
cache: the benchmark drops no cache. The window runs from the first
pass's start to the end of the first pass that ends after `seconds`; the
rate counts the capture samples of whole passes (every file's samples)
over that time. A uniform sample of N_CHECKED passes' answers, drawn from
the seed as they come (reservoir sampling), is kept; the check compares
them with the plain reference computed once from the files' bytes.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import os
import random
import time

import numpy as np

from gjt_bench import render
from gjt_bench import trace as trace_mod
from gjt_bench.loops.detect_passes import _workdir
from gjt_bench.reference import sharded as ref

TRACE_SECONDS = 3.0
N_CHECKED = 16
N_TOP = 4


def program_config(cfg: dict):
    """The program's FrameworkConfig for the configuration's file; raises
    where the file asks for what the sharded path does not run."""
    from gps_jamming_tpu_torch.config import DEFAULT_CONFIG
    acq = cfg["acquisition"]
    fixed = {"acq.method": (acq["method"], "pcf"),
             "acq.max_doppler_hz": (acq["max_doppler_hz"], 7000.0),
             "acq.coherent_groups": (acq["coherent_groups"], 2),
             "acq.code_samples": (acq["code_samples"],
                                  round(cfg["sample_rate_hz"] * 1e-3)),
             "acq.top_prns": (acq["top_prns"], N_TOP),
             "mesh.time_shards": (cfg["mesh"]["time_shards"], 1)}
    bad = {k: v for k, v in fixed.items() if v[0] != v[1]}
    if bad:
        raise RuntimeError(f"the sharded path runs none of {bad} "
                           f"(configuration, program)")
    c, det = DEFAULT_CONFIG, cfg["detector"]
    return dataclasses.replace(
        c,
        frontend=dataclasses.replace(c.frontend,
                                     sample_rate_hz=cfg["sample_rate_hz"]),
        detector=dataclasses.replace(
            c.detector, power_chunk_samples=det["power_chunk_samples"],
            baseline_percentile=det["baseline_percentile"],
            power_rise_db=det["power_rise_db"]),
        spectral=dataclasses.replace(c.spectral, nperseg=cfg["psd_nperseg"]),
        tdoa=dataclasses.replace(c.tdoa, **cfg["tdoa"]))


def cut_files(u8, offsets, n_file: int) -> list[np.ndarray]:
    """Each antenna's file: `n_file` samples of its scene bytes from its
    receiver's start offset."""
    return [a[2 * o: 2 * (o + n_file)] for a, o in zip(u8, offsets)]


def setup(cell) -> dict:
    from gps_jamming_tpu_torch.runtime import sharded

    tr, cfg = cell.traffic, cell.config
    pcfg = program_config(cfg)
    scene = dict(tr["scene"])
    if scene["antennas_m"] != cfg["antennas_m"] \
            or scene["sample_rate_hz"] != cfg["sample_rate_hz"] \
            or len(cfg["antennas_m"]) != cfg["mesh"]["antennas"]:
        raise RuntimeError("the traffic's scene and the configuration "
                           "disagree on antennas or sample rate")
    fs = float(cfg["sample_rate_hz"])
    n_file = int(round(scene["seconds"] * fs))
    offsets = [int(o) for o in tr["receiver_offsets_samples"]]
    scene["seconds"] = (n_file + max(offsets)) / fs
    u8 = render.render_scene(scene, cell.seed, cell.device)
    raws = cut_files([a.cpu().numpy() for a in u8], offsets, n_file)
    del u8
    work = _workdir(cell)
    paths = [str(work / f"ant{i}.bin") for i in range(len(raws))]
    for a, p in zip(raws, paths):
        a.tofile(p)
    cards = int(cfg["mesh"]["cards"])
    periods = int(cfg["acquisition"]["code_periods_per_shard"])

    def one_pass() -> dict:
        return sharded.analyze_capture_sharded(
            paths, n_devices=cards, cfg=pcfg, devices=[cell.device] * cards,
            acq_periods_per_shard=periods)

    got = one_pass()["mesh"]
    want = {"antenna": len(paths), "time": 1, "devices": len(paths)}
    if got != want:
        raise RuntimeError(f"the pass ran on a {got} mesh, not {want}")
    return {"cell": cell, "raws": raws, "paths": paths, "fs": fs,
            "one_pass": one_pass, "pass_samples": n_file * len(paths),
            "seen": 0, "kept": [], "rng": random.Random(cell.seed)}


def summary(res: dict, fs: float, nperseg: int) -> dict:
    """What a pass answers, as the check reads it."""
    return {
        "psd_peak_db": float(res["psd_fused_peak_db"]),
        "psd_bin": int(round(res["psd_fused_peak_freq_hz"] / (fs / nperseg)))
        % nperseg,
        "per_antenna": [([tuple(int(v) for v in r)
                          for r in a["power_ranges_bytes"]],
                         float(a["baseline"]), float(a["threshold"]))
                        for a in res["per_antenna"]],
        "acq": [[(int(r["prn"]), float(r["doppler_hz"]), float(r["peak"]))
                 for r in ant] for ant in res["acquisition"] or []],
        "lags": [(int(p["pair"][0]), int(p["pair"][1]),
                  int(p["lag_samples"])) for p in res["tdoa_pairs"] or []],
    }


def keep(st: dict, pos: int, answer) -> None:
    """Reservoir sampling (Algorithm R) of the window's pass answers."""
    kept = st["kept"]
    if len(kept) < N_CHECKED:
        kept.append((pos, answer))
        return
    j = st["rng"].randrange(pos + 1)
    if j < N_CHECKED:
        kept[j] = (pos, answer)


def _passes(st: dict, seconds: float) -> tuple[int, float]:
    nperseg = st["cell"].config["psd_nperseg"]
    n = 0
    t0 = time.perf_counter()
    while True:
        res = st["one_pass"]()
        keep(st, st["seen"] + n, summary(res, st["fs"], nperseg))
        n += 1
        dt = time.perf_counter() - t0
        if dt >= seconds:
            break
    st["seen"] += n
    return n, dt


def window(st: dict, seconds: float) -> dict:
    n, dt = _passes(st, seconds)
    return {"metrics": {"monitor_msamples_per_s":
                        n * st["pass_samples"] / dt / 1e6},
            "attempted": n, "failed": 0}


def traced(st: dict, dev) -> dict:
    """Whole passes lasting at least TRACE_SECONDS under the profiler; the
    program's count of the bytes it placed on the card over them (None
    from a program that keeps no such count)."""
    from gps_jamming_tpu_torch.parallel import mesh
    reset = getattr(mesh, "reset_upload_bytes", None)
    read = getattr(mesh, "upload_bytes", None)
    if reset is not None:
        reset()
    box: dict = {}
    with trace_mod.traced(dev, box):
        n, _ = _passes(st, TRACE_SECONDS)
    return {"trace": box["trace"],
            "counters": {"passes": n, "samples": n * st["pass_samples"],
                         "upload_bytes": None if read is None else read()},
            "attempted": n, "failed": 0}


def release(st: dict) -> None:
    st.pop("one_pass", None)
    for p in st.get("paths", []):
        if os.path.exists(p):
            os.remove(p)


def reference(st: dict, precision: str = "float64") -> dict:
    """The plain reference's answers for the run's files; the float64
    answers are computed once a run (check and control share them)."""
    if precision == "float64" and "ref" in st:
        return st["ref"]
    cfg = st["cell"].config
    acq, det = cfg["acquisition"], cfg["detector"]
    R = ref.analyse(
        st["raws"], st["fs"], cfg["psd_nperseg"], det["power_chunk_samples"],
        det["baseline_percentile"], det["power_rise_db"],
        acq["code_samples"], acq["code_periods_per_shard"],
        acq["coherent_groups"], acq["max_doppler_hz"],
        cfg["tdoa"]["correlation_slice_size"], precision)
    if precision == "float64":
        st["ref"] = R
    return R


def _db_below(top: float, v: float) -> float:
    """How far v lies under top, in dB (infinity where v is not above 0)."""
    return 10.0 * math.log10(top / v) if v > 0 else math.inf


def compare(answers: list[dict], R: dict, limits: dict) -> list:
    """The check's numbers over the checked passes (PERF.md §2): the PSD
    peak's gap in dB and wrong peak bins; power ranges that differ;
    baseline and threshold gaps over the reference's; PRNs and Dopplers
    that the reference separates from its own by more than `peak_gap`;
    the peaks' gap over the reference's; pair lags that differ."""
    psd = R["psd"]
    top_db = 10.0 * math.log10(psd.max())
    got = {"psd_peak_db_gap": 0.0, "psd_bin_wrong": 0, "ranges_wrong": 0,
           "baseline_gap": 0.0, "threshold_gap": 0.0, "prn_wrong": 0,
           "doppler_wrong": 0, "peak_gap": 0.0, "lags_wrong": 0}
    tie = limits["peak_gap"]
    grid = R["doppler_hz"]
    want_lags = [(i, j, lag) for i, j, lag, _ in R["pairs"]]
    n_ant = len(R["per_antenna"])
    for a in answers:
        got["psd_peak_db_gap"] = max(got["psd_peak_db_gap"],
                                     abs(a["psd_peak_db"] - top_db))
        got["psd_bin_wrong"] += int(_db_below(psd.max(), psd[a["psd_bin"]])
                                    > limits["psd_peak_db_gap"])
        got["ranges_wrong"] += abs(len(a["per_antenna"]) - n_ant)
        for (ranges, base, thr), w in zip(a["per_antenna"],
                                          R["per_antenna"]):
            got["ranges_wrong"] += sum(
                int(p != q) for p, q in itertools.zip_longest(
                    ranges, w["ranges"]))
            got["baseline_gap"] = max(got["baseline_gap"], abs(
                base - w["baseline"]) / w["baseline"])
            got["threshold_gap"] = max(got["threshold_gap"], abs(
                thr - w["threshold"]) / w["threshold"])
        got["prn_wrong"] += N_TOP * abs(len(a["acq"]) - n_ant)
        for ant, peak, rows in zip(a["acq"], R["peak"], R["rows"]):
            ranked = np.sort(peak)[::-1]
            got["prn_wrong"] += max(N_TOP - len(ant), 0)
            for k, (prn, dopp, p_peak) in enumerate(ant[:N_TOP]):
                w = peak[prn - 1]
                got["prn_wrong"] += int((ranked[k] - w) / ranked[k] > tie)
                row = rows[prn - 1][int(np.argmin(np.abs(grid - dopp)))]
                got["doppler_wrong"] += int((w - row) / w > tie)
                got["peak_gap"] = max(got["peak_gap"],
                                      float(abs(p_peak - w) / w))
        got["lags_wrong"] += sum(int(p != q) for p, q in itertools.zip_longest(
            a["lags"], want_lags))
    return [{"name": k, "value": v, "limit": limits[k]}
            for k, v in got.items()]


def picks(st: dict) -> list[dict]:
    """The checked passes' answers, in window order."""
    return [a for _, a in sorted(st["kept"], key=lambda pa: pa[0])]


def check(st: dict) -> list:
    return compare(picks(st), reference(st), st["cell"].limits)


def answers_of(R: dict) -> dict:
    """A reference's own answers, shaped as a pass's."""
    psd = R["psd"]
    return {
        "psd_peak_db": 10.0 * math.log10(psd.max()),
        "psd_bin": int(np.argmax(psd)),
        "per_antenna": [(w["ranges"], w["baseline"], w["threshold"])
                        for w in R["per_antenna"]],
        "acq": [[(int(p) + 1, float(R["doppler_hz"][np.argmax(rows[p])]),
                  float(peak[p])) for p in np.argsort(-peak)[:N_TOP]]
                for peak, rows in zip(R["peak"], R["rows"])],
        "lags": [(i, j, lag) for i, j, lag, _ in R["pairs"]],
    }


def control(st: dict) -> list:
    """The check's numbers with the reference computed in bfloat16 in the
    program's place, once for every checked pass."""
    low = answers_of(reference(st, "bfloat16"))
    return compare([low] * len(st["kept"]), reference(st),
                   st["cell"].limits)
