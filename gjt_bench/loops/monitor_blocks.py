"""Closed loop of the GPS block monitor: every block through
`entry.detect_acquire_step`, the next one issued as soon as the previous
block's outputs are on the host.

Set-up renders the scene on the card (one uint8 tensor per antenna, held
there as int8 as the program ingests it, the bytes kept on the host for the
reference), cuts it into blocks of
`block_samples`, orders them time-major (t0 a0, t0 a1, ..., t1 a0, ...)
and runs each block once, which builds and loads the kernels and warms
every shape the window uses (one). The window cycles through the blocks,
reads every block's four outputs to the host and keeps a uniform sample
of N_CHECKED of them, drawn from the seed as they come (reservoir
sampling: the kept set does not grow with the window, so the window's
cost does not either); the check compares them with the plain reference
computed from the same bytes.
"""
from __future__ import annotations

import contextlib
import random
import time

import numpy as np
import torch

from gjt_bench import render
from gjt_bench import trace as trace_mod
from gjt_bench.reference import monitor as ref

TRACE_SECONDS = 3.0
N_CHECKED = 16


def _program_matches(cfg: dict) -> None:
    """The program's monitor step must run the deployment the
    configuration states; a run that departs from it is no sound run."""
    from gps_jamming_tpu_torch import entry
    from gps_jamming_tpu_torch.config import DEFAULT_CONFIG
    acq, det = cfg["acquisition"], cfg["detector"]
    got = {"sample_rate_hz": entry.FS, "code_samples": entry.N_CODE,
           "acq.periods": entry.N_INTG,
           "acq.max_doppler_hz": entry.MAX_DOPPLER_HZ,
           "det.chunk": entry.CHUNK,
           "det.percentile": DEFAULT_CONFIG.detector.baseline_percentile,
           "det.rise_db": DEFAULT_CONFIG.detector.power_rise_db,
           "psd.nperseg": DEFAULT_CONFIG.spectral.nperseg}
    want = {"sample_rate_hz": cfg["sample_rate_hz"],
            "code_samples": acq["code_samples"],
            "acq.periods": acq["code_periods"],
            "acq.max_doppler_hz": acq["max_doppler_hz"],
            "det.chunk": det["power_chunk_samples"],
            "det.percentile": det["baseline_percentile"],
            "det.rise_db": det["power_rise_db"],
            "psd.nperseg": cfg["psd_nperseg"]}
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    if bad:
        raise RuntimeError(f"the program departs from the configuration: "
                           f"{bad} (program, configuration)")


def setup(cell) -> dict:
    from gps_jamming_tpu_torch import entry
    from gps_jamming_tpu_torch.ops import codes, iq

    _program_matches(cell.config)
    tr = cell.traffic
    u8 = render.render_scene(tr["scene"], cell.seed, cell.device)
    nb = int(tr["block_samples"])
    n_t = min(a.numel() for a in u8) // (2 * nb)
    i8 = [iq.uint8_to_int8(a) for a in u8]
    # the bytes stay for the reference alone: on the host, so that the
    # card holds what the deployment holds
    u8 = [a.cpu() for a in u8]
    order = [(t, a) for t in range(n_t) for a in range(len(i8))]
    blocks = [i8[a][2 * nb * t: 2 * nb * (t + 1)] for t, a in order]
    replica = codes.gps_replica_table(entry.FS, entry.N_CODE, cell.device)
    method = tr["method"]

    def step(raw):
        return entry.detect_acquire_step(raw, replica, method=method)

    for b in blocks:
        tuple(o.cpu() for o in step(b))
    return {"cell": cell, "u8": u8, "order": order, "nb": nb,
            "blocks": blocks, "step": step, "i8": i8, "seen": 0,
            "kept": [], "rng": random.Random(cell.seed)}


def _keep(st: dict, pos: int, out) -> None:
    """Reservoir sampling (Algorithm R) of the window's block outputs."""
    kept = st["kept"]
    if len(kept) < N_CHECKED:
        kept.append((pos, out))
        return
    j = st["rng"].randrange(pos + 1)
    if j < N_CHECKED:
        kept[j] = (pos, out)


def _blocks_loop(st: dict, seconds: float, spans: bool) -> tuple[int, float]:
    step, blocks = st["step"], st["blocks"]
    n = len(blocks)
    span = (lambda: torch.profiler.record_function("gjt.block")) if spans \
        else contextlib.nullcontext
    i = 0
    t0 = time.perf_counter()
    while True:
        pos = st["seen"] + i
        with span():
            out = tuple(o.cpu() for o in step(blocks[pos % n]))
        _keep(st, pos, out)
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    dt = time.perf_counter() - t0
    st["seen"] += i
    return i, dt


def window(st: dict, seconds: float) -> dict:
    n_done, dt = _blocks_loop(st, seconds, spans=False)
    return {"metrics": {"monitor_msamples_per_s":
                        n_done * st["nb"] / dt / 1e6},
            "attempted": n_done, "failed": 0}


def traced(st: dict, dev) -> dict:
    box: dict = {}
    with trace_mod.traced(dev, box):
        n_done, _ = _blocks_loop(st, TRACE_SECONDS, spans=True)
    return {"trace": box["trace"], "counters": {"blocks": n_done},
            "attempted": n_done, "failed": 0}


def release(st: dict) -> None:
    for k in ("blocks", "step", "i8"):
        st.pop(k, None)


def picks(st: dict) -> list[int]:
    """Window positions whose outputs are checked: the reservoir."""
    return sorted(pos for pos, _ in st["kept"])


def block_bytes(st: dict, block_id: int) -> np.ndarray:
    t, a = st["order"][block_id]
    nb = st["nb"]
    return st["u8"][a][2 * nb * t: 2 * nb * (t + 1)].numpy()


def reference_answers(st: dict, ids, precision: str = "float64") -> dict:
    cfg = st["cell"].config
    return {b: ref.block(block_bytes(st, b), cfg["sample_rate_hz"],
                         cfg["psd_nperseg"],
                         cfg["detector"]["power_chunk_samples"], precision)
            for b in sorted(set(ids))}


def compare(answers: list[tuple], refs: list[dict], limits: dict) -> list:
    """The four numbers of the check over the checked blocks: the widest
    PSD gap over the reference's mean PSD, the widest chunk-power gap over
    the reference's chunk power, the count of flags that differ, and the
    widest per-PRN peak gap over the reference's peak."""
    psd = power = peak = 0.0
    flags = 0
    for (p_psd, p_pm, p_flags, p_peak), r in zip(answers, refs):
        p_psd, p_pm, p_peak = (np.asarray(a, np.float64)
                               for a in (p_psd, p_pm, p_peak))
        psd = max(psd, float(np.max(np.abs(p_psd - r["psd"]))
                             / np.mean(r["psd"])))
        power = max(power, float(np.max(np.abs(p_pm - r["pm"]) / r["pm"])))
        flags += int(np.sum(np.asarray(p_flags, bool) != r["flags"]))
        peak = max(peak, float(np.max(np.abs(p_peak - r["peak"])
                                      / r["peak"])))
    got = {"psd_gap": psd, "power_gap": power, "flags_wrong": flags,
           "peak_gap": peak}
    return [{"name": k, "value": v, "limit": limits[k]}
            for k, v in got.items()]


def check(st: dict) -> list:
    pk = picks(st)
    n = len(st["order"])
    ids = [int(p) % n for p in pk]
    refs = reference_answers(st, ids)
    kept = dict(st["kept"])
    answers = [tuple(o.numpy() for o in kept[p]) for p in pk]
    return compare(answers, [refs[b] for b in ids], st["cell"].limits)


def control(st: dict) -> list:
    """The check's numbers with the reference computed in bfloat16 in the
    program's place, on the blocks a run checks."""
    pk = picks(st)
    n = len(st["order"])
    ids = [int(p) % n for p in pk]
    refs = reference_answers(st, ids)
    low = reference_answers(st, ids, "bfloat16")
    answers = [(low[b]["psd"], low[b]["pm"], low[b]["flags"], low[b]["peak"])
               for b in ids]
    return compare(answers, [refs[b] for b in ids], st["cell"].limits)
