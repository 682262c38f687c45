"""Closed loop of the Galileo E1B block monitor: `monitor_blocks.py`'s
contract, window, reservoir and comparison, with the program's monitor
step run on its Galileo plan (`entry.GALILEO_E1B_8M192`: 36 PRNs, 32768
lags, kernel B1 above 16384 in its thread-block cluster).

Set-up renders the scene on the card (`render_e1b.py`; one uint8 tensor per
antenna, held there as int8 as the program ingests it, the bytes kept on
the host for the reference), cuts it into blocks of `block_samples`,
orders them time-major and runs each block once, which builds and loads
the kernels and warms every shape the window uses (one). The check
computes `reference/galileo_monitor.py` of the checked blocks' bytes in
float64 on the cell's device (the card in a run).
"""
from __future__ import annotations

import random

import torch

from gjt_bench import render_e1b
from gjt_bench import trace as trace_mod
from gjt_bench.loops import monitor_blocks
from gjt_bench.reference import galileo_monitor as ref

TRACE_SECONDS = 3.0
# the window, its reservoir, the release and the comparison are the GPS
# monitor's
window = monitor_blocks.window
release = monitor_blocks.release
picks = monitor_blocks.picks


def program_plan(cfg: dict):
    """The program's Galileo plan, which must run the deployment the
    configuration states; a run that departs from it is no sound run."""
    from gps_jamming_tpu_torch import entry
    from gps_jamming_tpu_torch.config import DEFAULT_CONFIG
    plan = entry.GALILEO_E1B_8M192
    acq, det = cfg["acquisition"], cfg["detector"]
    lo, hi = cfg["prns"]
    got = {"system": plan.system, "sample_rate_hz": plan.sample_rate_hz,
           "code_samples": plan.code_samples, "acq.periods": plan.periods,
           "acq.max_doppler_hz": plan.max_doppler_hz,
           "det.chunk": plan.chunk,
           "det.percentile": DEFAULT_CONFIG.detector.baseline_percentile,
           "det.rise_db": DEFAULT_CONFIG.detector.power_rise_db,
           "psd.nperseg": plan.nperseg, "prns": tuple(plan.prns)}
    want = {"system": cfg["system"], "sample_rate_hz": cfg["sample_rate_hz"],
            "code_samples": acq["code_samples"],
            "acq.periods": acq["code_periods"],
            "acq.max_doppler_hz": acq["max_doppler_hz"],
            "det.chunk": det["power_chunk_samples"],
            "det.percentile": det["baseline_percentile"],
            "det.rise_db": det["power_rise_db"],
            "psd.nperseg": cfg["psd_nperseg"],
            "prns": tuple(range(lo, hi + 1))}
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    if bad:
        raise RuntimeError(f"the program departs from the configuration: "
                           f"{bad} (program, configuration)")
    return plan


def setup(cell) -> dict:
    from gps_jamming_tpu_torch import entry
    from gps_jamming_tpu_torch.ops import iq

    plan = program_plan(cell.config)
    tr = cell.traffic
    u8 = render_e1b.render_scene(tr["scene"], cell.seed, cell.device)
    nb = int(tr["block_samples"])
    n_t = min(a.numel() for a in u8) // (2 * nb)
    i8 = [iq.uint8_to_int8(a) for a in u8]
    # the bytes stay for the reference alone: on the host, so that the
    # card holds what the deployment holds
    u8 = [a.cpu() for a in u8]
    order = [(t, a) for t in range(n_t) for a in range(len(i8))]
    blocks = [i8[a][2 * nb * t: 2 * nb * (t + 1)] for t, a in order]
    replica = entry.replica_table(plan, torch.device(cell.device))
    method = tr["method"]

    def step(raw):
        return entry.detect_acquire_step(raw, replica, method=method,
                                         plan=plan)

    for b in blocks:
        tuple(o.cpu() for o in step(b))
    return {"cell": cell, "u8": u8, "order": order, "nb": nb,
            "blocks": blocks, "step": step, "i8": i8, "seen": 0,
            "kept": [], "rng": random.Random(cell.seed)}


def traced(st: dict, dev) -> dict:
    box: dict = {}
    with trace_mod.traced(dev, box):
        n_done, _ = monitor_blocks._blocks_loop(st, TRACE_SECONDS,
                                                spans=True)
    return {"trace": box["trace"], "counters": {"blocks": n_done},
            "attempted": n_done, "failed": 0}


def block_bytes(st: dict, block_id: int) -> torch.Tensor:
    t, a = st["order"][block_id]
    nb = st["nb"]
    return st["u8"][a][2 * nb * t: 2 * nb * (t + 1)]


def reference_answers(st: dict, ids, precision: str = "float64") -> dict:
    cell = st["cell"]
    out = {}
    for b in sorted(set(ids)):
        r = ref.block(block_bytes(st, b).to(cell.device), cell.config,
                      precision)
        out[b] = {k: v.cpu().numpy() for k, v in r.items()}
    return out


def _ids(st: dict) -> list[int]:
    n = len(st["order"])
    return [int(p) % n for p in picks(st)]


def check(st: dict) -> list:
    ids = _ids(st)
    refs = reference_answers(st, ids)
    kept = dict(st["kept"])
    answers = [tuple(o.numpy() for o in kept[p]) for p in picks(st)]
    return monitor_blocks.compare(answers, [refs[b] for b in ids],
                                  st["cell"].limits)


def control(st: dict) -> list:
    """The check's numbers with the reference computed in bfloat16 in the
    program's place, on the blocks a run checks."""
    ids = _ids(st)
    refs = reference_answers(st, ids)
    low = reference_answers(st, ids, "bfloat16")
    answers = [(low[b]["psd"], low[b]["pm"], low[b]["flags"], low[b]["peak"])
               for b in ids]
    return monitor_blocks.compare(answers, [refs[b] for b in ids],
                                  st["cell"].limits)
