"""One run of one cell: find its files by name, set up, measure, check,
print the result line.

`BENCHMARK.json` at the checkout's root names each cell's configuration and
traffic mix. The configuration's file (`configs/<name>.json`) states the
deployment; the traffic's file (`traffic/<name>.json`) states the mix and
names its loop (`loops/<loop>.py`), which drives the program; the cell's
comparison limits are `limits/<cell>.json`; each per-layer metric is
`metrics/<metric>.py`, a `read(ctx)` that returns a number or None. A
traffic file's "host" object holds its host settings (`host_settings`). A
later cell or metric is new files and entries, never an edit.

A loop module has:
  setup(cell) -> state             render the traffic, build, warm up
  window(state, seconds) -> dict   the measured window: {"metrics": {...},
                                   "attempted": n, "failed": n}
  traced(state, dev) -> dict       the traced window: {"trace": Trace,
                                   "counters": {...}}
  release(state)                   drop the program's state on the card
  check(state) -> list             [{"name", "value", "limit"}] of the
                                   answers the windows produced
  control(state) -> list           the same numbers with the cell's control
                                   in the program's place (`readings.py`)
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gps_jamming_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    device: object


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def resolve(bench: dict, workload: str):
    """(workload entry, config entry) of a cell named in BENCHMARK.json."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; one of "
                         f"{sorted(cells)}")
    w = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return w, cfg


def cell_from(workload: str, config_file: Path, traffic: str, seed: int,
              device) -> Cell:
    """The cell `workload` of a configuration's file and a traffic mix's
    name, with its limits (`limits/<workload>.json`)."""
    return Cell(name=workload, config=load_json(config_file),
                traffic=load_json(BENCH_DIR / "traffic" / f"{traffic}.json"),
                limits=load_json(BENCH_DIR / "limits" / f"{workload}.json"),
                seed=int(seed), device=device)


def make_cell(bench: dict, workload: str, seed: int, device) -> Cell:
    w, cfg = resolve(bench, workload)
    return cell_from(workload, ROOT / cfg["file"], w["traffic"], seed, device)


def loop_of(cell: Cell):
    name = cell.traffic["loop"]
    return load_module(BENCH_DIR / "loops" / f"{name}.py",
                       f"gjt_bench_loop_{name}")


def metrics_for(bench: dict, workload: str, kind: str) -> list[dict]:
    """The cell's end_to_end (kind) or per_layer metrics: those that list
    it, or list no cells."""
    return [m for m in bench[kind]
            if workload in m.get("workloads", [workload])]


def read_per_layer(bench: dict, cell: Cell, ctx: dict) -> dict:
    out = {}
    for m in metrics_for(bench, cell.name, "per_layer"):
        mod = load_module(BENCH_DIR / "metrics" / f"{m['name']}.py",
                          "gjt_bench_metric_" + m["name"].replace(".", "_"))
        v = mod.read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is one the
    benchmark may not load (compared whole)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def host_settings(traffic: dict) -> bool:
    """Apply a traffic mix's "host" settings before the program loads;
    True where the run keeps to one core. "one_core": the process runs on
    one CPU core (the highest it may use) with one torch thread, so that
    other load on a shared host moves its dispatch less."""
    host = traffic.get("host", {})
    if not host.get("one_core"):
        return False
    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
    return True


def run(workload: str, seed: int, seconds: float, trace: bool) -> int:
    bench = spec()
    w, _ = resolve(bench, workload)
    one_core = host_settings(load_json(BENCH_DIR / "traffic"
                                       / f"{w['traffic']}.json"))
    import torch

    from . import trace as trace_mod

    if one_core:
        torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("gjt_bench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(w["chips"]):
        print(f"gjt_bench: {workload} needs {w['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = make_cell(bench, workload, seed, dev)
    loop = loop_of(cell)

    t0 = time.perf_counter()
    state = loop.setup(cell)
    torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)

    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": 1}
    if trace:
        got = loop.traced(state, dev)
        tr = got["trace"]
        device["busy_s"] = trace_mod.busy_us(tr) * 1e-6
        device["window_s"] = tr.window_us * 1e-6
        ctx = {"trace": tr, "counters": got.get("counters", {}),
               "cell": cell, "device_name": device["kind"]}
        result["metrics"] = read_per_layer(bench, cell, ctx)
        result["breakdown"] = {"device_ops": trace_mod.device_ops(tr),
                               "idle_gaps": trace_mod.idle_gaps(tr)}
        result["attempted"] = got["attempted"]
        result["failed"] = got["failed"]
    else:
        got = loop.window(state, seconds)
        wanted = {m["name"]: m["unit"]
                  for m in metrics_for(bench, workload, "end_to_end")}
        for name, value in got["metrics"].items():
            if name in wanted:
                result["metrics"][name] = {"value": float(value),
                                           "unit": wanted[name]}
        result["metrics"]["setup_s"] = {"value": setup_s,
                                        "unit": wanted["setup_s"]}
        result["attempted"] = got["attempted"]
        result["failed"] = got["failed"]
    device["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    loop.release(state)
    torch.cuda.empty_cache()

    checks = loop.check(state)
    result["correct"] = bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks)
    for c in checks:
        if not math.isfinite(c["value"]):
            c["value"] = repr(c["value"])      # JSON has no nan or inf
    result["device"] = device
    result["checked"] = {c["name"]: {"value": c["value"],
                                     "limit": c["limit"]} for c in checks}
    bad = forbidden_modules()
    if bad:
        print(f"gjt_bench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for c in checks:
        print(f"check {c['name']} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
