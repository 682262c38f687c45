"""Readings for the comparison's limits: the program's numbers over many
seeds and the control's, in one process per cell (set-up is long).

    python3 gjt_bench/readings.py --workload gps.monitor --seeds 1-12 \
        --control 3 --seconds 2 --out readings.jsonl

Each seed: set up the cell, run a short window at the cell's own load,
check it (the program's reading), and for the first `--control` seeds the
same numbers with the cell's control in the program's place. One JSON line
per seed. Not run by the benchmark's own runs.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def seeds(spec: str) -> list[int]:
    out = []
    for part in spec.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b or a) + 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from gjt_bench import harness
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    bench = harness.spec()
    dev = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(seeds(args.seeds)):
        cell = harness.make_cell(bench, args.workload, seed, dev)
        loop = harness.loop_of(cell)
        t0 = time.perf_counter()
        st = loop.setup(cell)
        setup_s = time.perf_counter() - t0
        got = loop.window(st, args.seconds)
        loop.release(st)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        row = {"workload": args.workload, "seed": seed, "setup_s": setup_s,
               "metrics": got["metrics"],
               "program": {c["name"]: c["value"] for c in loop.check(st)}}
        row["check_s"] = time.perf_counter() - t0
        if hasattr(loop, "slot_readings"):
            row["slots"] = loop.slot_readings(st)
        if i < args.control:
            row["control"] = {c["name"]: c["value"]
                              for c in loop.control(st)}
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del st
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
