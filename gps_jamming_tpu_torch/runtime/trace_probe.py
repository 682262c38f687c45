"""Probe of the device records that `torch_trace` can lose (ROADMAP C14).

Each variant runs in a process of its own, side by side on the card: a
first profile, WAIT seconds of card work, then TRACES traces of a sharded
PCF search (a 3 x 2 mesh of the card, 6 launches of kernel B1), with
`profiling.torch_trace`'s pre-roll set to the variant's: none, or the
default (PREROLL_LAUNCHES, PREROLL_S). Prints one JSON line per variant,
per trace: the block's launches whose device record the trace lacks,
whether torch_trace raised, the pre-roll's launches and those of them
lost.

    python -m gps_jamming_tpu_torch.runtime.trace_probe [--wait 330]
        [--traces 12]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from . import profiling

VARIANTS = {"none": (0, 0.0),
            "pre-roll": (profiling.PREROLL_LAUNCHES, profiling.PREROLL_S)}


def _traces(wait_s: float, n_traces: int) -> list:
    from torch.profiler import ProfilerActivity, profile

    from ..ops import codes
    from ..parallel import fusion
    from ..parallel import mesh as mesh_lib
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    head = (rng.standard_normal((3, 2, 8 * 2048))
            + 1j * rng.standard_normal((3, 2, 8 * 2048))).astype(np.complex64)
    rep = codes.gps_replica_table_host(2.048e6, 2048)
    mesh = mesh_lib.make_mesh(3, 2, devices=[dev] * 6)

    def run():
        fusion.sharded_caf_acquire(head, mesh, rep, None, 2.048e6,
                                   method="pcf", group_blocks=4)
        torch.cuda.synchronize()

    run()
    with profile(activities=[ProfilerActivity.CUDA]):
        run()
    a, t0 = torch.randn(2048, 2048, device=dev), time.time()
    while time.time() - t0 < wait_s:
        for _ in range(20):
            a = (a @ a).clamp_(-1, 1)
        run()
        time.sleep(0.05)
    out = []
    for _ in range(n_traces):
        td = tempfile.mkdtemp()
        try:
            with profiling.torch_trace(td):
                run()
            raised = False
        except RuntimeError:
            raised = True
        with open(os.path.join(td, "trace.json")) as f:
            ev = json.load(f)["traceEvents"]
        _, lost = profiling.lost_launches(ev)
        (span,) = [e for e in ev if e.get("name") == profiling.BLOCK_SPAN
                   and e.get("cat") == "user_annotation"]
        done = {e["args"].get("correlation") for e in ev
                if e.get("cat") == "kernel"}
        pre = [e for e in ev if e.get("cat") == "cuda_runtime"
               and "Launch" in e["name"] and e["ts"] < span["ts"]]
        out.append((len(lost), raised, len(pre),
                    sum(e["args"].get("correlation") not in done
                        for e in pre)))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--wait", type=float, default=330.0)
    ap.add_argument("--traces", type=int, default=12)
    ap.add_argument("--child", nargs=2, type=float, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        profiling.PREROLL_LAUNCHES = int(args.child[0])
        profiling.PREROLL_S = args.child[1]
        print(json.dumps(_traces(args.wait, args.traces)), flush=True)
        return
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", __spec__.name, "--wait", str(args.wait),
         "--traces", str(args.traces), "--child", str(n), str(s)],
        stdout=subprocess.PIPE, text=True) for name, (n, s) in VARIANTS.items()}
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"{name}: exit {p.returncode}")
        print(json.dumps({"variant": name,
                          "preroll": VARIANTS[name],
                          "traces": json.loads(out.splitlines()[-1])}),
              flush=True)


if __name__ == "__main__":
    main()
