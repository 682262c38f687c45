"""Run one cell of the benchmark once and print its result line.

    python3 gjt_bench/run.py --workload gps.monitor --seed 7 --seconds 30 \
        --trace 0

from the root of a checkout that holds the program. The last line of
standard output is the JSON result; the numbers the correctness check
compared, each beside its limit, are the last lines of standard error.
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")
    # the port's nvcc builds land in its own _build/ inside the checkout;
    # keep any other compiler cache there too, at a fixed path
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "gjt_bench" / "_cache"
                                         / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "gjt_bench" / "_cache"
                                             / "torch_ext")
    sys.path.insert(0, str(ROOT))
    from gjt_bench import harness
    return harness.run(args.workload, args.seed, args.seconds,
                       bool(args.trace))


if __name__ == "__main__":
    sys.exit(main())
