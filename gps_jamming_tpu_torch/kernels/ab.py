"""Kernels B1, B2 and B3 of this tree against another checkout's, on one
card, timed in turns: other, this, this, other.

    python3 -m gps_jamming_tpu_torch.kernels.ab OTHER_ROOT [--only B3]

OTHER_ROOT is the root of another checkout of the repo (for example the
parent commit, unpacked by `git archive` into a directory that .gitignore
lists). Its `gps_jamming_tpu_torch/kernels/build.py` is loaded by file path,
so it builds its own csrc/ into its own _build/. B2's and B3's C entry
points (`gjt_welch_psd`, `gjt_caf_std`, through today's C signatures,
which the other tree must share) get the same seeded inputs at the shapes
of chip_smoke.py phases 3a-3d: B2 on a 512k-sample block at nperseg 1024
and 1536; B3 (32 PRN x 71 bins x 10 periods) at 2048, 2400, 2560, 2800,
3200 and 10368 lags, and Galileo E1B's 36 PRN at 16384; and, above 16384,
the four-step entry points (`gjt_welch_psd_large`, `gjt_caf_std_large`) at
the shapes of phase 10: B2 on 8 192 512 samples at nperseg 32768 and
131072, B3 at 32768 (36 x 71 x 10) and at 32000, 65536 and 131072 (8 PRN
x 35 bins x 4), and B3 at 128 (32 PRN). B1 goes through each tree's
wrapper, `ops.cuda_pcf.caf_accumulate_pcf_fused`, on 10 code periods, so
that a tree whose prologue runs as PyTorch operators before the kernel is
timed with them: peak-only (32 PRN x 15 coarse x 6 rows x 2 groups) at
2048, 2400, 2560, 2800, 3200 and 128 lags, and its statistics, peak-only
and surface modes on Galileo E1B at 8.192 MS/s (36 PRN x 57 coarse x 6
rows x 2 groups at 32768); "B1 monitor" is the monitor step's acquire
stage at 2048 (GPS, 32 PRN) and 32768 (Galileo E1B, 36 PRN), the per-PRN
peak over a block's first 10 periods: `pcf_peak_per_prn`, or, in a tree
without it, the peak-only statistics' max over rows. B2's and B3's large
entry points get the scratch chunks of each tree's own wrappers
(`large_seg_chunk`, `large_chunks`). A shape the other tree refuses is
timed on this tree alone. Each reading is the median over
`--reps` samples of CUDA-event time over `--inner` back-to-back calls,
divided by `--inner`; beside it, in the same turns, the device time of
the calls' kernels per call (`torch.profiler` over `--inner` calls),
which leaves out the gaps between launches that event time counts, and
each kernel's share of it. Prints one line per shape, then one JSON
object; needs a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from . import build

SHAPES = (("B2", 1024), ("B2", 1536),
          ("B1 peak", 2048), ("B1 peak", 2400), ("B1 peak", 2560),
          ("B1 peak", 2800), ("B1 peak", 3200),
          ("B3", 2048), ("B3", 2400), ("B3", 2560), ("B3", 2800),
          ("B3", 3200), ("B3", 10368), ("B3", 16384),
          ("B2", 32768), ("B2", 131072), ("B1 stats", 32768),
          ("B1 peak", 32768), ("B1 surface", 32768),
          ("B3", 32768), ("B3", 32000), ("B3", 65536), ("B3", 131072),
          ("B1 peak", 128), ("B3", 128), ("B1 monitor", 2048),
          ("B1 monitor", 32768))
B2_SAMPLES = 1 << 19
B2_LARGE_SAMPLES = 8_192_512          # above 16384 points per segment


def _other_build(root: Path):
    """The other checkout's `kernels.build`, its package loaded under the
    name gjt_other so that its relative imports resolve in that tree."""
    pkg_dir = root / "gps_jamming_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "gjt_other", pkg_dir / "__init__.py",
        submodule_search_locations=[str(pkg_dir)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules["gjt_other"] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module("gjt_other.kernels.build")


def _cplx(shape, seed, dev):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return torch.from_numpy(x.astype(np.complex64)).to(dev)


def _welch_inputs(n: int, samples: int, dev):
    """Kernel B2's seeded signal of `samples` samples at nperseg n, its
    Hann window, its number of segments and its output row."""
    x = _cplx(samples, n, dev)
    win = torch.from_numpy((0.5 - 0.5 * np.cos(
        2.0 * np.pi * np.arange(n) / n)).astype(np.float32)).to(dev)
    return (x, win, 1 + (samples - n) // (n // 2),
            torch.empty(n, dtype=torch.float32, device=dev))


def _large(mod, lib, what: str, n: int, dev, stream):
    """`what` above 16384 through the four-step entry points of `mod`'s
    library, with the scratch chunks of that tree's own wrappers."""
    pkg = mod.__name__.rsplit(".kernels", 1)[0]
    cuda_caf = importlib.import_module(f"{pkg}.ops.cuda_caf")
    cuda_psd = importlib.import_module(f"{pkg}.ops.cuda_psd")
    tw2 = mod.large_row_twiddles(n, dev)
    twn = mod.reg_twiddles(n, dev)
    if what == "B2":
        x, win, n_segs, out = _welch_inputs(n, B2_LARGE_SAMPLES, dev)
        chunk = cuda_psd.large_seg_chunk(n, n_segs)
        A = torch.empty((chunk, n), dtype=torch.complex64, device=dev)
        pw = torch.empty((chunk, n), dtype=torch.float32, device=dev)
        half = torch.empty(n_segs + 1, dtype=torch.complex64, device=dev)
        acc = torch.empty(n, dtype=torch.float32, device=dev)

        def fn():
            return lib.gjt_welch_psd_large(
                x.data_ptr(), win.data_ptr(), tw2.data_ptr(), twn.data_ptr(),
                A.data_ptr(), pw.data_ptr(), half.data_ptr(), acc.data_ptr(),
                out.data_ptr(), n, n_segs, chunk, 1, 1.0 / n_segs, stream)
        return fn, out
    n_f, nb, n_prn = (71, 10, 36) if n == 32768 else (35, 4, 8)
    x = _cplx((nb, n), n + 2, dev)
    osc = _cplx((n_f, n), n + 3, dev)
    rep = _cplx((n_prn, n), n + 4, dev)
    bins, cells = cuda_caf.large_chunks(n, nb, n_f, n_prn)
    Y = torch.empty((bins * nb, n), dtype=torch.complex64, device=dev)
    Bs = torch.empty((cells * nb, n), dtype=torch.complex64,
                     device=dev) if cells else None
    out = torch.empty((n_prn, n_f, n), dtype=torch.float32, device=dev)

    def fn():
        return lib.gjt_caf_std_large(
            x.data_ptr(), osc.data_ptr(), Y.data_ptr(),
            Bs.data_ptr() if cells else None, rep.data_ptr(), tw2.data_ptr(),
            twn.data_ptr(), out.data_ptr(), n_f, nb, n_prn, n, bins, cells,
            stream)
    return fn, out


def _b1(mod, what: str, n: int, dev):
    """(a closure, its output) of B1 at n through the wrapper of build
    module `mod`'s tree: 10 code periods, 32 PRN at n * 1 kHz (GPS) or, at
    32768, 36 PRN at 8.192 MS/s (Galileo E1B), +/-7 kHz. Raises
    RuntimeError where that tree cannot run it."""
    pkg = mod.__name__.rsplit(".kernels", 1)[0]
    cuda_pcf = importlib.import_module(f"{pkg}.ops.cuda_pcf")
    n_prn, fs = (36, 8.192e6) if n == 32768 else (32, n * 1e3)
    x = _cplx(10 * n, n, dev)
    rep = _cplx((n_prn, n), n + 1, dev)
    res = []
    if what == "B1 monitor":
        per_prn = getattr(cuda_pcf, "pcf_peak_per_prn", None)

        def fn():
            if per_prn is not None:
                res[:] = [per_prn(x, rep, fs, 10)]
            else:
                res[:] = [cuda_pcf.caf_accumulate_pcf_fused(
                    x.reshape(10, n), rep, fs, stats_excl=-1)[0].amax(-1)]
    else:
        excl = {"B1 stats": 16, "B1 peak": -1, "B1 surface": None}[what]

        def fn():
            res[:] = [cuda_pcf.caf_accumulate_pcf_fused(
                x.reshape(10, n), rep, fs, stats_excl=excl)]
    try:
        fn()
    except (ValueError, TypeError) as e:
        raise RuntimeError(f"{what} n={n}: {e}") from e
    torch.cuda.synchronize()
    out = res[0]
    return fn, out if torch.is_tensor(out) else torch.stack(out)


def _call(mod, what: str, n: int, dev):
    """A closure launching `what` at n through the library of build module
    `mod`, with its own twiddle table (B1: through that tree's wrapper,
    `_b1`); inputs are seeded, so both libraries see the same ones. Raises
    if the kernel refuses n."""
    if what.startswith("B1"):
        return _b1(mod, what, n, dev)
    lib = mod.load()
    stream = torch.cuda.current_stream().cuda_stream
    if n > 16384:
        fn, out = _large(mod, lib, what, n, dev, stream)
    elif what == "B2":
        x, win, n_segs, out = _welch_inputs(n, B2_SAMPLES, dev)
        tab = mod.reg_twiddles(n, dev)
        scratch = torch.zeros(lib.gjt_welch_scratch_bytes(n),
                              dtype=torch.uint8, device=dev)

        def fn():
            return lib.gjt_welch_psd(
                x.data_ptr(), win.data_ptr(), tab.data_ptr(),
                scratch.data_ptr(), out.data_ptr(), n, n_segs, 1,
                1.0 / n_segs, stream)
    else:
        n_f, nb, n_prn = 71, 10, (36 if n == 16384 else 32)
        x = _cplx((nb, n), n + 2, dev)
        osc = _cplx((n_f, n), n + 3, dev)
        rep = _cplx((n_prn, n), n + 4, dev)
        Y = torch.empty((n_f * nb, n), dtype=torch.complex64, device=dev)
        out = torch.empty((n_prn, n_f, n), dtype=torch.float32, device=dev)
        tw = mod.row_twiddles(n, dev)

        def fn():
            return lib.gjt_caf_std(x.data_ptr(), osc.data_ptr(), Y.data_ptr(),
                                   rep.data_ptr(), tw.data_ptr(),
                                   out.data_ptr(), n_f, nb, n_prn, n, stream)
    err = fn()
    torch.cuda.synchronize()
    if err:
        raise RuntimeError(f"{what} n={n}: {torch.cuda.CudaError(err)}")
    return fn, out


def _median_ms(fn, reps: int, inner: int) -> float:
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(inner):
            fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e) / inner)
    return statistics.median(ts)


def _device_ms(fn, calls: int) -> tuple[float, dict]:
    """The summed device time of the kernels of one call, ms, and each
    kernel's (by name), from torch.profiler over `calls` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per = {ev.key: ev.self_device_time_total / calls / 1000.0
           for ev in prof.key_averages()
           if ev.device_type == DeviceType.CUDA
           and ev.self_device_time_total > 0}
    return sum(per.values()), per


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, help="root of the other checkout")
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--inner", type=int, default=10)
    ap.add_argument("--only", default="",
                    help="time only the kernels whose name starts so")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab: no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    mods = {"other": _other_build(args.other.resolve()), "this": build}
    for m in mods.values():
        m.build()
    rows = []
    for what, n in (sh for sh in SHAPES if sh[0].startswith(args.only)):
        inner = args.inner if n <= 4096 else max(args.inner // 3, 1)
        calls = {"this": _call(build, what, n, dev)}
        try:
            calls["other"] = _call(mods["other"], what, n, dev)
        except RuntimeError as e:
            ms = _median_ms(calls["this"][0], args.reps, inner)
            rows.append({"kernel": what, "n": n, "this_ms": ms,
                         "other": str(e)})
            print(f"{what} n={n}: this {ms:.4f} ms; the other tree refuses "
                  f"it ({e}); card {card}", flush=True)
            continue
        diff = float((calls["this"][1] - calls["other"][1]).abs().max()
                     / calls["other"][1].abs().max())
        fns = {k: c[0] for k, c in calls.items()}
        turns = ("other", "this", "this", "other")
        ms = [_median_ms(fns[k], args.reps, inner) for k in turns]
        dev_kernels = [_device_ms(fns[k], inner) for k in turns]
        dms = [d[0] for d in dev_kernels]
        rows.append({"kernel": what, "n": n, "other_this_this_other_ms": ms,
                     "device_kernels_ms": {"other": dev_kernels[0][1],
                                           "this": dev_kernels[1][1]},
                     "change": (ms[1] + ms[2]) / (ms[0] + ms[3]) - 1.0,
                     "device_ms": dms,
                     "device_change": (dms[1] + dms[2]) / (dms[0] + dms[3])
                     - 1.0,
                     "max_rel_diff": diff})
        print(f"{what} n={n}: other, this, this, other ms "
              f"{', '.join(f'{t:.4f}' for t in ms)}; this/other "
              f"{(ms[1] + ms[2]) / (ms[0] + ms[3]):.4f}; device "
              f"{', '.join(f'{t:.4f}' for t in dms)}, this/other "
              f"{(dms[1] + dms[2]) / (dms[0] + dms[3]):.4f}; outputs differ "
              f"by {diff:.2e} of their max; card {card}", flush=True)
        del calls, fns
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "ab": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
