#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gps_jamming_tpu_torch) on one GPU.

    python3 chip_smoke.py              # the five phases below
    python3 chip_smoke.py --profile    # and a torch.profiler breakdown of
                                       # the main-path step after phase 4

Phases, in order; any failure raises and the exit code is non-zero:
1. the card: require CUDA, print torch, the device and nvidia-smi's name
   and power limit;
2. build the CUDA kernels from gps_jamming_tpu_torch/csrc/;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes (Welch PSD on one 512k-sample block; the PCF search at
   32 PRN x 2048 lags x 10 code periods in surface, stats and peak-only
   modes), with CUDA-event median times of both;
4. the main path: `entry.detect_acquire_step` over 8 consecutive 512k-sample
   blocks of a synthetic capture (noise, GPS PRN 7, a tone jammer in blocks
   3-5), then `acquire_all(method='pcf')` on the clean first 10 ms and
   `power_profile_file` on the same bytes, checked against the known
   answer and against the CPU plain path;
5. print the per-kernel JSON line, the card line, and the success line.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

FS = 2.048e6
N_BLOCK = 1 << 19                 # 512k samples = 256 ms
N_BLOCKS = 8                      # 2 s of capture
N_CODE = 2048
PRN = 7
CODE_PHASE = 1234                 # samples
DOPPLER_HZ = 3000.0
NOISE_LSB = 12.0                  # rms per I/Q component
SIGNAL_SNR_DB = -18.0             # per sample, ~45 dB-Hz C/N0
JAM_DB = 20.0                     # tone power over noise power
JAM_HZ = 250e3                    # PSD bin 125 at nperseg 1024
JAM_BLOCKS = (3, 4, 5)
REPS = 25                         # timed samples per kernel
INNER = 10                        # back-to-back calls per sample


def fail_unless(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_pair(kernel_fn, plain_fn, reps=REPS, inner=INNER):
    """Median ms per call of kernel_fn and plain_fn, run in turns: each of
    the `reps` samples is CUDA-event time over `inner` back-to-back calls
    (so host launch gaps hide behind queued work), divided by `inner`."""
    kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    tk, tp = [], []
    for _ in range(reps):
        for fn, acc in ((plain_fn, tp), (kernel_fn, tk)):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(inner):
                fn()
            e.record()
            e.synchronize()
            acc.append(s.elapsed_time(e) / inner)
    return statistics.median(tk), statistics.median(tp)


def close(got, ref, rtol, atol):
    """(ok, max_abs_err, max_rel_err) of got vs ref."""
    got, ref = got.double(), ref.double()
    err = (got - ref).abs()
    ok = bool((err <= atol + rtol * ref.abs()).all())
    rel = float((err / ref.abs().clamp(min=1e-30)).max())
    return ok, float(err.max()), rel


def profile_step(step, raw, steps=N_BLOCKS, top=12):
    """torch.profiler (CPU + CUDA activity) over `steps` back-to-back
    main-path steps after a warm-up: device time per step by kernel, and
    the device's busy share of the profiled window (summed kernel time over
    the window's host wall time; one stream, so kernels do not overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for b in range(steps):
        step(raw[b])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in range(steps):
            step(raw[b])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        rows.append((us / steps, ev.count // steps, ev.key))
    rows.sort(reverse=True)
    dev_us = sum(r[0] for r in rows)
    fail_unless(dev_us > 0, "profile: the trace shows no device time")
    print(f"profile: {steps} steps, device {dev_us:.1f} us/step, profiled "
          f"wall {wall_us / steps:.1f} us/step, busy share "
          f"{dev_us * steps / wall_us:.3f}; device work per step:",
          flush=True)
    for us, cnt, key in rows[:top]:
        print(f"  {us:9.1f} us {100 * us / dev_us:5.1f} %  x{cnt}  "
              f"{key[:90]}", flush=True)
    rest = rows[top:]
    print(f"  {sum(r[0] for r in rest):9.1f} us  the other {len(rest)} "
          f"kernels", flush=True)


def make_capture(rng) -> np.ndarray:
    """(N_BLOCKS, 2*N_BLOCK) uint8 interleaved I/Q: noise + PRN 7 at a
    known code phase and Doppler + a tone jammer in JAM_BLOCKS."""
    from gps_jamming_tpu_torch.ops import codes
    n = N_BLOCKS * N_BLOCK
    i = np.arange(n, dtype=np.float64)
    x = NOISE_LSB * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    amp = np.sqrt(2 * NOISE_LSB ** 2 * 10 ** (SIGNAL_SNR_DB / 10))
    chip = np.floor((i - CODE_PHASE) * (1.023e6 / FS)).astype(np.int64) % 1023
    code = codes.gps_ca_code(PRN).astype(np.float64)[chip]
    x += amp * code * np.exp(2j * np.pi * DOPPLER_HZ * i / FS)
    jam = np.sqrt(2 * NOISE_LSB ** 2 * 10 ** (JAM_DB / 10))
    for b in JAM_BLOCKS:
        sl = slice(b * N_BLOCK, (b + 1) * N_BLOCK)
        x[sl] += jam * np.exp(2j * np.pi * JAM_HZ * i[sl] / FS)
    inter = np.empty(2 * n, np.float64)
    inter[0::2], inter[1::2] = x.real, x.imag
    # RTL-SDR range: centered value -> clip to [-128, 127] -> +128
    u8 = (np.clip(inter, -128.0, 127.0).astype(np.int16) + 128).astype(
        np.uint8)
    return u8.reshape(N_BLOCKS, 2 * N_BLOCK)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print a torch.profiler breakdown of the "
                         "main-path step")
    args_cli = ap.parse_args()
    # 1. the card
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False)")
    from gps_jamming_tpu_torch import entry
    from gps_jamming_tpu_torch.device import require_cuda
    from gps_jamming_tpu_torch.kernels import build
    from gps_jamming_tpu_torch.models import detector
    from gps_jamming_tpu_torch.models.receiver import acquisition as acq
    from gps_jamming_tpu_torch.ops import codes, cuda_pcf, cuda_psd, iq
    CFG = entry.CFG

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = require_cuda()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device {name}; nvidia-smi: {card}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    lib_path = build.build()
    build.load()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    rng = np.random.default_rng(20261016)
    cap = make_capture(rng)
    raw = torch.from_numpy(iq.uint8_np_to_int8(cap)).to(dev)   # (8, 2n)
    x0 = iq.int8_to_complex(raw[0])
    replica = codes.gps_replica_table(FS, N_CODE, dev)
    kernels = []

    # 3a. kernel B2 vs plain on one clean 512k block
    got = cuda_psd.welch_psd_fused(x0, FS, 1024)
    ref = cuda_psd.welch_psd_reference(x0, FS, 1024)
    ok, abs_err, rel = close(got, ref, 1e-3, 1e-4 * float(ref.max()))
    ms, plain_ms = time_pair(lambda: cuda_psd.welch_psd_fused(x0, FS, 1024),
                             lambda: cuda_psd.welch_psd_reference(x0, FS,
                                                                  1024))
    print(f"B2 welch_psd n={N_BLOCK}: max_abs_err {abs_err:.3e} "
          f"max_rel_err {rel:.3e} (rtol 1e-3, atol 1e-4*max); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
    fail_unless(ok, "B2 disagrees with its plain version")
    kernels.append({"name": "welch_psd", "route": "cuda",
                    "source": "gps_jamming_tpu_torch/csrc/welch_psd.cu",
                    "replaces": "gps_jamming_tpu/ops/pallas_psd.py:99",
                    "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms})

    # 3b. kernel B1 vs plain, three modes, 32 PRN x 2048 x 10 periods
    blocks = x0[: 10 * N_CODE].reshape(10, N_CODE)
    y = cuda_pcf.pcf_prologue(blocks, FS)
    n_c = cuda_pcf.n_coarse(FS, N_CODE, 7000.0)
    excl = acq.exclusion_half_width(N_CODE, CFG.acquisition)
    args = (y, replica, n_c, 6, 2)
    ref_surf = cuda_pcf.pcf_search_reference(*args)
    surf = cuda_pcf.pcf_search(*args)
    ok, abs_err, rel = close(surf, ref_surf, 1e-3,
                             1e-4 * float(ref_surf.max()))
    ms, plain_ms = time_pair(lambda: cuda_pcf.pcf_search(*args),
                             lambda: cuda_pcf.pcf_search_reference(*args))
    print(f"B1 pcf surface {tuple(surf.shape)}: max_abs_err {abs_err:.3e} "
          f"max_rel_err {rel:.3e} (rtol 1e-3, atol 1e-4*max); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
    fail_unless(ok, "B1 surface disagrees with its plain version")
    modes = {"surface": {"max_abs_err": abs_err, "ms": ms,
                         "plain_ms": plain_ms}}
    top2 = ref_surf.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 1e-4 * top2[..., 0]
    for mode, ex in (("stats", excl), ("peak", -1)):
        got = cuda_pcf.pcf_search(*args, stats_excl=ex)
        ref = cuda_pcf.surface_stats(ref_surf, ex)
        same = got[1] == ref[1]
        fail_unless(bool(same[clear].all()),
                    f"B1 {mode}: arg-lag differs on a row with a clear peak")
        ok, abs_err, rel = close(got[0], ref[0], 1e-3, 0.0)
        fail_unless(ok, f"B1 {mode}: max disagrees (rel {rel:.3e})")
        if ex >= 0:
            # exclusion values are compared where both chose the same lag
            for j, what in ((2, "excluded max"), (3, "total"),
                            (4, "window sum")):
                sel = same if j != 3 else torch.ones_like(same)
                ok_j, _, rel_j = close(got[j][sel], ref[j][sel], 1e-3, 0.0)
                fail_unless(ok_j, f"B1 stats {what} disagrees "
                                  f"(rel {rel_j:.3e})")
        else:
            fail_unless(not any(bool(got[j].any()) for j in (2, 3, 4)),
                        "B1 peak-only: exclusion planes are not zero")
        ms, plain_ms = time_pair(
            lambda: cuda_pcf.pcf_search(*args, stats_excl=ex),
            lambda: cuda_pcf.surface_stats(
                cuda_pcf.pcf_search_reference(*args), ex))
        print(f"B1 pcf {mode} (excl {ex}): max_abs_err(max) {abs_err:.3e} "
              f"max_rel_err {rel:.3e}; arg-lag equal on "
              f"{int(same.sum())}/{same.numel()} rows "
              f"({int(clear.sum())} with a clear peak); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
        modes[mode] = {"max_abs_err": abs_err, "ms": ms,
                       "plain_ms": plain_ms}
    kernels.append({"name": "pcf", "route": "cuda",
                    "source": "gps_jamming_tpu_torch/csrc/pcf.cu",
                    "replaces": "gps_jamming_tpu/ops/pallas_caf.py:715",
                    "max_abs_err": modes["peak"]["max_abs_err"],
                    "ms": modes["peak"]["ms"],
                    "plain_ms": modes["peak"]["plain_ms"],
                    "modes": modes})

    # 4. the main path (warm-up pass first, then counters from zero)
    for b in range(N_BLOCKS):
        entry.detect_acquire_step(raw[b], replica)
    torch.cuda.synchronize()
    cuda_psd.LAUNCHES = 0
    cuda_pcf.LAUNCHES = 0
    step_s, outs = [], []
    for b in range(N_BLOCKS):
        t0 = time.perf_counter()
        out = entry.detect_acquire_step(raw[b], replica)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        outs.append(out)
    launches = {"welch_psd": cuda_psd.LAUNCHES, "pcf": cuda_pcf.LAUNCHES}
    fail_unless(launches == {"welch_psd": N_BLOCKS, "pcf": N_BLOCKS},
                f"main path: expected {N_BLOCKS} launches of each kernel, "
                f"got {launches}")
    # the receiver's acquisition (B1 in stats mode) and entry()'s forward
    # (B2 + B1 surface), counted apart from the main path
    cuda_psd.LAUNCHES = 0
    cuda_pcf.LAUNCHES = 0
    res = acq.acquire_all(blocks, replica, FS, CFG.acquisition,
                          method="pcf")
    acq_launches = cuda_pcf.LAUNCHES
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "capture.bin")
        cap.tofile(path)
        prof = detector.power_profile_file(path, CFG.detector, device=dev)
        ranges = detector.power_profile_ranges(prof, CFG.detector)
    cuda_psd.LAUNCHES = 0
    cuda_pcf.LAUNCHES = 0
    fwd, (raw_ex,) = entry.entry(dev)
    fwd_out = fwd(raw_ex)
    torch.cuda.synchronize()
    fwd_launches = {"welch_psd": cuda_psd.LAUNCHES, "pcf": cuda_pcf.LAUNCHES}
    fail_unless(acq_launches == 1, f"acquire_all: {acq_launches} B1 "
                                   "launches, expected 1")
    fail_unless(fwd_launches == {"welch_psd": 1, "pcf": 1},
                f"entry forward: launches {fwd_launches}, expected 1 each")

    for b, (psd, pm, flags, peak) in enumerate(outs):
        fail_unless(psd.shape == (1024,) and pm.shape == (16,)
                    and flags.shape == (16,) and peak.shape == (32,),
                    f"block {b}: unexpected output shapes")
        fail_unless(bool(torch.isfinite(psd).all() & torch.isfinite(pm).all()
                         & torch.isfinite(peak).all()),
                    f"block {b}: non-finite output")
        if b not in JAM_BLOCKS:
            fail_unless(int(peak.argmax()) == PRN - 1,
                        f"clean block {b}: strongest PRN is "
                        f"{int(peak.argmax()) + 1}, not {PRN}")
    tone_bin = int(round(JAM_HZ / (FS / 1024)))
    for b in JAM_BLOCKS:
        fail_unless(int(outs[b][0].argmax()) == tone_bin,
                    f"jammed block {b}: PSD argmax "
                    f"{int(outs[b][0].argmax())} != tone bin {tone_bin}")
    p = PRN - 1
    code_err = int(res.code_phase[p]) - CODE_PHASE
    dopp_err = float(res.doppler_hz[p]) - DOPPLER_HZ
    print(f"acquire_all(pcf): PRN {PRN} acquired={bool(res.acquired[p])} "
          f"code_phase={int(res.code_phase[p])} (true {CODE_PHASE}) "
          f"doppler={float(res.doppler_hz[p]):.1f} Hz (true {DOPPLER_HZ}) "
          f"ratio={float(res.peak_ratio[p]):.2f} "
          f"cn0={float(res.cn0_dbhz[p]):.2f} dB-Hz; acquired PRNs "
          f"{[i + 1 for i in torch.nonzero(res.acquired).flatten().tolist()]}",
          flush=True)
    fail_unless(bool(res.acquired[p]), f"PRN {PRN} not acquired")
    fail_unless(abs(code_err) <= 1, f"code phase off by {code_err}")
    fail_unless(abs(dopp_err) <= 150.0, f"Doppler off by {dopp_err} Hz")
    want_ranges = [(JAM_BLOCKS[0] * 2 * N_BLOCK,
                    (JAM_BLOCKS[-1] + 1) * 2 * N_BLOCK)]
    print(f"power_profile_file: ranges {ranges} (jammer {want_ranges})",
          flush=True)
    fail_unless(ranges == want_ranges, "power ranges miss the jammer")

    # the card's main path against the CPU plain path on the same bytes
    cpu_out = entry.detect_acquire_step(raw[0].cpu())
    for nm, g, r, tol in zip(("psd", "pm", "flags", "peak"), outs[0],
                             cpu_out, (1e-3, 1e-4, 0.0, 1e-3)):
        if nm == "flags":
            fail_unless(bool((g.cpu() == r).all()), "flags differ from CPU")
            continue
        ok, abs_err, rel = close(g.cpu(), r, tol, tol * float(r.abs().max()))
        fail_unless(ok, f"step {nm} differs from the CPU path (rel {rel:.3e})")
    fwd_cpu = entry.entry("cpu")[0](raw_ex.cpu())
    for nm, g, r in zip(("psd", "pm", "flags", "surf"), fwd_out, fwd_cpu):
        if nm == "flags":
            fail_unless(bool((g.cpu() == r).all()), "forward flags differ")
            continue
        ok, abs_err, rel = close(g.cpu(), r, 1e-3, 1e-4 * float(r.max()))
        fail_unless(ok, f"forward {nm} differs from the CPU path "
                        f"(max_abs_err {abs_err:.3e})")
    med = statistics.median(step_s)
    print(f"main path: detect_acquire_step x{N_BLOCKS} blocks of {N_BLOCK} "
          f"samples: median {med * 1e3:.3f} ms/block "
          f"({N_BLOCK / med / 1e6:.1f} Msamples/s); steps ms "
          f"{[round(s * 1e3, 3) for s in step_s]}; main-path launches "
          f"{launches}; acquire_all B1 launches {acq_launches}; entry "
          f"forward launches {fwd_launches}; card {card}", flush=True)
    if args_cli.profile:
        profile_step(lambda r: entry.detect_acquire_step(r, replica), raw)

    # 5. results
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
