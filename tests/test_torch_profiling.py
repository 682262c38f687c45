"""The port's profiling module, `caf_pair` and `lagrange_interp`, on the
CPU.

- `EventLog`, `Profiler`, `sync` and `torch_trace`
  (gps_jamming_tpu_torch.runtime.profiling), as tests/test_profiling.py
  holds the JAX package's: the ring and its JSONL file, stage counts and
  samples/s, a sync over a nesting of tensors and other leaves, and a
  Chrome trace written and non-empty; the trace's block span and
  `lost_launches` on a host trace and on made-up events.
- `span` and `SPANS`: outside a profiler one shared no-op context that
  makes no RecordFunction; under a host profiler one monitor step on CPU
  tensors records `gjt.step` with its three stages inside it, in order,
  and no kernel launch span; the names keep clear of the benchmark's own
  spans and of the kernel names its roofline metrics match; the kernel
  wrappers import `runtime.profiling` with no import cycle.
- `ops.caf.caf_pair` against the JAX package's on the same seeded pair
  (rtol 3e-3, atol 1e-3 * max: float32 FFTs of another factorization),
  and the delay and Doppler of its peak.
- `ops.interp.lagrange_interp` against the JAX package's on
  tests/test_geodesy.py's cases (rtol 1e-5).
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gps_jamming_tpu.ops import caf as jcaf
from gps_jamming_tpu.ops import interp as jinterp
from gps_jamming_tpu_torch import entry
from gps_jamming_tpu_torch.ops import caf, codes, interp, iq
from gps_jamming_tpu_torch.runtime import profiling

torch.set_num_threads(2)


def test_event_log_ring_and_jsonl(tmp_path):
    path = os.path.join(tmp_path, "events.jsonl")
    log = profiling.EventLog(path, ring_size=5)
    for i in range(8):
        log.emit("tick", i=i, v=np.float32(0.5), a=np.arange(2))
    tail = log.tail()
    assert len(tail) == 5 and tail[-1]["i"] == 7
    log.close()
    lines = [json.loads(line) for line in open(path)]
    assert len(lines) == 8
    assert all(ln["kind"] == "tick" and ln["a"] == [0, 1] for ln in lines)


def test_profiler_stage_counts_samples():
    prof = profiling.Profiler(profiling.EventLog())
    x = torch.arange(1024, dtype=torch.float32)
    for _ in range(2):
        with prof.stage("double", n_samples=1024) as box:
            box["out"] = (x * 2.0).sum()
    rep = prof.report()
    assert rep[0]["stage"] == "double"
    assert rep[0]["calls"] == 2
    assert rep[0]["samples_per_s"] > 0
    assert prof.log.tail()[-1]["kind"] == "stage"


def test_sync_walks_nested_results():
    out = {"a": torch.ones((4, 4)), "b": (torch.zeros(3), 1.5, [None]),
           "c": np.zeros(2)}
    profiling.sync(out)          # must not raise on mixed nestings


def test_torch_trace_writes_a_chrome_trace(tmp_path):
    with profiling.torch_trace(str(tmp_path), device="cpu"):
        torch.fft.fft(torch.ones(256, dtype=torch.complex64)).abs().sum()
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("fft" in str(ev.get("name", "")) for ev in events)


def test_torch_trace_marks_its_block(tmp_path):
    """The block runs inside one BLOCK_SPAN span, and the ops it ran lie in
    it; a host-only trace launches nothing, so nothing is lost."""
    with profiling.torch_trace(str(tmp_path), device="cpu"):
        torch.fft.fft(torch.ones(256, dtype=torch.complex64))
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    (span,) = [e for e in events if e.get("name") == profiling.BLOCK_SPAN]
    fft = [e for e in events if "fft" in str(e.get("name", ""))]
    assert fft and all(span["ts"] <= e["ts"] <= span["ts"] + span["dur"]
                       for e in fft)
    assert profiling.lost_launches(events) == (0, [])


def test_lost_launches_pairs_launches_with_kernel_records():
    """A launch inside the block whose kernel record (same correlation) is
    missing is lost; launches outside the block and other runtime calls
    are not counted; a trace without the block's span raises."""
    def ev(cat, name, ts, corr=None, dur=1.0):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": {} if corr is None else {"correlation": corr}}
    events = [
        ev("user_annotation", profiling.BLOCK_SPAN, 100.0, dur=50.0),
        ev("cuda_runtime", "cudaLaunchKernel", 90.0, corr=1),   # pre-roll
        ev("cuda_runtime", "cudaLaunchKernel", 110.0, corr=2),
        ev("kernel", "gjt::reg_forward_kernel<2048>", 111.0, corr=2),
        ev("cuda_runtime", "cudaLaunchKernelExC", 120.0, corr=3),
        ev("cuda_driver", "cuLaunchKernel", 130.0, corr=4),
        ev("kernel", "triton_kernel", 131.0, corr=4),
        ev("cuda_runtime", "cudaMemcpyAsync", 140.0, corr=5),
    ]
    assert profiling.lost_launches(events) == (3, ["cudaLaunchKernelExC"])
    events.append(ev("kernel", "gemm", 121.0, corr=3))
    assert profiling.lost_launches(events) == (3, [])
    with pytest.raises(ValueError, match="0 'torch_trace' spans"):
        profiling.lost_launches(events[1:])


def test_span_outside_a_profiler_is_one_no_op(monkeypatch):
    """Without a running profiler a span is the same shared context every
    time and never reaches `record_function`."""
    def no_record(*a, **k):
        raise AssertionError("a span made a RecordFunction")
    monkeypatch.setattr(torch.profiler, "record_function", no_record)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        no_record)
    first = profiling.span("gjt.step")
    assert profiling.span("gjt.b1.launch") is first
    with first:
        with profiling.span("gjt.step.psd"):
            pass


def test_monitor_step_spans_nest_on_the_cpu():
    """One step of 65 536 samples (two power chunks) under a host profiler:
    one `gjt.step`, its three stages inside it in the order they run, and no
    launch span, since the CPU runs the kernels' plain versions."""
    rng = np.random.default_rng(3)
    raw = torch.from_numpy(iq.uint8_np_to_int8(
        rng.integers(0, 256, 2 * 65536, dtype=np.uint8)))
    replica = codes.gps_replica_table(entry.FS, entry.N_CODE, "cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = entry.detect_acquire_step(raw, replica)
    assert out[1].shape == (2,)
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("gjt."))
    (step,) = [sp for sp in spans if sp[2] == "gjt.step"]
    stages = [sp for sp in spans if sp[2] != "gjt.step"]
    assert [sp[2] for sp in stages] == ["gjt.step.ingest", "gjt.step.psd",
                                        "gjt.step.acquire"]
    assert all(step[0] <= s and e <= step[1] for s, e, _ in stages)
    assert all(a[1] <= b[0] for a, b in zip(stages, stages[1:]))


def test_span_names_keep_clear_of_the_benchmark():
    """Every span is named in SPANS, starts with "gjt.", is none of the
    benchmark's own spans and holds no kernel name that a roofline metric
    matches; every span the package opens is one of SPANS."""
    names = profiling.SPANS
    assert len(set(names)) == len(names)
    for name in names:
        assert name.startswith("gjt.")
        assert name not in ("gjt.window", "gjt.block")
        assert not any(k in name for k in ("welch_", "pcf_correlate",
                                           "pcf_forward_kernel",
                                           "reg_forward_kernel"))
    pkg = Path(profiling.__file__).resolve().parents[1]
    opened = set()
    for path in pkg.rglob("*.py"):
        opened |= set(re.findall(r'span\("([^"]+)"\)', path.read_text()))
    assert opened == set(names)


@pytest.mark.parametrize("module", ["gps_jamming_tpu_torch.ops.cuda_pcf",
                                    "gps_jamming_tpu_torch.ops.cuda_psd",
                                    "gps_jamming_tpu_torch.entry"])
def test_span_users_import_alone(module):
    """A module that opens spans imports first in a fresh interpreter: the
    kernel wrappers import `runtime.profiling` with no import cycle."""
    root = Path(profiling.__file__).resolve().parents[2]
    subprocess.run([sys.executable, "-c", f"import {module}"], cwd=root,
                   check=True, timeout=120)


def test_caf_pair_matches_jax():
    rng = np.random.default_rng(8)
    n, fs, delay, dopp = 1024, 2.048e6, 37, 3000.0
    s = (rng.standard_normal(n + delay)
         + 1j * rng.standard_normal(n + delay)).astype(np.complex64)
    t = np.arange(n) / fs
    b = s[delay:delay + n]
    a = (s[:n] * np.exp(2j * np.pi * dopp * t)).astype(np.complex64)
    freqs = np.arange(-5000.0, 5001.0, 1000.0, dtype=np.float32)
    want = np.asarray(jcaf.caf_pair(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(freqs), fs))
    got = caf.caf_pair(torch.from_numpy(a), torch.from_numpy(b), freqs,
                       fs).numpy()
    assert got.shape == want.shape == (freqs.size, 2 * n)
    np.testing.assert_allclose(got, want, rtol=3e-3, atol=1e-3 * want.max())
    f_i, lag = np.unravel_index(np.argmax(got), got.shape)
    assert freqs[f_i] == dopp and lag == delay      # b = a advanced


@pytest.mark.parametrize("x,fn,xq", [
    ([0.0, 1.0, 2.0, 3.0], lambda v: 2.0 * v ** 3 - v + 1.0, 1.5),
    ([0.0, 1.0, 2.0], lambda v: v ** 2, [0.5, 1.5])])
def test_lagrange_interp_matches_jax(x, fn, xq):
    x = np.asarray(x)
    want = np.asarray(jinterp.lagrange_interp(jnp.asarray(x),
                                              jnp.asarray(fn(x)), xq))
    got = interp.lagrange_interp(torch.from_numpy(x.astype(np.float32)),
                                 torch.from_numpy(fn(x).astype(np.float32)),
                                 xq).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, fn(np.asarray(xq)), rtol=1e-5)
