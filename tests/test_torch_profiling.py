"""The port's profiling module, `caf_pair` and `lagrange_interp`, on the
CPU.

- `EventLog`, `Profiler`, `sync` and `torch_trace`
  (gps_jamming_tpu_torch.runtime.profiling), as tests/test_profiling.py
  holds the JAX package's: the ring and its JSONL file, stage counts and
  samples/s, a sync over a nesting of tensors and other leaves, and a
  Chrome trace written and non-empty; the trace's block span and
  `lost_launches` on a host trace and on made-up events.
- `ops.caf.caf_pair` against the JAX package's on the same seeded pair
  (rtol 3e-3, atol 1e-3 * max: float32 FFTs of another factorization),
  and the delay and Doppler of its peak.
- `ops.interp.lagrange_interp` against the JAX package's on
  tests/test_geodesy.py's cases (rtol 1e-5).
"""
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gps_jamming_tpu.ops import caf as jcaf
from gps_jamming_tpu.ops import interp as jinterp
from gps_jamming_tpu_torch.ops import caf, interp
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
