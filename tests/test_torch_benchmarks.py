"""The port's benchmark harness (`gps_jamming_tpu_torch.runtime.benchmarks`
and the `benchmark` verb) against the JAX package's, on the CPU.

Tolerances: the flagship chain as tests/test_torch_entry.py's slice (psd
rtol 1e-4 + atol 1e-4 * max, pm rtol 1e-6, flags equal, peak rtol 2e-4);
the benchmark captures equal (both simulators draw the same noise from
np.random.default_rng(seed) in float64); the weak-scaling step and chain
rtol 1e-4; `_slope_time` and weak_scaling's rows equal.
"""
import collections
import json
import re
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from gps_jamming_tpu import cli as jcli
from gps_jamming_tpu.config import DetectorConfig as JDetectorConfig
from gps_jamming_tpu.config import SpectralConfig as JSpectralConfig
from gps_jamming_tpu.ops import caf as jcaf
from gps_jamming_tpu.ops import cplx as jcplx
from gps_jamming_tpu.parallel import fusion as jfusion
from gps_jamming_tpu.parallel import mesh as jmesh
from gps_jamming_tpu.runtime import benchmarks as jbench
from gps_jamming_tpu.runtime import rx_stream as jrx_stream
from gps_jamming_tpu_torch import cli
from gps_jamming_tpu_torch.ops import codes
from gps_jamming_tpu_torch.runtime import benchmarks
from gps_jamming_tpu_torch.runtime import rx_stream

torch.set_num_threads(2)

SCALING_KEYS = {"n_devices", "mesh", "chain_step_s",
                "chain_msamples_per_s_per_device", "step_s",
                "msamples_per_s", "msamples_per_s_per_device"}


@pytest.fixture
def fake_clock(monkeypatch):
    """time.perf_counter advancing 0.25 ms per read and 1.5 ms per step of
    the fake step below, so a run of n steps takes a known time; the
    step's first argument 'start' restarts the clock at 0."""
    clock = types.SimpleNamespace(t=0.0)

    def perf_counter():
        clock.t += 2.5e-4
        return clock.t

    def step(x, scale):
        if x == "start":
            clock.t, x = 0.0, 1.0
        clock.t += 1.5e-3 * scale
        return (torch.full((3,), x), {"a": torch.ones(2) * x},
                types.SimpleNamespace(skipped=1))

    monkeypatch.setattr("time.perf_counter", perf_counter)
    return step


@pytest.mark.parametrize("kw", [{}, {"n_lo": 1, "n_hi": 5, "reps": 2}])
def test_slope_time_matches_jax(fake_clock, kw):
    calls = []

    def step(x, scale):
        calls.append(x)
        return fake_clock("start" if len(calls) == 1 else x, scale)

    want = jbench._slope_time(step, 2.0, 1.0, **kw)
    n_calls = len(calls)
    calls.clear()
    got = benchmarks._slope_time(step, 2.0, 1.0, **kw)
    assert got == want and len(calls) == n_calls
    assert got == pytest.approx(1.5e-3)
    # a step that costs nothing is clamped to 1e-9 s by both
    assert benchmarks._slope_time(fake_clock, 2.0, 0.0, **kw) == \
        jbench._slope_time(fake_clock, 2.0, 0.0, **kw) == 1e-9


def test_fetch_reads_every_tensor_of_the_tree():
    Pair = collections.namedtuple("Pair", "values indices")
    nt = Pair(torch.ones(2), torch.zeros(2))
    tree = ({"a": torch.ones(1), "b": [torch.zeros(1), 3]}, nt,
            types.SimpleNamespace(x=1))
    got = benchmarks._fetch(tree)
    assert isinstance(got[0]["b"], list) and got[0]["b"][1] == 3
    assert type(got[1]) is Pair and torch.equal(got[1].values,
                                                torch.ones(2))
    assert got[2] is tree[2]


def test_flagship_chain_matches_bench():
    jfn, jraw, jn = bench._build_tpu_chain(n_scan=2)
    want = [np.asarray(a) for a in jfn(jraw)]
    fn, raw, n = benchmarks._build_chain(n_scan=2, device="cpu")
    assert n == jn == 2 * (1 << 19)
    np.testing.assert_array_equal(raw.numpy(), np.asarray(jraw))
    psd, pm, flags, peak = [a.numpy() for a in fn(raw)]
    assert psd.shape == want[0].shape == (2, 1024)
    assert peak.shape == want[3].shape == (2, 32)
    np.testing.assert_allclose(psd, want[0], rtol=1e-4,
                               atol=1e-4 * want[0].max())
    np.testing.assert_allclose(pm, want[1], rtol=1e-6)
    np.testing.assert_array_equal(flags, want[2])
    np.testing.assert_allclose(peak, want[3], rtol=2e-4)


def test_time_chain_and_single_chip_keys(monkeypatch):
    fn, raw, n = benchmarks._build_chain(n_scan=1, device="cpu")
    msps = benchmarks._time_chain(fn, raw, n, n_lo=1, n_hi=2, reps=1)
    assert msps > 0
    build, time_chain = benchmarks._build_chain, benchmarks._time_chain
    monkeypatch.setattr(benchmarks, "_build_chain",
                        lambda device: build(n_scan=1, device=device))
    monkeypatch.setattr(benchmarks, "_time_chain",
                        lambda *a: time_chain(*a, n_lo=1, n_hi=2, reps=1))
    row = benchmarks.single_chip(device="cpu")
    assert set(row) == {"metric", "backend", "msamples_per_s_per_chip"}
    assert row["metric"] == "iq_detect_acquire_throughput"
    assert row["backend"] == "cpu" and row["msamples_per_s_per_chip"] > 0


@pytest.mark.parametrize("system", ["gps", "galileo", "glonass"])
def test_bench_capture_equals_the_jax_packages(system):
    want, wfs = jbench._bench_capture(system, 0.01)
    got, fs = benchmarks._bench_capture(system, 0.01)
    assert fs == wfs and got.dtype == want.dtype == np.complex64
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown system"):
        benchmarks._bench_capture("beidou", 0.01)


def test_receiver_chain_keys_and_counts(monkeypatch):
    # both packages on the 12-slot plan of tests/conftest.py
    monkeypatch.setattr(rx_stream, "CHANNEL_PLAN",
                        dict(jrx_stream.CHANNEL_PLAN))
    seconds, segment_s = 1.2, 0.2
    row = benchmarks.receiver_chain("gps", seconds=seconds,
                                    segment_s=segment_s, device="cpu")
    jrx = jrx_stream.StreamingReceiver(2.048e6, system="gps",
                                       segment_s=segment_s)
    assert set(row) == {
        "system", "sample_rate_hz", "capture_s", "processed_s", "n_slots",
        "wire_bits", "e2e_wall_s", "e2e_msamples_per_s", "e2e_realtime_x",
        "track_scan_s_per_segment", "track_msamples_per_s",
        "track_realtime_x", "n_fixes", "compile_warmup_s", "profile_s"}
    n = int(seconds * 2.048e6)
    seg = jrx.seg_epochs * jrx.n_epoch
    n_used = ((n - jrx.su["n_code"]) // seg) * seg
    assert row["processed_s"] == round(n_used / 2.048e6, 2) == 1.0
    assert row["capture_s"] == seconds
    assert row["n_slots"] == jrx.n_slots == 12
    assert row["wire_bits"] == {"i8": 8, "i4": 4, "i2": 2,
                                "i1": 1}[jrx._ingest_conv[0]] == 8
    assert row["track_scan_s_per_segment"] > 0
    assert row["profile_s"]["n_acquire_calls"] >= 1


def _jax_scaling_outputs(n_devices, blocks, n_prn, step_hz):
    n_ant = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    m = jmesh.make_mesh(n_ant, n_devices // n_ant,
                        devices=jax.devices()[:n_devices])
    det = JDetectorConfig(power_chunk_samples=4096)
    spec = JSpectralConfig(nperseg=1024)
    b = jnp.asarray(blocks)
    psd, _, pm = jfusion.sharded_psd_and_power(b, m, 2.048e6, det, spec)
    rep = jcplx.CArray(*codes.sampled_code_fft_conj_host(
        codes.gps_ca_table()[:n_prn], 1.023e6, 2.048e6, 2048))
    surf = jfusion.sharded_caf_acquire(
        b, m, rep, jcaf.doppler_bins(7000.0, step_hz), 2.048e6)
    return (float(psd.sum()), float(pm.sum())), \
        (float(pm.sum()), float(surf.max()))


@pytest.mark.parametrize("n_devices", [1, 2])
def test_scaling_worker_matches_jax_fusion(monkeypatch, n_devices):
    from gps_jamming_tpu_torch.parallel import mesh as mesh_lib
    monkeypatch.setattr(benchmarks, "_PER_DEVICE_SAMPLES", 1 << 15)
    row = benchmarks.scaling_worker(n_devices, device="cpu")
    assert set(row) == SCALING_KEYS
    assert row["mesh"] == ([2, 1] if n_devices == 2 else [1, 1])
    mesh, blocks, step, chain, total = benchmarks._scaling_setup(
        n_devices, "cpu")
    # each device holds _PER_DEVICE_SAMPLES, as blocks of _BLOCK
    assert blocks.shape == (mesh.n_antenna, (1 << 15) // (1 << 14)
                            * mesh.n_time, 1 << 14)
    assert total == mesh.n_antenna * mesh.n_time * (1 << 15)
    grid = mesh_lib.place_blocks(blocks, mesh)
    got_step = [float(v) for v in step(grid)]
    got_chain = [float(v) for v in chain(grid)]
    want_step, want_chain = _jax_scaling_outputs(n_devices, blocks, 8,
                                                 1000.0)
    np.testing.assert_allclose(got_step, want_step, rtol=1e-4)
    np.testing.assert_allclose(got_chain, want_chain, rtol=1e-4)


def _canned_run(fail_n):
    rows = {1: 40.0, 2: 36.0, 4: 30.0, 8: 20.0}

    def run(cmd, **kw):
        n = int(re.search(r"scaling_worker\((\d+)", cmd[-1]).group(1))
        if n == fail_n:
            return subprocess.CompletedProcess(cmd, 1, "",
                                               "RuntimeError: boom\n")
        row = {"n_devices": n, "mesh": [1, n], "step_s": 0.01,
               "msamples_per_s": rows[n] * n,
               "msamples_per_s_per_device": rows[n]}
        return subprocess.CompletedProcess(
            cmd, 0, "noise\nRESULT " + json.dumps(row) + "\n", "")
    return run


@pytest.mark.parametrize("platform,counts,fail_n", [
    ("gpu", [1, 2, 4], 4), ("cpu", [1, 2, 4, 8], 2), ("gpu", [2, 8], 2)])
def test_weak_scaling_rows_match_jax(monkeypatch, platform, counts,
                                     fail_n):
    monkeypatch.setattr(subprocess, "run", _canned_run(fail_n))
    got = benchmarks.weak_scaling(counts, platform=platform)
    want = jbench.weak_scaling(counts, platform="cpu"
                               if platform == "cpu" else "tpu")
    assert [("note" in r) for r in got] == [("note" in r) for r in want] \
        == [platform == "cpu"] * len(counts)
    strip = [{k: v for k, v in r.items() if k != "note"} for r in got]
    assert strip == [{k: v for k, v in r.items() if k != "note"}
                     for r in want]
    assert any("error" in r and "boom" in r["error"] for r in got)
    with pytest.raises(ValueError, match="platform"):
        benchmarks.weak_scaling([1], platform="tpu")


def test_benchmark_verb_lists_the_flags():
    out = subprocess.run([sys.executable, "-m", "gps_jamming_tpu_torch",
                          "benchmark", "--help"], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for flag in ("--scaling", "--platform", "--no-single", "--receiver",
                 "--seconds", "--device"):
        assert flag in out.stdout
    ns = cli.build_parser().parse_args(["benchmark"])
    jns = jcli.build_parser().parse_args(["benchmark"])
    assert ns.platform == "gpu" and ns.seconds == jns.seconds == 6.0


def test_benchmark_verb_with_nothing_asked_prints_what_jax_prints(capsys):
    assert jcli.main(["benchmark", "--no-single"]) == 0
    want = capsys.readouterr().out
    assert cli.main(["benchmark", "--device", "cpu", "--no-single"]) == 0
    got = capsys.readouterr().out
    assert json.loads(got) == json.loads(want) == {}


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (benchmarks.single_chip, benchmarks.receiver_chain,
                 lambda: benchmarks.scaling_worker(1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_weak_scaling_reports_a_mesh_the_cards_cannot_hold():
    # a child process per mesh size: no machine shows 99 cards
    (row,) = benchmarks.weak_scaling([99])
    assert set(row) == {"n_devices", "error"} and row["n_devices"] == 99
    assert "RuntimeError" in row["error"]
