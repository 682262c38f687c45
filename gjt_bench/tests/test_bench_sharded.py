"""The `gps.detect_sharded` cell's host side at a small size on the CPU:
the receivers' files are cut from the scene at their start offsets; the
reservoir keeps a uniform, seeded sample of the passes; the program's
passes come out correct against the plain reference and the control
(the reference in bfloat16) does not; `compare` counts each kind of
wrong answer planted in the reference's own; and the cell's per-layer
metrics read their spans and counters, and nothing where the program
has none."""
import copy
import random

import numpy as np
import pytest

from gjt_bench import harness, render, trace
from gjt_bench.loops import sharded_passes as loop
from gjt_bench.tests.common import small_cell

CELL = "gps.detect_sharded"


def _correct(checks):
    return all(c["value"] <= c["limit"] for c in checks)


@pytest.fixture(scope="module")
def run():
    cell = small_cell(CELL, seed=2**31 + 23, seconds=1.0, jam=(0.5, 0.9))
    st = loop.setup(cell)
    loop.window(st, 0.1)
    loop.release(st)
    return st


@pytest.fixture(scope="module")
def R(run):
    return loop.reference(run)


def test_files_are_cut_at_the_receivers_offsets():
    cell = small_cell(CELL, seconds=0.01)
    scene = cell.traffic["scene"]
    offsets = cell.traffic["receiver_offsets_samples"]
    assert offsets == [0, 2500, 9000]
    n_file = int(round(scene["seconds"] * scene["sample_rate_hz"]))
    scene["seconds"] = (n_file + max(offsets)) / scene["sample_rate_hz"]
    u8 = [a.numpy() for a in render.render_scene(scene, 3, "cpu")]
    files = loop.cut_files(u8, offsets, n_file)
    for f, a, o in zip(files, u8, offsets):
        assert f.size == 2 * n_file
        np.testing.assert_array_equal(f, a[2 * o: 2 * (o + n_file)])
    assert not np.array_equal(files[0][:64], u8[0][2 * 2500:][:64])


def test_reservoir_keeps_a_seeded_uniform_sample():
    def fill(seed, n):
        st = {"kept": [], "rng": random.Random(seed)}
        for pos in range(n):
            loop.keep(st, pos, {"pos": pos})
        return sorted(p for p, _ in st["kept"])
    assert fill(1, 5) == list(range(5))
    got = fill(1, 200)
    assert len(got) == loop.N_CHECKED == len(set(got))
    assert got == fill(1, 200) != fill(2, 200)
    assert max(got) >= 100                # later passes are kept too


def test_program_passes_are_correct(run):
    assert run["kept"] and _correct(loop.check(run))


def test_control_is_not_correct(run):
    checks = loop.control(run)
    assert not _correct(checks), checks


def _plant(answers, fault, R):
    a = copy.deepcopy(answers)
    if fault == "psd_peak_db_gap":
        a["psd_peak_db"] += 0.01
    elif fault == "psd_bin_wrong":
        a["psd_bin"] = int(np.argmin(R["psd"]))
    elif fault == "ranges_wrong":
        r0, r1 = a["per_antenna"][1][0][0]
        a["per_antenna"][1][0][0] = (r0 + 65536, r1)
    elif fault in ("baseline_gap", "threshold_gap"):
        ranges, base, thr = a["per_antenna"][2]
        a["per_antenna"][2] = (ranges, base * 1.01, thr) \
            if fault == "baseline_gap" else (ranges, base, thr * 1.01)
    elif fault == "prn_wrong":
        w = int(np.argmin(R["peak"][0]))
        a["acq"][0][0] = (w + 1, R["doppler_hz"][np.argmax(R["rows"][0][w])],
                          R["peak"][0][w])
    elif fault == "doppler_wrong":
        prn, dopp, peak = a["acq"][1][0]
        a["acq"][1][0] = (prn, dopp + 3000.0, peak)
    elif fault == "peak_gap":
        prn, dopp, peak = a["acq"][2][3]
        a["acq"][2][3] = (prn, dopp, peak * 1.01)
    elif fault == "lags_wrong":
        i, j, lag = a["lags"][1]
        a["lags"][1] = (i, j, lag + 1)
    return a


@pytest.mark.parametrize("fault", ["psd_peak_db_gap", "psd_bin_wrong",
                                   "ranges_wrong", "baseline_gap",
                                   "threshold_gap", "prn_wrong",
                                   "doppler_wrong", "peak_gap",
                                   "lags_wrong"])
def test_compare_counts_each_planted_fault(run, R, fault):
    limits = run["cell"].limits
    own = loop.answers_of(R)
    assert _correct(loop.compare([own], R, limits))
    checks = loop.compare([own, _plant(own, fault, R)], R, limits)
    broken = {c["name"] for c in checks if c["value"] > c["limit"]}
    assert broken == {fault}, checks


def test_compare_counts_a_missing_pair_and_antenna(run, R):
    limits = run["cell"].limits
    own = loop.answers_of(R)
    short = dict(own, lags=own["lags"][:2], acq=own["acq"][:2])
    got = {c["name"]: c["value"] for c in loop.compare([short], R, limits)}
    assert got["lags_wrong"] == 1 and got["prn_wrong"] == loop.N_TOP


def _metric(name):
    return harness.load_module(harness.BENCH_DIR / "metrics" / f"{name}.py",
                               "gjt_bench_metric_" + name.replace(".", "_"))


def test_metrics_read_their_spans_and_counters():
    spans = [("gjt.sharded", 0.0, 900.0), ("gjt.sharded.read", 10.0, 610.0),
             ("gjt.sharded.psd_power", 610.0, 700.0)]
    tr = trace.Trace((0.0, 1000.0), [("welch_kernel", 650.0, 700.0)], spans)
    ctx = {"trace": tr, "counters": {"passes": 1, "samples": 1000,
                                     "upload_bytes": 8120}}
    assert _metric("read_share.sharded").read(ctx) == pytest.approx(60.0)
    assert _metric("idle_share.sharded").read(ctx) == pytest.approx(95.0)
    assert _metric("upload_bytes_per_sample.sharded").read(ctx) == \
        pytest.approx(8.12)


def test_metrics_read_nothing_from_a_program_without_them():
    tr = trace.Trace((0.0, 1000.0), [("welch_kernel", 650.0, 700.0)], [])
    ctx = {"trace": tr, "counters": {"passes": 1, "samples": 1000,
                                     "upload_bytes": None}}
    assert _metric("read_share.sharded").read(ctx) is None
    assert _metric("upload_bytes_per_sample.sharded").read(ctx) is None
