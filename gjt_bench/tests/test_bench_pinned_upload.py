"""`pinned_upload_share.sharded` on synthetic traces: the share of the
host-to-card copies' device time that ran from page-locked memory, None
where the window holds no such copy, and read in the sharded cell alone."""
import pytest

from gjt_bench import harness, trace

NAME = "pinned_upload_share.sharded"
PINNED = "Memcpy HtoD (Pinned -> Device)"
PAGEABLE = "Memcpy HtoD (Pageable -> Device)"


def _read(kernels):
    mod = harness.load_module(harness.BENCH_DIR / "metrics" / f"{NAME}.py",
                              "gjt_bench_metric_" + NAME.replace(".", "_"))
    return mod.read({"trace": trace.Trace((0.0, 1000.0), kernels, []),
                     "counters": {}})


@pytest.mark.parametrize("kernels, want", [
    ([(PAGEABLE, 0.0, 300.0), (PAGEABLE, 400.0, 420.0)], 0.0),
    ([(PINNED, 0.0, 30.0), (PINNED, 100.0, 110.0)], 100.0),
    ([(PINNED, 0.0, 30.0), ("welch_kernel", 30.0, 90.0),
      (PAGEABLE, 200.0, 210.0), ("Memcpy DtoH (Device -> Pageable)",
                                 300.0, 800.0)], 75.0),
], ids=["pageable", "pinned", "three_to_one"])
def test_share_of_htod_time_from_pinned_memory(kernels, want):
    assert _read(kernels) == pytest.approx(want)


def test_no_htod_record_reads_nothing():
    assert _read([("welch_kernel", 0.0, 50.0),
                  ("Memcpy DtoH (Device -> Pinned)", 60.0, 70.0)]) is None
    assert _read([]) is None


def test_read_in_the_sharded_cell_only():
    bench = harness.spec()
    for w in bench["workloads"]:
        names = {m["name"] for m in
                 harness.metrics_for(bench, w["name"], "per_layer")}
        assert (NAME in names) == (w["name"] == "gps.detect_sharded")
    cell = harness.make_cell(bench, "gps.detect_sharded", 1, "cpu")
    tr = trace.Trace((0.0, 1000.0), [(PINNED, 0.0, 30.0),
                                     (PAGEABLE, 40.0, 50.0)],
                     [("gjt.sharded.read", 100.0, 300.0)])
    got = harness.read_per_layer(bench, cell, {
        "trace": tr, "counters": {"samples": 1000, "upload_bytes": 2016}})
    assert got[NAME] == {"value": pytest.approx(75.0), "unit": "%"}
