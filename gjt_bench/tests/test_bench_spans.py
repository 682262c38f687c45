"""The metrics that read the program's host spans, on hand-made traces:
each reads its share of the window exactly, reads nothing where the trace
holds no program span (as from a program that opens none), and a gap in
the device's work is named by the innermost span open at its middle."""
import pytest

from gjt_bench import harness, trace

SPAN_METRICS = ("step_share.monitor", "read_share.monitor",
                "kernel_host_share.monitor")


def _metric(name):
    return harness.load_module(harness.BENCH_DIR / "metrics" / f"{name}.py",
                               "gjt_bench_metric_" + name.replace(".", "_"))


def _tr(kernels=(), spans=(), window=(0.0, 1000.0)):
    return trace.Trace(window, list(kernels), list(spans))


# Two blocks in a 1000 us window, as the monitor loop records them: the
# block span holds the step, which holds its stages and the two launches;
# the rest of each block is the reads.
BLOCKS = [
    ("gjt.block", 100.0, 400.0),
    ("gjt.step", 110.0, 350.0),
    ("gjt.step.ingest", 112.0, 130.0),
    ("gjt.step.psd", 130.0, 180.0),
    ("gjt.b2.launch", 140.0, 170.0),
    ("gjt.step.power", 180.0, 240.0),
    ("gjt.step.acquire", 240.0, 348.0),
    ("gjt.b1.launch", 300.0, 340.0),
    ("gjt.block", 500.0, 700.0),
    ("gjt.step", 500.0, 620.0),
    ("gjt.step.psd", 505.0, 540.0),
    ("gjt.b2.launch", 510.0, 530.0),
    ("gjt.step.acquire", 560.0, 615.0),
    ("gjt.b1.launch", 580.0, 610.0),
]


@pytest.mark.parametrize("name,want", [
    ("step_share.monitor", 100.0 * (240.0 + 120.0) / 1000.0),
    ("read_share.monitor", 100.0 * ((300.0 - 240.0) + (200.0 - 120.0))
     / 1000.0),
    ("kernel_host_share.monitor",
     100.0 * (30.0 + 40.0 + 20.0 + 30.0) / 1000.0)])
def test_span_metric_reads_its_share(name, want):
    got = _metric(name).read({"trace": _tr(spans=BLOCKS)})
    assert got == pytest.approx(want)


def test_span_metrics_clip_to_the_window():
    spans = [("gjt.block", -50.0, 100.0), ("gjt.step", -40.0, 60.0),
             ("gjt.b1.launch", -30.0, 20.0)]
    tr = _tr(spans=spans, window=(0.0, 200.0))
    assert _metric("step_share.monitor").read({"trace": tr}) == \
        pytest.approx(30.0)
    assert _metric("read_share.monitor").read({"trace": tr}) == \
        pytest.approx(20.0)
    assert _metric("kernel_host_share.monitor").read({"trace": tr}) == \
        pytest.approx(10.0)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_metric_reads_nothing_without_program_spans(name):
    """The loop's own block spans and the device's work, but no span of the
    program: a program that opens none."""
    tr = _tr(kernels=[("pcf_correlate_reg_kernel", 150.0, 200.0)],
             spans=[("gjt.block", 100.0, 400.0), ("gjt.block", 500.0, 700.0)])
    assert _metric(name).read({"trace": tr}) is None


def test_a_gap_inside_a_launch_is_named_by_the_launch():
    """A gap in the device's work while the host is in B1's wrapper is named
    by `gjt.b1.launch`, the innermost span open at its middle, and not by
    the step or the block that enclose it."""
    tr = _tr(kernels=[("welch_kernel", 0.0, 290.0),
                      ("pcf_correlate_reg_kernel", 345.0, 1000.0)],
             spans=BLOCKS)
    (gap,) = trace.idle_gaps(tr, top=1)
    assert gap == ["gjt.b1.launch", pytest.approx(55e-6)]
