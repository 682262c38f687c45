"""front_engaged.monitor on hand-made traces: 100 with one F1 record per
block, a share where some blocks lack it, nothing without blocks or
without F1 (a program whose front is plain torch), and a name that none
of the roofline metrics' kernel patterns takes."""
import pytest

from gjt_bench import harness, trace

NAME = "front_engaged.monitor"
F1 = "void (anonymous namespace)::block_front_kernel(signed char const*)"


def _metric(name=NAME):
    return harness.load_module(harness.BENCH_DIR / "metrics" / f"{name}.py",
                               "gjt_bench_metric_" + name.replace(".", "_"))


def _tr(kernels):
    return trace.Trace((0.0, 1000.0), list(kernels), [])


# Two blocks, each with F1, B2 and B1's records, as the monitor step runs.
TWO_BLOCKS = [(F1, 100.0, 104.0), ("welch_kernel", 110.0, 130.0),
              ("pcf_correlate_reg_kernel", 150.0, 200.0),
              (F1, 500.0, 504.0), ("welch_kernel", 510.0, 530.0),
              ("pcf_correlate_reg_kernel", 550.0, 600.0)]


@pytest.mark.parametrize("kernels,blocks,want", [
    (TWO_BLOCKS, 2, 100.0),
    (TWO_BLOCKS[3:], 2, 50.0)])
def test_front_engaged_reads_records_per_block(kernels, blocks, want):
    ctx = {"trace": _tr(kernels), "counters": {"blocks": blocks}}
    assert _metric().read(ctx) == pytest.approx(want)


@pytest.mark.parametrize("kernels,counters", [
    (TWO_BLOCKS, {}), (TWO_BLOCKS, {"blocks": 0}),
    ([k for k in TWO_BLOCKS if k[0] != F1], {"blocks": 2})])
def test_front_engaged_reads_nothing_without_blocks_or_f1(kernels, counters):
    assert _metric().read({"trace": _tr(kernels),
                           "counters": counters}) is None


@pytest.mark.parametrize("roofline", ["b1_roofline.monitor",
                                      "b2_roofline.monitor"])
def test_f1_is_none_of_the_roofline_kernels(roofline):
    assert not any(p in F1 for p in _metric(roofline).KERNELS)
