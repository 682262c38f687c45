"""The trace reduction on hand-made traces: busy time is the union of the
device records, the idle share its complement over the window, and the
gaps are named by the harness span open at their middle."""
import pytest

from gjt_bench import trace


def _tr(kernels, spans=(), window=(0.0, 100.0)):
    return trace.Trace(window, list(kernels), list(spans))


def test_union_merges_overlaps():
    assert trace.union_us([(0, 10), (5, 20), (30, 40)]) == 30


def test_idle_share_from_a_hand_made_trace():
    tr = _tr([("a", 10, 30), ("b", 20, 40), ("c", 90, 120)])
    # busy: 10-40 and 90-100 inside the window
    assert trace.busy_us(tr) == 40
    assert trace.idle_share(tr) == pytest.approx(0.6)


def test_no_device_record_reads_nothing():
    assert trace.idle_share(_tr([])) is None


def test_gaps_named_by_the_innermost_open_span():
    tr = _tr([("k", 0, 10), ("k", 60, 70)],
             spans=[("gjt.pass", 0, 100), ("gjt.block", 20, 50)])
    gaps = trace.idle_gaps(tr)
    assert gaps[0] == ["gjt.block", pytest.approx(50e-6)]
    assert [g[0] for g in gaps] == ["gjt.block", "gjt.pass"]


def test_kernel_time_by_name_patterns():
    tr = _tr([("void reg_forward_kernel<2048>", 0, 5),
              ("pcf_correlate_reg_kernel<2048>", 5, 25),
              ("welch_kernel<1024>", 30, 32)])
    assert trace.kernel_us(tr, ("reg_forward", "pcf_correlate")) == (25, 2)
    assert trace.device_ops(tr, top=1) == [
        ["pcf_correlate_reg_kernel<2048>", pytest.approx(20e-6)]]
