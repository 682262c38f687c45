"""prologue_folded.monitor on hand-made traces: 100 with one folded B1
forward record per block (GPS: the register forward; Galileo: the
four-step's column pass), a share where some blocks lack it, nothing
without blocks or without a folded record (a program whose prologue runs
as PyTorch operators before B1), and B1's roofline metrics still take the
folded forwards' names."""
import pytest

from gjt_bench import harness, trace

NAME = "prologue_folded.monitor"
FWD_GPS = ("void gjt::reg_forward_kernel<2048, gjt::SrcFold>("
           "gjt::SrcFold, float2*, float2 const*)")
FWD_GAL = ("void gjt::large_cols_fwd<2, gjt::SrcFold>(gjt::SrcFold, "
           "float2*, float2 const*, int)")
CORR = "void gjt::pcf_correlate_reg_kernel<2048>(float2 const*)"
GEMM = "sm80_xmma_gemm_cf32cf32_f32f32_cf32_nn_n_tilesize32x32x8_stage3"


def _metric(name=NAME):
    return harness.load_module(harness.BENCH_DIR / "metrics" / f"{name}.py",
                               "gjt_bench_metric_" + name.replace(".", "_"))


def _tr(kernels):
    return trace.Trace((0.0, 1000.0), list(kernels), [])


def _blocks(fwd, n):
    return [rec for b in range(n) for rec in (
        ("block_front_kernel", 500.0 * b, 500.0 * b + 4.0),
        (fwd, 500.0 * b + 10.0, 500.0 * b + 14.0),
        (CORR, 500.0 * b + 20.0, 500.0 * b + 80.0))]


@pytest.mark.parametrize("fwd", [FWD_GPS, FWD_GAL])
@pytest.mark.parametrize("kernels,blocks,want", [
    (2, 2, 100.0), (1, 2, 50.0)])
def test_prologue_folded_reads_records_per_block(fwd, kernels, blocks, want):
    ctx = {"trace": _tr(_blocks(fwd, kernels)),
           "counters": {"blocks": blocks}}
    assert _metric().read(ctx) == pytest.approx(want)


# the parent's block: the prologue's GEMM, then B1's forward of y
UNFOLDED = [(GEMM, 0.0, 2.0),
            ("void gjt::reg_forward_kernel<2048>(float2 const*)", 3.0, 6.0),
            (CORR, 7.0, 60.0)]


@pytest.mark.parametrize("kernels,counters", [
    (_blocks(FWD_GPS, 2), {}), (_blocks(FWD_GPS, 2), {"blocks": 0}),
    (UNFOLDED, {"blocks": 1}), ([], {"blocks": 1})])
def test_prologue_folded_reads_nothing_without_blocks_or_folded_forward(
        kernels, counters):
    assert _metric().read({"trace": _tr(kernels),
                           "counters": counters}) is None


@pytest.mark.parametrize("roofline,fwd", [("b1_roofline.monitor", FWD_GPS),
                                          ("b1_roofline.galileo", FWD_GAL)])
def test_b1_rooflines_take_the_folded_forward(roofline, fwd):
    assert any(p in fwd for p in _metric(roofline).KERNELS)
