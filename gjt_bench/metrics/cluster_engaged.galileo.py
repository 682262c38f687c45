"""cluster_engaged.galileo (layer: ops/cuda_pcf (B1 route)): how often the
Galileo monitor step's search ran on B1's route above 16384 lags,
`gjt_pcf_large` and its thread-block cluster: the device records of the
cluster correlate (`pcf_correlate_cluster`, one a launch) in the traced
window over the blocks traced, in %. 100 where every block launches it
once; a search that has left the cluster path (B1 below 16384, its
two-pass correlate, or plain torch) has no such record and reads 0. A
window with no block reads nothing."""
from gjt_bench import trace

KERNELS = ("pcf_correlate_cluster",)


def read(ctx):
    _, n = trace.kernel_us(ctx["trace"], KERNELS)
    blocks = ctx["counters"].get("blocks")
    if not blocks:
        return None
    return 100.0 * n / blocks
