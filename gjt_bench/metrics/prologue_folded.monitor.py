"""prologue_folded.monitor (layer: ops/cuda_pcf (B1 entry)): how often the
monitor step's PCF search read the block's code periods itself, kernel B1's
forward building the prologue's rows as it loads them: the device records
whose name carries B1's folded row source (`SrcFold`, a template argument
of its forward kernel: `reg_forward_kernel`, `pcf_forward_kernel` or the
four-step's `large_cols_fwd`, one a launch) in the traced window over the
blocks traced, in %. 100 where every block's forward reads the periods; a
program whose prologue runs as PyTorch operators before B1 has no such
record and reads nothing, as does a window with no block."""
from gjt_bench import trace

KERNELS = ("SrcFold",)


def read(ctx):
    _, n = trace.kernel_us(ctx["trace"], KERNELS)
    blocks = ctx["counters"].get("blocks")
    if not n or not blocks:
        return None
    return 100.0 * n / blocks
