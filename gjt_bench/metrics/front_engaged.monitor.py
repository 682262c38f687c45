"""front_engaged.monitor (layer: entry.detect_acquire_step (host
dispatch)): how often the monitor step's front ran as the program's one
hand-written launch, kernel F1 (`block_front_kernel`): F1's device
records in the traced window over the blocks traced, in %. 100 where every
block launches it once; a program without F1 (its front in plain torch
operators) has no such record and reads nothing, as does a window with no
block."""
from gjt_bench import trace

KERNELS = ("block_front_kernel",)


def read(ctx):
    _, n = trace.kernel_us(ctx["trace"], KERNELS)
    blocks = ctx["counters"].get("blocks")
    if not n or not blocks:
        return None
    return 100.0 * n / blocks
