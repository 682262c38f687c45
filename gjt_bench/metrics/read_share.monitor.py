"""read_share.monitor (layer: host reads of the block's outputs): the
time the host spends in each block outside the program's step, the sum
over the loop's `gjt.block` spans of the block's span less the `gjt.step`
span inside it, over the traced window, in %. That is the host waiting on
the device's tail and the four copies of the block's outputs to the host.
A window whose blocks hold no `gjt.step` span (a program that opens none)
reads nothing."""
from gjt_bench import spans

BLOCK, STEP = "gjt.block", "gjt.step"


def read(ctx):
    tr = ctx["trace"]
    us, n = spans.outside_us(tr, BLOCK, STEP)
    if not n or tr.window_us <= 0:
        return None
    return 100.0 * us / tr.window_us
