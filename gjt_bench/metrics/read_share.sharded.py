"""read_share.sharded (layer: runtime/sharded.py host read
(ops/iq.read_iq_file)): the time the host spends reading the capture
files and converting them to complex64, the sum of the program's
`gjt.sharded.read` spans over the traced window of whole passes, in %. A
window that holds no such span (a program that opens none) reads
nothing."""
from gjt_bench import spans

SPANS = ("gjt.sharded.read",)


def read(ctx):
    tr = ctx["trace"]
    us, n = spans.span_us(tr, SPANS)
    if not n or tr.window_us <= 0:
        return None
    return 100.0 * us / tr.window_us
