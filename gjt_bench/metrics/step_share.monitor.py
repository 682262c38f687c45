"""step_share.monitor (layer: entry.detect_acquire_step (host dispatch)):
the time the host spends inside the program's monitor step, the sum of
its `gjt.step` spans over the traced window, in %. A window that holds no
such span (a program that opens none) reads nothing."""
from gjt_bench import spans

SPANS = ("gjt.step",)


def read(ctx):
    tr = ctx["trace"]
    us, n = spans.span_us(tr, SPANS)
    if not n or tr.window_us <= 0:
        return None
    return 100.0 * us / tr.window_us
