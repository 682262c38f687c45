"""kernel_host_share.monitor (layer: ops/cuda_pcf, ops/cuda_psd (host
side of B1, B2)): the time the host spends in the wrappers of kernels B1
and B2 on the card (checks, outputs, the build's handle, twiddles, the
ctypes call and its error check), the sum of the `gjt.b1.launch` and
`gjt.b2.launch` spans over the traced window, in %. A window that holds
neither span reads nothing."""
from gjt_bench import spans

SPANS = ("gjt.b1.launch", "gjt.b2.launch")


def read(ctx):
    tr = ctx["trace"]
    us, n = spans.span_us(tr, SPANS)
    if not n or tr.window_us <= 0:
        return None
    return 100.0 * us / tr.window_us
