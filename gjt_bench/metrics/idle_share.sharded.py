"""idle_share.sharded (layer: device): the share of the traced window of
whole `detect --devices 1` passes in which no operation ran on the card
(1 - the union of the device records' intervals over the window), in %."""
from gjt_bench import trace


def read(ctx):
    v = trace.idle_share(ctx["trace"])
    return None if v is None else 100.0 * v
