"""launches_per_epoch.detect (layer: models.receiver.tracking, the epoch
loop): the kernels that ran on the card during a traced `detect` pass
(device records other than copies and sets) over the 1 ms epochs the
receiver tracked in it. A count."""


def read(ctx):
    epochs = ctx["counters"].get("epochs")
    n = sum(1 for name, _, _ in ctx["trace"].kernels
            if not name.startswith(("Memcpy", "Memset")))
    if not epochs or not n:
        return None
    return n / epochs
