"""pinned_upload_share.sharded (layer: parallel/mesh._to (host to card)):
of the device time of the traced window's host-to-card copies (records
whose name holds "HtoD"), the share that ran from page-locked host memory
(names that also hold "Pinned": an async DMA; "Pageable" ones go through
the CUDA runtime's staging copy), in %. A window with no host-to-card copy
reads nothing."""
from gjt_bench import trace


def read(ctx):
    tr = ctx["trace"]
    total, n = trace.kernel_us(tr, ("HtoD",))
    if not n or total <= 0:
        return None
    pinned = sum(e - s for name, s, e in tr.kernels
                 if "HtoD" in name and "Pinned" in name)
    return 100.0 * pinned / total
