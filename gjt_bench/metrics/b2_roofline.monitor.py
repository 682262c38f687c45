"""b2_roofline.monitor (layer: kernel B2, csrc/welch_psd.cu via
ops/cuda_psd): the least time of one block's Welch PSD (the traffic's block
of samples, the configuration's nperseg, 50 % overlap;
`roofline.welch_psd`) over B2's device time per block in the traced
window, in %. B2's kernels are the names below; a window that holds none
of them reads nothing."""
from gjt_bench import roofline, trace

KERNELS = ("welch_",)


def read(ctx):
    us, _ = trace.kernel_us(ctx["trace"], KERNELS)
    blocks = ctx["counters"].get("blocks")
    peak = roofline.peaks(ctx["device_name"])
    if not us or not blocks or peak is None:
        return None
    cell = ctx["cell"]
    least, _ = roofline.least_seconds(*roofline.welch_psd(
        cell.traffic["block_samples"], cell.config["psd_nperseg"]), peak)
    return 100.0 * least / (us * 1e-6 / blocks)
