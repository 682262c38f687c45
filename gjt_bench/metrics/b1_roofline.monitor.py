"""b1_roofline.monitor (layer: kernel B1, csrc/pcf.cu via ops/cuda_pcf):
the least time of one block's PCF search (32 PRNs, +/-7 kHz, 10 periods
of the configuration's code samples; `roofline.pcf_search`) over B1's
device time per block in the traced window, in %. B1's kernels are the
names below; a window that holds none of them reads nothing."""
from gjt_bench import roofline, trace

KERNELS = ("pcf_forward_kernel", "reg_forward_kernel", "pcf_correlate")
N_PRN = 32


def read(ctx):
    us, _ = trace.kernel_us(ctx["trace"], KERNELS)
    blocks = ctx["counters"].get("blocks")
    peak = roofline.peaks(ctx["device_name"])
    if not us or not blocks or peak is None:
        return None
    cfg = ctx["cell"].config
    acq = cfg["acquisition"]
    n = acq["code_samples"]
    n_c = 2 * int(acq["max_doppler_hz"] // (cfg["sample_rate_hz"] / n)) + 1
    least, _ = roofline.least_seconds(*roofline.pcf_search(n, N_PRN, n_c),
                                      peak)
    return 100.0 * least / (us * 1e-6 / blocks)
