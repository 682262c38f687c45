"""b1_roofline.galileo (layer: kernel B1 above 16384 (gjt_pcf_large,
cluster)): the least time of one block's PCF search at the configuration's
code samples (32768 lags; its PRNs, +/-max Doppler in bins of fs / n, 10
periods; `roofline.pcf_search`) over B1's device time per block in the
traced window, in %. B1 above 16384 is the four-step forward FFT
(`large_cols_fwd`, then `large_rows_reg` or `large_rows_smem`) and the
cluster correlate (`pcf_correlate_cluster`); the cell's Welch segment
(1024) takes none of them. A window that holds none reads nothing."""
from gjt_bench import roofline, trace

KERNELS = ("large_cols_fwd", "large_rows_", "pcf_correlate_cluster")


def read(ctx):
    us, _ = trace.kernel_us(ctx["trace"], KERNELS)
    blocks = ctx["counters"].get("blocks")
    peak = roofline.peaks(ctx["device_name"])
    if not us or not blocks or peak is None:
        return None
    cfg = ctx["cell"].config
    acq = cfg["acquisition"]
    n = acq["code_samples"]
    n_prn = cfg["prns"][1] - cfg["prns"][0] + 1
    n_c = 2 * int(acq["max_doppler_hz"] // (cfg["sample_rate_hz"] / n)) + 1
    least, _ = roofline.least_seconds(*roofline.pcf_search(n, n_prn, n_c),
                                      peak)
    return 100.0 * least / (us * 1e-6 / blocks)
