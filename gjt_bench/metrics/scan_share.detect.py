"""scan_share.detect (layer: runtime.rx_stream, the streaming receiver's
tracking runs): the receiver's own `stage_seconds['scan']` over the
pass's `AnalysisResult.elapsed_s`, of the traced pass (the profiler
records the device only there), in %."""


def read(ctx):
    c = ctx["counters"]
    if not c.get("scan_s") or not c.get("elapsed_s"):
        return None
    return 100.0 * c["scan_s"] / c["elapsed_s"]
