"""The benchmark's device trace: `torch.profiler` around a window, reduced to
kernel intervals and the host spans the harness opens.

A session's first device records can carry a stale GPU-to-host clock
offset and fall before the profiler's window, where it drops them; a
pre-roll of small kernels inside the session, before the window's span,
takes that loss (the same repair as the port's `runtime/profiling`, kept
here so that the yardstick does not live in the program).

Everything below the profiler is plain data: `Trace` holds the window's
kernels as (name, start_us, end_us) and the harness's spans, and the
functions over it (`busy_us`, `idle_gaps`, `kernel_us`) are what the
per-layer metrics read.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

WINDOW_SPAN = "gjt.window"
PREROLL_LAUNCHES, PREROLL_S = 256, 0.05


@dataclasses.dataclass
class Trace:
    window: tuple[float, float]                  # us, the WINDOW_SPAN span
    # every device record (kernels, copies, sets): (name, start, end) us
    kernels: list[tuple[str, float, float]]
    spans: list[tuple[str, float, float]]        # harness spans, us

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _clipped(tr: Trace):
    w0, w1 = tr.window
    return [(max(s, w0), min(e, w1)) for _, s, e in tr.kernels
            if e > w0 and s < w1]


def busy_us(tr: Trace) -> float:
    """Time inside the window in which any kernel ran on the device."""
    return union_us(_clipped(tr))


def idle_share(tr: Trace) -> float | None:
    if tr.window_us <= 0 or not tr.kernels:
        return None
    return 1.0 - busy_us(tr) / tr.window_us


def kernel_us(tr: Trace, patterns) -> tuple[float, int]:
    """(summed device time, count) of the window's kernels whose name holds
    any of `patterns`."""
    hits = [(e - s) for n, s, e in tr.kernels
            if any(p in n for p in patterns)]
    return float(sum(hits)), len(hits)


def idle_gaps(tr: Trace, top: int = 10) -> list[list]:
    """The longest gaps between device work inside the window, each named
    by the innermost harness span open at its middle ("host" where none
    is): [[name, seconds], ...]."""
    w0, w1 = tr.window
    busy = sorted(_clipped(tr))
    gaps, cursor = [], w0
    for s, e in busy:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if w1 > cursor:
        gaps.append((cursor, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, e in gaps[:top]:
        mid = 0.5 * (s + e)
        open_ = [sp for sp in tr.spans if sp[1] <= mid <= sp[2]
                 and sp[0] != WINDOW_SPAN]
        name = min(open_, key=lambda sp: sp[2] - sp[1])[0] if open_ \
            else "host"
        out.append([name, (e - s) * 1e-6])
    return out


def device_ops(tr: Trace, top: int = 10) -> list[list]:
    """The kernels that took most device time in the window:
    [[name, seconds], ...]."""
    acc: dict[str, float] = {}
    for n, s, e in tr.kernels:
        acc[n] = acc.get(n, 0.0) + (e - s)
    ranked = sorted(acc.items(), key=lambda kv: -kv[1])[:top]
    return [[n, us * 1e-6] for n, us in ranked]


def _preroll(dev) -> None:
    import torch
    z = torch.zeros(1, device=dev)
    for _ in range(PREROLL_LAUNCHES):
        z.add_(1.0)
    torch.cuda.synchronize(dev)
    time.sleep(PREROLL_S)


@contextlib.contextmanager
def traced(dev, box: dict, host_ops: bool = True):
    """Profile the block on `dev` (a CUDA device); on exit put the reduced
    `Trace` in box["trace"]. With host_ops the host's operators and the
    harness's spans (`torch.profiler.record_function` names starting with
    "gjt.") are recorded too and the window is a WINDOW_SPAN span; without
    them (a `detect` pass launches over a million kernels, and recording
    the host's operators as well multiplies the events to reduce) only the
    device's records are, and the window is the block's wall-clock
    interval, on the profiler's clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CUDA]
    if host_ops:
        acts.append(ProfilerActivity.CPU)
    window = None
    with profile(activities=acts) as prof:
        _preroll(dev)
        if host_ops:
            with record_function(WINDOW_SPAN):
                yield
        else:
            t0 = time.time_ns()
            yield
            torch.cuda.synchronize(dev)
            window = (t0 / 1e3, time.time_ns() / 1e3)
        torch.cuda.synchronize(dev)
    box["trace"] = reduce(prof, window)


def reduce(prof, window=None) -> Trace:
    """The profile's raw Kineto events -> `Trace` (no FunctionEvent tree is
    built: a detect pass holds millions of events). `window` (start, end)
    in us on the profiler's clock, else the WINDOW_SPAN span's."""
    kernels, spans = [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        s = ev.start_ns() / 1e3
        e = s + ev.duration_ns() / 1e3
        dev_type = str(ev.device_type())
        if dev_type.endswith("CUDA"):
            # the device side of a record_function span is an annotation,
            # not work on the card
            if not (ev.is_user_annotation() or name.startswith("gjt.")):
                kernels.append((name, s, e))
        elif name == WINDOW_SPAN and window is None:
            window = (s, e)
        elif name.startswith("gjt."):
            spans.append((name, s, e))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
    w0, w1 = window
    return Trace(window, [k for k in kernels if k[1] < w1 and k[2] > w0],
                 spans)

