"""The program's host spans in a reduced `trace.Trace`: the
`record_function` spans whose names start with "gjt." that the port opens
inside its monitor step (`runtime.profiling.SPANS` there), recorded by the
benchmark's profiler session on the clock of the device's records.

The per-layer metrics that read them sum span time over the whole traced
window, never one span's time alone: a host span of about a millisecond
is below what a single reading can resolve, and the sum over a window of
seconds is not. A trace that holds none of a metric's spans reads nothing
(None), as from a program that opens no spans.
"""
from __future__ import annotations

import bisect


def _clip(tr, s: float, e: float) -> float:
    w0, w1 = tr.window
    return max(0.0, min(e, w1) - max(s, w0))


def span_us(tr, names) -> tuple[float, int]:
    """(summed time inside the window, count) of the spans named in
    `names`."""
    hits = [(s, e) for n, s, e in tr.spans if n in names]
    return float(sum(_clip(tr, s, e) for s, e in hits)), len(hits)


def outside_us(tr, outer: str, inner: str) -> tuple[float, int]:
    """(summed time inside the window, count) of what the `outer` spans
    hold outside the `inner` spans that lie within them, over the outer
    spans that hold at least one inner span."""
    inners = sorted((s, e) for n, s, e in tr.spans if n == inner)
    starts = [s for s, _ in inners]
    total, count = 0.0, 0
    for n, s, e in tr.spans:
        if n != outer:
            continue
        lo = bisect.bisect_left(starts, s)
        hi = bisect.bisect_right(starts, e)
        held = [(a, b) for a, b in inners[lo:hi] if b <= e]
        if not held:
            continue
        total += _clip(tr, s, e) - sum(_clip(tr, a, b) for a, b in held)
        count += 1
    return total, count
