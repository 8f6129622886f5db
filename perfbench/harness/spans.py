"""The card's idle time inside the program's spans, read from a traced window.

The program marks its layers with torch.profiler ranges named ``khmer_ocr.*``
(khmer_ocr_torch/profiling.py::span). The benchmark's profiler records the
host events of the thread that drives the requests or steps alone (the
dispatch and prefetch threads' spans are not in its trace), so a span's
intervals are the host events of that name on ``Trace.main_thread``. Idle
time is the window less the union of the device's intervals. A program that
records no span of the name (one older than its spans) gives None.
"""

from __future__ import annotations


def merged(intervals, end: float) -> list:
    """(start, stop) intervals clipped to [0, ``end``] -> their union as
    sorted, disjoint intervals."""
    out: list = []
    for s, e in sorted((max(s, 0.0), min(e, end)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def complement(intervals: list, end: float) -> list:
    """[0, ``end``] less sorted, disjoint ``intervals``."""
    out, at = [], 0.0
    for s, e in intervals + [(end, end)]:
        if s > at:
            out.append((at, s))
        at = max(at, e)
    return out


def overlap_s(a: list, b: list) -> float:
    """The length of the intersection of two lists of sorted, disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def span_intervals(trace, name: str) -> list:
    """The union of the driving thread's spans named ``name``."""
    return merged(((s, e) for s, e, n, th in trace.host if n == name and th == trace.main_thread), trace.window_s)


def idle_pct(trace, name: str, outside: bool = False) -> float | None:
    """100 x the seconds in which the card was idle inside the spans named
    ``name`` (with ``outside``: outside them), over the window; None where
    the driving thread recorded no such span."""
    inside = span_intervals(trace, name)
    if not inside:
        return None
    idle = complement(merged(((s, e) for s, e, _, _ in trace.device), trace.window_s), trace.window_s)
    part = complement(inside, trace.window_s) if outside else inside
    return 100.0 * overlap_s(idle, part) / trace.window_s
