"""The card's activity under torch.profiler: one measure of its busy time for
chip_smoke.py and examples/profile_torch_e2e.py, and the profiler that
utils/profiling.py::profile_trace writes its traces with.

    events, wall_ms = device_events(fn)
    busy = busy_ms(events)   # the union of the kernel, copy and set intervals
"""

from __future__ import annotations

import contextlib
import json
import tempfile
import time
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union_us(intervals) -> float:
    """The length of the union of (start, stop) intervals."""
    total, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if stop <= end:
            continue
        total += stop - max(start, end)
        end = stop
    return total


@contextlib.contextmanager
def profiler(trace: Path | None = None):
    """torch.profiler over the block, on the host and on the card where there
    is one; yields the profiler, and writes its chrome trace to ``trace``
    when the block ends, if given."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    if trace is not None:
        prof.export_chrome_trace(str(trace))


def device_events(fn, trace: Path | None = None) -> tuple[list, float]:
    """Run ``fn`` under torch.profiler -> (the chrome trace's device events:
    kernels, copies and sets, each with ``ts`` and ``dur`` in us; the wall ms
    of ``fn`` to its last synchronise, the profiler's own start left out).
    ``trace``: where to keep the whole chrome trace, else nowhere."""
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(trace or Path(tmp) / "trace.json")
        with profiler(path):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e], wall


def busy_ms(events) -> float:
    """The card's busy ms over ``events``: the union of their intervals."""
    return union_us((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events) / 1e3
