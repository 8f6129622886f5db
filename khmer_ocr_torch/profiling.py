"""The card's activity under torch.profiler: one measure of its busy time for
chip_smoke.py and examples/profile_torch_e2e.py, the profiler that
utils/profiling.py::profile_trace writes its traces with, and the spans the
program marks its layers with.

    events, wall_ms = device_events(fn)
    busy = busy_ms(events)   # the union of the kernel, copy and set intervals

    with span("khmer_ocr.decode"):   # a torch.profiler range while a profiler runs
        ...

A span is a ``record_function`` range while any torch.profiler session runs
in the process, so it lies on the profiler's clock beside the card's kernels,
copies and runtime calls. With no profiler it is one shared no-op: it reads
``torch.autograd.profiler._is_profiler_enabled``, a process-wide flag (a
``record_function`` costs some 12 us to enter and leave even then). The
program's spans (all named ``khmer_ocr.*``) sit at its layer boundaries,
never in a loop over lines nor inside a body captured into a CUDA graph.
"""

from __future__ import annotations

import contextlib
import json
import tempfile
import time
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_OFF = contextlib.nullcontext()
_autograd_profiler = None  # torch.autograd.profiler, bound at the first span: importing this module loads no torch


def span(name: str):
    """A context manager: ``torch.profiler.record_function(name)`` while a
    torch.profiler session runs, else a shared no-op."""
    global _autograd_profiler
    if _autograd_profiler is None:
        import torch.autograd.profiler

        _autograd_profiler = torch.autograd.profiler
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _autograd_profiler.record_function(name)


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
    is one, the host's ops and spans on every thread (where the installed
    torch can; by default it records those of the thread that started it
    alone); yields the profiler, and writes its chrome trace to ``trace``
    when the block ends, if given."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except TypeError:  # a torch without the option
        every_thread = None
    with torch.profiler.profile(activities=acts, experimental_config=every_thread) as prof:
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
