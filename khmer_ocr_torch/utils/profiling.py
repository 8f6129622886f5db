"""Per-stage wall timers that wait for the card's work, and trace capture
with torch.profiler (through khmer_ocr_torch/profiling.py)."""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
from pathlib import Path

from ..profiling import profiler


@dataclasses.dataclass
class StageTimes:
    totals: dict = dataclasses.field(default_factory=dict)
    counts: dict = dataclasses.field(default_factory=dict)

    def add(self, name: str, seconds: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name}: {total:.3f}s total, {total / n * 1000:.2f}ms/call x{n}")
        return "\n".join(lines)


def _wait(sync) -> None:
    """Wait for the work behind ``sync``: a ``torch.cuda.Event``, or a tensor
    (on the card: its device's current stream; on the host there is nothing
    to wait for)."""
    import torch

    if isinstance(sync, torch.cuda.Event):
        sync.synchronize()
    elif isinstance(sync, torch.Tensor):
        if sync.is_cuda:
            torch.cuda.current_stream(sync.device).synchronize()
    else:
        raise TypeError(f"sync takes a tensor or a torch.cuda.Event, not {type(sync).__name__}")


@contextlib.contextmanager
def stage_timer(times: StageTimes, name: str, sync=None):
    """Add the block's wall seconds to ``times`` under ``name``; with
    ``sync`` (a tensor or a ``torch.cuda.Event``) the clock is read once the
    card's work behind it is done."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync is not None:
            _wait(sync)
        times.add(name, time.perf_counter() - t0)


@contextlib.contextmanager
def profile_trace(log_dir=None, enabled: bool = True):
    """Trace the block with torch.profiler into a chrome trace (Perfetto,
    chrome://tracing) in ``log_dir`` (default: ``khmer_ocr_trace`` in the
    temporary directory); yields the trace's path, or None when not
    ``enabled`` (nothing is traced or written)."""
    if not enabled:
        yield None
        return
    out = Path(log_dir) if log_dir is not None else Path(tempfile.gettempdir()) / "khmer_ocr_trace"
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"trace_{os.getpid()}_{time.time_ns()}.json"
    with profiler(path):
        yield path
