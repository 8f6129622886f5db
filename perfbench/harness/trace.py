"""The device's activity in a traced window, read from torch.profiler.

The window is the block ``traced(...)`` runs, marked by a record_function
named ``WINDOW`` on the thread that drives the requests. From the
profiler's events the harness keeps:

  * every device interval (kernel, copy, set) inside the window, with its
    name and the host thread that launched it (through the correlation id
    of the launching runtime call), "main" for the driving thread;
  * the host's events, to name what the host was doing in each of the
    device's idle gaps.

``busy_s`` is the length of the union of the device intervals (the
arithmetic of ``yardstick.union``), ``window_s`` the window's length.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

from .yardstick import union

WINDOW = "perfbench.window"


@dataclasses.dataclass
class Trace:
    window_s: float
    device: list  # (start_s, end_s, name, launcher) relative to the window's start; launcher "main" or "other"
    host: list  # (start_s, end_s, name, thread) of the host's events
    main_thread: int

    def busy_s(self, launcher: str | None = None, name_has: str | None = None) -> float:
        return union((s, e) for s, e, n, who in self.device
                     if (launcher is None or who == launcher) and (name_has is None or name_has in n))

    def time_s(self, name_has: str) -> float:
        """Summed durations of the device intervals whose name holds ``name_has``."""
        return sum(e - s for s, e, n, _ in self.device if name_has in n)

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict = {}
        for s, e, n, _ in self.device:
            by_name[n] = by_name.get(n, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        spans = sorted((s, e) for s, e, _, _ in self.device)
        gaps, end = [], 0.0
        for s, e in spans + [(self.window_s, self.window_s)]:
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n[:160], t] for n, t in ops],
                "idle_gaps": [[self.host_at((a + b) / 2), b - a] for a, b in gaps]}

    def host_at(self, t: float) -> str:
        """What the host was doing at time ``t``: the innermost profiled call
        on the driving thread, else on another thread, else Python."""
        inside = [(e - s, th != self.main_thread, n) for s, e, n, th in self.host if s <= t <= e and n != WINDOW]
        if not inside:
            return "python: no profiled call on any thread"
        _, other, name = min(inside, key=lambda x: (x[1], x[0]))
        return ("another thread: " if other else "") + name[:140]


@contextlib.contextmanager
def traced():
    """torch.profiler over the block, host and card; yields a holder whose
    ``trace`` is set once the block has ended."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    holder = type("Holder", (), {"trace": None})()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield holder
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    holder.trace = read(prof)
    holder.read_s = time.perf_counter() - t0


def read(prof) -> Trace:
    events = prof.profiler.kineto_results.events()
    win = next(e for e in events if e.name() == WINDOW and e.device_type().name == "CPU")
    # a host event's device_resource_id is its thread (start_thread_id numbers every thread 1 here)
    w0, w1, main = win.start_ns(), win.end_ns(), win.device_resource_id()
    launcher, host, dev = {}, [], []
    for e in events:
        if e.device_type().name == "CPU":
            th = e.device_resource_id()
            if e.name().startswith("cu"):  # a runtime or driver call: its correlation id names what it launched
                launcher[e.correlation_id()] = th
            if w0 <= e.start_ns() <= w1:
                host.append(((e.start_ns() - w0) / 1e9, (e.end_ns() - w0) / 1e9, e.name(), th))
        elif e.name() != WINDOW and not e.is_user_annotation():  # the window's own range on the device's timeline
            dev.append(e)
    device = []
    for e in dev:
        s, t = max(e.start_ns(), w0), min(e.end_ns(), w1)
        if t <= s:
            continue
        th = launcher.get(e.correlation_id(), launcher.get(e.linked_correlation_id()))
        device.append(((s - w0) / 1e9, (t - w0) / 1e9, e.name(), "main" if th == main else "other"))
    return Trace((w1 - w0) / 1e9, device, host, main)
