"""What one run measured, as the metric readers see it."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Served:
    """One request that came back inside the window."""

    lines: int
    chunks: list  # per line, its real chunks
    steps: list  # per line, the decode steps its served tokens took
    latency_s: float


@dataclasses.dataclass
class Run:
    cell: dict  # the workload file, with its name and chips
    config: dict  # the configuration file
    setup_s: float
    window_s: float
    served: list = dataclasses.field(default_factory=list)  # Served, for serving cells
    samples: int = 0  # trained samples whose steps completed, for training cells
    train_shapes: list = dataclasses.field(default_factory=list)  # per trained line, (chunks, label positions)
    trace: object = None  # trace.Trace of a traced run
    counters: dict = dataclasses.field(default_factory=dict)

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def lines(self) -> int:
        return sum(s.lines for s in self.served)
