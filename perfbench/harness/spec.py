"""Finding a cell's files by name.

``BENCHMARK.json`` at the checkout's root names the cells and metrics. Each
cell is ``perfbench/workloads/<cell>.json`` (its configuration, traffic mix,
runner and the runner's parameters), each configuration
``perfbench/configs/<config>.json``, each traffic mix
``perfbench/traffic/<mix>.json``, and each metric has a reader
``perfbench/metrics/<metric>.py`` with ``read(run) -> float | None``. A
later cell, configuration, mix or metric is added as files alone.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path


class Spec:
    def __init__(self, root: Path, bench_dir: Path | None = None, benchmark: dict | None = None):
        self.root = Path(root)
        self.dir = Path(bench_dir) if bench_dir is not None else self.root / "perfbench"
        self.benchmark = benchmark or json.loads((self.root / "BENCHMARK.json").read_text())

    def _json(self, kind: str, name: str) -> dict:
        path = self.dir / kind / f"{name}.json"
        if not path.is_file():
            raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
        return json.loads(path.read_text())

    def cell(self, name: str) -> dict:
        entry = next((w for w in self.benchmark["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"BENCHMARK.json has no workload {name!r}")
        cell = self._json("workloads", name)
        if cell["config"] != entry["config"] or cell["traffic"] != entry["traffic"]:
            raise ValueError(f"{name}: its file and BENCHMARK.json name different configs or traffic")
        return {**cell, "name": name, "chips": entry["chips"]}

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def metrics(self, cell: str, traced: bool) -> list[dict]:
        """The metrics this cell reports: its per-layer ones when traced, else
        its end-to-end ones (those that list it, or list no cells)."""
        group = self.benchmark["per_layer" if traced else "end_to_end"]
        return [m for m in group if "workloads" not in m or cell in m["workloads"]]

    def reader(self, metric: str):
        path = self.dir / "metrics" / f"{metric}.py"
        if not path.is_file():
            raise FileNotFoundError(f"metric {metric!r} has no reader ({path})")
        mod_spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        return mod.read
