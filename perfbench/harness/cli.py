"""The benchmark's command: one run of one cell, one JSON line at the end.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is a JSON object with ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``check``: each number the comparison held to its
limit. The same numbers are the last lines of standard error.

A run exits with another code than 0 and prints no result where there is no
CUDA card or fewer than the cell asks for, where the program is not beside
the benchmark, and where ``jax``, ``jaxlib``, ``flax`` or ``khmer_ocr_tpu``
is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .spec import Spec

FORBIDDEN = ("jax", "jaxlib", "flax", "khmer_ocr_tpu")
RUNNERS = ("serve", "train")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def process_start() -> float:
    """The wall-clock time this process started (from /proc), else now."""
    try:
        start_ticks = int(open("/proc/self/stat").read().rsplit(")", 1)[1].split()[19])
        uptime = float(open("/proc/uptime").read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> list[str]:
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("tf32",), default=None,
                    help="judge the reference at TF32 in the program's place (a control run, not a benchmark run)")
    return ap.parse_args(argv)


def run_cell(spec: Spec, name: str, seed: int, seconds: float, traced: bool, device: str = "cuda",
             control: str | None = None, t_process: float | None = None) -> dict:
    """One run of the cell -> the result object (without the checks of the card)."""
    cell = spec.cell(name)
    config = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    if cell["runner"] not in RUNNERS:
        raise ValueError(f"{name}: runner {cell['runner']!r}")
    t_process = time.time() if t_process is None else t_process
    if cell["runner"] == "serve":
        from . import serve as runner
    else:
        from . import train as runner
    result, numbers, attempted, failed, peak = runner.run(spec, cell, config, mix, seed, seconds, traced, device,
                                                          t_process, control, log)
    metrics = {}
    for m in spec.metrics(name, traced):
        value = spec.reader(m["name"])(result)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    compared = {k: v for k, v in numbers.items() if v[1] is not None}
    correct = failed == 0 and attempted > 0 and bool(compared) and all(v <= lim for v, lim in compared.values())
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": device_info(device, cell["chips"], peak)}
    if traced:
        out["device"]["busy_s"] = result.trace.busy_s()
        out["device"]["window_s"] = result.trace.window_s
        out["breakdown"] = result.trace.breakdown()
    out["check"] = {k: ({"value": v, "limit": lim} if lim is not None else {"value": v}) for k, (v, lim) in
                    numbers.items()}
    return out


def device_info(device: str, chips: int, peak: int) -> dict:
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": peak}
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips, "memory_peak_bytes": peak}


def power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv, root) -> int:
    t_process = process_start()
    args = parse(argv)
    if not (root / "khmer_ocr_torch").is_dir():
        log(f"the program (khmer_ocr_torch) is not beside the benchmark in {root}")
        return 2
    import torch

    spec = Spec(root)
    chips = spec.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"no CUDA card, or fewer than the {chips} this cell asks for")
        return 3
    log(f"card: {power_limit()}")
    out = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", args.control, t_process)
    found = forbidden_modules()
    if found:
        log(f"modules of JAX or the JAX package are loaded: {found}")
        return 4
    for k, v in out["check"].items():
        log(f"check {k}: {v['value']!r}" + (f" limit {v['limit']!r}" if "limit" in v else ""))
    print(json.dumps(out), flush=True)
    return 0
