"""The cell serve_resnet_greedy_wide (resnet_seeded on column_lines) on the
CPU at a small cut of its mix, the card's look skipped: its result line,
``correct`` false once a fault is planted under the timed path
(tests/faults.py), and encode_roofline_pct on made-up traces."""

import json
import shutil

import pytest

from perfbench.harness import yardstick
from perfbench.harness.cli import run_cell
from perfbench.harness.context import Run, Served
from perfbench.harness.spec import Spec
from perfbench.harness.trace import Trace

from .faults import planted

CELL = "serve_resnet_greedy_wide"
SEED = 2**31 + 29


@pytest.fixture(scope="module")
def small(root, tmp_path_factory):
    """The benchmark's files with the column mix cut to 3-4 lines of 200-420 px
    (3-5 chunks) a request and batches of 8: the full mix's 8-12 chunks at
    batch 32 would warm and encode hundreds of chunks through the ResNet on
    the CPU."""
    d = tmp_path_factory.mktemp("perfbench_resnet")
    for sub in ("configs", "workloads", "traffic", "metrics", "data"):
        shutil.copytree(root / "perfbench" / sub, d / sub)
    path = d / "traffic" / "column_lines.json"
    mix = json.loads(path.read_text())
    mix["lines_per_request"] = {"low": 3, "high": 4}
    mix["line"]["join"]["width_px"] = [200, 420]
    path.write_text(json.dumps(mix))
    path = d / "workloads" / f"{CELL}.json"
    cell = json.loads(path.read_text())
    cell["serve"]["batch_size"] = 8
    path.write_text(json.dumps(cell))
    return Spec(root, d)


def test_the_cell_is_in_the_benchmark(root):
    b = Spec(root).benchmark
    (entry,) = [w for w in b["workloads"] if w["name"] == CELL]
    assert entry["config"] == "resnet_seeded" and entry["traffic"] == "column_lines" and entry["chips"] == 1
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert CELL in e2e["lines_per_s"]["workloads"] and CELL not in e2e["request_p95_ms"]["workloads"]
    serving = [m for m in b["per_layer"] if m["moves"] == "lines_per_s"]
    assert len(serving) == 10 and all(CELL in m["workloads"] for m in serving)
    config = Spec(root).config("resnet_seeded")
    assert config["model"]["backbone"] == "resnet" and config["model"]["use_bilstm"] is False
    assert config["reduced"] == [] and "seed" in config["weights"]


def test_result_line(small):
    out = run_cell(small, CELL, SEED, 0.5, False, "cpu")
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1, out["check"]
    assert set(out["metrics"]) == {"lines_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert out["check"]["token_gap"]["value"] <= out["check"]["token_gap"]["limit"]
    assert out["check"]["tokens"]["value"] >= out["check"]["lines"]["value"] >= 3


@pytest.mark.parametrize("fault", ["token", "half"])
def test_a_planted_fault_is_not_correct(small, fault):
    with planted(fault):
        out = run_cell(small, CELL, SEED + 1, 0.5, False, "cpu")
    assert out["correct"] is False, out["check"]


def made_up_run(model, device, served, dtype="float32"):
    return Run({"serve": {"compute_dtype": dtype}}, {"model": model}, 0.0, 1.0, served,
               trace=Trace(1.0, device, [], 7) if device is not None else None)


def test_encode_roofline_counts_real_chunks_over_the_dispatch_threads_busy_time(root):
    spec = Spec(root)
    reader = spec.reader("encode_roofline_pct")
    model = spec.config("resnet_seeded")["model"]
    # two requests: lines of 9 and 12 real chunks (a 9-chunk line pads to the 12-chunk bucket), then one of 8
    served = [Served(2, [9, 12], [70, 90], 0.5), Served(1, [8], [60], 0.2)]
    # the dispatch thread ("other") busy 0.004 + 0.001 s; the caller's decode ("main") is not the encode's
    device = [(0.0, 0.002, "fprop", "other"), (0.001, 0.004, "fprop", "other"), (0.0, 0.5, "k2", "main"),
              (0.6, 0.601, "copy", "other")]
    flops = sum(yardstick.line_encode_flops(model, c) for c in (9, 12, 8))
    assert reader(made_up_run(model, device, served)) == pytest.approx(100 * flops / 67e12 / 0.005)
    assert reader(made_up_run(model, device, served, "bfloat16")) == pytest.approx(100 * flops / 989e12 / 0.005)
    assert reader(made_up_run(model, None, served)) is None  # untraced
    assert reader(made_up_run(model, [(0.0, 0.5, "k2", "main")], served)) is None  # nothing from the dispatch thread
    assert reader(made_up_run(model, device, [])) is None
