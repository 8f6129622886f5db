"""Whole runs on the CPU at small sizes, the card's look skipped: the result
line's keys, and ``correct`` false once a fault is planted under the timed
path (tests/faults.py) in each cell."""

import json
import shutil

import pytest

from perfbench.harness.cli import run_cell
from perfbench.harness.spec import Spec

from .faults import planted

SEED = 2**31 + 17
SMALL_MIX = {"train_real_lines": {"samples": 40},
             "pages_real_lines": {"lines_per_request": {"low": 6, "high": 7}}}


@pytest.fixture(scope="module")
def small(root, tmp_path_factory):
    """The benchmark's files with each mix cut to a few short lines a request."""
    d = tmp_path_factory.mktemp("perfbench")
    for sub in ("configs", "workloads", "traffic", "metrics", "data"):
        shutil.copytree(root / "perfbench" / sub, d / sub)
    for name, cut in SMALL_MIX.items():
        path = d / "traffic" / f"{name}.json"
        mix = json.loads(path.read_text())
        if "samples" in cut:  # a training set of 40 lines, batches of 4, groups of 2
            mix["samples"] = cut["samples"]
            path.write_text(json.dumps(mix))
            work = d / "workloads" / "train_se_vgg_b32_mixed.json"
            cell = json.loads(work.read_text())
            cell["train"].update(batch_size=4, dispatch_group=2)
            # the CPU's float32 backward (its own convolution algorithms) departs from the reference's by up
            # to 5e-6 in the loss and 5e-3 in the norms at this size; the card's, by 1e-6 and 2e-3
            cell["check"] = {"loss_gap": 1e-3, "grad_norm_gap": 1e-2, "update_norm_gap": 1e-2,
                             "group_loss_gap": 1e-3, "group_update_gap": 1e-2}
            work.write_text(json.dumps(cell))
            continue
        mix["lines_per_request"] = cut["lines_per_request"]
        path.write_text(json.dumps(mix))
    return Spec(root, d)


CELLS = ["serve_se_vgg_beam3_pages", "serve_se_vgg_seeded_beam3_pages", "train_se_vgg_b32_mixed"]
# the faults each cell can have
FAULTS = {"serve_se_vgg_beam3_pages": ("token", "half"), "serve_se_vgg_seeded_beam3_pages": ("token", "half"),
          "train_se_vgg_b32_mixed": ("train_half", "train_group")}


@pytest.mark.parametrize("cell", CELLS)
def test_result_line(small, cell):
    out = run_cell(small, cell, SEED, 0.5, False, "cpu")
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"], out["check"]
    assert list(out)[-1] == "check" and set(out) == {"correct", "attempted", "failed", "metrics", "device", "check"}
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {m["name"] for m in small.metrics(cell, traced=False)}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    compared = {k: v for k, v in out["check"].items() if "limit" in v}
    assert compared and all(v["value"] <= v["limit"] for v in compared.values())
    json.dumps(out)


@pytest.mark.parametrize("cell, fault", [(c, f) for c in CELLS for f in FAULTS[c]])
def test_a_planted_fault_is_not_correct(small, cell, fault):
    with planted(fault):
        out = run_cell(small, cell, SEED + 1, 0.5, False, "cpu")
    assert out["correct"] is False, out["check"]


def test_every_cell_is_run_here(root):
    assert sorted(w["name"] for w in Spec(root).benchmark["workloads"]) == sorted(CELLS)
    assert sorted(p.stem for p in (root / "perfbench" / "workloads").glob("*.json")) == sorted(CELLS)


def test_a_state_left_unchanged_reads_one():
    from perfbench.harness.check import _gap

    ref = {("a",): 2.0, ("b",): 0.5, ("c",): 1.0}
    assert _gap({k: 0.0 for k in ref}, ref) == 1.0
