"""The harness finds every cell, configuration, mix and metric by name."""

import ast
import json
import re

import pytest

from perfbench.harness.spec import Spec


@pytest.fixture(scope="module")
def spec(root):
    return Spec(root)


def test_every_cell_has_its_files(spec):
    for w in spec.benchmark["workloads"]:
        cell = spec.cell(w["name"])
        assert cell["runner"] in ("serve", "train")
        assert spec.config(cell["config"])["name"] == cell["config"]
        assert "line" in spec.traffic(cell["traffic"])
        limits = [v for k, v in cell["check"].items() if k == "limit" or k.endswith("_gap")]
        assert limits and all(v > 0 for v in limits)


def test_every_metric_has_a_reader(spec):
    for group in ("end_to_end", "per_layer"):
        for m in spec.benchmark[group]:
            assert callable(spec.reader(m["name"]))


def test_each_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(spec):
    for w in spec.benchmark["workloads"]:
        e2e = {m["name"] for m in spec.metrics(w["name"], traced=False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics(w["name"], traced=True)


def test_every_per_layer_metric_moves_a_metric_of_its_cells(spec):
    for m in spec.benchmark["per_layer"]:
        target = next(e for e in spec.benchmark["end_to_end"] if e["name"] == m["moves"])
        for cell in m["workloads"]:
            assert "workloads" not in target or cell in target["workloads"]


def test_configs_name_their_files(spec, root):
    for c in spec.benchmark["configs"]:
        data = json.loads((root / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]


def test_unknown_names_raise(spec):
    with pytest.raises(KeyError):
        spec.cell("no_such_cell")
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric")


def test_reader_modules_parse(root):
    for path in (root / "perfbench" / "metrics").glob("*.py"):
        tree = ast.parse(path.read_text())
        assert any(isinstance(n, ast.FunctionDef) and n.name == "read" for n in tree.body), path


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_its_shape(spec, root):
    b = spec.benchmark
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"] and 1 <= b["run_seconds"] <= 51
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(names)) == len(names) and "setup_s" in names
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in names and 1 <= len(m["layer"]) <= 200
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.match(w["name"]) and 1 <= len(w["why"]) <= 200 and "\t" not in w["why"]
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["file"].startswith("perfbench/")
        assert len(c["why"]) <= 200 and len(c["source"]) <= 200
    assert len(json.dumps(b)) <= 64 * 1024
