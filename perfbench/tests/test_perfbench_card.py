"""On the card at each cell's own size: the control (the reference at TF32
in the program's place) comes out as not correct where it can fail. Run on
the card: ``python -m pytest perfbench/tests -q -m card``."""

import json
import subprocess
import sys

import pytest

pytestmark = pytest.mark.card


def run(root, *args):
    out = subprocess.run([sys.executable, "perfbench/run.py", *args], cwd=root, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["serve_se_vgg_seeded_beam3_pages", "train_se_vgg_b32_mixed"])
def test_the_control_is_not_correct(card, root, cell):
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        out = run(root, "--workload", cell, "--seed", str(seed), "--seconds", "10", "--trace", "0",
                  "--control", "tf32")
        assert out["correct"] is False, out["check"]
