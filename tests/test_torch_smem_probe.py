"""Kernel K4's plain version and the probe's bisection, on the CPU.

* The plain version computes row 0 as x[0] + 2 x[0], exactly what the kernel
  adds up from its buffer's first and last rows, and leaves rows 1-7 zero;
  the wrapper takes it for a CPU tensor. Exact.
* The ladder and the bisection, driven by a fake ``try_bytes`` that accepts
  every size up to a known limit, end within 1 KB below the limit with the
  size above it refused; with no size refused, or the smallest size refused,
  the probe raises instead of guessing.

The torch side runs in a subprocess (this file run as a script), as the
port's other test files do.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
# H100 (227 KB), A100 (163 KB), Ada/Ampere consumer parts (99 KB), the 48 KB default, a tiny card
LIMITS = (232448, 166912, 101376, 49152, 1536)


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_smem_probe")
    subprocess.run([sys.executable, __file__, str(tmp)], cwd=REPO, check=True, timeout=300)
    return json.loads((tmp / "result.json").read_text())


def test_plain_row0_and_untouched_rows(probe):
    assert probe["plain_row0_exact"] and probe["plain_rest_zero"]


def test_cpu_tensor_takes_the_plain_version(probe):
    assert probe["wrapper_is_plain"] and probe["launches"] == 0


@pytest.mark.parametrize("limit", LIMITS)
def test_bisection_converges_within_1kb(probe, limit):
    best, refused = probe["bisect"][str(limit)]
    assert best <= limit < refused
    assert refused - best <= 1024
    assert limit - best < 1024


@pytest.mark.parametrize("case", ["nothing_refused", "smallest_refused"])
def test_probe_raises_without_a_bracket(probe, case):
    assert probe[case].startswith("RuntimeError"), probe[case]


def _port_main(tmp: Path) -> None:
    sys.path.insert(0, str(REPO))
    import torch

    from khmer_ocr_torch.ops.kernels import build
    from khmer_ocr_torch.ops.kernels import smem_probe as K

    x = K.probe_input("cpu")
    plain = K.smem_probe_plain(x)
    res = {
        "plain_row0_exact": bool(torch.equal(plain[0], x[0] + 2.0 * x[0])),
        "plain_rest_zero": bool((plain[1:] == 0).all()),
        "wrapper_is_plain": bool(torch.equal(K.smem_probe(x, 4096), plain)),
        "launches": build.launches["k4"],
        "bisect": {},
    }
    for limit in LIMITS:
        res["bisect"][str(limit)] = list(K.probe_max_bytes(lambda n, lim=limit: n <= lim))
    for case, fake in (("nothing_refused", lambda n: True), ("smallest_refused", lambda n: False)):
        try:
            res[case] = f"returned {K.probe_max_bytes(fake)}"
        except RuntimeError as e:  # recorded and asserted on by the test
            res[case] = f"RuntimeError: {e}"
    (tmp / "result.json").write_text(json.dumps(res))


if __name__ == "__main__":
    _port_main(Path(sys.argv[1]))
