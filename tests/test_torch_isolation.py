"""The PyTorch port stands alone and never hides the device.

* Importing ``khmer_ocr_torch`` (or every module of it) leaves JAX and the
  JAX package out of ``sys.modules``; no file of the port, nor chip_smoke.py,
  names the JAX package or imports JAX.
* The entry points need a CUDA card unless the caller asks for the CPU:
  without one they raise. A kernel wrapper handed a tensor that is not on the
  CPU launches its kernel or raises; it never falls back to the plain version.

The torch-side checks run in one subprocess (this file run as a script).
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "khmer_ocr_torch"
PORT_FILES = sorted(p.relative_to(REPO).as_posix() for p in PORT.rglob("*")
                    if p.suffix in (".py", ".cu", ".json") and "_build" not in p.parts) + ["chip_smoke.py"]
IMPORTS_JAX = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.])", re.M)

RAISES = ("predictor_without_device", "recognize_without_device", "recognize_batch_without_device",
          "lstm_wrapper_on_meta", "decode_step_wrapper_on_meta")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import khmer_ocr_torch
for m in pkgutil.walk_packages(khmer_ocr_torch.__path__, "khmer_ocr_torch."):
    importlib.import_module(m.name)
"""


@pytest.mark.parametrize("code", ["import khmer_ocr_torch", _IMPORT_ALL], ids=["package", "every_module"])
def test_import_loads_neither_jax_nor_the_jax_package(code):
    probe = code + "\nimport sys\nprint(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'khmer_ocr_tpu')))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_file_names_no_jax_package(rel):
    text = (REPO / rel).read_text(encoding="utf-8")
    assert "khmer_ocr_tpu" not in text
    assert not IMPORTS_JAX.search(text)


@pytest.fixture(scope="module")
def no_card(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_isolation")
    subprocess.run([sys.executable, __file__, str(tmp)], cwd=REPO, check=True, timeout=300)
    return json.loads((tmp / "result.json").read_text())


@pytest.mark.parametrize("case", RAISES)
def test_raises_without_card(no_card, case):
    assert no_card[case].startswith("RuntimeError"), no_card[case]


def test_cpu_on_request_runs_and_kernels_stay_unlaunched(no_card):
    assert no_card["cpu_strings"] and all(isinstance(s, str) for s in no_card["cpu_strings"])
    assert no_card["launches"] == [0, 0]


def _port_main(tmp: Path) -> None:
    sys.path.insert(0, str(REPO))
    import torch

    import khmer_ocr_torch
    from khmer_ocr_torch.config import ModelConfig
    from khmer_ocr_torch.convert.from_jax import save_npz, seeded_params
    from khmer_ocr_torch.data.synthetic import synthetic_lines
    from khmer_ocr_torch.infer.api import set_predictor
    from khmer_ocr_torch.infer.predictor import Predictor
    from khmer_ocr_torch.ops.kernels import decode_step, lstm

    torch.cuda.is_available = lambda: False  # the checks below are about a machine without a card
    cfg = ModelConfig(emb_dim=32, num_heads=4, enc_layers=1, dec_layers=1, enc_ffn_dim=64, max_global_len=256,
                      decode_max_len=16)
    params, stats = seeded_params(cfg, 0)
    save_npz(tmp / "toy.npz", params, stats, cfg)
    lines = synthetic_lines([1, 2], seed=0)
    res = {}

    def attempt(name, fn):
        try:
            fn()
            res[name] = "returned"
        except Exception as e:  # recorded and asserted on by the tests
            res[name] = f"{type(e).__name__}: {e}"

    attempt("predictor_without_device", lambda: Predictor(params=params, batch_stats=stats, model_cfg=cfg))
    attempt("recognize_without_device", lambda: khmer_ocr_torch.recognize(lines[0], model_path=tmp / "toy.npz"))
    set_predictor(None)
    attempt("recognize_batch_without_device",
            lambda: khmer_ocr_torch.recognize_batch(lines, beam_width=3, model_path=tmp / "toy.npz"))
    meta = dict(device="meta")
    attempt("lstm_wrapper_on_meta",
            lambda: lstm.lstm_recurrence(torch.empty(1, 4, 768, **meta), torch.empty(192, 768, **meta)))
    d, f = 32, 128
    wt = {k: torch.empty(*s, **meta) for k, s in dict(
        qkv_w=(d, 3 * d), qkv_b=(3 * d,), so_w=(d, d), so_b=(d,), ln1_s=(d,), ln1_b=(d,), cq_w=(d, d), cq_b=(d,),
        co_w=(d, d), co_b=(d,), ln2_s=(d,), ln2_b=(d,), l1_w=(d, f), l1_b=(f,), l2_w=(f, d), l2_b=(d,),
        ln3_s=(d,), ln3_b=(d,)).items()}
    attempt("decode_step_wrapper_on_meta",
            lambda: decode_step.decoder_layer_step(
                wt, torch.empty(3, d, **meta), 0, torch.empty(3, 8, d, **meta), torch.empty(3, 8, d, **meta),
                torch.empty(1, 32, d, **meta), torch.empty(1, 32, d, **meta), torch.empty(1, 32, **meta),
                torch.zeros(3, 8, dtype=torch.int32, device="meta"), num_heads=4, window=8, lanes=3))
    set_predictor(Predictor(params=params, batch_stats=stats, model_cfg=cfg, device="cpu"))
    res["cpu_strings"] = khmer_ocr_torch.recognize_batch(lines, beam_width=3)
    res["launches"] = [lstm.launches, decode_step.launches]
    (tmp / "result.json").write_text(json.dumps(res))


if __name__ == "__main__":
    _port_main(Path(sys.argv[1]))
