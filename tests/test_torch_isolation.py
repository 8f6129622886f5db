"""The PyTorch port stands alone and never hides the device.

* Importing ``khmer_ocr_torch`` (or every module of it) leaves JAX and the
  JAX package out of ``sys.modules``, and Pillow, OpenCV and safetensors
  too (the card's machine may lack them; the modules that use them import
  them inside their functions); no file of the port, nor chip_smoke.py,
  names the JAX package or imports JAX.
* The entry points (the Predictor, ``recognize``, ``recognize_batch``, the
  CLI, ``train()``, the train CLI, the layout trainer's ``finetune`` and
  CLI, the evaluation CLI, and the page path's
  ``LayoutInference``, ``KhmerOCRPipeline(engine="custom")``,
  ``run_layout_aware_pipeline``, ``KhmerOCRInference`` and the layout,
  pipeline and PDF CLIs) need a CUDA card unless the caller asks for the
  CPU: without one they raise; ``--data-parallel`` without a process group
  raises too. A kernel wrapper handed a tensor that is not on the
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
                    if p.suffix in (".py", ".cu", ".cuh", ".json") and "_build" not in p.parts) + [
    "chip_smoke.py", "examples/probe_smem_torch.py", "examples/profile_torch_e2e.py", "examples/k1_routes_torch.py",
    "examples/layout_determinism_torch.py"]
IMPORTS_JAX = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.])", re.M)

RAISES = ("predictor_without_device", "recognize_without_device", "recognize_batch_without_device",
          "cli_without_device", "lstm_wrapper_on_meta", "decode_step_wrapper_on_meta",
          "decode_loop_wrapper_on_meta", "smem_probe_wrapper_on_meta", "train_without_device",
          "train_cli_without_device", "lstm_backward_wrapper_on_meta", "evaluate_cli_without_device",
          "layout_inference_without_device", "pipeline_custom_without_device",
          "layout_aware_pipeline_without_device", "standalone_without_device", "layout_cli_without_device",
          "pipeline_cli_without_device", "pdf_cli_without_device", "layout_finetune_without_device",
          "layout_train_cli_without_device", "data_parallel_cli_without_torchrun",
          "data_parallel_cli_cpu_without_torchrun", "decode_step_bf16_wrapper_on_meta",
          "decode_step_head_wrapper_on_meta", "decoder_block_wrapper_on_meta", "decode_loop_bf16_wrapper_on_meta",
          "bf16_predictor_without_device", "make_mesh_without_a_group")

_PAGE_PATH = ("import khmer_ocr_torch.detection.detector, khmer_ocr_torch.detection.cli, "
              "khmer_ocr_torch.detection.surya, khmer_ocr_torch.pipeline.engine, khmer_ocr_torch.pipeline.document, "
              "khmer_ocr_torch.pipeline.pdf, khmer_ocr_torch.infer.standalone, khmer_ocr_torch.detection.graphs")
_TRAINING = ("import khmer_ocr_torch.detection.train, khmer_ocr_torch.train.augment, khmer_ocr_torch.parallel.mesh, "
             "khmer_ocr_torch.train.cli, khmer_ocr_torch.detection.graphs")
_TENTH_SLICE = ("import khmer_ocr_torch.parallel.placement, khmer_ocr_torch.parallel.mesh, "
                "khmer_ocr_torch.native.imageio, khmer_ocr_torch.preprocess, khmer_ocr_torch.infer.api, "
                "khmer_ocr_torch.ops.kernels.decode_step, khmer_ocr_torch.decode.beam")
_IMPORT_ALL = """
import importlib, pkgutil, sys
import khmer_ocr_torch
for m in pkgutil.walk_packages(khmer_ocr_torch.__path__, "khmer_ocr_torch."):
    importlib.import_module(m.name)
"""


@pytest.mark.parametrize("code", ["import khmer_ocr_torch", _IMPORT_ALL, "import khmer_ocr_torch.train.loop", _PAGE_PATH,
                                  _TRAINING, _TENTH_SLICE],
                         ids=["package", "every_module", "train_loop", "page_path", "training", "tenth_slice"])
def test_import_loads_neither_jax_nor_the_jax_package(code):
    probe = code + "\nimport sys\nprint(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'khmer_ocr_tpu')))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


@pytest.mark.parametrize("code", ["import khmer_ocr_torch", _IMPORT_ALL, "import khmer_ocr_torch.evaluate", _PAGE_PATH,
                                  _TRAINING], ids=["package", "every_module", "evaluate", "page_path", "training"])
def test_import_loads_no_pillow_opencv_or_safetensors(code):
    probe = code + "\nimport sys\nprint(sorted(m for m in sys.modules if m.split('.')[0] in ('PIL', 'cv2', " \
                   "'safetensors')))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_lazy_exports_load_neither_torch_nor_opencv():
    """The package's light exports (``Evaluator``, ``calculate_cer``,
    ``levenshtein``, ``TrainConfig``) come without torch or OpenCV."""
    probe = ("import sys, khmer_ocr_torch as k\n"
             "assert k.Evaluator and k.calculate_cer('ab', 'ab') == 0.0 and k.levenshtein('ab', 'b') == 1\n"
             "assert k.TrainConfig().batch_size == 32\n"
             "print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'cv2', 'jax')))")
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
    """Beam 3 on the CPU, with the host loop and with the whole-decode path:
    the same strings, and none of the five kernels launched."""
    assert no_card["cpu_strings"] and all(isinstance(s, str) for s in no_card["cpu_strings"])
    assert no_card["cpu_strings_mega"] == no_card["cpu_strings"]
    assert no_card["mega_batches"] > 0
    assert no_card["launches"] == [0, 0, 0, 0, 0]


def test_page_path_on_cpu_on_request(no_card):
    """KhmerOCRPipeline(engine="custom", device="cpu").process_pages reads a
    page through the plain versions: a string a page, no kernel launched."""
    assert len(no_card["page_texts"]) == 1 and isinstance(no_card["page_texts"][0], str)
    assert no_card["page_launches"] == [0, 0, 0]


def test_train_on_cpu_on_request(no_card):
    """train(device="cpu") at se_vgg with the BiLSTM takes its steps
    through the plain versions of K1 and K1b: no kernel launched."""
    assert no_card["train_steps"] == 2
    assert no_card["train_launches"] == [0, 0]


def _port_main(tmp: Path) -> None:
    import os

    sys.path.insert(0, str(REPO))
    import torch

    import khmer_ocr_torch
    from khmer_ocr_torch.config import ModelConfig
    from khmer_ocr_torch.convert.from_jax import save_npz, seeded_params
    from khmer_ocr_torch.data.synthetic import synthetic_lines
    from khmer_ocr_torch import evaluate
    from khmer_ocr_torch.config import DecodeConfig
    from khmer_ocr_torch.convert.from_jax import params_from_jax
    from khmer_ocr_torch.infer import cli
    from khmer_ocr_torch.infer.api import set_predictor
    from khmer_ocr_torch.infer.predictor import Predictor
    from khmer_ocr_torch.ops.kernels import build, decode_loop, decode_step, lstm, lstm_backward, smem_probe
    from khmer_ocr_torch.train import cli as train_cli
    from khmer_ocr_torch.train.data import LineDataset
    from khmer_ocr_torch.train.loop import train

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
    set_predictor(None)
    attempt("cli_without_device", lambda: cli.main(["--image", str(tmp / "line.png"), "--model", str(tmp / "toy.npz")]))
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
    attempt("decode_loop_wrapper_on_meta",
            lambda: decode_loop.fused_beam_decode(params_from_jax(params, stats, cfg, device="meta"),
                                                  torch.empty(2, 32, d, **meta),
                                                  torch.zeros(2, 32, dtype=torch.bool, device="meta"), cfg,
                                                  DecodeConfig(beam_width=3, max_len=8)))
    attempt("smem_probe_wrapper_on_meta", lambda: smem_probe.smem_probe(torch.empty(8, 128, **meta), 2048))
    bf = dict(device="meta", dtype=torch.bfloat16)
    wt16 = {k: (torch.empty(*v.shape, **bf) if k in decode_step.MATRIX_FIELDS else v) for k, v in wt.items()}
    attempt("decode_step_bf16_wrapper_on_meta",
            lambda: decode_step.decoder_layer_step(
                wt16, torch.empty(3, d, **bf), 0, torch.empty(3, 8, d, **bf), torch.empty(3, 8, d, **bf),
                torch.empty(1, 32, d, **bf), torch.empty(1, 32, d, **bf), torch.empty(1, 32, **meta),
                torch.zeros(3, 8, dtype=torch.int32, device="meta"), num_heads=4, window=8, lanes=3))
    attempt("decode_step_head_wrapper_on_meta",
            lambda: decode_step.decoder_layer_step(
                wt, torch.empty(3, d, **meta), 0, torch.empty(3, 8, d, **meta), torch.empty(3, 8, d, **meta),
                torch.empty(1, 32, d, **meta), torch.empty(1, 32, d, **meta), torch.empty(1, 32, **meta),
                torch.zeros(3, 8, dtype=torch.int32, device="meta"), num_heads=4, window=8, lanes=3,
                head=(torch.empty(d, 128, **meta), torch.empty(128, **meta), 124)))
    attempt("decoder_block_wrapper_on_meta",
            lambda: decode_step.decoder_block("ffn", wt, torch.empty(3, d, **meta), torch.empty(3, d, **meta),
                                              num_heads=4, lanes=3, prologue=(wt["co_b"], wt["ln2_s"], wt["ln2_b"])))
    attempt("decode_loop_bf16_wrapper_on_meta",
            lambda: decode_loop.fused_beam_decode(params_from_jax(params, stats, cfg, device="meta"),
                                                  torch.empty(2, 32, d, **bf),
                                                  torch.zeros(2, 32, dtype=torch.bool, device="meta"), cfg,
                                                  DecodeConfig(beam_width=3, max_len=8)))
    from khmer_ocr_torch.config import OCRConfig as _OCRConfig
    from khmer_ocr_torch.config import RuntimeConfig as _RuntimeConfig
    from khmer_ocr_torch.parallel.mesh import make_mesh

    attempt("bf16_predictor_without_device",
            lambda: Predictor(params=params, batch_stats=stats, model_cfg=cfg,
                              config=_OCRConfig(runtime=_RuntimeConfig(compute_dtype="bfloat16"))))
    attempt("make_mesh_without_a_group", lambda: make_mesh(1, 2))
    attempt("lstm_backward_wrapper_on_meta",
            lambda: lstm_backward.lstm_adjoint(torch.empty(1, 4, 768, **meta), torch.empty(1, 4, 192, **meta),
                                               torch.empty(1, 4, 192, **meta), torch.empty(192, 768, **meta)))
    from khmer_ocr_torch.config import OCRConfig, TrainConfig

    ocfg = OCRConfig(model=cfg, train=TrainConfig(batch_size=2, epoch_sample_size=4, checkpoint_every_epochs=100))
    dataset = LineDataset([(line, "ab") for line in synthetic_lines([1, 1, 1, 1], seed=1)], device_augment=True)
    attempt("train_without_device", lambda: train(dataset, ocfg, tmp / "ck", num_epochs=1))
    attempt("train_cli_without_device", lambda: train_cli.main(["--synthetic", "2", "--epochs", "1",
                                                                "--checkpoint-dir", str(tmp / "cli")]))
    attempt("evaluate_cli_without_device",
            lambda: evaluate.main(["--data", str(tmp), "--model", str(tmp / "toy.npz")]))
    from PIL import Image

    from khmer_ocr_torch.convert.from_jax import seeded_segformer_state
    from khmer_ocr_torch.detection import cli as layout_cli
    from khmer_ocr_torch.detection.detector import LayoutInference
    from khmer_ocr_torch.detection.segformer import save_hf_checkpoint
    from khmer_ocr_torch.infer.standalone import KhmerOCRInference
    from khmer_ocr_torch.pipeline import engine as pipeline_cli
    from khmer_ocr_torch.pipeline import pdf as pdf_cli
    from khmer_ocr_torch.pipeline.document import run_layout_aware_pipeline
    from khmer_ocr_torch.pipeline.engine import KhmerOCRPipeline

    layout, toy, page = str(save_hf_checkpoint(tmp / "layout", seeded_segformer_state(None, 0))), str(tmp / "toy.npz"), \
        str(tmp / "page.png")
    Image.fromarray(lines[1]).save(page)
    attempt("layout_inference_without_device", lambda: LayoutInference(layout))
    attempt("pipeline_custom_without_device",
            lambda: KhmerOCRPipeline(engine="custom", layout_model_dir=layout, recognizer_model_path=toy))
    attempt("layout_aware_pipeline_without_device",
            lambda: run_layout_aware_pipeline(page, model_path=toy, engine="custom", layout_model_dir=layout))
    attempt("standalone_without_device", lambda: KhmerOCRInference(toy))
    attempt("layout_cli_without_device",
            lambda: layout_cli.main(["--image", page, "--model", layout, "--output", str(tmp / "det")]))
    attempt("pipeline_cli_without_device",
            lambda: pipeline_cli.main(["--image", page, "--engine", "custom", "--layout-model", layout,
                                       "--recognizer", toy, "--output", str(tmp / "out.txt")]))
    attempt("pdf_cli_without_device",
            lambda: pdf_cli.main(["--image", page, "--model", toy, "--font", str(tmp / "none.ttf"), "--engine",
                                  "custom", "--layout-model", layout, "--outdir", str(tmp / "pdf")]))
    from khmer_ocr_torch.detection import train as layout_train

    attempt("layout_finetune_without_device", lambda: layout_train.finetune(steps=1, batch_size=1, image_size=64))
    attempt("layout_train_cli_without_device",
            lambda: layout_train.main(["--steps", "1", "--image-size", "64", "--out", str(tmp / "lt.npz")]))
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        os.environ.pop(var, None)
    attempt("data_parallel_cli_without_torchrun",
            lambda: train_cli.main(["--synthetic", "2", "--epochs", "1", "--data-parallel",
                                    "--checkpoint-dir", str(tmp / "dp")]))
    attempt("data_parallel_cli_cpu_without_torchrun",
            lambda: train_cli.main(["--synthetic", "2", "--epochs", "1", "--data-parallel", "--device", "cpu",
                                    "--checkpoint-dir", str(tmp / "dp")]))
    set_predictor(None)
    cpu_pipe = KhmerOCRPipeline(engine="custom", layout_model_dir=layout, recognizer_model_path=toy, device="cpu")
    res["page_texts"] = cpu_pipe.process_pages([page])
    res["page_launches"] = [build.launches[k] for k in ("k1", "k2", "k3")]
    set_predictor(None)
    state = train(dataset, ocfg, tmp / "ck_cpu", device="cpu", num_epochs=1)
    res["train_steps"] = state.step
    res["train_launches"] = [build.launches[k] for k in ("k1", "k1b")]
    pred = Predictor(params=params, batch_stats=stats, model_cfg=cfg, device="cpu")
    set_predictor(pred)
    res["cpu_strings"] = khmer_ocr_torch.recognize_batch(lines, beam_width=3)
    os.environ["KHMER_OCR_MEGA_DECODE"] = "1"
    res["cpu_strings_mega"] = khmer_ocr_torch.recognize_batch(lines, beam_width=3)
    res["mega_batches"] = pred.mega_batches
    res["launches"] = [build.launches[k] for k in ("k1", "k1b", "k2", "k3", "k4")]
    (tmp / "result.json").write_text(json.dumps(res))


if __name__ == "__main__":
    _port_main(Path(sys.argv[1]))
