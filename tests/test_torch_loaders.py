"""The port's weight loaders against the JAX package's, on the CPU.

Random reference-layout weights (tests/torch_oracle.py, D = 32) for the
se_vgg, vgg and resnet backbones, saved as ``.safetensors``, as a raw
``.pth`` state dict and as a ``{'model_state_dict': ...}`` ``.pth``:

* the port's ``load_and_convert`` gives the JAX package's
  ``load_and_convert`` trees leaf for leaf, exactly, with the same
  ``detect_model_config``, the ``safetensors`` package blocked in the port's
  process (its reader is numpy);
* the port's Predictor loads each file kind, and a checkpoint directory
  written by the port's trainer (``train/checkpoint.py::save_checkpoint``),
  on the CPU: its beam-3 tokens equal the JAX Predictor's on the same file;
* an Orbax checkpoint directory and an unknown suffix raise.

The files are written in one torch subprocess and the port runs in a
second, torch-only one (this file run as a script).
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
BACKBONES = ("se_vgg", "vgg", "resnet")
KINDS = ("model.safetensors", "raw.pth", "wrapped.pth")
EMB, GLOBAL_LEN = 32, 256
BEAM, MAX_LEN = 3, 16
N_LINES = 2


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, prefix + (str(key),)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, prefix + (str(i),)).items()}
    return {"/".join(prefix): np.asarray(tree)}


def _strip(row) -> list[int]:
    out = [int(v) for v in row]
    while out and out[-1] == 0:
        out.pop()
    return out


def _lines():
    with np.load(REPO / "khmer_ocr_torch" / "assets" / "real_lines.npz") as z:
        return [z[f"line_{i}"] for i in range(N_LINES)]


if __name__ != "__main__":
    import jax

    @pytest.fixture(scope="module")
    def run(tmp_path_factory):
        tmp = tmp_path_factory.mktemp("torch_loaders")
        subprocess.run([sys.executable, __file__, "save", str(tmp)], cwd=REPO / "tests", check=True, timeout=600)
        subprocess.run([sys.executable, __file__, "port", str(tmp)], cwd=REPO, check=True, timeout=600)
        return tmp, json.loads((tmp / "port.json").read_text())

    @pytest.mark.parametrize("kind", KINDS)
    @pytest.mark.parametrize("backbone", BACKBONES)
    def test_load_and_convert_equals_jax(run, backbone, kind):
        from khmer_ocr_tpu.convert.torch_loader import load_and_convert

        tmp, port = run
        params, stats, cfg = load_and_convert(tmp / backbone / kind, vocab_size=124)
        assert port["cfg"][f"{backbone}/{kind}"] == dataclasses.asdict(cfg)
        assert cfg.backbone == backbone and cfg.emb_dim == EMB and cfg.use_bilstm == (backbone == "se_vgg")
        with np.load(tmp / backbone / f"{kind}.tree.npz") as z:
            got = {k: z[k] for k in z.files}
        want = {**{f"params/{k}": v for k, v in _flat(params).items()},
                **{f"batch_stats/{k}": v for k, v in _flat(stats).items()}}
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype == np.float32 and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)

    def test_safetensors_package_was_blocked(run):
        assert run[1]["safetensors_blocked"] == "ModuleNotFoundError"

    @pytest.fixture(scope="module")
    def jax_tokens(run):
        from khmer_ocr_tpu.infer.predictor import Predictor

        tmp, _ = run
        pred = Predictor(model_path=tmp / "se_vgg" / "model.safetensors")
        rows = [None] * N_LINES
        with jax.default_matmul_precision("highest"):
            for batch in pred.preprocessor.iter_batches(_lines(), max_batch=8):
                tok, b = pred._dispatch_prepared(batch, BEAM, MAX_LEN)
                for i, r in zip(batch.indices, np.asarray(tok)[:b]):
                    rows[i] = _strip(r)
        return rows

    @pytest.mark.parametrize("kind", KINDS + ("trainer_checkpoint",))
    def test_predictor_tokens_equal_jax(run, jax_tokens, kind):
        assert run[1]["tokens"][kind] == jax_tokens

    @pytest.mark.parametrize("case", ["orbax_directory", "unknown_suffix"])
    def test_unreadable_weights_raise(run, case):
        err = run[1]["raises"][case]
        if case == "orbax_directory":
            assert err.startswith("RuntimeError") and "tensorstore" in err, err
        else:
            assert err.startswith("ValueError"), err


def _save_main(tmp: Path) -> None:
    """The oracle's random weights for each backbone, in each file kind."""
    import torch
    from safetensors.numpy import save_file
    from torch_oracle import KhmerOCR

    for i, backbone in enumerate(BACKBONES):
        torch.manual_seed(i)
        model = KhmerOCR(vocab_size=124, emb_dim=EMB, max_global_len=GLOBAL_LEN, backbone=backbone)
        with torch.no_grad():  # non-trivial BatchNorm statistics
            for name, buf in model.named_buffers():
                if name.endswith("running_mean"):
                    buf.normal_(0.0, 0.05)
                elif name.endswith("running_var"):
                    buf.uniform_(0.5, 1.5)
        sd = model.state_dict()
        out = tmp / backbone
        out.mkdir()
        save_file({k: v.detach().contiguous().numpy() for k, v in sd.items()}, str(out / "model.safetensors"))
        torch.save(sd, out / "raw.pth")
        torch.save({"model_state_dict": sd, "epoch": 7}, out / "wrapped.pth")


def _port_main(tmp: Path) -> None:
    sys.modules["safetensors"] = None  # the port reads .safetensors without the package
    sys.path.insert(0, str(REPO))
    import torch

    from khmer_ocr_torch.convert.from_jax import trainable_from_jax
    from khmer_ocr_torch.convert.torch_loader import load_and_convert
    from khmer_ocr_torch.infer.predictor import Predictor
    from khmer_ocr_torch.train.checkpoint import save_checkpoint

    torch.set_num_threads(4)
    res = {"cfg": {}, "tokens": {}, "raises": {}}
    try:
        import safetensors  # noqa: F401
        res["safetensors_blocked"] = "imported"
    except ImportError as e:
        res["safetensors_blocked"] = type(e).__name__
    for backbone in BACKBONES:
        for kind in KINDS:
            params, stats, cfg = load_and_convert(tmp / backbone / kind, vocab_size=124)
            res["cfg"][f"{backbone}/{kind}"] = dataclasses.asdict(cfg)
            np.savez(tmp / backbone / f"{kind}.tree.npz",
                     **{f"params/{k}": v for k, v in _flat(params).items()},
                     **{f"batch_stats/{k}": v for k, v in _flat(stats).items()})
    params, stats, cfg = load_and_convert(tmp / "se_vgg" / "model.safetensors")
    trainable, batch_stats = trainable_from_jax(params, stats, cfg)
    save_checkpoint(tmp / "trainer_checkpoint", trainable, batch_stats, cfg, step=3, epoch=1)
    lines = _lines()
    for kind in KINDS + ("trainer_checkpoint",):
        path = tmp / "se_vgg" / kind if kind in KINDS else tmp / kind
        pred = Predictor(model_path=path, device="cpu")
        res["tokens"][kind] = [_strip(r) for r in pred.predict_batch_tokens(lines, beam_width=BEAM, max_len=MAX_LEN)]
    (tmp / "weights.bin").write_bytes(b"\0")
    for case, path in (("orbax_directory", REPO / "checkpoints" / "se_vgg_flagship"),
                       ("unknown_suffix", tmp / "weights.bin")):
        try:
            Predictor(model_path=path, device="cpu")
            res["raises"][case] = "returned"
        except Exception as e:  # recorded and asserted on by the tests
            res["raises"][case] = f"{type(e).__name__}: {e}"
    (tmp / "port.json").write_text(json.dumps(res))


if __name__ == "__main__":
    {"save": _save_main, "port": _port_main}[sys.argv[1]](Path(sys.argv[2]))
