"""The port's main path end to end against the JAX package, on the CPU.

* The flagship checkpoint (checkpoints/se_vgg_flagship, loaded by the JAX
  package and cast to float32) decodes rendered Khmer lines with beam 3:
  the strings of ``khmer_ocr_torch`` ``Predictor(device="cpu")`` must EQUAL
  those of the JAX ``Predictor`` (float32, "highest"), and the memory after
  the BiLSTM must agree within 1e-4 (two encoder layers and a 4096-step-capable
  recurrence after the input, float32 sums in another order).
* The golden tokens that chip_smoke.py holds the card's output to
  (khmer_ocr_torch/assets/smoke_golden.json) are recomputed by the JAX
  package from the same seeded weights and synthetic lines, so the file
  cannot go stale.

The port side runs in a torch-only subprocess (this file run as a script);
torch compute followed by jitted JAX in one process can hang.

    python tests/test_torch_slice.py golden     # rewrite the golden tokens
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
CKPT = REPO / "checkpoints" / "se_vgg_flagship"
GOLDEN = REPO / "khmer_ocr_torch" / "assets" / "smoke_golden.json"
N_LINES = 6
# chip_smoke.py's end-to-end lines: buckets 1/2/4/8 (7 pads into bucket 8), one
# 32-chunk line and one 128-chunk line (Tm = 4096)
SMOKE = dict(seed=0, lines_seed=0, chunk_counts=[1, 1, 1, 1, 2, 2, 2, 2, 4, 4, 4, 4, 7, 8, 8, 7, 32, 128],
             beam_width=3, batch_size=8, max_len=64)


def _strip(row) -> list[int]:
    out = [int(v) for v in row]
    while out and out[-1] == 0:
        out.pop()
    return out


def _jax_tokens(params, stats, lines, beam_width, batch_size, max_len):
    """Token rows of the JAX Predictor's own dispatch, in input order."""
    import jax

    from khmer_ocr_tpu.config import ModelConfig
    from khmer_ocr_tpu.infer.predictor import Predictor

    pred = Predictor(params=jax.tree.map(np.asarray, params), batch_stats=stats, model_cfg=ModelConfig())
    rows = [None] * len(lines)
    for batch in pred.preprocessor.iter_batches(lines, max_batch=batch_size):
        tok, b = pred._dispatch_prepared(batch, beam_width, max_len)
        for i, r in zip(batch.indices, np.asarray(tok)[:b]):
            rows[i] = _strip(r)
    return rows


def golden_tokens():
    from khmer_ocr_torch.config import ModelConfig
    from khmer_ocr_torch.convert.from_jax import seeded_params
    from khmer_ocr_torch.data.synthetic import synthetic_lines

    params, stats = seeded_params(ModelConfig(), SMOKE["seed"])
    lines = synthetic_lines(SMOKE["chunk_counts"], seed=SMOKE["lines_seed"])
    return _jax_tokens(params, stats, lines, SMOKE["beam_width"], SMOKE["batch_size"], SMOKE["max_len"])


if __name__ != "__main__":
    import jax
    import jax.numpy as jnp

    @pytest.fixture(scope="module")
    def slice_run(tmp_path_factory):
        from PIL import Image

        from khmer_ocr_torch.convert.from_jax import save_npz
        from khmer_ocr_tpu.config import PreprocessConfig
        from khmer_ocr_tpu.data.generator import DocumentTextGenerator
        from khmer_ocr_tpu.preprocess import resize_line_u8
        from khmer_ocr_tpu.train.checkpoint import load_checkpoint

        tmp = tmp_path_factory.mktemp("torch_slice")
        params, stats, cfg = load_checkpoint(CKPT)
        f32 = lambda t: jax.tree.map(lambda v: np.asarray(v, np.float32), t)
        params, stats = f32(params), f32(stats)
        gen = DocumentTextGenerator(seed=123, augment=False, words_per_sample=(2, 5))
        texts, lines = [], []
        for i in range(N_LINES):
            img, text = gen.sample(np.random.default_rng(1000 + i))
            texts.append(text)
            lines.append(resize_line_u8(Image.fromarray(img), PreprocessConfig()))
        save_npz(tmp / "flagship.npz", params, stats, cfg)
        np.savez(tmp / "lines.npz", **{f"line_{i}": l for i, l in enumerate(lines)})
        subprocess.run([sys.executable, __file__, "port", str(tmp)], cwd=REPO, check=True, timeout=600)
        port = json.loads((tmp / "port.json").read_text())
        with np.load(tmp / "port_memory.npz") as z:
            port_mem = {k: z[k] for k in z.files}
        return dict(params=params, stats=stats, cfg=cfg, lines=lines, texts=texts, port=port, port_mem=port_mem)

    def test_flagship_beam3_strings_equal(slice_run):
        from khmer_ocr_tpu.infer.predictor import Predictor

        pred = Predictor(params=slice_run["params"], batch_stats=slice_run["stats"], model_cfg=slice_run["cfg"])
        ref = pred.predict_batch(slice_run["lines"], beam_width=3)
        assert slice_run["port"]["strings"] == ref
        # the checkpoint reads these lines: the comparison is between real strings
        assert sum(r == t for r, t in zip(ref, slice_run["texts"])) >= N_LINES // 2, (ref, slice_run["texts"])

    def test_flagship_memory_within_1e4(slice_run):
        from khmer_ocr_tpu.infer.predictor import Predictor, _device_chunk
        from khmer_ocr_tpu.models.layers import Ctx
        from khmer_ocr_tpu.models.ocr_model import encode

        cfg = slice_run["cfg"]
        pred = Predictor(params=slice_run["params"], batch_stats=slice_run["stats"], model_cfg=cfg)
        ctx = Ctx(num_heads=cfg.num_heads, dropout=0.0, deterministic=True)

        @jax.jit
        def enc(p, s, u8, n):
            chunks = _device_chunk((u8.astype(jnp.float32) / 255.0 - 0.5) / 0.5, (100, 84))
            return encode(p, s, chunks, n, cfg, ctx)[:2]

        batches = list(pred.preprocessor.iter_batches(slice_run["lines"], max_batch=8))
        assert [b.indices for b in batches] == slice_run["port"]["batches"]
        for j, batch in enumerate(batches):
            chunks, counts, b = pred._padded_host(batch)
            with jax.default_matmul_precision("highest"):
                mem, pad = enc(pred.params, pred.batch_stats, jnp.asarray(chunks), jnp.asarray(counts))
            valid = ~np.asarray(pad)[:b]
            np.testing.assert_array_equal(slice_run["port_mem"][f"pad_{j}"], ~valid)
            got, ref = slice_run["port_mem"][f"memory_{j}"][valid], np.asarray(mem)[:b][valid]
            assert np.abs(got - ref).max() <= 1e-4, np.abs(got - ref).max()

    def test_smoke_golden_tokens_are_current():
        """All of chip_smoke.py's lines, recomputed by the JAX package."""
        golden = json.loads(GOLDEN.read_text())
        assert {k: golden[k] for k in SMOKE} == SMOKE
        assert golden_tokens() == golden["tokens"]


def _port_main(tmp: Path) -> None:
    sys.path.insert(0, str(REPO))
    import torch

    from khmer_ocr_torch.infer.predictor import Predictor
    from khmer_ocr_torch.models.ocr_model import encode
    from khmer_ocr_torch.ops.lines import device_chunk, u8_to_unit, unit_normalize

    torch.set_num_threads(4)
    with np.load(tmp / "lines.npz") as z:
        lines = [z[f"line_{i}"] for i in range(len(z.files))]
    pred = Predictor(model_path=tmp / "flagship.npz", device="cpu")
    strings = pred.predict_batch(lines, beam_width=3)
    mem_out, batches = {}, []
    with torch.inference_mode():
        for j, batch in enumerate(pred.preprocessor.iter_batches(lines, max_batch=8)):
            batches.append(batch.indices)
            u8, counts, b = pred._to_device_batch(batch)
            memory, pad = encode(pred.params, device_chunk(unit_normalize(u8_to_unit(u8)), (100, 84)), counts,
                                 pred.model_cfg)
            mem_out[f"memory_{j}"], mem_out[f"pad_{j}"] = memory[:b].numpy(), pad[:b].numpy()
    np.savez(tmp / "port_memory.npz", **mem_out)
    (tmp / "port.json").write_text(json.dumps({"strings": strings, "batches": batches}, ensure_ascii=False))


def _write_golden() -> None:
    sys.path.insert(0, str(REPO))
    import os

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    with jax.default_matmul_precision("highest"):
        rows = golden_tokens()
    GOLDEN.write_text(json.dumps({**SMOKE, "tokens": rows,
                                  "made_by": "tests/test_torch_slice.py golden: the JAX package's Predictor, "
                                             "CPU, float32, matmul precision highest"}, indent=1) + "\n")
    print(f"wrote {GOLDEN} ({len(rows)} lines)")


if __name__ == "__main__":
    if sys.argv[1] == "golden":
        _write_golden()
    else:
        _port_main(Path(sys.argv[2]))
