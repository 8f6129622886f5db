"""The port's two flagship assets against the checkpoint and the JAX package, on the CPU.

* ``khmer_ocr_torch/assets/flagship/``: the weights index of
  checkpoints/se_vgg_flagship (convert/orbax_index.py) and its
  model_config.json. Loaded by the port without tensorstore, every leaf
  equals the JAX package's ``load_checkpoint`` leaf widened to float32, bit
  for bit; the index equals one rebuilt from the checkpoint now.
* ``khmer_ocr_torch/assets/real_lines.npz`` + ``real_lines.json``: 64 lines
  rendered by the JAX package's generator (seed 123, no augmentation, 2-6
  words, lines of at most 60 tokens), resized to 48 px, with their texts,
  the JAX Predictor's beam-3 strings (max_len 64, batch 8, float32) and the
  mean CER and exact-match share of those strings, and the same three of
  the JAX Predictor in bfloat16 (its speed mode: ``compute_dtype=
  "bfloat16"``, matmul precision "default"), which chip_smoke.py's [bf16]
  phase holds the card to. The lines re-render to the same bytes, the
  recipe and the float32 strings are the ones stored before the bfloat16
  strings joined them, and the first 8 decode to the stored strings, by
  JAX and by the port's Predictor loading the weights directory, in
  float32 and in bfloat16 (the port's bfloat16 strings equal JAX's but for
  lines whose two answers part at a near-tie: their teacher-forced scores,
  the port's float32 model, within 0.05 nats where they first differ).
* ``save_npz``/``load_npz`` keep bfloat16 leaves in 16 bits and widen them
  exactly; float32 files of the earlier layout still load.

The port's decode runs in a torch-only subprocess (this file run as a
script); torch compute followed by jitted JAX in one process can hang.

    python tests/test_torch_flagship.py assets    # rewrite both assets
"""

from __future__ import annotations

import base64
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
CKPT = REPO / "checkpoints" / "se_vgg_flagship"
WEIGHTS = REPO / "khmer_ocr_torch" / "assets" / "flagship"
LINES_NPZ = REPO / "khmer_ocr_torch" / "assets" / "real_lines.npz"
LINES_JSON = REPO / "khmer_ocr_torch" / "assets" / "real_lines.json"
RECIPE = dict(seed=123, augment=False, words_per_sample=[2, 6], rendered=96, lines=64, max_tokens=60,
              beam_width=3, max_len=64, batch_size=8)
N_CHECKED = 8  # lines decoded by both packages in the tests
# sha256 of the float32 strings' JSON (ensure_ascii=False) as first stored: they must not move
F32_STRINGS_SHA256 = "627273bfb9d06d4ffd4cbb4c64712a7998f11e35fbadbba394f99699af8d4f29"
BF16_MARGIN = 0.05  # nats


def build_index() -> dict:
    """The weights index of CKPT, read through tensorstore's OCDBT store:
    each chunk located by its bytes in the data files, or kept inline."""
    import tensorstore as ts

    state = CKPT / "state"
    kv = ts.KvStore.open(f"file://{state}/|ocdbt:").result()
    files = {p.relative_to(CKPT).as_posix(): p.read_bytes() for p in sorted(state.rglob("d/*")) if p.is_file()}
    leaves = []
    for key in kv.list().result():
        name, chunk = key.decode().rsplit("/", 1)
        if chunk == ".zarray":
            continue
        meta = json.loads(kv.read(f"{name}/.zarray").result().value)
        assert meta["chunks"] == meta["shape"] and meta["order"] == "C" and meta["filters"] is None, meta
        assert meta["compressor"]["id"] == "zstd", meta
        value = kv.read(key).result().value
        entry = {"path": [int(p) if p.isdigit() else p for p in name.split(".")], "dtype": meta["dtype"],
                 "shape": meta["shape"], "sha256": hashlib.sha256(value).hexdigest()}
        hits = [(f, data.find(value)) for f, data in files.items() if value in data]
        if len(hits) == 1:
            entry.update(file=hits[0][0], offset=hits[0][1], length=len(value))
        else:  # kept in a b-tree node (compressed there), not in a data file
            entry["inline"] = base64.b64encode(value).decode()
        leaves.append(entry)
    return {"checkpoint": "../../../checkpoints/se_vgg_flagship", "leaves": leaves}


def render_lines():
    """(48-px uint8 lines, texts) by the JAX package's generator and resize."""
    from PIL import Image

    from khmer_ocr_tpu.config import PreprocessConfig
    from khmer_ocr_tpu.data.generator import DocumentTextGenerator
    from khmer_ocr_tpu.preprocess import resize_line_u8
    from khmer_ocr_tpu.tokenizer import Tokenizer

    gen = DocumentTextGenerator(seed=RECIPE["seed"], augment=RECIPE["augment"],
                                words_per_sample=tuple(RECIPE["words_per_sample"]))
    tok = Tokenizer()
    samples = [s for s in gen.generate(RECIPE["rendered"], processes=1)
               if len(tok.encode(s[1])) <= RECIPE["max_tokens"]][:RECIPE["lines"]]
    assert len(samples) == RECIPE["lines"]
    return [resize_line_u8(Image.fromarray(img), PreprocessConfig()) for img, _ in samples], [t for _, t in samples]


def jax_strings(lines, bf16: bool = False) -> list[str]:
    """The JAX Predictor's beam-3 strings of ``lines``, the checkpoint cast to
    float32 (parity mode), or with ``bf16`` its speed mode (the Predictor
    casts the params to bfloat16; matmul precision "default")."""
    import jax

    from khmer_ocr_tpu.config import OCRConfig, RuntimeConfig
    from khmer_ocr_tpu.infer.predictor import Predictor
    from khmer_ocr_tpu.train.checkpoint import load_checkpoint

    params, stats, cfg = load_checkpoint(CKPT)
    f32 = lambda t: jax.tree.map(lambda v: np.asarray(v, np.float32), t)
    runtime = RuntimeConfig(compute_dtype="bfloat16", matmul_precision="default") if bf16 else RuntimeConfig()
    pred = Predictor(params=f32(params), batch_stats=f32(stats), model_cfg=cfg, config=OCRConfig(runtime=runtime))
    with jax.default_matmul_precision(runtime.matmul_precision):
        return pred.predict_batch(lines, beam_width=RECIPE["beam_width"], batch_size=RECIPE["batch_size"],
                                  max_len=RECIPE["max_len"])


def stored_lines() -> list[np.ndarray]:
    with np.load(LINES_NPZ) as z:
        return [z[f"line_{i}"] for i in range(len(z.files))]


if __name__ != "__main__":
    import jax

    @pytest.fixture(scope="module")
    def port_run(tmp_path_factory):
        """The port's Predictor on the weights directory: beam-3 strings of
        the first lines, on the CPU, in a torch-only subprocess."""
        tmp = tmp_path_factory.mktemp("torch_flagship")
        subprocess.run([sys.executable, __file__, "port", str(tmp)], cwd=REPO, check=True, timeout=600)
        return json.loads((tmp / "port.json").read_text())

    def test_weights_index_equals_checkpoint_bit_for_bit():
        from khmer_ocr_torch.convert.from_jax import _flatten
        from khmer_ocr_torch.convert.orbax_index import load_index
        from khmer_ocr_tpu.train.checkpoint import load_checkpoint

        params, stats, cfg = load_index(WEIGHTS)
        ref_p, ref_s, ref_cfg = load_checkpoint(CKPT)
        assert json.loads((WEIGHTS / "model_config.json").read_text()) == json.loads(
            (CKPT / "model_config.json").read_text())
        assert (cfg.emb_dim, cfg.backbone, cfg.vocab_size) == (ref_cfg.emb_dim, ref_cfg.backbone, ref_cfg.vocab_size)
        for got, ref in ((params, ref_p), (stats, ref_s)):
            got, ref = _flatten(got), _flatten(jax.tree.map(np.asarray, ref))
            assert sorted(map(str, got)) == sorted(map(str, ref))
            for key, leaf in got.items():
                want = np.asarray(ref[key], np.float32)
                assert leaf.dtype == np.float32 and leaf.shape == want.shape, key
                np.testing.assert_array_equal(leaf.view(np.uint32), want.view(np.uint32), err_msg=str(key))

    def test_weights_index_is_current():
        assert json.loads((WEIGHTS / "index.json").read_text()) == build_index()

    def test_real_lines_rerender_to_the_same_bytes():
        lines, texts = render_lines()
        meta = json.loads(LINES_JSON.read_text())
        assert meta["recipe"] == RECIPE and meta["texts"] == texts
        stored = stored_lines()
        assert len(stored) == len(lines) == RECIPE["lines"]
        for got, want in zip(stored, lines):
            assert got.dtype == np.uint8 and got.shape == want.shape
            np.testing.assert_array_equal(got, want)

    def test_real_lines_jax_strings_and_cer_are_current():
        from khmer_ocr_tpu.metrics import calculate_cer

        meta = json.loads(LINES_JSON.read_text())
        assert jax_strings(stored_lines()[:N_CHECKED]) == meta["strings"][:N_CHECKED]
        cers = [calculate_cer(t, s) for t, s in zip(meta["texts"], meta["strings"])]
        assert meta["mean_cer"] == float(np.mean(cers))
        assert meta["exact_match"] == float(np.mean([t == s for t, s in zip(meta["texts"], meta["strings"])]))
        assert meta["mean_cer"] < 0.05  # the checkpoint reads these lines

    def test_port_predictor_on_the_weights_directory(port_run):
        meta = json.loads(LINES_JSON.read_text())
        assert port_run["strings"] == meta["strings"][:N_CHECKED]

    def test_real_lines_recipe_and_float32_strings_unchanged():
        meta = json.loads(LINES_JSON.read_text())
        assert meta["recipe"] == RECIPE
        digest = hashlib.sha256(json.dumps(meta["strings"], ensure_ascii=False).encode()).hexdigest()
        assert digest == F32_STRINGS_SHA256

    def test_real_lines_jax_bf16_strings_and_cer_are_current():
        from khmer_ocr_tpu.metrics import calculate_cer

        meta = json.loads(LINES_JSON.read_text())
        assert jax_strings(stored_lines()[:N_CHECKED], bf16=True) == meta["bf16_strings"][:N_CHECKED]
        cers = [calculate_cer(t, s) for t, s in zip(meta["texts"], meta["bf16_strings"])]
        assert meta["bf16_mean_cer"] == float(np.mean(cers))
        assert meta["bf16_exact_match"] == float(np.mean([t == s for t, s in zip(meta["texts"],
                                                                                   meta["bf16_strings"])]))

    def test_port_bf16_predictor_against_jax_bf16_strings(port_run):
        meta = json.loads(LINES_JSON.read_text())
        ref = meta["bf16_strings"][:N_CHECKED]
        differ = [i for i, (g, r) in enumerate(zip(port_run["bf16_strings"], ref)) if g != r]
        gaps = port_run["bf16_gaps"]
        assert sorted(int(i) for i in gaps) == differ and all(g < BF16_MARGIN for g in gaps.values()), gaps
        assert len(differ) <= 1, differ

    def test_load_npz_widens_bf16_exactly(tmp_path):
        """bf16 leaves of the checkpoint stay 16 bits in the file and widen
        exactly; a float32 file of the earlier layout (no dtype record) loads."""
        from khmer_ocr_torch.convert.from_jax import load_npz, save_npz
        from khmer_ocr_tpu.train.checkpoint import load_checkpoint

        params, stats, _ = load_checkpoint(CKPT)
        sub_p = {"dec": {"out": jax.tree.map(np.asarray, params["dec"]["out"])},
                 "bilstm": {"fw": {"w_hh": np.asarray(params["bilstm"]["fw"]["w_hh"])}}}
        sub_s = {"bn_conv1": jax.tree.map(np.asarray, stats["bn_conv1"])}
        assert str(sub_p["dec"]["out"]["w"].dtype) == "bfloat16"
        save_npz(tmp_path / "bf16.npz", sub_p, sub_s)
        with np.load(tmp_path / "bf16.npz") as z:
            assert z["params/dec/out/w"].dtype == np.uint16
        got_p, got_s, cfg = load_npz(tmp_path / "bf16.npz")
        assert cfg is None
        for got, ref in ((got_p, sub_p), (got_s, sub_s)):
            for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
                assert g.dtype == np.float32
                np.testing.assert_array_equal(g.view(np.uint32), np.asarray(r, np.float32).view(np.uint32))
        old = {f"params/{k}": np.asarray(v, np.float32) for k, v in (("a/w", sub_p["dec"]["out"]["w"]),)}
        np.savez(tmp_path / "old.npz", **old)
        p_old, s_old, _ = load_npz(tmp_path / "old.npz")
        np.testing.assert_array_equal(p_old["a"]["w"], old["params/a/w"])
        assert s_old == {}


def _first_split_gap(torch, pred, line, seq_a, seq_b) -> float:
    """The teacher-forced log-probs (``pred``'s model) of two token rows
    summed through the first token where they differ, and their difference."""
    from khmer_ocr_torch.models.ocr_model import forward_train
    from khmer_ocr_torch.ops.lines import device_chunk, u8_to_unit, unit_normalize

    n = max(len(seq_a), len(seq_b))
    a, b = (np.pad(np.asarray(s), (0, n - len(s))) for s in (seq_a, seq_b))
    k = int(np.argmax(a != b))
    batch = next(iter(pred.preprocessor.iter_batches([line])))
    lines, counts = torch.from_numpy(batch.lines), torch.from_numpy(batch.chunk_counts)
    chunks = device_chunk(unit_normalize(u8_to_unit(lines)), pred._chunk_geom)
    sums = []
    for seq in (a, b):
        seq = torch.tensor([int(t) for t in seq[:k + 1]])[None]
        with torch.no_grad():
            logits, _ = forward_train(pred.params, None, chunks, counts, seq[:, :-1], pred.model_cfg, train=False)
        sums.append(float(torch.log_softmax(logits.float(), -1)[0].gather(-1, seq[0, 1:, None]).sum()))
    return abs(sums[0] - sums[1])


def _port_main(tmp: Path) -> None:
    sys.path.insert(0, str(REPO))
    import torch

    from khmer_ocr_torch.config import OCRConfig, RuntimeConfig
    from khmer_ocr_torch.infer.predictor import Predictor

    torch.set_num_threads(4)
    lines = stored_lines()[:N_CHECKED]
    kw = dict(beam_width=RECIPE["beam_width"], batch_size=RECIPE["batch_size"], max_len=RECIPE["max_len"])
    pred = Predictor(model_path=WEIGHTS, device="cpu")
    strings = pred.predict_batch(lines, **kw)
    bf16 = Predictor(model_path=WEIGHTS, device="cpu",
                     config=OCRConfig(runtime=RuntimeConfig(compute_dtype="bfloat16", matmul_precision="default")))
    rows = bf16.predict_batch_tokens(lines, **kw)
    bf16_strings = [bf16.tokenizer.decode(r) for r in rows]
    ref = json.loads(LINES_JSON.read_text()).get("bf16_strings", [])[:N_CHECKED]
    gaps = {str(i): _first_split_gap(torch, pred, lines[i], rows[i], pred.tokenizer.encode(r))
            for i, (g, r) in enumerate(zip(bf16_strings, ref)) if g != r}
    (tmp / "port.json").write_text(json.dumps({"strings": strings, "bf16_strings": bf16_strings, "bf16_gaps": gaps},
                                              ensure_ascii=False))


def _write_assets() -> None:
    sys.path.insert(0, str(REPO))
    import os

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    from khmer_ocr_tpu.metrics import calculate_cer

    WEIGHTS.mkdir(parents=True, exist_ok=True)
    (WEIGHTS / "model_config.json").write_text((CKPT / "model_config.json").read_text())
    (WEIGHTS / "index.json").write_text(json.dumps(build_index(), indent=1) + "\n")
    lines, texts = render_lines()
    strings = jax_strings(lines)
    bf16_strings = jax_strings(lines, bf16=True)
    np.savez_compressed(LINES_NPZ, **{f"line_{i}": line for i, line in enumerate(lines)})
    LINES_JSON.write_text(json.dumps({
        "recipe": RECIPE, "texts": texts, "strings": strings,
        "mean_cer": float(np.mean([calculate_cer(t, s) for t, s in zip(texts, strings)])),
        "exact_match": float(np.mean([t == s for t, s in zip(texts, strings)])),
        "bf16_strings": bf16_strings,
        "bf16_mean_cer": float(np.mean([calculate_cer(t, s) for t, s in zip(texts, bf16_strings)])),
        "bf16_exact_match": float(np.mean([t == s for t, s in zip(texts, bf16_strings)])),
        "made_by": "tests/test_torch_flagship.py assets: lines by the JAX package's DocumentTextGenerator and "
                   "resize, strings by its Predictor on the CPU, float32, matmul precision highest; bf16_* by "
                   "the same Predictor with compute_dtype bfloat16, matmul precision default"},
        ensure_ascii=False, indent=1) + "\n")
    print(f"wrote {WEIGHTS} and {LINES_NPZ.name} ({len(lines)} lines)")


if __name__ == "__main__":
    if sys.argv[1] == "assets":
        _write_assets()
    else:
        _port_main(Path(sys.argv[2]))
