"""The port's host input path: the native loader, the Preprocessor's thread
pool, slab and deadline, ``Predictor.warmup`` and the small public helpers, on the CPU.

* ``khmer_ocr_torch/native/imageio.py`` (imageio.cpp built with g++ into
  ``khmer_ocr_torch/_build/``): PNG pixels equal to Pillow's
  ``convert("L").resize(..., BILINEAR)`` bit for bit, gray, RGB, RGBA and
  palette images; JPEG within 1 (the system libjpeg against Pillow's own);
  the in-memory entry equal to Pillow for arrays and PIL images; every file's
  pixels equal to the JAX package's loader. The JAX package's loader is run
  in a subprocess that builds it into the test's own cache directory
  (``KHMER_OCR_CACHE``), so it never races the builds of
  tests/test_native_imageio.py.
* ``Preprocessor`` batches (lines, counts, indices, bucket) equal to the JAX
  package's ``Preprocessor`` for the same sources (files through the native
  slab, in-memory arrays and PIL images through the thread pool), with
  ``host_workers`` 1 and 8 and a slab 300 px wide, so a wider line takes the
  full-width decode; equal to each other and to the PIL path the port takes
  where the loader cannot be built; a missing file raises on the slab and on
  the pool; the deadline flush as tests/test_foundations.py tests the JAX
  package's.
* The helpers (``load_grayscale``, ``resize_line``, ``resize_line_u8``,
  ``process_line``, ``PreparedBatch.chunk_mask``, ``prepare_batches``, the
  tokenizer's ``encode_padded``, ``decode_batch`` and
  ``default_vocab_path``, ``ModelConfig.head_dim``/``replace``,
  ``OCRConfig.replace``, the new ``RuntimeConfig`` and ``DecodeConfig``
  fields' defaults) against the JAX package's; ``load_hf_dataset`` on a
  list of examples without importing ``datasets``.
* In a torch-only subprocess: ``Predictor.warmup`` runs the buckets and
  beam widths it is given and leaves the predictions as they were;
  ``get_predictor(config=)`` and ``reset_predictor``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

REPO = Path(__file__).resolve().parents[1]
SLAB_CAP_W = 300
IMAGES = [((60, 300), "L"), ((37, 511), "L"), ((100, 80), "RGB"), ((48, 200), "L"), ((13, 40), "RGB"),
          ((97, 977), "L"), ((200, 31), "L"), ((48, 700), "RGBA"), ((30, 90), "P"), ((48, 420), "L")]


def make_images() -> list[Image.Image]:
    rng = np.random.RandomState(9)
    out = []
    for (h, w), mode in IMAGES:
        if mode == "P":
            img = Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8), "RGB").convert("P")
        else:
            chans = {"L": (), "RGB": (3,), "RGBA": (4,)}[mode]
            img = Image.fromarray(rng.randint(0, 256, (h, w, *chans), np.uint8), mode)
        out.append(img)
    return out


def write_files(tmp: Path) -> list[Path]:
    paths = []
    for i, img in enumerate(make_images()):
        paths.append(tmp / f"img{i}.png")
        img.save(paths[-1])
    return paths


def pil_line(img: Image.Image) -> np.ndarray:
    gray = img.convert("L")
    w = max(50, int(48 * gray.width / gray.height))
    return np.asarray(gray.resize((w, 48), Image.Resampling.BILINEAR), np.uint8)


def batch_record(batches, lines_attr: str) -> list:
    return [(b.bucket_n, list(b.indices), b.chunk_counts.tolist(), getattr(b, lines_attr)) for b in batches]


def sources(kind: str, paths: list[Path]) -> list:
    if kind == "files":
        return list(paths)
    imgs = [Image.open(p) for p in paths]
    if kind == "pil":
        return [im.copy() for im in imgs]
    return [np.asarray(im.convert("RGB") if im.mode == "P" else im) for im in imgs]


def _jax_main(tmp: Path) -> None:
    """The JAX package's loader and Preprocessor on the test's files (this file run as a script)."""
    sys.path.insert(0, str(REPO))
    from khmer_ocr_tpu.config import PreprocessConfig, RuntimeConfig
    from khmer_ocr_tpu.native.imageio import load_imageio_library, load_resize_gray
    from khmer_ocr_tpu.preprocess import Preprocessor

    assert load_imageio_library() is not None
    paths = sorted(tmp.glob("img*.png"), key=lambda p: int(p.stem[3:])) + [tmp / "img.jpg"]
    out = {f"pixels_{i}": load_resize_gray(p, as_uint8=True) for i, p in enumerate(paths)}
    for kind in ("files", "arrays", "pil"):
        for workers in (1, 8):
            pre = Preprocessor(PreprocessConfig(), RuntimeConfig(slab_cap_w=SLAB_CAP_W, host_workers=workers))
            for j, (bn, idx, counts, lines) in enumerate(batch_record(
                    pre.iter_batches(sources(kind, paths[:-1]), max_batch=3), "chunks")):
                out[f"{kind}_{workers}_{j}_lines"] = lines
                out[f"{kind}_{workers}_{j}_meta"] = np.array([bn, *counts, -1, *idx])
    np.savez(tmp / "jax.npz", **out)


if __name__ != "__main__":
    from khmer_ocr_torch.config import DecodeConfig, ModelConfig, OCRConfig, PreprocessConfig, RuntimeConfig
    from khmer_ocr_torch.native import imageio as native
    from khmer_ocr_torch.preprocess import Preprocessor

    @pytest.fixture(scope="module")
    def files(tmp_path_factory):
        tmp = tmp_path_factory.mktemp("torch_host")
        paths = write_files(tmp)
        make_images()[0].convert("RGB").save(tmp / "img.jpg", quality=90)
        env = {**os.environ, "KHMER_OCR_CACHE": str(tmp / "cache")}
        subprocess.run([sys.executable, __file__, "jax", str(tmp)], cwd=REPO, env=env, check=True, timeout=600)
        return {"tmp": tmp, "paths": paths, "jpg": tmp / "img.jpg", "jax": dict(np.load(tmp / "jax.npz"))}

    def test_native_loader_builds_here():
        assert native.load_imageio_library() is not None, native.unavailable_reason()

    @pytest.mark.parametrize("i", range(len(IMAGES)), ids=[f"{m}{h}x{w}" for (h, w), m in IMAGES])
    def test_native_png_bit_exact_vs_pil(files, i):
        got = native.load_resize_gray(files["paths"][i], as_uint8=True)
        ref = pil_line(Image.open(files["paths"][i]))
        assert got is not None and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)

    def test_native_jpeg_within_one(files):
        got = native.load_resize_gray(files["jpg"], as_uint8=True)
        ref = pil_line(Image.open(files["jpg"]))
        assert got.shape == ref.shape and np.abs(got.astype(int) - ref).max() <= 1

    def test_native_pixels_equal_the_jax_loader(files):
        for i, p in enumerate(files["paths"] + [files["jpg"]]):
            np.testing.assert_array_equal(native.load_resize_gray(p, as_uint8=True), files["jax"][f"pixels_{i}"],
                                          err_msg=str(p))

    @pytest.mark.parametrize("kind", ["arrays", "pil"])
    def test_native_memory_entry_equals_pil(files, kind):
        for src, p in zip(sources(kind, files["paths"]), files["paths"]):
            arr = src if isinstance(src, np.ndarray) else np.asarray(src.convert("L") if src.mode == "P" else src)
            np.testing.assert_array_equal(native.resize_gray_mem(arr, as_uint8=True), pil_line(Image.open(p)),
                                          err_msg=str(p))

    def _port_record(kind, workers, paths):
        pre = Preprocessor(PreprocessConfig(), RuntimeConfig(slab_cap_w=SLAB_CAP_W, host_workers=workers))
        return batch_record(pre.iter_batches(sources(kind, paths), max_batch=3), "lines")

    @pytest.mark.parametrize("workers", [1, 8])
    @pytest.mark.parametrize("kind", ["files", "arrays", "pil"])
    def test_batches_equal_jax(files, kind, workers):
        got = _port_record(kind, workers, files["paths"])
        ref = files["jax"]
        n = len([k for k in ref if k.startswith(f"{kind}_{workers}_") and k.endswith("_meta")])
        assert len(got) == n
        for j, (bn, idx, counts, lines) in enumerate(got):
            np.testing.assert_array_equal(np.array([bn, *counts, -1, *idx]), ref[f"{kind}_{workers}_{j}_meta"])
            np.testing.assert_array_equal(lines, ref[f"{kind}_{workers}_{j}_lines"])

    @pytest.mark.parametrize("kind", ["files", "arrays", "pil"])
    def test_one_and_eight_workers_and_the_pil_path_agree(files, kind, monkeypatch):
        one, eight = _port_record(kind, 1, files["paths"]), _port_record(kind, 8, files["paths"])
        monkeypatch.setattr(native, "load_imageio_library", lambda: None)
        pil = _port_record(kind, 8, files["paths"])
        for a, b, c in zip(one, eight, pil):
            assert a[:3] == b[:3] == c[:3]
            np.testing.assert_array_equal(a[3], b[3])
            np.testing.assert_array_equal(a[3], c[3])
        assert len(one) == len(eight) == len(pil)

    def test_a_line_wider_than_the_slab_decodes_at_full_width(files):
        wide = [i for i, ((h, w), _) in enumerate(IMAGES) if int(48 * w / h) > SLAB_CAP_W]
        assert wide
        pre = Preprocessor(PreprocessConfig(), RuntimeConfig(slab_cap_w=SLAB_CAP_W))
        for b in pre.iter_batches(files["paths"], max_batch=64):
            for pos, idx in enumerate(b.indices):
                ref = pil_line(Image.open(files["paths"][idx]))
                np.testing.assert_array_equal(b.lines[pos][:, :ref.shape[1]], ref[:, :b.lines.shape[2]])
                assert (b.lines[pos][:, ref.shape[1]:] == 255).all()

    @pytest.mark.parametrize("kind", ["files", "mixed"])
    def test_a_missing_file_raises(files, kind):
        srcs = files["paths"][:2] + [files["tmp"] / "nope.png"]
        if kind == "mixed":  # not all files: the thread pool
            srcs = srcs + [np.full((48, 60), 255, np.uint8)]
        with pytest.raises(FileNotFoundError):
            list(Preprocessor().iter_batches(srcs, max_batch=2))

    def test_deadline_flush_partial_buckets():
        rng = np.random.RandomState(0)
        imgs = [Image.fromarray(rng.randint(0, 256, (48, 60 + 85 * (i % 4)), np.uint8)) for i in range(24)]
        ref = {}
        for b in Preprocessor(PreprocessConfig(), RuntimeConfig(chunk_buckets=(1, 2, 4))).iter_batches(imgs, 256):
            for pos, idx in enumerate(b.indices):
                ref[idx] = (b.bucket_n, int(b.chunk_counts[pos]), b.lines[pos])
        pre = Preprocessor(PreprocessConfig(), RuntimeConfig(chunk_buckets=(1, 2, 4), flush_deadline_ms=1e-6))
        batches = list(pre.iter_batches(imgs, max_batch=256))
        assert len(batches) > 3
        seen = {}
        for b in batches:
            assert b.lines.shape[0] == len(b.indices) <= 256
            for pos, idx in enumerate(b.indices):
                assert idx not in seen
                seen[idx] = (b.bucket_n, int(b.chunk_counts[pos]), b.lines[pos])
        assert set(seen) == set(range(len(imgs)))
        for idx, (bn, cc, payload) in ref.items():
            assert seen[idx][:2] == (bn, cc)
            np.testing.assert_array_equal(seen[idx][2], payload)
        again = list(Preprocessor(PreprocessConfig(), RuntimeConfig(chunk_buckets=(1, 2, 4))).iter_batches(imgs, 256))
        assert len(again) == len({b.bucket_n for b in again})

    def test_line_helpers_equal_jax(files):
        from khmer_ocr_torch import preprocess as P
        from khmer_ocr_tpu import preprocess as J
        from khmer_ocr_tpu.config import PreprocessConfig as JPre

        for p in files["paths"]:
            g = P.load_grayscale(p)
            assert g.mode == "L"
            np.testing.assert_array_equal(np.asarray(g), np.asarray(J.load_grayscale(p)))
            np.testing.assert_array_equal(P.resize_line_u8(g, PreprocessConfig()), J.resize_line_u8(g, JPre()))
            np.testing.assert_array_equal(P.resize_line(g, PreprocessConfig()), J.resize_line(g, JPre()))
            np.testing.assert_array_equal(Preprocessor().process_line(np.asarray(Image.open(p).convert("L"))),
                                          J.Preprocessor().process_line(np.asarray(Image.open(p).convert("L"))))
        arr = np.asarray(Image.open(files["paths"][0]).convert("L"))
        np.testing.assert_array_equal(Preprocessor().process_line(arr, n_chunks=7),
                                      J.Preprocessor().process_line(arr, n_chunks=7))

    def test_chunk_mask_and_prepare_batches(files):
        pre = Preprocessor()
        batches = pre.prepare_batches(files["paths"], max_batch=4)
        assert [b.indices for b in batches] == [b.indices for b in pre.iter_batches(files["paths"], max_batch=4)]
        for b in batches:
            np.testing.assert_array_equal(b.chunk_mask, np.arange(b.bucket_n)[None, :] < b.chunk_counts[:, None])
            assert b.chunk_mask.sum() == b.chunk_counts.sum()

    def test_tokenizer_helpers_equal_jax():
        from khmer_ocr_torch.tokenizer import Tokenizer, default_vocab_path
        from khmer_ocr_tpu.tokenizer import Tokenizer as JTok

        tok, jtok = Tokenizer(), JTok()
        assert default_vocab_path().exists() and Tokenizer(default_vocab_path()).char2idx == tok.char2idx
        texts = ["សាកល្បង ១២៣", "ab", "", "x" * 40]
        for max_len in (4, 8, 64):
            for a, b in zip(tok.encode_padded(texts, max_len), jtok.encode_padded(texts, max_len)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        ids, _ = tok.encode_padded(texts, 64)
        assert tok.decode_batch(ids) == jtok.decode_batch(ids) == [tok.decode(r) for r in ids]
        assert tok.encode("ab", add_special=False) == jtok.encode("ab", add_special=False)

    def test_config_helpers_and_defaults_equal_jax():
        from khmer_ocr_tpu import config as J

        m = ModelConfig()
        assert m.head_dim == J.ModelConfig().head_dim == 48
        assert m.replace(emb_dim=64).emb_dim == 64 and m.replace(emb_dim=64).num_heads == m.num_heads
        with pytest.raises(ValueError):
            ModelConfig(emb_dim=30, num_heads=4).head_dim
        o = OCRConfig().replace(runtime=RuntimeConfig(compute_dtype="bfloat16"))
        assert o.runtime.compute_dtype == "bfloat16" and o.model == ModelConfig()
        for field in ("compute_dtype", "matmul_precision", "host_workers", "slab_cap_w", "flush_deadline_ms",
                      "chunk_buckets", "batch_buckets"):
            assert getattr(RuntimeConfig(), field) == getattr(J.RuntimeConfig(), field), field
        assert DecodeConfig().head_mode is None and J.DecodeConfig().head_mode is None

    def test_load_hf_dataset_on_examples_needs_no_datasets_package():
        code = ("import sys, numpy as np\n"
                "from khmer_ocr_torch.train.data import load_hf_dataset\n"
                "ds = load_hf_dataset([[{'image': np.full((48, 90), 255, np.uint8), 'label': 'ab'}],"
                " [{'image': np.zeros((48, 60), np.uint8), 'label': 'c'}]])\n"
                "print(len(ds), [t for _, t in ds.samples], 'datasets' in sys.modules)\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, check=True)
        assert out.stdout.split() == ["2", "['ab',", "'c']", "False"]

    @pytest.fixture(scope="module")
    def torch_side(tmp_path_factory):
        tmp = tmp_path_factory.mktemp("torch_host_port")
        subprocess.run([sys.executable, __file__, "port", str(tmp)], cwd=REPO, check=True, timeout=600)
        return json.loads((tmp / "port.json").read_text())

    def test_warmup_leaves_predictions_unchanged(torch_side):
        assert torch_side["warm"] == torch_side["cold"]
        assert torch_side["warmup_batches"] == [2, 2]  # one batch a bucket, two buckets, at each beam width

    def test_get_predictor_config_and_reset(torch_side):
        assert torch_side["api"] == {"same": True, "dtype": "torch.bfloat16", "reloaded": True, "after_reset": True}


def _port_main(tmp: Path) -> None:
    sys.path.insert(0, str(REPO))
    import torch

    from khmer_ocr_torch.config import ModelConfig, OCRConfig, RuntimeConfig
    from khmer_ocr_torch.convert.from_jax import save_npz, seeded_params
    from khmer_ocr_torch.data.synthetic import synthetic_lines
    from khmer_ocr_torch.infer import api, predictor
    from khmer_ocr_torch.infer.predictor import Predictor

    torch.set_num_threads(2)
    cfg = ModelConfig(emb_dim=32, num_heads=4, enc_layers=1, dec_layers=1, enc_ffn_dim=64, max_global_len=256,
                      decode_max_len=16)
    params, stats = seeded_params(cfg, 4)
    lines = synthetic_lines([1, 2, 3, 1], seed=4)
    meta = {}
    cold = Predictor(params=params, batch_stats=stats, model_cfg=cfg, device="cpu")
    meta["cold"] = cold.predict_batch(lines, beam_width=3, max_len=12)
    warm = Predictor(params=params, batch_stats=stats, model_cfg=cfg, device="cpu")
    seen = []
    real = predictor.infer_batch

    def spy(*args, **kw):  # each bucket batch's device part, in predict_batch's pipeline too
        seen.append(args[4].beam_width)
        return real(*args, **kw)

    predictor.infer_batch = spy
    warm.warmup(beam_widths=(1, 3), batch_size=2, chunk_buckets=(1, 2))
    meta["warmup_batches"] = [seen.count(1), seen.count(3)]
    predictor.infer_batch = real
    meta["warm"] = warm.predict_batch(lines, beam_width=3, max_len=12)

    save_npz(tmp / "toy.npz", params, stats, cfg)
    bf16 = OCRConfig(runtime=RuntimeConfig(compute_dtype="bfloat16"))
    p1 = api.get_predictor(tmp / "toy.npz", device="cpu", config=bf16)
    p2 = api.get_predictor(device="cpu")
    p3 = api.get_predictor(tmp / "toy.npz", device="cpu")
    api.reset_predictor()
    try:
        api.get_predictor(device="cpu")
        after_reset = False
    except FileNotFoundError:
        after_reset = True
    meta["api"] = {"same": p1 is p2, "dtype": str(p1.params["patch"]["proj"]["w"].dtype), "reloaded": p3 is not p1,
                   "after_reset": after_reset}
    (tmp / "port.json").write_text(json.dumps(meta))


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_main(Path(sys.argv[2]))
    else:
        _port_main(Path(sys.argv[2]))
