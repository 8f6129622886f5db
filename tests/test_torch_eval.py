"""The port's evaluation against the JAX package's, on the CPU.

* ``levenshtein``, ``calculate_cer`` and the C++ ``levenshtein_batch`` (built
  with g++ at first use) equal the JAX package's on hypothesis strings:
  Khmer, ASCII, empty and long ones.
* On a folder pair of rendered lines, given the same ``recognize_fn``
  outputs, the port's ``Evaluator`` gives the JAX package's CER, exact
  match, failures and report text.
* ``binarize_image`` (numpy) equals the JAX package's OpenCV blur + Otsu
  bit for bit: on any image, ties and constant images included, against
  OpenCV's own code (Intel IPP off), and on rendered lines with OpenCV's
  defaults; the binarized Preprocessor gives the JAX package's lines.
* ``degrade_image`` equals the JAX package's for each kind and severity.
* ``evaluate.main([..., "--device", "cpu"])`` runs on a folder pair with and
  without ``--binarize`` and ``--degraded`` (torch-only subprocess: this file
  run as a script).
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings, strategies as st
from hypothesis.extra.numpy import arrays

REPO = Path(__file__).resolve().parents[1]
KHMER = st.characters(min_codepoint=0x1780, max_codepoint=0x17F9)
TEXT = st.text(alphabet=st.one_of(KHMER, st.sampled_from("ab ?1")), max_size=40)
KINDS = ("blur", "noise", "lowres", "jpeg", "rotate", "erode", "mix")


@settings(max_examples=300, deadline=None)
@given(TEXT, TEXT)
def test_levenshtein_and_cer_equal_jax(ref, hyp):
    from khmer_ocr_torch.metrics import calculate_cer, levenshtein
    from khmer_ocr_tpu.metrics import calculate_cer as jax_cer, levenshtein as jax_lev

    assert levenshtein(ref, hyp) == jax_lev(ref, hyp)
    assert calculate_cer(ref, hyp) == jax_cer(ref, hyp)


@settings(max_examples=40, deadline=None)
@given(st.lists(st.tuples(TEXT, TEXT), max_size=12))
def test_levenshtein_batch_equals_jax(pairs):
    from khmer_ocr_torch.metrics import levenshtein
    from khmer_ocr_torch.native import levenshtein_batch
    from khmer_ocr_tpu.native import levenshtein_batch as jax_batch

    long = ("ក្ខ" * 400, "ខក" * 500)  # past any small-string shortcut
    refs, hyps = [r for r, _ in pairs] + [long[0], "", ""], [h for _, h in pairs] + [long[1], "", "ក"]
    got = levenshtein_batch(refs, hyps)
    assert got.dtype == np.int64
    assert got.tolist() == jax_batch(refs, hyps).tolist() == [levenshtein(r, h) for r, h in zip(refs, hyps)]


@pytest.fixture(scope="module")
def folder_pair(tmp_path_factory):
    """Six rendered lines written as a folder pair by the JAX generator."""
    from khmer_ocr_tpu.data.generator import DocumentTextGenerator

    root = tmp_path_factory.mktemp("torch_eval") / "split"
    samples = DocumentTextGenerator(seed=4, augment=False, words_per_sample=(1, 3)).generate(6, out_dir=root,
                                                                                              processes=1)
    (root / "images" / "notes.txt").write_text("not an image")
    return root, [t for _, t in samples]


def _fake_recognizer(texts):
    """Exact, edited, truncated, empty and reversed readings of the texts."""
    edits = [lambda t: t, lambda t: t[:-1] + "ក", lambda t: t[: len(t) // 2], lambda t: "", lambda t: t[::-1],
             lambda t: t + " x"]

    def recognize_fn(paths):
        return [edits[int(Path(p).stem) % len(edits)](texts[int(Path(p).stem)]) for p in paths]

    return recognize_fn


@pytest.mark.parametrize("threshold", [0.0, 0.1, 0.5])
def test_evaluator_equals_jax(folder_pair, tmp_path, threshold):
    from khmer_ocr_torch.metrics import Evaluator
    from khmer_ocr_tpu.metrics import Evaluator as JaxEvaluator

    root, texts = folder_pair
    got = Evaluator(_fake_recognizer(texts), threshold).evaluate_split(root, tmp_path / "port.txt")
    want = JaxEvaluator(_fake_recognizer(texts), threshold).evaluate_split(root, tmp_path / "jax.txt")
    assert (got.mean_cer, got.exact_match_accuracy, got.num_samples) == (
        want.mean_cer, want.exact_match_accuracy, want.num_samples)
    assert got.num_samples == 6 and 0 < got.mean_cer < 1
    assert got.failures == want.failures
    assert (tmp_path / "port.txt").read_text(encoding="utf-8") == (tmp_path / "jax.txt").read_text(encoding="utf-8")


def _jax_binarize(arr: np.ndarray) -> np.ndarray:
    from PIL import Image

    from khmer_ocr_tpu.preprocess import binarize_image

    return np.asarray(binarize_image(Image.fromarray(arr)))


@pytest.fixture
def opencv_without_ipp():
    """OpenCV's own Otsu code: with Intel IPP (the default where OpenCV has
    it), which of two exactly tied levels wins depends on IPP's arithmetic."""
    import cv2

    saved = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        yield
    finally:
        cv2.ipp.setUseIPP(saved)


@settings(max_examples=400, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(arrays(np.uint8, st.tuples(st.integers(1, 40), st.integers(1, 70))))
def test_binarize_equals_opencv_on_any_image(opencv_without_ipp, arr):
    from khmer_ocr_torch.preprocess import binarize_image

    np.testing.assert_array_equal(binarize_image(arr), _jax_binarize(arr))


@settings(max_examples=200, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(st.integers(1, 30), st.integers(1, 60), st.lists(st.integers(0, 255), min_size=1, max_size=3),
       st.integers(0, 2**31))
def test_binarize_equals_opencv_on_ties_and_constant_images(opencv_without_ipp, h, w, values, seed):
    """Two or three levels in any proportion (exactly tied variances are
    common) and single-level images."""
    from khmer_ocr_torch.preprocess import binarize_image

    arr = np.array(values, np.uint8)[np.random.default_rng(seed).integers(0, len(values), size=(h, w))]
    np.testing.assert_array_equal(binarize_image(arr), _jax_binarize(arr))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_binarize_equals_opencv_defaults_on_rendered_lines(seed):
    from khmer_ocr_torch.preprocess import binarize_image
    from khmer_ocr_tpu.data.generator import DocumentTextGenerator

    gen = DocumentTextGenerator(seed=seed, augment=True)
    for i in range(6):
        img, _ = gen.sample(np.random.default_rng(100 * seed + i))
        got = binarize_image(img)
        np.testing.assert_array_equal(got, _jax_binarize(img))
        assert set(np.unique(got)) == {0, 255}


def test_binarized_preprocessor_equals_jax():
    """Rendered lines of any height and 48-px lines (the port's shortcut
    past PIL) are binarized before the resize, as the JAX package does."""
    import dataclasses

    from PIL import Image

    from khmer_ocr_torch.config import PreprocessConfig
    from khmer_ocr_torch.preprocess import Preprocessor
    from khmer_ocr_tpu.config import PreprocessConfig as JaxConfig
    from khmer_ocr_tpu.data.generator import DocumentTextGenerator
    from khmer_ocr_tpu.preprocess import Preprocessor as JaxPreprocessor, resize_line_u8

    port = Preprocessor(dataclasses.replace(PreprocessConfig(), binarize=True))
    ref = JaxPreprocessor(dataclasses.replace(JaxConfig(), binarize=True))
    gen = DocumentTextGenerator(seed=9, augment=True)
    for i in range(4):
        img, _ = gen.sample(np.random.default_rng(i))
        line48 = resize_line_u8(Image.fromarray(img), JaxConfig())
        for src in (img, line48, Image.fromarray(img)):
            np.testing.assert_array_equal(port.load_line_u8(src), ref._load_line_u8(src))


@pytest.mark.parametrize("severity", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("kind", KINDS)
def test_degrade_image_equals_jax(kind, severity):
    from khmer_ocr_torch.data.degrade import _rng_for, degrade_image
    from khmer_ocr_tpu.data.degrade import _rng_for as jax_rng, degrade_image as jax_degrade
    from khmer_ocr_tpu.data.generator import DocumentTextGenerator

    img, _ = DocumentTextGenerator(seed=2, augment=False).sample(np.random.default_rng(5))
    img = img.astype(np.float32) / 255.0
    got = degrade_image(img, kind, severity, _rng_for("000001.png", kind, severity, 0))
    want = jax_degrade(img, kind, severity, jax_rng("000001.png", kind, severity, 0))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def cli_run(folder_pair, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_eval_cli")
    subprocess.run([sys.executable, __file__, str(tmp), str(folder_pair[0])], cwd=REPO, check=True, timeout=600)
    return tmp


@pytest.mark.parametrize("variant", ["clean", "binarize", "degraded"])
def test_evaluate_cli_on_cpu(cli_run, folder_pair, variant):
    results = json.loads((cli_run / variant / "results.json").read_text())
    names = ["split/blur_s1", "split/noise_s1"] if variant == "degraded" else ["split"]
    assert sorted(results) == names
    for r in results.values():
        assert r["num_samples"] == 6 and 0.0 <= r["mean_cer"] and 0.0 <= r["exact_match_accuracy"] <= 1.0
    assert (cli_run / variant / f"{names[0].replace('/', '_')}_failures.txt").exists()


def _cli_main(tmp: Path, split: Path) -> None:
    """evaluate.main on the CPU with seeded toy weights, three ways."""
    sys.path.insert(0, str(REPO))
    import torch

    from khmer_ocr_torch.config import ModelConfig
    from khmer_ocr_torch.convert.from_jax import save_npz, seeded_params
    from khmer_ocr_torch.evaluate import main

    torch.set_num_threads(2)
    cfg = ModelConfig(emb_dim=32, num_heads=4, enc_layers=1, dec_layers=1, enc_ffn_dim=64, max_global_len=256,
                      decode_max_len=16)
    save_npz(tmp / "toy.npz", *seeded_params(cfg, 0), cfg)
    base = ["--data", str(split), "--model", str(tmp / "toy.npz"), "--device", "cpu", "--batch-size", "4"]
    for variant, extra in (("clean", []), ("binarize", ["--binarize"]),
                           ("degraded", ["--degraded", "--kinds", "blur", "noise", "--severities", "1"])):
        assert main(base + extra + ["--report-dir", str(tmp / variant)]) == 0


if __name__ == "__main__":
    _cli_main(Path(sys.argv[1]), Path(sys.argv[2]))
