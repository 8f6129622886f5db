"""The port's font renderer and data CLI against the JAX package's, on the CPU.

* ``render_text_line`` gives the same uint8 bytes as the JAX package's for
  every packaged font; ``find_fonts`` and ``load_corpus_words`` give the same
  fonts (by name) and words.
* ``DocumentTextGenerator`` (with and without its OpenCV augmentation) and
  ``SceneTextGenerator`` samples equal the JAX package's, image bytes and
  text, for several seeds; ``generate`` with a spawn pool gives the same
  samples as without one.
* The data CLI writes the same folder pair, file for file.
* The train CLI's ``--synthetic N`` trains on N rendered lines with their
  texts (the training loop stubbed out, in a torch-only subprocess).
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
SEEDS = (0, 1, 7, 123)
TEXT = "សាកល្បង ១២៣ ភាសាខ្មែរ"


def _fonts():
    return sorted(p.name for p in (REPO / "khmer_ocr_torch" / "data" / "fonts").glob("*.ttf"))


@pytest.mark.parametrize("font", _fonts())
def test_render_text_line_equals_jax(font):
    from khmer_ocr_torch.data.generator import render_text_line
    from khmer_ocr_tpu.data.generator import render_text_line as jax_render

    for size, fg, bg in ((14, 0, 255), (22, 255, 0)):
        got = render_text_line(TEXT, REPO / "khmer_ocr_torch" / "data" / "fonts" / font, size, fg=fg, bg=bg)
        want = jax_render(TEXT, REPO / "khmer_ocr_tpu" / "data" / "fonts" / font, size, fg=fg, bg=bg)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_fonts_and_corpus_equal_jax():
    from khmer_ocr_torch.data.generator import find_fonts, load_corpus_words
    from khmer_ocr_tpu.data.generator import find_fonts as jax_fonts, load_corpus_words as jax_words

    assert [p.name for p in find_fonts(None)] == [p.name for p in jax_fonts(None)] == _fonts()
    assert len(_fonts()) == 11
    for corpus in (None, "none"):
        assert load_corpus_words(corpus, np.random.default_rng(3)) == jax_words(corpus, np.random.default_rng(3))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("style", ["document", "document_augmented", "scene"])
def test_samples_equal_jax(style, seed):
    import khmer_ocr_torch.data.generator as port
    import khmer_ocr_tpu.data.generator as ref

    kw = dict(seed=seed, augment=style == "document_augmented", words_per_sample=(2, 6))
    cls = "SceneTextGenerator" if style == "scene" else "DocumentTextGenerator"
    got_gen, want_gen = getattr(port, cls)(**kw), getattr(ref, cls)(**kw)
    for i in range(3):
        (got, got_text), (want, want_text) = (g.sample(np.random.default_rng(seed * 10 + i))
                                              for g in (got_gen, want_gen))
        assert got_text == want_text
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_generate_with_a_spawn_pool_gives_the_same_samples():
    from khmer_ocr_torch.data.generator import DocumentTextGenerator

    gen = DocumentTextGenerator(seed=5, augment=False)
    key = lambda s: (s[1], s[0].shape, s[0].tobytes())
    assert sorted(map(key, gen.generate(6, processes=2))) == sorted(map(key, gen.generate(6, processes=1)))


@pytest.mark.parametrize("style", ["document", "scene"])
def test_data_cli_writes_the_same_folder_pair(tmp_path, style):
    from khmer_ocr_torch.data.cli import main
    from khmer_ocr_tpu.data.cli import main as jax_main

    args = ["--num", "5", "--processes", "1", "--seed", "11", "--style", style]
    assert main(args + ["--out", str(tmp_path / "port")]) == 0
    assert jax_main(args + ["--out", str(tmp_path / "jax")]) == 0
    files = lambda root: sorted(p.relative_to(root).as_posix() for p in root.rglob("*") if p.is_file())
    assert files(tmp_path / "port") == files(tmp_path / "jax")
    assert len(files(tmp_path / "port")) == 10
    for rel in files(tmp_path / "port"):
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), rel


def test_train_cli_synthetic_renders_lines(tmp_path):
    subprocess.run([sys.executable, __file__, str(tmp_path)], cwd=REPO, check=True, timeout=300)
    got = json.loads((tmp_path / "train_cli.json").read_text())
    from khmer_ocr_tpu.data.generator import DocumentTextGenerator

    texts = [t for _, t in DocumentTextGenerator().generate(3, processes=1)]
    assert sorted(got["texts"]) == sorted(texts)
    assert got["device"] == "cpu" and got["device_augment"] and got["heights"] != [48, 48, 48]
    assert not got["process_group"]  # no --data-parallel: one process


def _train_cli_main(tmp: Path) -> None:
    """The train CLI with --synthetic 3, its training loop replaced by a
    recorder of what it was given."""
    sys.path.insert(0, str(REPO))
    import khmer_ocr_torch.train.loop as loop
    from khmer_ocr_torch.train import cli

    def record(dataset, config, checkpoint_dir, device, num_epochs, resume_from, process_group):
        (tmp / "train_cli.json").write_text(json.dumps({
            "texts": [t for _, t in dataset.samples], "heights": [int(img.shape[0]) for img, _ in dataset.samples],
            "device": str(device), "device_augment": dataset.device_augment,
            "process_group": process_group is not None}, ensure_ascii=False))

    loop.train = record
    cli.main(["--synthetic", "3", "--device", "cpu", "--checkpoint-dir", str(tmp / "ck")])


if __name__ == "__main__":
    _train_cli_main(Path(sys.argv[1]))
