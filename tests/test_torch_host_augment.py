"""The host ``Augmenter`` and ``--host-augment`` in the PyTorch port against the JAX package, on the CPU.

  * ``train/augment.py::Augmenter`` equals the JAX package's bit for bit
    (the same draws from a ``numpy.random.Generator``, the same OpenCV
    calls) over 64 seeds on each of four lines, in the low-res and hi-res
    modes;
  * one epoch of ``LineDataset(augment=True)`` (each sample augmented with a
    child seed drawn from the epoch's generator, then cut and normalised
    into the "chunks" layout) equals the JAX package's batches (chunks,
    counts, labels) bit for bit, shuffled and subsampled;
  * the digest that chip_smoke.py holds the card's machine to
    (khmer_ocr_torch/assets/host_augment_golden.json: one epoch of the
    first 16 rendered lines of real_lines.npz, batch 4) is the JAX
    package's now, and the port's CPU epoch meets it;
  * ``train/cli.py --synthetic N --host-augment`` trains on host-augmented
    "chunks" batches with the device step's augmentation probability 0;
    without the flag the lines go to the device augmentation; ``--data``
    lines are not augmented;
  * without OpenCV an ``Augmenter`` (and so ``LineDataset(augment=True)``)
    raises; device augmentation needs no OpenCV.

The augmenter and the dataset import no torch, so they run in the pytest
process; the CLI checks run in one torch-only subprocess (this file run as
a script).

    python tests/test_torch_host_augment.py golden     # rewrite the digest
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
ASSETS = REPO / "khmer_ocr_torch" / "assets"
GOLDEN = ASSETS / "host_augment_golden.json"
GOLDEN_SPEC = dict(lines=16, batch=4, seed=0)  # the first 16 lines of real_lines.npz, one epoch


def real_samples(n: int) -> list:
    """The first ``n`` rendered lines of real_lines.npz with their texts."""
    texts = json.loads((ASSETS / "real_lines.json").read_text())["texts"]
    with np.load(ASSETS / "real_lines.npz") as z:
        return [(z[f"line_{i}"], texts[i]) for i in range(n)]


def sample_lines() -> list:
    """Four float lines in [0, 1]: two rendered, a 30 px wide one with one
    dark bar, and a noisy one."""
    rendered = [s[0].astype(np.float32) / 255.0 for s in real_samples(2)]
    narrow = np.ones((48, 30), np.float32)
    narrow[20:28, 5:25] = 0.1
    return rendered + [narrow, np.random.RandomState(3).rand(48, 260).astype(np.float32)]


def epoch_digest(batches) -> str:
    """sha256 over every batch's chunks, chunk counts and labels, in order."""
    h = hashlib.sha256()
    for b in batches:
        for a in (b.chunks, b.chunk_counts, b.labels):
            h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _jax_digest() -> str:
    from khmer_ocr_tpu.train.data import LineDataset

    g = GOLDEN_SPEC
    ds = LineDataset(real_samples(g["lines"]), augment=True)
    return epoch_digest(ds.epoch_batches(g["batch"], np.random.default_rng(g["seed"])))


if __name__ != "__main__":
    from khmer_ocr_tpu.train.augment import Augmenter as JaxAugmenter
    from khmer_ocr_tpu.train.data import LineDataset as JaxLineDataset
    from khmer_ocr_torch.train.augment import Augmenter
    from khmer_ocr_torch.train.data import LineDataset

    @pytest.mark.parametrize("line", range(4))
    @pytest.mark.parametrize("low_res", [True, False], ids=["low_res", "hi_res"])
    def test_augmenter_equals_jax(line, low_res):
        img = sample_lines()[line]
        ours, ref = Augmenter(0.8, is_low_res_input=low_res), JaxAugmenter(0.8, is_low_res_input=low_res)
        changed = 0
        for seed in range(64):
            got = ours(img.copy(), np.random.default_rng(seed))
            want = ref(img.copy(), np.random.default_rng(seed))
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=f"seed {seed}")
            changed += not np.array_equal(got, img)
        assert changed > 32  # p 0.8: the augmentations did run

    @pytest.mark.parametrize("seed,sample_size", [(0, None), (1, None), (2, 12)])
    def test_epoch_equals_jax(seed, sample_size):
        """One epoch of host-augmented batches, shuffled (or a random subset
        of 12), against the JAX package's from the same samples and rng."""
        samples = real_samples(16)
        want = list(JaxLineDataset(samples, augment=True).epoch_batches(
            4, np.random.default_rng(seed), sample_size=sample_size, num_workers=2))
        got = list(LineDataset(samples, augment=True).epoch_batches(
            4, np.random.default_rng(seed), sample_size=sample_size, num_workers=2))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.lines is None and g.texts == w.texts
            for name in ("chunks", "chunk_counts", "labels"):
                np.testing.assert_array_equal(getattr(g, name), getattr(w, name), err_msg=name)
        plain = list(LineDataset(samples).epoch_batches(4, np.random.default_rng(seed), sample_size=sample_size,
                                                        num_workers=2))
        assert any(not np.array_equal(g.chunks, p.chunks) for g, p in zip(got, plain))

    def test_host_augment_golden_is_current_and_met_on_cpu():
        golden = json.loads(GOLDEN.read_text())
        assert {k: golden[k] for k in GOLDEN_SPEC} == GOLDEN_SPEC
        assert golden["digest"] == _jax_digest()
        g = GOLDEN_SPEC
        ds = LineDataset(real_samples(g["lines"]), augment=True)
        assert epoch_digest(ds.epoch_batches(g["batch"], np.random.default_rng(g["seed"]))) == golden["digest"]

    @pytest.mark.parametrize("build", ["augmenter", "dataset"])
    def test_missing_opencv_raises(monkeypatch, build):
        monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 now raises ImportError
        with pytest.raises(RuntimeError, match="OpenCV"):
            Augmenter() if build == "augmenter" else LineDataset(real_samples(2), augment=True)
        # device augmentation runs on the card and needs no OpenCV
        assert LineDataset(real_samples(2), augment=True, device_augment=True).augmenter is None

    @pytest.fixture(scope="module")
    def cli_runs(tmp_path_factory):
        tmp = tmp_path_factory.mktemp("torch_host_augment")
        subprocess.run([sys.executable, __file__, "cli", str(tmp)], cwd=REPO, check=True, timeout=300)
        return json.loads((tmp / "cli.json").read_text())

    @pytest.mark.parametrize("mode,augmenter,device_augment,aug_prob,layout", [
        ("host_augment", True, False, 0.0, "chunks"),
        ("device_augment", False, True, 0.8, "lines"),
        ("data", False, False, 0.0, "chunks"),
    ])
    def test_train_cli_augmentation(cli_runs, mode, augmenter, device_augment, aug_prob, layout):
        """What the train CLI hands the loop, and what the loop hands the
        device step: lines are augmented once, on the host or on the card."""
        run = cli_runs[mode]
        assert (run["augmenter"], run["device_augment"], run["aug_prob"]) == (augmenter, device_augment, aug_prob)
        assert run["layout"] == layout


# ---------------------------------------------------------------------------
# the CLI checks (torch only)
# ---------------------------------------------------------------------------


class _Stop(Exception):
    pass


def _cli_main(tmp: Path) -> None:
    sys.path.insert(0, str(REPO))
    from PIL import Image

    from khmer_ocr_torch.train import cli, loop

    (tmp / "data" / "images").mkdir(parents=True)
    (tmp / "data" / "labels").mkdir()
    for i, (line, text) in enumerate(real_samples(2)):
        Image.fromarray(line).save(tmp / "data" / "images" / f"{i}.png")
        (tmp / "data" / "labels" / f"{i}.txt").write_text(text, encoding="utf-8")

    seen = {}
    real_train, real_step = loop.train, loop.make_train_step

    def spy_train(dataset, *a, **kw):
        seen["augmenter"] = dataset.augmenter is not None
        seen["device_augment"] = dataset.device_augment
        return real_train(dataset, *a, **kw)

    def spy_step(mcfg, chunk_geom, aug_prob, *a, **kw):
        seen["aug_prob"] = aug_prob

        def step(state, batch, generator, lr):
            seen["layout"] = "lines" if "lines" in batch else "chunks"
            raise _Stop

        return step

    loop.make_train_step = spy_step
    loop.train = spy_train  # the CLI imports train from the loop when it runs
    out = {}
    for mode, args in (("host_augment", ["--synthetic", "8", "--host-augment"]), ("device_augment", ["--synthetic", "8"]),
                       ("data", ["--data", str(tmp / "data"), "--host-augment"])):
        seen.clear()
        try:
            cli.main(args + ["--epochs", "1", "--batch-size", "2", "--device", "cpu",
                             "--checkpoint-dir", str(tmp / mode)])
        except _Stop:
            pass
        out[mode] = dict(seen)
    loop.train, loop.make_train_step = real_train, real_step
    (tmp / "cli.json").write_text(json.dumps(out))


def _write_golden() -> None:
    sys.path.insert(0, str(REPO))
    digest = _jax_digest()
    GOLDEN.write_text(json.dumps({**GOLDEN_SPEC, "digest": digest,
                                  "made_by": "tests/test_torch_host_augment.py golden: the JAX package's "
                                             "LineDataset(augment=True) (its host Augmenter, OpenCV "
                                             f"{__import__('cv2').__version__}), one epoch of the first `lines` "
                                             "rendered lines of real_lines.npz at batch `batch` from "
                                             "default_rng(seed); sha256 over each batch's chunks, chunk counts "
                                             "and labels in order"}, indent=1) + "\n")
    print(f"wrote {GOLDEN}: {digest}")


if __name__ == "__main__":
    if sys.argv[1] == "golden":
        _write_golden()
    else:
        _cli_main(Path(sys.argv[2]))
