"""The document path's golden asset, and the port held to it on the CPU.

``khmer_ocr_torch/assets/document_golden.{npz,json}`` is what
``chip_smoke.py [document]`` holds the card to. It is made here by the JAX
package, on the CPU, float32 with matmul precision highest:

* the pages: the 64 rendered lines of ``assets/real_lines.npz`` pasted 16
  a page onto 4 white A4 pages at 150 dpi with one dark picture block
  (``khmer_ocr_torch/data/pages.py::compose_pages``, recipe in the JSON);
* the layout model: ``seeded_segformer_state(SegFormerConfig(), 0)`` (the
  seed and recipe are stored, not the weights);
* the packed (2, 512, 512) uint8 maps of the 4 pages from one group of 4 at
  model resolution, and for each page the pixels whose top-two logits (at
  512²) lie closer than 1e-4 (near-ties: either class may win);
* the elements ``extract_layout_elements`` finds on those maps resized to
  each page (the seeded model finds no lines: one Title box a page);
* the known layout: the pages' own line rectangles as class 10 at heat 1.0,
  its elements, their crops (padding 6, ``KhmerOCRPipeline._crops_from_elements``)
  and the trained flagship's beam-3 strings of those crops, with their CER
  against the lines' texts;
* the page texts of ``KhmerOCRPipeline(engine="custom").process_pages`` on
  the 4 pages written as PNG, beam 3, with the seeded layout model and the
  flagship recognizer.

The tests: the golden is current (JAX re-run), the port's maps on the CPU
equal the golden maps off near-ties (heatmaps within 1), its post-process
gives the golden elements, its Predictor reads the first crops into the
golden strings, and its ``process_pages`` on the PNG pages through the
users' entry points (an HF checkpoint directory, the flagship's weights
index) gives the golden page texts. The port runs in a torch-only
subprocess (this file run as a script).

    python tests/test_torch_document.py assets    # rewrite the golden asset
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
ASSETS = REPO / "khmer_ocr_torch" / "assets"
GOLDEN_NPZ = ASSETS / "document_golden.npz"
GOLDEN_JSON = ASSETS / "document_golden.json"
CKPT = REPO / "checkpoints" / "se_vgg_flagship"
RECIPE = dict(seed=0, group=4, tile=512, beam_width=3, batch_size=64, padding=6, near_tie=1e-4)
N_CHECKED = 8  # known-layout crops decoded by both packages in the tests

sys.path.insert(0, str(REPO))


def pages_and_boxes():
    from khmer_ocr_torch.data.pages import compose_pages

    with np.load(ASSETS / "real_lines.npz") as z:
        lines = [z[f"line_{i}"] for i in range(len(z.files))]
    return compose_pages(lines)


def write_pages(pages, out: Path) -> list[Path]:
    from PIL import Image

    out.mkdir(parents=True, exist_ok=True)
    paths = []
    for i, page in enumerate(pages):
        paths.append(out / f"page{i}.png")
        Image.fromarray(page).save(paths[-1])
    return paths


def golden():
    meta = json.loads(GOLDEN_JSON.read_text())
    with np.load(GOLDEN_NPZ) as z:
        maps = z["maps"]
        exempt = [z[f"exempt_{i}"] for i in range(maps.shape[0])]
    return meta, maps, exempt


def as_elements(elements) -> list:
    return [[[int(v) for v in box], int(cls)] for box, cls in elements]


def maps_agree(got: np.ndarray, want: np.ndarray, exempt: np.ndarray) -> dict:
    """Packed maps (2, H, W): class ids differing off the exempt pixels, and
    the largest heatmap step."""
    ok = np.ones(got.shape[1:], bool).ravel()
    ok[exempt] = False
    differ = (got[0].ravel() != want[0].ravel()) & ok
    return dict(class_differ=int(differ.sum()), exempt=int(exempt.size),
                heat_max_step=int(np.abs(got[1].astype(int) - want[1].astype(int)).max()))


# ---------------------------------------------------------------------------
# the JAX side: the golden itself
# ---------------------------------------------------------------------------


def jax_maps(pages):
    """The JAX package's packed maps (N, 2, S, S) of one group, and the
    flat indices of each page's near-tied pixels."""
    import jax
    import jax.numpy as jnp
    from PIL import Image

    from khmer_ocr_torch.convert.from_jax import seeded_segformer_state
    from khmer_ocr_tpu.detection.detector import _jit_predict
    from khmer_ocr_tpu.detection.preprocess import prepare_image
    from khmer_ocr_tpu.detection.segformer import SegFormerConfig, _resize_bilinear, convert_hf_state_dict
    from khmer_ocr_tpu.detection.segformer import segformer_logits

    cfg, tile = SegFormerConfig(), RECIPE["tile"]
    params = convert_hf_state_dict(seeded_segformer_state(None, RECIPE["seed"]))
    x = jnp.asarray(np.concatenate([prepare_image(Image.fromarray(p), tile)[1] for p in pages]))

    @jax.jit
    def margin(p, xx):
        logits = _resize_bilinear(segformer_logits(p, xx, cfg), (tile, tile))
        top = jax.lax.top_k(logits, 2)[0]
        return top[..., 0] - top[..., 1]

    with jax.default_matmul_precision("highest"):
        packed = np.asarray(_jit_predict(cfg, (tile, tile), compact=True)(params, x))
        gap = np.asarray(margin(params, x))
    exempt = [np.flatnonzero(g.ravel() < RECIPE["near_tie"]).astype(np.int32) for g in gap]
    return packed, exempt, params


def jax_pipeline(params, flagship_predictor):
    """A JAX KhmerOCRPipeline(engine='custom') around the seeded layout tree
    and an in-memory flagship Predictor."""
    from khmer_ocr_tpu.detection.config import LayoutConfig
    from khmer_ocr_tpu.detection.detector import LayoutInference
    from khmer_ocr_tpu.detection.segformer import SegFormerConfig
    from khmer_ocr_tpu.pipeline.engine import KhmerOCRPipeline

    pipe = KhmerOCRPipeline(engine="surya", recognize_fn=lambda crops, beam_width, batch_size, model_path,
                            vocab_path: flagship_predictor.predict_batch(crops, beam_width=beam_width,
                                                                         batch_size=batch_size))
    pipe.engine = "custom"
    pipe.detector = LayoutInference(None, config=LayoutConfig(), params=params, seg_cfg=SegFormerConfig())
    return pipe


def jax_flagship():
    import jax

    from khmer_ocr_tpu.infer.predictor import Predictor
    from khmer_ocr_tpu.train.checkpoint import load_checkpoint

    params, stats, cfg = load_checkpoint(CKPT)
    f32 = lambda t: jax.tree.map(lambda v: np.asarray(v, np.float32), t)  # noqa: E731
    return Predictor(params=f32(params), batch_stats=f32(stats), model_cfg=cfg)


def jax_known_crops(pipe, pages, boxes):
    """The known layout's elements a page and its crops, page-major."""
    from PIL import Image

    from khmer_ocr_torch.data.pages import layout_maps
    from khmer_ocr_tpu.detection.postprocess import extract_layout_elements

    elements, crops = [], []
    for page, page_boxes in zip(pages, boxes):
        img = Image.fromarray(page).convert("RGB")
        _, el = extract_layout_elements(img, *layout_maps(page.shape, page_boxes))
        elements.append(as_elements(el))
        crops += pipe._crops_from_elements(img, el, RECIPE["padding"])
    return elements, crops


def _write_assets() -> None:
    import os
    import tempfile

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    from PIL import Image

    from khmer_ocr_torch.data.pages import PAGE_RECIPE
    from khmer_ocr_tpu.detection.postprocess import extract_layout_elements
    from khmer_ocr_tpu.metrics import calculate_cer

    pages, boxes = pages_and_boxes()
    packed, exempt, params = jax_maps(pages)
    flagship = jax_flagship()
    pipe = jax_pipeline(params, flagship)
    elements = [as_elements(extract_layout_elements(img, cm, hm)[1])
                for img, cm, hm in pipe.detector.predict_maps_batch([Image.fromarray(p) for p in pages],
                                                                    group=RECIPE["group"])]
    known, crops = jax_known_crops(pipe, pages, boxes)
    strings = flagship.predict_batch(crops, beam_width=RECIPE["beam_width"], batch_size=RECIPE["batch_size"])
    texts = json.loads((ASSETS / "real_lines.json").read_text())["texts"]
    with tempfile.TemporaryDirectory() as tmp:
        page_texts = pipe.process_pages(write_pages(pages, Path(tmp)), beam_width=RECIPE["beam_width"],
                                        batch_size=RECIPE["batch_size"], pages_per_batch=RECIPE["group"])
    np.savez_compressed(GOLDEN_NPZ, maps=packed, **{f"exempt_{i}": e for i, e in enumerate(exempt)})
    GOLDEN_JSON.write_text(json.dumps({
        "recipe": RECIPE, "pages": PAGE_RECIPE,
        "lines": "assets/real_lines.npz, line i on page i // 16, top to bottom (data/pages.py::compose_pages)",
        "weights": "convert.from_jax.seeded_segformer_state(SegFormerConfig(), seed): conv and dense weights "
                   "N(0, 1/fan_in), biases and norm shifts N(0, 0.01), norm scales 1 + N(0, 0.01), BatchNorm "
                   "running mean 0.2 N(0, 1) and variance U(0, 1) + 0.5, drawn in HF state-dict order",
        "maps": "npz 'maps': (4, 2, 512, 512) uint8, class id and heatmap * 255 + 0.5 truncated, one group of 4 "
                "pages at model resolution; 'exempt_i': flat indices of page i's pixels whose top-two logits lie "
                "closer than near_tie",
        "exempt": [int(e.size) for e in exempt],
        "elements": elements, "known_elements": known, "crop_strings": strings,
        "crop_texts": texts, "crop_mean_cer": float(np.mean([calculate_cer(t, s) for t, s in zip(texts, strings)])),
        "crop_exact_match": float(np.mean([t == s for t, s in zip(texts, strings)])),
        "page_texts": page_texts,
        "made_by": "python tests/test_torch_document.py assets: the JAX package on the CPU, float32, matmul "
                   "precision highest; the flagship (checkpoints/se_vgg_flagship) widened to float32"},
        ensure_ascii=False, indent=1) + "\n")
    print(f"wrote {GOLDEN_NPZ.name} ({GOLDEN_NPZ.stat().st_size} B) and {GOLDEN_JSON.name}")


# ---------------------------------------------------------------------------
# the port, in a torch-only subprocess
# ---------------------------------------------------------------------------


def _port_main(tmp: Path) -> None:
    import torch
    from PIL import Image

    from khmer_ocr_torch.convert.from_jax import seeded_segformer_state
    from khmer_ocr_torch.detection.detector import LayoutInference, unpack_maps
    from khmer_ocr_torch.detection.postprocess import extract_layout_elements
    from khmer_ocr_torch.detection.preprocess import prepare_image
    from khmer_ocr_torch.detection.segformer import SegFormerConfig, save_hf_checkpoint
    from khmer_ocr_torch.infer.predictor import Predictor
    from khmer_ocr_torch.pipeline.engine import KhmerOCRPipeline

    torch.set_num_threads(4)
    meta, _, _ = golden()
    pages, _ = pages_and_boxes()
    state = seeded_segformer_state(SegFormerConfig(), RECIPE["seed"])
    det = LayoutInference(None, params=state, device="cpu")
    pixels = np.concatenate([prepare_image(Image.fromarray(p), RECIPE["tile"])[1] for p in pages])
    packed = det.packed_maps(pixels)
    np.save(tmp / "maps.npy", packed)
    elements = []
    for page, maps in zip(pages, packed):
        img = Image.fromarray(page).convert("RGB")
        elements.append(as_elements(extract_layout_elements(img, *unpack_maps(maps, img.size))[1]))
    pred = Predictor(model_path=ASSETS / "flagship", device="cpu")
    pipe = KhmerOCRPipeline(engine="surya", device="cpu")
    crops = pipe._crops_from_elements(Image.fromarray(pages[0]).convert("RGB"), meta["known_elements"][0],
                                      RECIPE["padding"])  # page 0's crops come first
    strings = pred.predict_batch(crops[:N_CHECKED], beam_width=RECIPE["beam_width"], batch_size=RECIPE["batch_size"])
    model_dir = save_hf_checkpoint(tmp / "layout", state)
    pipe = KhmerOCRPipeline(engine="custom", layout_model_dir=model_dir, recognizer_model_path=ASSETS / "flagship",
                            device="cpu")
    page_texts = pipe.process_pages(write_pages(pages, tmp / "pages"), beam_width=RECIPE["beam_width"],
                                    batch_size=RECIPE["batch_size"], pages_per_batch=RECIPE["group"])
    (tmp / "port.json").write_text(json.dumps({"elements": elements, "strings": strings, "page_texts": page_texts},
                                              ensure_ascii=False))


if __name__ != "__main__":
    import jax

    @pytest.fixture(scope="module")
    def port(tmp_path_factory):
        tmp = tmp_path_factory.mktemp("torch_document")
        subprocess.run([sys.executable, __file__, "port", str(tmp)], cwd=REPO, check=True, timeout=600)
        return np.load(tmp / "maps.npy"), json.loads((tmp / "port.json").read_text())

    @pytest.fixture(scope="module")
    def jax_golden():
        pages, boxes = pages_and_boxes()
        packed, exempt, params = jax_maps(pages)
        return pages, boxes, packed, exempt, params

    def test_golden_recipe_and_size():
        from khmer_ocr_torch.data.pages import PAGE_RECIPE

        meta, maps, exempt = golden()
        assert meta["recipe"] == RECIPE and meta["pages"] == PAGE_RECIPE
        assert maps.shape == (4, 2, RECIPE["tile"], RECIPE["tile"]) and maps.dtype == np.uint8
        assert meta["exempt"] == [e.size for e in exempt]
        assert GOLDEN_NPZ.stat().st_size + GOLDEN_JSON.stat().st_size < 1_000_000

    def test_golden_maps_are_current(jax_golden):
        _, maps, exempt = golden()
        _, _, packed, jexempt, _ = jax_golden
        np.testing.assert_array_equal(packed, maps)
        for a, b in zip(jexempt, exempt):
            np.testing.assert_array_equal(a, b)

    def test_golden_elements_are_current(jax_golden):
        import cv2
        from PIL import Image

        from khmer_ocr_tpu.detection.postprocess import extract_layout_elements

        meta, maps, _ = golden()
        pages, boxes, *_ = jax_golden
        for page, m, want in zip(pages, maps, meta["elements"]):
            img = Image.fromarray(page).convert("RGB")
            h, w = page.shape
            cm = cv2.resize(m[0].astype(np.int32), (w, h), interpolation=cv2.INTER_NEAREST)
            hm = cv2.resize(m[1].astype(np.float32) * (1.0 / 255.0), (w, h), interpolation=cv2.INTER_LINEAR)
            assert as_elements(extract_layout_elements(img, cm, hm)[1]) == want

    def test_golden_known_layout_and_crop_strings_are_current(jax_golden):
        meta, _, _ = golden()
        pages, boxes, _, _, params = jax_golden
        flagship = jax_flagship()
        known, crops = jax_known_crops(jax_pipeline(params, flagship), pages, boxes)
        assert known == meta["known_elements"] and len(crops) == 64
        with jax.default_matmul_precision("highest"):
            strings = flagship.predict_batch(crops[:N_CHECKED], beam_width=RECIPE["beam_width"],
                                             batch_size=RECIPE["batch_size"])
        assert strings == meta["crop_strings"][:N_CHECKED]
        assert meta["crop_mean_cer"] < 0.05  # the flagship reads the known layout's crops

    @pytest.mark.parametrize("page", range(4))
    def test_port_maps_equal_golden_off_near_ties(port, page):
        _, maps, exempt = golden()
        agree = maps_agree(port[0][page], maps[page], exempt[page])
        print(f"page {page}: {agree}")
        assert agree["class_differ"] == 0 and agree["heat_max_step"] <= 1, agree

    def test_port_post_process_gives_the_golden_elements(port):
        assert port[1]["elements"] == golden()[0]["elements"]

    def test_port_reads_the_known_crops_into_the_golden_strings(port):
        assert port[1]["strings"] == golden()[0]["crop_strings"][:N_CHECKED]

    def test_port_process_pages_gives_the_golden_page_texts(port):
        assert port[1]["page_texts"] == golden()[0]["page_texts"]


if __name__ == "__main__":
    if sys.argv[1] == "assets":
        _write_assets()
    else:
        _port_main(Path(sys.argv[2]))
