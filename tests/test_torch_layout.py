"""The port's layout post-process, ``LayoutInference.run`` and the layout CLI
against the JAX package's, on the CPU.

* ``detection/postprocess.py`` is a copy: on synthetic pages of the kind
  tests/test_detection.py draws (text-ish dash lines, a dense picture block,
  a ruling line, rectangles of seeded classes and confidences in the maps)
  and on the golden document pages (their known layout and the seeded
  model's golden maps, ``assets/document_golden``), both give the same
  elements and crops; each helper gives the same answers on its own.
  Neither side needs torch, so both run in the pytest process.
* ``LayoutInference.run`` with ``save_artifacts`` (seeded weights, image size
  128, on the CPU) writes the JAX package's reading-order JSON, and the
  layout CLI with ``--device cpu`` on a document page reads an HF checkpoint
  directory (``model.safetensors``) into the JSON JAX's ``run`` writes for
  the same directory. The port runs in a torch-only subprocess (this file
  run as a script) and in the CLI's own process.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
SEED = 0
N_RANDOM = 6

sys.path.insert(0, str(REPO))


def synthetic_page():
    """tests/test_detection.py's page: two dash lines and a dense block, with
    its maps."""
    page = np.full((400, 600), 255, np.uint8)
    for x0 in range(50, 400, 18):
        page[60:80, x0 : x0 + 10] = 0
    for x0 in range(50, 500, 18):
        page[120:145, x0 : x0 + 10] = 0
    page[220:360, 80:300] = 40
    cm = np.zeros(page.shape, np.int32)
    hm = np.zeros(page.shape, np.float32)
    for (y1, y2, x1, x2), cls, heat in (((55, 85, 45, 420), 10, 0.9), ((115, 150, 45, 520), 10, 0.85),
                                         ((215, 365, 75, 305), 7, 0.8)):
        cm[y1:y2, x1:x2], hm[y1:y2, x1:x2] = cls, heat
    return page, cm, hm


def random_page(seed: int):
    """A seeded page: dash lines of several heights, a dense block, a thin
    ruling line and noise specks; maps with a rectangle of a random class and
    confidence over each object, overlapping and stray rectangles, and low
    confidences that the score filter drops."""
    rs = np.random.RandomState(seed)
    h, w = 500, 700
    page = np.full((h, w), 255, np.uint8)
    cm = np.zeros((h, w), np.int32)
    hm = rs.uniform(0.0, 0.1, (h, w)).astype(np.float32)
    y = 20
    while y < h - 60:
        lh = int(rs.randint(12, 30))
        x0, x1 = int(rs.randint(10, 200)), int(rs.randint(300, w - 10))
        for x in range(x0, x1, int(rs.randint(12, 22))):
            page[y : y + lh, x : x + int(rs.randint(4, 10))] = int(rs.randint(0, 80))
        cls = int(rs.choice([1, 2, 4, 5, 6, 8, 10, 11, 3, 7, 9]))
        pad = int(rs.randint(0, 8))
        cm[max(0, y - pad) : y + lh + pad, max(0, x0 - pad) : x1 + pad] = cls
        hm[max(0, y - pad) : y + lh + pad, max(0, x0 - pad) : x1 + pad] = rs.uniform(0.1, 0.95)
        y += lh + int(rs.randint(8, 40))
    bx, by = int(rs.randint(300, 500)), int(rs.randint(50, 300))
    page[by : by + 120, bx : bx + 150] = int(rs.randint(20, 90))
    cm[by - 4 : by + 124, bx - 4 : bx + 154] = int(rs.choice([3, 7, 9]))
    hm[by - 4 : by + 124, bx - 4 : bx + 154] = rs.uniform(0.3, 0.9)
    page[h - 30 : h - 27, 20 : w - 20] = 0  # a ruling line
    cm[h - 34 : h - 23, 15 : w - 15] = 10
    hm[h - 34 : h - 23, 15 : w - 15] = 0.7
    for _ in range(5):  # stray rectangles over empty paper
        sx, sy = int(rs.randint(0, w - 60)), int(rs.randint(0, h - 30))
        cm[sy : sy + 20, sx : sx + 50] = int(rs.randint(1, 12))
        hm[sy : sy + 20, sx : sx + 50] = rs.uniform(0.0, 0.6)
    specks = rs.randint(0, h * w, 40)
    page.ravel()[specks] = 0
    return page, cm, hm


def as_elements(elements) -> list:
    return [[[int(v) for v in box], int(cls)] for box, cls in elements]


def golden_pages():
    from khmer_ocr_torch.data.pages import compose_pages

    assets = REPO / "khmer_ocr_torch" / "assets"
    with np.load(assets / "real_lines.npz") as z:
        lines = [z[f"line_{i}"] for i in range(len(z.files))]
    with np.load(assets / "document_golden.npz") as z:
        maps = z["maps"]
    pages, boxes = compose_pages(lines)
    return pages, boxes, maps, json.loads((assets / "document_golden.json").read_text())


# ---------------------------------------------------------------------------
# the port, in a torch-only subprocess
# ---------------------------------------------------------------------------


def _port_main(tmp: Path) -> None:
    import torch
    from PIL import Image
    from safetensors.numpy import save_file

    from khmer_ocr_torch.convert.from_jax import seeded_segformer_state
    from khmer_ocr_torch.detection.config import LayoutConfig
    from khmer_ocr_torch.detection.detector import LayoutInference
    from khmer_ocr_torch.detection.segformer import SegFormerConfig, hf_config

    torch.set_num_threads(4)
    state = seeded_segformer_state(None, SEED)
    (tmp / "layout").mkdir()
    (tmp / "layout" / "config.json").write_text(json.dumps(hf_config(SegFormerConfig())))
    save_file({k: v for k, v in state.items() if v.ndim}, str(tmp / "layout" / "model.safetensors"))
    page, _, _ = synthetic_page()
    Image.fromarray(page).save(tmp / "synthetic.png")
    Image.fromarray(golden_pages()[0][0]).save(tmp / "document.png")
    det = LayoutInference(None, config=LayoutConfig(image_size=128), params=state, device="cpu")
    crops, elements = det.run(str(tmp / "synthetic.png"), output_dir=tmp / "port_run", stem="synthetic")
    (tmp / "port.json").write_text(json.dumps({"elements": as_elements(elements),
                                               "crop_sizes": [list(c.size) for c in crops]}))


if __name__ != "__main__":
    from PIL import Image

    from khmer_ocr_torch.detection import postprocess as port_pp
    from khmer_ocr_torch.detection.config import LayoutConfig as PortLayoutConfig
    from khmer_ocr_tpu.detection import postprocess as jax_pp
    from khmer_ocr_tpu.detection.config import LayoutConfig

    def both(page, cm, hm):
        img = Image.fromarray(page)
        pc, pe = port_pp.extract_layout_elements(img, cm, hm, PortLayoutConfig())
        jc, je = jax_pp.extract_layout_elements(img, cm, hm, LayoutConfig())
        return (as_elements(pe), [c.size for c in pc]), (as_elements(je), [c.size for c in jc])

    def test_layout_config_equals_jax():
        import dataclasses

        from khmer_ocr_torch.detection import config as port_cfg
        from khmer_ocr_tpu.detection import config as jax_cfg

        assert dataclasses.asdict(PortLayoutConfig()) == dataclasses.asdict(LayoutConfig())
        assert port_cfg.ID2LABEL == jax_cfg.ID2LABEL and port_cfg.CLASS_COLORS == jax_cfg.CLASS_COLORS

    def test_synthetic_page_elements_equal_jax():
        port, ref = both(*synthetic_page())
        assert port == ref
        assert sorted(c for _, c in port[0]) == [7, 10, 10]

    @pytest.mark.parametrize("seed", range(N_RANDOM))
    def test_random_page_elements_equal_jax(seed):
        port, ref = both(*random_page(seed))
        assert port == ref and port[0], port

    @pytest.mark.parametrize("page", range(4))
    @pytest.mark.parametrize("maps", ["known_layout", "golden_maps"])
    def test_golden_pages_elements_equal_jax_and_golden(page, maps):
        import cv2

        from khmer_ocr_torch.data.pages import layout_maps

        pages, boxes, packed, meta = golden_pages()
        h, w = pages[page].shape
        if maps == "known_layout":
            cm, hm = layout_maps((h, w), boxes[page])
            want = meta["known_elements"][page]
        else:
            cm = cv2.resize(packed[page, 0].astype(np.int32), (w, h), interpolation=cv2.INTER_NEAREST)
            hm = cv2.resize(packed[page, 1].astype(np.float32) * (1.0 / 255.0), (w, h),
                            interpolation=cv2.INTER_LINEAR)
            want = meta["elements"][page]
        port, ref = both(pages[page], cm, hm)
        assert port == ref and port[0] == want

    def test_helpers_equal_jax():
        page, _, _ = synthetic_page()
        cfg, jcfg = PortLayoutConfig(), LayoutConfig()
        boxes = [([0, 0, 100, 100], 10), ([10, 10, 50, 50], 10), ([200, 0, 260, 40], 7), ([90, 90, 150, 140], 8)]
        for a, b in [([0, 0, 100, 100], [10, 10, 50, 50]), ([0, 0, 10, 10], [20, 20, 30, 30]),
                     ([0, 0, 100, 100], [50, 50, 150, 150])]:
            assert port_pp.intersection_over_smaller(a, b) == jax_pp.intersection_over_smaller(a, b)
        assert port_pp.suppress_overlapping_boxes(boxes, 0.7) == jax_pp.suppress_overlapping_boxes(boxes, 0.7)
        rs = np.random.RandomState(1)
        crops = [np.full((4, 400), 255, np.uint8), np.full((100, 110), 255, np.uint8),
                 (rs.rand(30, 200) > 0.7).astype(np.uint8) * 255, (rs.rand(60, 40) > 0.5).astype(np.uint8) * 255]
        for crop in crops:
            assert port_pp.is_graphical_line(crop, cfg) == jax_pp.is_graphical_line(crop, jcfg)
            assert port_pp.classify_text_vs_picture(crop) == jax_pp.classify_text_vs_picture(crop)
        for box in ([150, 58, 250, 82], [480, 300, 560, 380], [60, 118, 100, 146], [90, 230, 290, 350]):
            assert port_pp.snap_to_ink(page, box, cfg) == jax_pp.snap_to_ink(page, box, jcfg)
            assert port_pp.validate_non_text_content(page, box, cfg) == jax_pp.validate_non_text_content(page, box,
                                                                                                         jcfg)

    @pytest.fixture(scope="module")
    def port(tmp_path_factory):
        tmp = tmp_path_factory.mktemp("torch_layout")
        subprocess.run([sys.executable, __file__, "port", str(tmp)], cwd=REPO, check=True, timeout=600)
        cli = subprocess.run([sys.executable, "-m", "khmer_ocr_torch.detection.cli", "--image",
                              str(tmp / "document.png"), "--model", str(tmp / "layout"), "--output",
                              str(tmp / "cli"), "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
                             timeout=600)
        return tmp, json.loads((tmp / "port.json").read_text()), cli

    def test_run_and_save_artifacts_equal_jax(port, tmp_path):
        import jax

        from khmer_ocr_torch.convert.from_jax import seeded_segformer_state
        from khmer_ocr_tpu.detection.detector import LayoutInference
        from khmer_ocr_tpu.detection.segformer import SegFormerConfig, convert_hf_state_dict

        tmp, res, _ = port
        det = LayoutInference(None, config=LayoutConfig(image_size=128), seg_cfg=SegFormerConfig(),
                              params=convert_hf_state_dict(seeded_segformer_state(None, SEED)))
        with jax.default_matmul_precision("highest"):
            crops, elements = det.run(str(tmp / "synthetic.png"), output_dir=tmp_path, stem="synthetic")
        assert res["elements"] == as_elements(elements) and res["crop_sizes"] == [list(c.size) for c in crops]
        for name in ("synthetic_heatmap.png", "synthetic_boxes.png"):
            assert (tmp / "port_run" / name).stat().st_size > 0
        assert json.loads((tmp / "port_run" / "synthetic_layout.json").read_text()) == json.loads(
            (tmp_path / "synthetic_layout.json").read_text())

    def test_layout_cli_on_the_cpu_equals_jax(port, tmp_path):
        import jax

        from khmer_ocr_tpu.detection.detector import LayoutInference

        tmp, _, cli = port
        assert cli.returncode == 0, cli.stderr[-2000:]
        assert "layout elements ->" in cli.stdout
        with jax.default_matmul_precision("highest"):
            LayoutInference(tmp / "layout").run(str(tmp / "document.png"), output_dir=tmp_path, stem="document")
        got = json.loads((tmp / "cli" / "document_layout.json").read_text())
        assert got and got == json.loads((tmp_path / "document_layout.json").read_text())


if __name__ == "__main__":
    _port_main(Path(sys.argv[2]))
