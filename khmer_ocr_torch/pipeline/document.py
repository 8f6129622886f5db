"""Standalone document OCR: detect lines -> sort by reading order -> recognise
-> structured results.

Reference: ``run_full_document_ocr`` (inference.py:297-337) and the
layout-aware block assignment of inference_pdf.py:49-101 (lines mapped into
layout blocks by center containment, orphans appended). Recognition is one
batched pass of the Predictor over all lines, on the CUDA card unless the
caller passes ``device="cpu"``. Pillow is imported inside the functions.

    python -m khmer_ocr_torch.pipeline.document --image page.png --model khmer_ocr_torch/assets/flagship
"""

from __future__ import annotations

import logging
from pathlib import Path

logger = logging.getLogger(__name__)


def get_center(bbox):
    return ((bbox[0] + bbox[2]) / 2, (bbox[1] + bbox[3]) / 2)


def is_center_inside(inner_bbox, outer_bbox) -> bool:
    cx, cy = get_center(inner_bbox)
    x0, y0, x1, y1 = outer_bbox
    return x0 <= cx <= x1 and y0 <= cy <= y1


def crop_with_padding(image, bbox, expansion: int = 5, padding: int = 10):
    """Expand bbox by ``expansion``, crop, surround with white ``padding``
    (inference_pdf.py:34-43)."""
    from PIL import ImageOps

    w, h = image.size
    x0, y0, x1, y1 = bbox
    box = (max(0, x0 - expansion), max(0, y0 - expansion), min(w, x1 + expansion), min(h, y1 + expansion))
    return ImageOps.expand(image.crop(box), border=padding, fill="white")


def run_full_document_ocr(image_path, model_path=None, vocab_path=None, beam_width: int = 3,
                          expansion: int = 5, padding: int = 10, batch_size: int = 8, device=None):
    """Surya-detected lines, sorted by their y centers, recognised in batches.

    Returns [{"line_number", "text", "bbox"}] (reference inference.py:297-337)."""
    from ..detection.surya import run_textline_detector
    from ..infer.api import recognize_batch

    crops_with_coords, _ = run_textline_detector(image_path, expansion_px=expansion, padding_px=padding)
    crops_with_coords.sort(key=lambda item: (item[1][1] + item[1][3]) / 2)  # y center
    crops = [c for c, _ in crops_with_coords]
    texts = recognize_batch(crops, beam_width=beam_width, batch_size=batch_size,
                            model_path=model_path, vocab_path=vocab_path, device=device)
    return [
        {"line_number": i + 1, "text": t, "bbox": list(bbox)}
        for i, (t, (_, bbox)) in enumerate(zip(texts, crops_with_coords))
    ]


def assign_lines_to_blocks(text_line_bboxes, layout_blocks):
    """Center-containment assignment of text lines to layout blocks with
    orphan handling (inference_pdf.py:62-84).

    layout_blocks: [(label, bbox)] in any order. Returns [{"type", "bbox",
    "lines": [bbox]}]; orphans last under type 'Orphan'."""
    blocks = sorted(layout_blocks, key=lambda b: (b[1][1], b[1][0]))
    assigned = set()
    structured = []
    for label, bbox in blocks:
        members = [
            i for i, line in enumerate(text_line_bboxes)
            if i not in assigned and is_center_inside(line, bbox)
        ]
        members.sort(key=lambda i: text_line_bboxes[i][1])
        assigned.update(members)
        if members:
            structured.append({"type": label, "bbox": list(bbox), "lines": [text_line_bboxes[i] for i in members]})
    orphans = [line for i, line in enumerate(text_line_bboxes) if i not in assigned]
    if orphans:
        orphans.sort(key=lambda b: b[1])
        structured.append({"type": "Orphan", "bbox": None, "lines": orphans})
    return structured


def run_layout_aware_pipeline(image_path, model_path=None, vocab_path=None, beam_width: int = 3,
                              batch_size: int = 8, engine: str = "surya",
                              layout_model_dir: str | None = None, device=None):
    """Detection + layout -> block-structured recognised lines
    (inference_pdf.py:49-101). engine='surya' follows the reference (Surya
    text lines and Surya layout blocks); engine='custom' takes both from the
    port's SegFormer stack, so the PDF pipeline runs without surya-ocr.
    Returns [{"type", "text", "bbox"}]."""
    from PIL import Image

    image = Image.open(image_path).convert("RGB")

    if engine == "custom":
        from ..detection.config import ID2LABEL, LayoutConfig
        from ..detection.detector import LayoutInference

        if layout_model_dir is None:
            raise ValueError("engine='custom' needs layout_model_dir")
        det = LayoutInference(layout_model_dir, device=device)
        _, elements = det.run(image_path)
        text_ids = set(LayoutConfig().text_classes)
        line_bboxes = [list(box) for box, cls in elements if cls in text_ids]
        blocks = [(ID2LABEL.get(cls, str(cls)), list(box)) for box, cls in elements if cls not in text_ids]
    else:
        from ..detection.surya import run_textline_detector

        crops_with_coords, _ = run_textline_detector(image_path, expansion_px=0, padding_px=0)
        line_bboxes = [list(bbox) for _, bbox in crops_with_coords]
        try:
            from surya.foundation import FoundationPredictor
            from surya.layout import LayoutPredictor
            from surya.settings import settings

            layout_pred = LayoutPredictor(FoundationPredictor(checkpoint=settings.LAYOUT_MODEL_CHECKPOINT))([image])[0]
            blocks = [(b.label, list(b.bbox)) for b in layout_pred.bboxes]
        except ImportError:
            logger.warning("surya layout unavailable; treating all lines as orphans")
            blocks = []

    structured = assign_lines_to_blocks(line_bboxes, blocks)

    from ..infer.api import recognize_batch

    flat = [(block["type"], bbox) for block in structured for bbox in block["lines"]]
    crops = [crop_with_padding(image, bbox, expansion=5, padding=10) for _, bbox in flat]
    texts = recognize_batch(crops, beam_width=beam_width, batch_size=batch_size,
                            model_path=model_path, vocab_path=vocab_path, device=device)
    return [
        {"type": btype, "text": text, "bbox": list(bbox)}
        for (btype, bbox), text in zip(flat, texts)
    ]


def main(argv=None) -> int:
    """Standalone document OCR CLI: writes <outdir>/<name>.txt
    (reference inference.py __main__, inference.py:343-381)."""
    import argparse

    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description="Full-document Khmer OCR")
    p.add_argument("--image", required=True)
    p.add_argument("--model", required=True)
    p.add_argument("--vocab", default=None)
    p.add_argument("--beam", type=int, default=3)
    p.add_argument("--outdir", default="results")
    p.add_argument("--device", type=str, default=None, help="Device (default: the CUDA card)")
    args = p.parse_args(argv)
    results = run_full_document_ocr(args.image, args.model, args.vocab, args.beam, device=args.device)
    out = Path(args.outdir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / (Path(args.image).stem + ".txt")
    path.write_text("\n".join(r["text"] for r in results), encoding="utf-8")
    print(f"{len(results)} lines -> {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
