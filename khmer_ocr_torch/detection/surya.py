"""Surya text-line detection wrapper (a third-party model on the host).

Reference: netra_ocr/textline_detection.py:7-79. Surya's detector stays a
host dependency: it feeds line crops to the recognizer on the card. The
import is gated: without ``surya-ocr`` the engine raises a clear
``ImportError`` only when it is asked for. The DetectionPredictor is built
once and cached (the reference builds one per call,
textline_detection.py:58). Pillow is imported inside the functions.
"""

from __future__ import annotations

_PREDICTOR = None


def _get_surya_predictor():
    global _PREDICTOR
    if _PREDICTOR is None:
        try:
            from surya.detection import DetectionPredictor
        except ImportError as e:
            raise ImportError(
                "surya-ocr is not installed; use engine='custom' (SegFormer) or "
                "pip install surya-ocr for the surya text-line engine"
            ) from e
        _PREDICTOR = DetectionPredictor()
    return _PREDICTOR


def extract_textline_crops(image, prediction, expansion_px: int = 0, padding_px: int = 0):
    """Polygon -> bbox, expand, crop, white-pad, sort top to bottom
    (reference textline_detection.py:7-53) -> [(PIL crop, bbox)]."""
    from PIL import Image

    crops = []
    w, h = image.size
    for line in prediction.bboxes:
        x1, y1, x2, y2 = (int(v) for v in line.bbox)
        x1, y1 = max(0, x1 - expansion_px), max(0, y1 - expansion_px)
        x2, y2 = min(w, x2 + expansion_px), min(h, y2 + expansion_px)
        if x2 <= x1 or y2 <= y1:
            continue
        crop = image.crop((x1, y1, x2, y2))
        if padding_px > 0:
            padded = Image.new("RGB", (crop.width + 2 * padding_px, crop.height + 2 * padding_px), "white")
            padded.paste(crop, (padding_px, padding_px))
            crop = padded
        crops.append((crop, (x1, y1, x2, y2)))
    crops.sort(key=lambda item: item[1][1])  # top to bottom by y1
    return crops


def run_textline_detector(image_source, expansion_px: int = 0, padding_px: int = 0):
    """-> (sorted [(PIL crop, bbox)], raw surya prediction)
    (reference textline_detection.py:56-79)."""
    from PIL import Image

    image = image_source if isinstance(image_source, Image.Image) else Image.open(image_source)
    image = image.convert("RGB")
    predictor = _get_surya_predictor()
    prediction = predictor([image])[0]
    return extract_textline_crops(image, prediction, expansion_px, padding_px), prediction
