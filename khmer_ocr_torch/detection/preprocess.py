"""Detection preprocessing (reference: netra_ocr/detection/preprocessor.py:6-24,
SegformerImageProcessor at 512x512): PIL bilinear resize, 1/255 rescale,
ImageNet mean/std normalisation. Pillow is imported inside the function."""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def prepare_image(image_source, image_size: int = 512):
    """-> (PIL RGB original, (1, 3, S, S) float32 NCHW pixels, (W, H) original size).

    ``image_source``: a PIL image or a path."""
    from PIL import Image

    if isinstance(image_source, Image.Image):
        image = image_source.convert("RGB")
    else:
        image = Image.open(image_source).convert("RGB")
    original_size = image.size  # (W, H)
    resized = image.resize((image_size, image_size), Image.Resampling.BILINEAR)
    arr = np.asarray(resized, np.float32) / 255.0
    arr = (arr - IMAGENET_MEAN) / IMAGENET_STD
    return image, np.ascontiguousarray(arr.transpose(2, 0, 1)[None]), original_size
