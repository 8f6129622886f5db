"""Layout-detection configuration: the same values as the JAX package's
``detection/config.py`` (reference: netra_ocr/detection/config.py:3-52).

One frozen dataclass; every threshold keeps the reference value (tuned
against DocLayNet-style documents with Khmer text).
"""

from __future__ import annotations

from dataclasses import dataclass

ID2LABEL = {
    0: "Background", 1: "Caption", 2: "Footnote", 3: "Formula",
    4: "List-item", 5: "Page-footer", 6: "Page-header", 7: "Picture",
    8: "Section-header", 9: "Table", 10: "Text", 11: "Title",
}

CLASS_COLORS = {
    1: (255, 255, 0), 2: (0, 255, 255), 3: (255, 0, 255), 4: (0, 128, 128),
    5: (128, 128, 128), 6: (200, 200, 200), 7: (128, 0, 128), 8: (255, 165, 0),
    9: (255, 0, 0), 10: (0, 255, 0), 11: (0, 0, 255),
}


@dataclass(frozen=True)
class LayoutConfig:
    num_labels: int = 12
    image_size: int = 512
    # False (default): the maps leave the card as ONE packed uint8 array
    # (class ids exact, heatmap quantized to 1/255); True: int32 + f32 maps.
    exact_maps: bool = False

    # contour scoring
    score_threshold: float = 0.2  # mean heatmap confidence per contour
    # morphology & merging
    morph_kernel: tuple[int, int] = (40, 6)
    merge_x_dist: int = 60
    line_overlap_threshold: float = 0.4
    # class arbitration
    significance_threshold: float = 0.10
    # ink snapping & filtering
    padding: int = 5
    min_ink_pixels: int = 3
    snap_lookahead: int = 15
    snap_expand_y: int = 5
    line_aspect_ratio: float = 50.0
    line_density_threshold: float = 0.80
    # overlap suppression
    suppress_overlap: float = 0.7

    text_classes: tuple[int, ...] = (1, 2, 4, 5, 6, 8, 10, 11)
    picture_classes: tuple[int, ...] = (3, 7, 9)
