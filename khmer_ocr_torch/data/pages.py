"""Synthetic document pages made from rendered text lines, for the document
pipeline's checks.

``compose_pages`` pastes uint8 line images onto white A4 pages at 150 dpi
(1240 x 1754) in one column, ``lines_per_page`` a page, with a gap of at
least 24 px between lines so that the post-process's 40x6 closing keeps them
apart, and one dark block to the right of the lines as a picture. It also
gives the layout those pages define: each pasted line's rectangle, which
``layout_maps`` turns into a class map (class 10, Text) and a heatmap (1.0)
over those rectangles.
"""

from __future__ import annotations

import numpy as np

PAGE_RECIPE = dict(width=1240, height=1754, lines_per_page=16, left=120, top=100, gap=40,
                   picture=[800, 200, 1100, 500], picture_value=40, text_class=10)


def compose_pages(lines: list[np.ndarray], recipe: dict = PAGE_RECIPE):
    """uint8 (H, W) lines -> ([uint8 (height, width) page], [[(x1, y1, x2, y2) of
    each pasted line] a page]); line i goes to page i // lines_per_page."""
    r = recipe
    pages, boxes = [], []
    per = r["lines_per_page"]
    for p0 in range(0, len(lines), per):
        page = np.full((r["height"], r["width"]), 255, np.uint8)
        px1, py1, px2, py2 = r["picture"]
        page[py1:py2, px1:px2] = r["picture_value"]
        y, page_boxes = r["top"], []
        for line in lines[p0 : p0 + per]:
            h, w = line.shape
            x = r["left"]
            if x + w > px1 and y < py2 and y + h > py1 or y + h > r["height"]:
                raise ValueError(f"line of {w}x{h} px does not fit at ({x}, {y})")
            page[y : y + h, x : x + w] = line
            page_boxes.append((x, y, x + w, y + h))
            y += h + r["gap"]
        pages.append(page)
        boxes.append(page_boxes)
    return pages, boxes


def layout_maps(shape, boxes, text_class: int = PAGE_RECIPE["text_class"]):
    """(class map int32, heatmap float32) of ``shape`` (H, W): ``text_class``
    and 1.0 over each box, 0 elsewhere."""
    cm = np.zeros(shape, np.int32)
    hm = np.zeros(shape, np.float32)
    for x1, y1, x2, y2 in boxes:
        cm[y1:y2, x1:x2] = text_class
        hm[y1:y2, x1:x2] = 1.0
    return cm, hm
