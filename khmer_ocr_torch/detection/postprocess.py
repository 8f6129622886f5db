"""Classical-CV layout post-processing, on the host (numpy and OpenCV; the
card runs only the SegFormer forward).

A copy of the JAX package's ``detection/postprocess.py``, itself a
behaviour-equivalent reimplementation of the reference's contour/cluster/
arbitrate/snap pipeline (netra_ocr/detection/utils.py:25-395) with the same
thresholds (LayoutConfig):

  class map -> binary content mask -> MORPH_CLOSE (40x6) -> external contours
  -> per-contour mean-heatmap confidence filter (>= 0.2) -> vertical overlap
  clustering (0.4) -> confidence-weighted class arbitration (significance 0.10)
  -> horizontal merging (gap < 60 px) -> per-class refinement (ink snapping for
  text, content validation for pictures/tables, Khmer-aware text-vs-picture
  reclassification) -> intersection-over-smaller suppression (0.7).

Column-ink profiles are computed once per band (the reference counts ink per
column inside the walk), and the snapping walk runs on that profile. OpenCV
is imported inside each function that calls it.
"""

from __future__ import annotations

import numpy as np

from .config import LayoutConfig


def intersection_over_smaller(a, b) -> float:
    """IoS — better than IoU for detecting containment (utils.py:6-23)."""
    ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
    ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
    if ix2 <= ix1 or iy2 <= iy1:
        return 0.0
    inter = (ix2 - ix1) * (iy2 - iy1)
    area_a = (a[2] - a[0]) * (a[3] - a[1])
    area_b = (b[2] - b[0]) * (b[3] - b[1])
    return inter / min(area_a, area_b)


def suppress_overlapping_boxes(boxes, overlap_threshold: float = 0.7):
    """Largest-first absorption of boxes overlapping > threshold (utils.py:25-58)."""
    if not boxes:
        return []
    order = sorted(boxes, key=lambda bc: (bc[0][2] - bc[0][0]) * (bc[0][3] - bc[0][1]), reverse=True)
    kept, absorbed = [], set()
    for i, (box, cls) in enumerate(order):
        if i in absorbed:
            continue
        box = list(box)
        for j in range(i + 1, len(order)):
            if j in absorbed:
                continue
            other = order[j][0]
            if intersection_over_smaller(box, other) > overlap_threshold:
                box = [min(box[0], other[0]), min(box[1], other[1]),
                       max(box[2], other[2]), max(box[3], other[3])]
                absorbed.add(j)
        kept.append((box, cls))
    return kept


def is_graphical_line(binary_crop: np.ndarray, cfg: LayoutConfig) -> bool:
    """Solid ruling lines: extreme aspect ratio AND >80% ink (utils.py:60-77)."""
    h, w = binary_crop.shape[:2]
    if h == 0 or w == 0:
        return False
    density = np.count_nonzero(binary_crop) / (w * h)
    extreme = (w / h > cfg.line_aspect_ratio) or (h / w > cfg.line_aspect_ratio)
    return extreme and density > cfg.line_density_threshold


def validate_non_text_content(img_gray: np.ndarray, box, cfg: LayoutConfig):
    """Reject empty 'Picture'/'Table' boxes: brightness, variance, Canny edge
    density checks (utils.py:79-111). Returns clipped box or None."""
    import cv2

    x1, y1, x2, y2 = (int(v) for v in box)
    x1, y1 = max(0, x1), max(0, y1)
    x2, y2 = min(img_gray.shape[1], x2), min(img_gray.shape[0], y2)
    if (x2 - x1) < 5 or (y2 - y1) < 5:
        return None
    crop = img_gray[y1:y2, x1:x2]
    if crop.mean() > 252 or crop.std() < 5:
        return None
    edges = cv2.Canny(crop, 50, 150)
    if np.count_nonzero(edges) < (x2 - x1) * (y2 - y1) * 0.005:
        return None
    return [x1, y1, x2, y2]


def classify_text_vs_picture(binary_crop: np.ndarray) -> str:
    """Khmer-aware structural reclassification of 'picture' boxes
    (utils.py:113-159): blob count, aspect ratio, projection-profile
    transitions, ink density."""
    import cv2

    h, w = binary_crop.shape[:2]
    if h < 5 or w < 5:
        return "text"
    n_labels, _, stats, _ = cv2.connectedComponentsWithStats(binary_crop)
    num_blobs = int(np.sum(stats[1:, cv2.CC_STAT_AREA] > 4)) if n_labels > 1 else 0
    aspect = w / h
    row_sums = binary_crop.sum(axis=1)
    peak = row_sums.max()
    ink_rows = row_sums > peak * 0.1 if peak > 0 else np.zeros(h, bool)
    transitions = int(np.sum(np.diff(ink_rows.astype(int)) != 0))
    if transitions >= 3:
        return "text"  # multiple lines => paragraph
    if transitions <= 2 and aspect > 1.3:
        if num_blobs >= 2:
            return "text"  # consonant + vowel/diacritic blobs
        if aspect > 4.0:
            return "text"  # very wide single blob: underlined text / rule
    density = np.count_nonzero(binary_crop) / (w * h)
    if density > 0.70 and aspect < 2.0:
        return "picture"
    if h < 30 and aspect > 1.5:
        return "text"
    return "picture"


def _binarize(gray: np.ndarray) -> np.ndarray:
    import cv2

    _, binary = cv2.threshold(gray, 0, 255, cv2.THRESH_BINARY_INV + cv2.THRESH_OTSU)
    return binary


def _walk(ink_cols: np.ndarray, start: int, step: int, limit: int, lookahead: int) -> int:
    """The reference's expand-left/right walk (utils.py:185-213) over a
    precomputed per-column ink profile: advance while tracking the empty-column
    streak; stop after `lookahead` empties and backtrack to the last ink."""
    pos, empty = start, 0
    while (pos > limit) if step < 0 else (pos < limit):
        nxt = pos + step
        probe = nxt if step < 0 else pos  # column examined this iteration
        if 0 <= probe < ink_cols.size and ink_cols[probe]:
            empty = 0
        else:
            empty += 1
        pos = nxt
        if empty >= lookahead:
            pos -= step * empty  # backtrack past the empty run
            break
    return pos


def snap_to_ink(img_gray: np.ndarray, box, cfg: LayoutConfig):
    """Expand a text box horizontally to the full ink extent, then shrink
    vertically to ink (utils.py:161-242). Returns (box|None, is_graphical_line).
    """
    import cv2

    x1, y1, x2, y2 = (int(v) for v in box)
    img_h, img_w = img_gray.shape[:2]
    sy1 = max(0, y1 - cfg.snap_expand_y)
    sy2 = min(img_h, y2 + cfg.snap_expand_y)
    band = _binarize(img_gray[sy1:sy2, :])
    band = cv2.morphologyEx(band, cv2.MORPH_OPEN, np.ones((2, 2), np.uint8))
    ink_cols = band.any(axis=0)

    new_x1 = _walk(ink_cols, x1, -1, 0, cfg.snap_lookahead)
    new_x2 = _walk(ink_cols, x2, +1, img_w, cfg.snap_lookahead)

    segment = band[:, new_x1:new_x2]
    if segment.size == 0 or np.count_nonzero(segment) < cfg.min_ink_pixels:
        return None, False
    ys, xs = np.nonzero(segment)
    bx1, bx2 = int(xs.min()), int(xs.max()) + 1
    by1, by2 = int(ys.min()), int(ys.max()) + 1

    if is_graphical_line(segment, cfg):
        return None, True
    pad = cfg.padding
    return [
        max(0, new_x1 + bx1 - pad),
        max(0, sy1 + by1 - pad // 2),
        min(img_w, new_x1 + bx2 + pad),
        min(img_h, sy1 + by2 + pad // 2),
    ], False


def _score_contours(class_map, heatmap, cfg: LayoutConfig):
    """Binary content mask -> close -> external contours -> confidence filter."""
    import cv2

    content = (class_map > 0).astype(np.uint8) * 255
    kernel = cv2.getStructuringElement(cv2.MORPH_RECT, cfg.morph_kernel)
    closed = cv2.morphologyEx(content, cv2.MORPH_CLOSE, kernel)
    contours, _ = cv2.findContours(closed, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    boxes = []
    for cnt in contours:
        x, y, w, h = cv2.boundingRect(cnt)
        if h < 1 or w < 2:
            continue
        mask = np.zeros((h, w), np.uint8)
        cv2.drawContours(mask, [cnt - (x, y)], -1, 255, -1)
        score = cv2.mean(heatmap[y : y + h, x : x + w], mask=mask)[0]
        if score >= cfg.score_threshold:
            boxes.append([x, y, x + w, y + h])
    return boxes


def _cluster_lines(boxes, cfg: LayoutConfig):
    """Greedy vertical-overlap clustering against each cluster's last member
    (utils.py:283-297)."""
    boxes = sorted(boxes, key=lambda b: b[1])
    clusters: list[list] = []
    for box in boxes:
        bx1, by1, bx2, by2 = box
        for cluster in clusters:
            lx1, ly1, lx2, ly2 = cluster[-1]
            inter_y = max(0, min(by2, ly2) - max(by1, ly1))
            min_h = min(by2 - by1, ly2 - ly1)
            if min_h > 0 and inter_y / min_h > cfg.line_overlap_threshold:
                cluster.append(box)
                break
        else:
            clusters.append([box])
    return clusters


def _arbitrate_class(class_map, heatmap, bounds, cfg: LayoutConfig) -> int | None:
    """Confidence-weighted class vote within the cluster bounds with a
    significance floor (utils.py:302-330)."""
    x1, y1, x2, y2 = bounds
    seg = class_map[y1:y2, x1:x2]
    conf = heatmap[y1:y2, x1:x2]
    mask = seg > 0
    if not mask.any():
        return None
    classes = seg[mask].ravel()
    weights = conf[mask].ravel()
    mass = np.bincount(classes, weights=weights, minlength=cfg.num_labels)
    total = mass.sum()
    significant = np.nonzero(mass / total > cfg.significance_threshold)[0]
    pool = significant if significant.size else np.nonzero(mass)[0]
    return int(pool[np.argmax(mass[pool])])


def _merge_horizontal(cluster, cfg: LayoutConfig):
    """Merge x-sorted cluster members with gaps < merge_x_dist (utils.py:333-344)."""
    cluster = sorted(cluster, key=lambda b: b[0])
    merged = [list(cluster[0])]
    for nx1, ny1, nx2, ny2 in cluster[1:]:
        cx1, cy1, cx2, cy2 = merged[-1]
        if nx1 - cx2 < cfg.merge_x_dist:
            merged[-1] = [min(cx1, nx1), min(cy1, ny1), max(cx2, nx2), max(cy2, ny2)]
        else:
            merged.append([nx1, ny1, nx2, ny2])
    return merged


def extract_layout_elements(image, class_map: np.ndarray, heatmap: np.ndarray,
                            cfg: LayoutConfig | None = None):
    """Full pipeline. image: PIL; class_map/heatmap: full-resolution numpy.

    Returns (crops: [PIL], boxes: [([x1,y1,x2,y2], class_id)]).
    """
    import cv2

    cfg = cfg or LayoutConfig()
    img_rgb = np.asarray(image.convert("RGB"))
    img_gray = cv2.cvtColor(img_rgb, cv2.COLOR_RGB2GRAY)
    class_map = class_map.astype(np.int32)
    heatmap = heatmap.astype(np.float32)

    components = _score_contours(class_map, heatmap, cfg)
    if not components:
        return [], []

    candidates = []  # (box, class)
    for cluster in _cluster_lines(components, cfg):
        bounds = (
            min(b[0] for b in cluster), min(b[1] for b in cluster),
            max(b[2] for b in cluster), max(b[3] for b in cluster),
        )
        cls = _arbitrate_class(class_map, heatmap, bounds, cfg)
        if cls is None:
            continue
        for box in _merge_horizontal(cluster, cfg):
            candidates.append((box, cls))

    refined = []
    for box, cls in candidates:
        x1, y1, x2, y2 = (int(v) for v in box)
        x1, y1 = max(0, x1), max(0, y1)
        x2 = min(img_rgb.shape[1], x2)
        y2 = min(img_rgb.shape[0], y2)
        if x2 <= x1 or y2 <= y1:
            continue
        target_cls = cls
        if cls in cfg.picture_classes:
            if classify_text_vs_picture(_binarize(img_gray[y1:y2, x1:x2])) == "text":
                target_cls = 10  # reclassify hallucinated picture/table as Text
        if target_cls in cfg.text_classes:
            new_box, _ignored = snap_to_ink(img_gray, box, cfg)
        else:
            new_box = validate_non_text_content(img_gray, box, cfg)
            if new_box is not None:
                pad = cfg.padding
                new_box = [
                    max(0, new_box[0] - pad), max(0, new_box[1] - pad),
                    min(img_rgb.shape[1], new_box[2] + pad), min(img_rgb.shape[0], new_box[3] + pad),
                ]
        if new_box is not None:
            refined.append((new_box, target_cls))

    final = suppress_overlapping_boxes(refined, cfg.suppress_overlap)
    crops = [image.crop(tuple(box)) for box, _ in final]
    return crops, final
