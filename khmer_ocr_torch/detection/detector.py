"""Layout detection: prep -> SegFormer on the card -> CV post-process on the
host -> artifacts (reference: netra_ocr/detection/detector.py:13-136,
``LayoutInference.run`` with heatmap PNG, box-viz PNG, reading-order JSON).

The model runs on the CUDA card unless the caller passes ``device="cpu"``;
without a card the constructor raises. Each forward runs in full float32
(``PRECISION``, the parity mode), scoped to the forward and its copy to the
host (``precision.matmul_precision``). On the card each forward replays the
captured CUDA graph of its key (batch and size of the pixels, output size,
packing: detection/graphs.py), the counterpart of the JAX package's jitted
forward a key; a ``LayoutInference`` owns its graphs and frees them with
it. On the CPU the forward runs eagerly. OpenCV is imported inside the
functions that call it.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np
import torch

from ..infer.predictor import resolve_device
from ..precision import matmul_precision
from .config import CLASS_COLORS, ID2LABEL, LayoutConfig
from .graphs import DetectionGraphs
from .postprocess import extract_layout_elements
from .preprocess import prepare_image
from .segformer import SegFormerConfig, build_model, load_hf_checkpoint, predict_maps

logger = logging.getLogger(__name__)

PRECISION = "highest"  # the SegFormer's matmul precision: TF32 off, as the JAX package's parity runs


def to_page_size(cm: np.ndarray, hm: np.ndarray, size) -> tuple[np.ndarray, np.ndarray]:
    """Class map and heatmap -> ``size`` = (W, H) of the page: nearest for
    the classes, linear for the heatmap, by OpenCV on the host."""
    w, h = size
    if cm.shape == (h, w):
        return cm, hm
    import cv2

    return (cv2.resize(cm, (w, h), interpolation=cv2.INTER_NEAREST),
            cv2.resize(hm, (w, h), interpolation=cv2.INTER_LINEAR))


def maps_body(model, out_hw, compact: bool):
    """-> body(pixels) -> the forward's maps as a tuple: ``(packed,)`` the
    (B, 2, H, W) uint8 maps, or the class map (B, H, W) int32 and the
    heatmap (B, H, W) float32, at ``out_hw``."""

    def body(x):
        if compact:
            return (predict_maps(model, x, out_hw, compact=True),)
        class_map, heatmap = predict_maps(model, x, out_hw)
        return class_map.to(torch.int32), heatmap

    return body


def unpack_maps(packed: np.ndarray, size) -> tuple[np.ndarray, np.ndarray]:
    """One page's packed (2, H, W) uint8 maps -> (class map int32, heatmap
    float32 in [0, 1]) at the page's ``size`` = (W, H)."""
    return to_page_size(packed[0].astype(np.int32), packed[1].astype(np.float32) * (1.0 / 255.0), size)


class LayoutInference:
    """Loads the SegFormer layout model once and runs document pages through it.

    ``params``: a state dict with the SegFormer's keys (HF's, the
    ``segformer.`` prefix optional; numpy arrays or tensors), e.g. from
    ``convert.from_jax.segformer_params_from_jax`` or
    ``seeded_segformer_state``; else ``model_dir`` is read by
    ``load_hf_checkpoint``. The constructor puts the model in eval mode and
    sets no global switch; each forward runs under ``PRECISION``, on the
    card through ``graphs`` (a DetectionGraphs bounded by
    ``cuda_graphs.CACHE_SHARE`` of the card's memory)."""

    def __init__(self, model_dir: str | Path | None, config: LayoutConfig | None = None, params=None,
                 seg_cfg: SegFormerConfig | None = None, device=None):
        self.device = resolve_device(device)
        self.cfg = config or LayoutConfig()
        if params is not None:
            state, self.seg_cfg = params, seg_cfg or SegFormerConfig()
        else:
            logger.info("Loading SegFormer layout model from %s", model_dir)
            state, self.seg_cfg = load_hf_checkpoint(model_dir)
        self.model = build_model(state, self.seg_cfg, self.device)
        self.graphs = DetectionGraphs()

    def _maps(self, pixels: np.ndarray, out_hw, compact: bool) -> tuple:
        """(B, 3, S, S) prepared pages -> ``maps_body``'s maps as numpy
        arrays: one forward (on the card the graph of its key) and one copy
        to the host, under ``PRECISION``."""
        body, x = maps_body(self.model, out_hw, compact), torch.from_numpy(pixels)
        with matmul_precision(PRECISION):
            if self.device.type == "cuda":
                maps = self.graphs.forward(body, self.model, x, out_hw, compact)
            else:
                maps = body(x.to(self.device))
        return tuple(m.numpy() for m in maps)

    @torch.inference_mode()
    def predict_maps(self, image_source):
        """-> (PIL image, class map (H, W) int32, heatmap (H, W) float32 in [0, 1]).

        The logits are resized on the card to the page size rounded up to
        multiples of 256, and the maps then by OpenCV to the exact size on
        the host (nearest for classes, linear for the heatmap). By default
        the maps come back packed as one (2, H, W) uint8 copy (class ids
        exact, heatmap quantised to 1/255); ``LayoutConfig(exact_maps=True)``
        returns the int32 and float32 maps."""
        image, pixels, (w, h) = prepare_image(image_source, self.cfg.image_size)
        hb, wb = ((h + 255) // 256) * 256, ((w + 255) // 256) * 256
        maps = [m[0] for m in self._maps(pixels, (hb, wb), not self.cfg.exact_maps)]
        if not self.cfg.exact_maps:
            return image, *unpack_maps(maps[0], (w, h))
        return image, *to_page_size(*maps, (w, h))

    @torch.inference_mode()
    def packed_maps(self, pixels: np.ndarray) -> np.ndarray:
        """(B, 3, S, S) prepared pages -> their packed (B, 2, S, S) uint8 maps
        at model resolution: one forward and one copy to the host."""
        return self._maps(pixels, pixels.shape[2:], True)[0]

    def predict_maps_batch(self, image_sources, group: int = 4):
        """Maps for N pages -> [(PIL image, class map, heatmap)], the
        document-serving path: ``group`` pages a forward, their packed maps
        back at model resolution (image_size², where the logits live: 128²
        for a 512² input) in one copy, resized to each page's size on the
        host. A page's maps do not depend on its group mates, so the last
        group, when short, is padded with zero pages to ``group`` (their
        maps dropped), as the JAX package pads it to the compiled batch
        shape: one graph serves every group.

        Region edges may move a few pixels against ``predict_maps``'s order
        (upsample to the page, then argmax); the post-process snaps every
        text box to ink."""
        tile = self.cfg.image_size
        prepared = [prepare_image(src, tile) for src in image_sources]
        out = []
        for g0 in range(0, len(prepared), group):
            part = prepared[g0 : g0 + group]
            pixels = np.concatenate([p[1] for p in part], axis=0)
            if len(part) < group:
                pixels = np.concatenate([pixels, np.zeros((group - len(part), *pixels.shape[1:]), pixels.dtype)])
            packed = self.packed_maps(pixels)
            for (image, _, size), maps in zip(part, packed):
                out.append((image, *unpack_maps(maps, size)))
        return out

    def run(self, image_source, output_dir: str | Path | None = None, stem: str = "page"):
        """The full path for one page -> (crops, [(box, class_id)]); with
        ``output_dir`` the heatmap, box and JSON artifacts are written too."""
        image, class_map, heatmap = self.predict_maps(image_source)
        crops, elements = extract_layout_elements(image, class_map, heatmap, self.cfg)
        if output_dir is not None:
            self.save_artifacts(image, heatmap, elements, output_dir, stem)
        return crops, elements

    def run_batch(self, image_sources, group: int = 4):
        """``run`` over N pages -> [(crops, elements)], the forwards batched
        by ``predict_maps_batch``, the post-process a page at a time."""
        return [extract_layout_elements(image, cm, hm, self.cfg)
                for image, cm, hm in self.predict_maps_batch(image_sources, group=group)]

    def save_artifacts(self, image, heatmap, elements, output_dir, stem="page"):
        import cv2

        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        # JET heatmap (detector.py:45-52)
        hm = (np.clip(heatmap, 0, 1) * 255).astype(np.uint8)
        cv2.imwrite(str(out / f"{stem}_heatmap.png"), cv2.applyColorMap(hm, cv2.COLORMAP_JET))
        # box visualisation (detector.py:54-70)
        viz = cv2.cvtColor(np.asarray(image.convert("RGB")), cv2.COLOR_RGB2BGR)
        for box, cls in elements:
            color = CLASS_COLORS.get(cls, (255, 255, 255))[::-1]  # RGB -> BGR
            x1, y1, x2, y2 = (int(v) for v in box)
            cv2.rectangle(viz, (x1, y1), (x2, y2), color, 1)
            cv2.putText(viz, ID2LABEL.get(cls, str(cls)), (x1, max(0, y1 - 4)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.4, color, 1)
        cv2.imwrite(str(out / f"{stem}_boxes.png"), viz)
        # reading-order JSON (detector.py:72-91): top to bottom, then left to right
        ordered = sorted(elements, key=lambda e: (e[0][1], e[0][0]))
        payload = [
            {"order": i, "label": ID2LABEL.get(cls, str(cls)), "class_id": int(cls),
             "bbox": [int(v) for v in box]}
            for i, (box, cls) in enumerate(ordered)
        ]
        (out / f"{stem}_layout.json").write_text(json.dumps(payload, indent=2))
