"""Document OCR pipeline: detection -> crops -> batched recognition on the card.

Reference: ``KhmerOCRPipeline`` and the ``netra_ocr`` CLI
(netra_ocr/ocr_engine.py:13-129). Engines: ``custom`` runs the port's
SegFormer layout stack (detection/), ``surya`` the import-gated Surya
wrapper (detection/surya.py). Text elements are filtered to the text class
ids, sorted top to bottom, padded and recognised in batches by the
Predictor (kernels K1 and K2 on the card).

The entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card the ``custom`` engine's constructor and
every recognition raise. Errors propagate to the caller. Pillow is imported
inside the functions.

    python -m khmer_ocr_torch.pipeline.engine --image page.png --engine custom --layout-model det-b0 \\
        --recognizer khmer_ocr_torch/assets/flagship --beam 3
"""

from __future__ import annotations

import contextlib
import logging
import shutil
from pathlib import Path

from ..detection.config import LayoutConfig
from ..infer.api import recognize_batch

logger = logging.getLogger(__name__)


class KhmerOCRPipeline:
    def __init__(self, engine: str = "surya", layout_model_dir: str | None = None,
                 recognizer_model_path: str | None = None, vocab_path: str | None = None,
                 recognize_fn=None, device=None):
        """``recognize_fn``: optional ``recognize_batch``-compatible callable
        ``(crops, beam_width, batch_size, model_path, vocab_path) -> [str]``;
        by default the public API's singleton Predictor (infer/api.py) on
        ``device``. Lets callers with a Predictor in memory use the pipelined
        path without a checkpoint on disk."""
        self.engine = engine
        self.device = device
        self.layout_cfg = LayoutConfig()
        self.text_ids = set(self.layout_cfg.text_classes)
        self.recognizer_model_path = recognizer_model_path
        self.vocab_path = vocab_path
        self.recognize_fn = recognize_fn
        if engine == "custom":
            from ..detection.detector import LayoutInference

            if layout_model_dir is None:
                raise ValueError("engine='custom' needs layout_model_dir (HF SegFormer checkpoint)")
            self.detector = LayoutInference(layout_model_dir, device=device)
        elif engine != "surya":
            raise ValueError(f"Unknown engine {engine!r} (use 'surya' or 'custom')")

    def _recognize(self, crops, beam_width: int, batch_size: int) -> list[str]:
        if self.recognize_fn is not None:
            return self.recognize_fn(crops, beam_width=beam_width, batch_size=batch_size,
                                     model_path=self.recognizer_model_path, vocab_path=self.vocab_path)
        return recognize_batch(crops, beam_width=beam_width, batch_size=batch_size,
                               model_path=self.recognizer_model_path, vocab_path=self.vocab_path, device=self.device)

    def _crops_from_elements(self, img, elements, padding: int) -> list:
        text_elements = [e for e in elements if e[1] in self.text_ids]
        text_elements.sort(key=lambda e: e[0][1])  # top to bottom
        w, h = img.size
        return [
            img.crop((max(0, x1 - padding), max(0, y1 - padding),
                      min(w, x2 + padding), min(h, y2 + padding)))
            for (x1, y1, x2, y2), _ in text_elements
        ]

    def _detect_crops(self, image_path: str, padding: int) -> list:
        from PIL import Image

        if self.engine == "surya":
            from ..detection.surya import run_textline_detector

            crops_with_coords, _ = run_textline_detector(image_path, expansion_px=2, padding_px=padding)
            return [c for c, _ in crops_with_coords]
        img = Image.open(image_path).convert("RGB")
        _, elements = self.detector.run(image_path)
        return self._crops_from_elements(img, elements, padding)

    def _detect_crops_batch(self, image_paths: list, padding: int) -> list[list]:
        """Detection for a group of pages. engine='custom' runs the group's
        SegFormer forwards as one batch and copies model-resolution maps
        (detection/detector.py::predict_maps_batch); surya goes page by page."""
        if self.engine != "custom" or getattr(self, "detector", None) is None:
            return [self._detect_crops(p, padding) for p in image_paths]
        from PIL import Image

        from ..detection.postprocess import extract_layout_elements

        images = [Image.open(p).convert("RGB") for p in image_paths]
        out = []
        for img, (_, cm, hm) in zip(images, self.detector.predict_maps_batch(images, group=4)):
            _, elements = extract_layout_elements(img, cm, hm, self.detector.cfg)
            out.append(self._crops_from_elements(img, elements, padding))
        return out

    def _detection_stream(self):
        """The detection worker's CUDA stream, made once a pipeline, so that
        its forwards overlap the decode the main thread issues on the default
        stream and its cached blocks are reused from call to call; the
        worker's copy of the packed maps to the host waits for this stream
        alone. Each use first waits for the default stream (the weights'
        upload)."""
        detector = getattr(self, "detector", None)
        if detector is None or detector.device.type != "cuda":
            return contextlib.nullcontext()
        import torch

        if getattr(self, "_stream", None) is None:
            self._stream = torch.cuda.Stream(detector.device)
        self._stream.wait_stream(torch.cuda.default_stream(detector.device))
        return torch.cuda.stream(self._stream)

    def process_image(self, image_path: str, output_path: str | None = None,
                      save_debug: bool = False, padding: int = 6,
                      beam_width: int = 1, batch_size: int = 8) -> str:
        image_path = str(image_path)
        if not Path(image_path).exists():
            raise FileNotFoundError(f"Image not found at: {image_path}")
        logger.info("Step 1: detecting layout (%s) for %s", self.engine, image_path)
        crops = self._detect_crops(image_path, padding)
        if not crops:
            logger.warning("No text elements found.")
            return ""
        logger.info("Step 2: recognizing %d lines (batch %d)", len(crops), batch_size)
        recognitions = self._recognize(crops, beam_width, batch_size)
        if save_debug:
            debug_dir = Path(f"debug_{Path(image_path).stem}_{self.engine}")
            if debug_dir.exists():
                shutil.rmtree(debug_dir)
            debug_dir.mkdir(parents=True)
            for i, (crop, text) in enumerate(zip(crops, recognitions)):
                crop.save(debug_dir / f"line_{i:03d}.png")
                (debug_dir / f"line_{i:03d}.txt").write_text(text, encoding="utf-8")
        final_text = "\n".join(recognitions)
        if output_path:
            Path(output_path).write_text(final_text, encoding="utf-8")
            logger.info("Step 3: saved to %s", output_path)
        return final_text

    def process_pages(self, image_paths, output_dir: str | None = None,
                      padding: int = 6, beam_width: int = 3, batch_size: int = 64,
                      pages_per_batch: int = 4, queue_depth: int = 4,
                      flush_lines: int = 256) -> list[str]:
        """Pipelined multi-page OCR, the serving path for documents.

        A detection worker thread streams each page's crops through a
        bounded queue while the main thread recognises them, so the
        detection of the next pages overlaps the decode of the earlier ones
        (the reference goes page by page, ocr_engine.py:37-102). The worker
        detects ``pages_per_batch`` pages at a time: with engine='custom'
        one batched SegFormer forward and one copy of model-resolution maps
        a group (``_detect_crops_batch``), on its own CUDA stream.

        Recognition flushes once the pending crops reach ``flush_lines``
        (default 256: full batches) or at the end of the stream. Returns the
        pages' texts; with ``output_dir`` each page also writes
        ``<stem>.txt``. A worker exception is raised here."""
        import queue as queue_mod
        import threading

        paths = [str(p) for p in image_paths]
        q: queue_mod.Queue = queue_mod.Queue(maxsize=max(1, queue_depth))
        worker_err: list[BaseException] = []
        group = max(1, pages_per_batch)

        def detect_worker():
            try:
                with self._detection_stream():
                    for g0 in range(0, len(paths), group):
                        part = paths[g0 : g0 + group]
                        for i, crops in enumerate(self._detect_crops_batch(part, padding)):
                            q.put((g0 + i, crops))
            except BaseException as e:  # raised again in the main thread
                worker_err.append(e)
            finally:
                q.put(None)

        t = threading.Thread(target=detect_worker, name="khmer-ocr-detect", daemon=True)
        t.start()
        texts: list[str] = [""] * len(paths)
        pending: list[tuple[int, list]] = []

        def flush():
            flat = [c for _, crops in pending for c in crops]
            if flat:
                rec = self._recognize(flat, beam_width, batch_size)
                off = 0
                for i, crops in pending:
                    texts[i] = "\n".join(rec[off : off + len(crops)])
                    off += len(crops)
            pending.clear()

        n_pending_lines = 0
        while (item := q.get()) is not None:
            pending.append(item)
            n_pending_lines += len(item[1])
            if n_pending_lines >= flush_lines:
                flush()
                n_pending_lines = 0
        flush()
        t.join()
        if worker_err:
            raise worker_err[0]
        if output_dir is not None:
            out = Path(output_dir)
            out.mkdir(parents=True, exist_ok=True)
            for path, text in zip(paths, texts):
                (out / f"{Path(path).stem}.txt").write_text(text, encoding="utf-8")
        return texts


def main(argv=None) -> int:
    """``khmer-ocr-pipeline``: the reference's ``netra_ocr`` flags
    (ocr_engine.py:104-129) with explicit model paths and ``--device``.
    Errors propagate."""
    import argparse

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s", datefmt="%H:%M:%S")
    p = argparse.ArgumentParser(description="Khmer OCR holistic pipeline (PyTorch, CUDA)")
    p.add_argument("--image", type=str, required=True,
                   help="Page image, or a DIRECTORY of pages (pipelined multi-page mode: "
                        "detection of the next pages overlaps recognition of the earlier ones)")
    p.add_argument("--engine", type=str, choices=["custom", "surya"], default="surya")
    p.add_argument("--output", type=str, default="ocr_result.txt")
    p.add_argument("--padding", type=int, default=6)
    p.add_argument("--beam", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--recognizer", type=str, required=True, help="Recognition weights (any kind the Predictor reads)")
    p.add_argument("--layout-model", type=str, default=None, help="SegFormer dir (engine=custom)")
    p.add_argument("--vocab", type=str, default=None)
    p.add_argument("--device", type=str, default=None, help="Device (default: the CUDA card)")
    args = p.parse_args(argv)
    pipeline = KhmerOCRPipeline(
        engine=args.engine, layout_model_dir=args.layout_model,
        recognizer_model_path=args.recognizer, vocab_path=args.vocab, device=args.device,
    )
    if Path(args.image).is_dir():
        exts = {".png", ".jpg", ".jpeg", ".tif", ".tiff", ".bmp"}
        pages = sorted(p for p in Path(args.image).iterdir() if p.suffix.lower() in exts)
        if not pages:
            raise FileNotFoundError(f"No page images in directory {args.image}")
        pipeline.process_pages(
            pages, output_dir=args.output, padding=args.padding,
            beam_width=args.beam, batch_size=args.batch_size,
        )
    else:
        pipeline.process_image(
            image_path=args.image, output_path=args.output, save_debug=args.debug,
            padding=args.padding, beam_width=args.beam, batch_size=args.batch_size,
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
