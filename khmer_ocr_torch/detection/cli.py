"""Layout detection from the command line, on the CUDA card.

    python -m khmer_ocr_torch.detection.cli --image page.png --model det-b0 --output detection_results

Flag-compatible with the JAX package's layout CLI (reference: detector.py
argparse CLI, detector.py:106-136), plus ``--device`` (``cpu`` for the
plain PyTorch path; without a card and without ``--device cpu`` it raises).
"""

from __future__ import annotations

import argparse
import logging


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s", datefmt="%H:%M:%S")
    p = argparse.ArgumentParser(description="Khmer OCR layout detection (PyTorch, CUDA SegFormer)")
    p.add_argument("--image", type=str, required=True, help="Input page image")
    p.add_argument("--model", type=str, required=True, help="HF SegFormer checkpoint dir")
    p.add_argument("--output", type=str, default="detection_results", help="Artifact directory")
    p.add_argument("--device", type=str, default=None, help="Device (default: the CUDA card)")
    args = p.parse_args(argv)

    from pathlib import Path

    from .detector import LayoutInference

    engine = LayoutInference(args.model, device=args.device)
    stem = Path(args.image).stem
    _, elements = engine.run(args.image, output_dir=args.output, stem=stem)
    print(f"{len(elements)} layout elements -> {args.output}/{stem}_layout.json")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
