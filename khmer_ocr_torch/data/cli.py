"""Synthetic Khmer text-line data from the command line:

    python -m khmer_ocr_torch.data.cli --num 1000 --out data/train [--style scene] [--seed 0]

Writes ``images/`` + ``labels/`` (data/generator.py). Needs Pillow, and
OpenCV unless ``--no-augment``.
"""

from __future__ import annotations

import argparse
import logging


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description="Generate synthetic Khmer text-line data")
    p.add_argument("--style", choices=["document", "scene"], default="document")
    p.add_argument("--num", type=int, default=1000)
    p.add_argument("--out", type=str, required=True, help="Output dir (images/ + labels/)")
    p.add_argument("--font-dir", type=str, default=None)
    p.add_argument("--corpus", type=str, default=None)
    p.add_argument("--background-dir", type=str, default=None, help="Scene style backgrounds")
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--processes", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--push-to-hub", type=str, default=None, help="Also push as HF dataset repo id")
    vis = p.add_mutually_exclusive_group()
    vis.add_argument("--private", dest="private", action="store_true", default=None,
                     help="Push the hub dataset private (default: document public, scene private)")
    vis.add_argument("--public", dest="private", action="store_false", default=None)
    args = p.parse_args(argv)

    from .generator import DocumentTextGenerator, SceneTextGenerator

    if args.style == "scene":
        gen = SceneTextGenerator(
            font_dir=args.font_dir, corpus_path=args.corpus, seed=args.seed,
            augment=not args.no_augment, background_dir=args.background_dir,
        )
    else:
        gen = DocumentTextGenerator(
            font_dir=args.font_dir, corpus_path=args.corpus, seed=args.seed,
            augment=not args.no_augment,
        )
    results = gen.generate(args.num, out_dir=args.out, processes=args.processes)
    print(f"{len(results)} samples -> {args.out}")
    if args.push_to_hub:
        gen.push_to_hub(args.push_to_hub, args.num, processes=args.processes, private=args.private)
        print(f"pushed to hub: {args.push_to_hub}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
