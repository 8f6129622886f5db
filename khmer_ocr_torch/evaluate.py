"""CER evaluation over ``images/`` + ``labels/`` folder pairs, and the Tesseract baseline.

    python -m khmer_ocr_torch.evaluate --data test/printed --model khmer_ocr_torch/assets/flagship \\
        [--binarize] [--degraded --kinds blur noise --severities 1 3 5] [--report-dir out] [--device cpu]

Recognition runs through the port's Predictor, on the CUDA card unless
``--device`` names another device; without a card it raises. ``--tesseract``
scores pytesseract (lang=khm, --psm 7) through the same interface instead,
where pytesseract is installed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
from pathlib import Path

from .metrics import Evaluator

logger = logging.getLogger(__name__)


def make_recognizer(model_path, vocab_path=None, beam_width: int = 3, batch_size: int = 32,
                    binarize: bool = False, device=None):
    """A ``recognize_fn`` (image paths -> strings) over one Predictor; with
    ``binarize`` every line is blurred and Otsu-thresholded before its resize."""
    from .config import OCRConfig
    from .infer.predictor import Predictor

    cfg = OCRConfig()
    cfg = dataclasses.replace(cfg, preprocess=dataclasses.replace(cfg.preprocess, binarize=binarize))
    predictor = Predictor(model_path=model_path, vocab_path=vocab_path, config=cfg, device=device)

    def recognize_fn(paths: list[str]) -> list[str]:
        return predictor.predict_batch(paths, beam_width=beam_width, batch_size=batch_size)

    return recognize_fn


def make_tesseract_recognizer(lang: str = "khm", psm: int = 7):
    """The Tesseract baseline: pytesseract, lang=khm, --psm 7."""
    try:
        import pytesseract
    except ImportError as e:
        raise ImportError("pytesseract not installed: the Tesseract baseline is unavailable") from e
    from PIL import Image

    def recognize_fn(paths: list[str]) -> list[str]:
        return [
            pytesseract.image_to_string(Image.open(p), lang=lang, config=f"--psm {psm}").strip()
            for p in paths
        ]

    return recognize_fn


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s", datefmt="%H:%M:%S")
    p = argparse.ArgumentParser(description="CER evaluation over images/+labels/ folder pairs (PyTorch, CUDA)")
    p.add_argument("--data", required=True, nargs="+",
                   help="One or more split dirs, each containing images/ and labels/")
    p.add_argument("--model", default=None, help="Recognition weights, any kind the Predictor loads "
                                                 "(omit with --tesseract)")
    p.add_argument("--vocab", default=None)
    p.add_argument("--beam", type=int, default=3, help="Beam width")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--tesseract", action="store_true", help="Run the Tesseract baseline instead")
    p.add_argument("--binarize", action="store_true",
                   help="Otsu-binarize inputs (after a 5x5 Gaussian blur) before the resize")
    p.add_argument("--report-dir", default=None, help="Write failure reports + results.json here")
    p.add_argument("--degraded", action="store_true",
                   help="Evaluate severity-swept degradations of each split instead of the clean images "
                        "(data/degrade.py; builds and caches <split>_degraded/; needs OpenCV)")
    p.add_argument("--kinds", nargs="+", default=None,
                   help="Degradation kinds (default: all + 'mix'); with --degraded")
    p.add_argument("--severities", nargs="+", type=int, default=None,
                   help="Severities 1-5 to sweep (default: 1 3 5); with --degraded")
    p.add_argument("--degrade-seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card; 'cpu' on request)")
    args = p.parse_args(argv)

    if args.tesseract:
        recognize_fn = make_tesseract_recognizer()
    elif args.model:
        recognize_fn = make_recognizer(args.model, args.vocab, args.beam, args.batch_size,
                                       binarize=args.binarize, device=args.device)
    else:
        p.error("Provide --model or --tesseract")
        return 2

    splits: list[tuple[str, Path]] = []
    if args.degraded:
        from .data.degrade import DEFAULT_KINDS, DEFAULT_SEVERITIES, build_degraded_suite

        kinds = tuple(args.kinds) if args.kinds else DEFAULT_KINDS
        severities = tuple(args.severities) if args.severities else DEFAULT_SEVERITIES
        include_mix = args.kinds is None or "mix" in args.kinds
        kinds = tuple(k for k in kinds if k != "mix")
        for split in args.data:
            suite = build_degraded_suite(split, kinds=kinds, severities=severities,
                                         seed=args.degrade_seed, include_mix=include_mix)
            base = Path(split).name
            splits += [(f"{base}/{name}", path) for name, path in sorted(suite.items())]
    else:
        splits = [(Path(s).name, Path(s)) for s in args.data]

    evaluator = Evaluator(recognize_fn)
    results = {}
    for name, split in splits:
        report = Path(args.report_dir) / f"{name.replace('/', '_')}_failures.txt" if args.report_dir else None
        if report:
            report.parent.mkdir(parents=True, exist_ok=True)
        res = evaluator.evaluate_split(split, report_path=report)
        results[name] = {
            "mean_cer": res.mean_cer,
            "exact_match_accuracy": res.exact_match_accuracy,
            "num_samples": res.num_samples,
        }
        print(f"{name}: {res.summary()}")
    if args.report_dir:
        (Path(args.report_dir) / "results.json").write_text(json.dumps(results, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
