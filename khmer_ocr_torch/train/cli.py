"""Train the recognizer with the PyTorch port:

    python -m khmer_ocr_torch.train.cli --synthetic 256 --epochs 2 --batch-size 32
    python -m khmer_ocr_torch.train.cli --data DIR --device cpu

Runs on the CUDA card unless ``--device`` names another device; without a
card it stops with an error.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging

SYNTHETIC_HELP = ("Train on N synthetic lines (data/synthetic.py: seeded blocks, not rendered text) with label "
                  "strings drawn from the vocabulary by the seed; this stands in for the font renderer "
                  "(data/generator.py), which the port does not have yet")


def synthetic_dataset(n: int, seed: int, train_cfg, device_augment: bool = True):
    """N seeded lines of 1-16 chunks with label strings drawn from the
    vocabulary (data/synthetic.py::synthetic_samples)."""
    import numpy as np

    from ..data.synthetic import synthetic_samples
    from .data import LineDataset

    counts = np.random.RandomState(seed).randint(1, 17, size=n)
    return LineDataset(synthetic_samples(counts.tolist(), seed), train_cfg=train_cfg, device_augment=device_augment)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s", datefmt="%H:%M:%S")
    p = argparse.ArgumentParser(description="Train the Khmer OCR recognizer (PyTorch, CUDA)")
    p.add_argument("--data", type=str, help="images/ + labels/ folder-pair dataset root")
    p.add_argument("--synthetic", type=int, default=0, metavar="N", help=SYNTHETIC_HELP)
    p.add_argument("--backbone", type=str, default="se_vgg", choices=["se_vgg", "vgg", "resnet"])
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--checkpoint-dir", type=str, default="checkpoints")
    p.add_argument("--resume", type=str, default=None, help="Checkpoint dir to resume from")
    p.add_argument("--device", type=str, default=None, help="torch device (default: the CUDA card; 'cpu' on request)")
    args = p.parse_args(argv)
    if not (args.data or args.synthetic):
        p.error("Provide --data or --synthetic N")

    from ..config import OCRConfig
    from .data import load_folder_dataset
    from .loop import train

    config = OCRConfig()
    config = dataclasses.replace(config, model=dataclasses.replace(
        config.model, backbone=args.backbone, use_bilstm=args.backbone == "se_vgg"))
    if args.batch_size:
        config = dataclasses.replace(config, train=dataclasses.replace(config.train, batch_size=args.batch_size))
    if args.synthetic:
        dataset = synthetic_dataset(args.synthetic, config.train.seed, config.train)
    else:
        dataset = load_folder_dataset(args.data, train_cfg=config.train)
    train(dataset, config, checkpoint_dir=args.checkpoint_dir, device=args.device, num_epochs=args.epochs,
          resume_from=args.resume)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
