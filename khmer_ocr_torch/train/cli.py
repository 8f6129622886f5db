"""Train the recognizer with the PyTorch port:

    python -m khmer_ocr_torch.train.cli --synthetic 256 --epochs 2 --batch-size 32 [--font-dir DIR] [--corpus FILE]
    python -m khmer_ocr_torch.train.cli --data DIR --device cpu
    python -m torch.distributed.run --nproc-per-node N -m khmer_ocr_torch.train.cli --data-parallel --synthetic 256

Runs on the CUDA card unless ``--device`` names another device; without a
card it stops with an error, before any line is rendered. ``--synthetic N``
renders N document-style lines with the font renderer (data/generator.py),
which needs Pillow and, for its augmentation, OpenCV; they are augmented on
the device, or on the host with ``--host-augment`` (train/augment.py, cv2).
``--data`` lines are not augmented, as in the JAX package.
``--data-parallel`` trains one process per card over the process group
that ``torchrun`` sets up (parallel/mesh.py); without one it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s", datefmt="%H:%M:%S")
    p = argparse.ArgumentParser(description="Train the Khmer OCR recognizer (PyTorch, CUDA)")
    p.add_argument("--data", type=str, help="images/ + labels/ folder-pair dataset root")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="Train on N rendered document-style lines instead (data/generator.py)")
    p.add_argument("--font-dir", type=str, default=None, help="Fonts for --synthetic (default: data/fonts)")
    p.add_argument("--corpus", type=str, default=None, help="Word corpus for --synthetic (default: corpus_seed.txt)")
    p.add_argument("--backbone", type=str, default="se_vgg", choices=["se_vgg", "vgg", "resnet"])
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--checkpoint-dir", type=str, default="checkpoints")
    p.add_argument("--resume", type=str, default=None, help="Checkpoint dir to resume from")
    p.add_argument("--device", type=str, default=None, help="torch device (default: the CUDA card; 'cpu' on request)")
    p.add_argument("--host-augment", action="store_true",
                   help="Augment --synthetic lines on the host (cv2) instead of on the device")
    p.add_argument("--data-parallel", action="store_true",
                   help="One process per card under torchrun; the batch size is the global batch")
    args = p.parse_args(argv)
    if not (args.data or args.synthetic):
        p.error("Provide --data or --synthetic N")

    from ..config import OCRConfig
    from ..infer.predictor import resolve_device
    from .data import LineDataset, load_folder_dataset
    from .loop import train

    group = None
    if args.data_parallel:  # no torchrun, or no card: stop before any rendering
        from ..parallel.mesh import init_data_parallel

        group, device = init_data_parallel(device=args.device)
    else:
        device = resolve_device(args.device)  # no card: stop before any rendering

    config = OCRConfig()
    config = dataclasses.replace(config, model=dataclasses.replace(
        config.model, backbone=args.backbone, use_bilstm=args.backbone == "se_vgg"))
    if args.batch_size:
        config = dataclasses.replace(config, train=dataclasses.replace(config.train, batch_size=args.batch_size))
    if args.synthetic:
        from ..data.generator import DocumentTextGenerator

        gen = DocumentTextGenerator(font_dir=args.font_dir, corpus_path=args.corpus)
        dataset = LineDataset(gen.generate(args.synthetic, processes=4), train_cfg=config.train,
                              device_augment=not args.host_augment, augment=True)
    else:
        dataset = load_folder_dataset(args.data, train_cfg=config.train)
    try:
        train(dataset, config, checkpoint_dir=args.checkpoint_dir, device=device, num_epochs=args.epochs,
              resume_from=args.resume, process_group=group)
    finally:
        if group is not None:
            import torch.distributed as dist

            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
