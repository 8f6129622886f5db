"""Text-line recognition from the command line, on the CUDA card.

    python -m khmer_ocr_torch.infer.cli --image line.png --model weights.npz --beam 3 --output out.txt

Flag-compatible with the JAX package's CLI (--image/--model/--vocab/--beam/
--output). ``--model`` takes a reference checkpoint (.pth, .pt,
.safetensors), an .npz written by ``convert.from_jax.save_npz``, a
checkpoint directory of the port's trainer, or a weights index directory
(``khmer_ocr_torch/assets/flagship``): ``predictor.load_weights``.
Without a CUDA card it raises; it never falls back to the CPU.
``KHMER_OCR_MEGA_DECODE=1`` decodes a line in one launch of kernel K3 where
the beam width and the line fit its envelope.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Khmer OCR (PyTorch, CUDA): text-line recognition")
    parser.add_argument("--image", type=str, required=True, help="Path to input image")
    parser.add_argument("--model", type=str, required=True,
                        help="Weights: .pth/.pt/.safetensors, an .npz of save_npz, a trainer checkpoint directory "
                             "or a weights index directory")
    parser.add_argument("--vocab", type=str, default=None, help="char2idx.json (default: bundled)")
    parser.add_argument("--beam", type=int, default=3, help="Beam width (1 for greedy)")
    parser.add_argument("--output", type=str, help="Save result to text file")
    args = parser.parse_args(argv)

    from .api import recognize

    text = recognize(args.image, args.beam, args.model, args.vocab)
    print("\n" + "=" * 40)
    print(f"RESULT: {text}")
    print("=" * 40 + "\n")
    if args.output:
        with open(args.output, "w", encoding="utf-8") as f:
            f.write(text)
        print(f"Saved to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
