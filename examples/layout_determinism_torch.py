#!/usr/bin/env python3
"""Whether the SegFormer layout train step gives the same bits every run on
the card, with CUDA's own bilinear backward and with the port's
(``detection/segformer.py::_Upsample``: the upsample's gradient as two
matmuls with the interpolation matrices).

    python3 examples/layout_determinism_torch.py [--steps 8] [--batch 4] [--size 512]

For each backward: two eager runs and one run through the layout train
graphs (detection/graphs.py) of ``--steps`` steps from ``segformer_init(0)``
(MiT-b0, 12 labels) at lr 6e-5 on one synthetic batch, cuDNN deterministic,
matmul precision "highest"; the largest |difference| of the losses,
parameters, Adam's moments and the BatchNorm running pair between the two
eager runs and between the graph and the first eager run, and the eager
step's ms (CUDA events over ``--steps`` steps after two warm-up steps), with
the card's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def cuda_backward_resize(x, out_hw):
    """``segformer.resize_bilinear`` with ``F.interpolate``'s own backward."""
    import torch.nn.functional as F

    h, w = x.shape[2:]
    out_hw = tuple(int(v) for v in out_hw)
    return F.interpolate(x, size=out_hw, mode="bilinear", align_corners=False,
                         antialias=out_hw[0] < h or out_hw[1] < w)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--size", type=int, default=512)
    args = p.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from khmer_ocr_torch.detection import segformer
    from khmer_ocr_torch.detection import train as dtrain
    from khmer_ocr_torch.detection.graphs import LayoutTrainGraphs
    from khmer_ocr_torch.detection.segformer import SegFormerConfig
    from khmer_ocr_torch.precision import matmul_precision

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    x, y = (torch.from_numpy(a).cuda() for a in dtrain.synth_layout_batch(np.random.RandomState(1), args.batch,
                                                                          args.size))

    def run(graphed: bool) -> list:
        model = dtrain.segformer_init(0, SegFormerConfig(), "cuda")
        step = dtrain.make_train_step(model, 6e-5, graphs=LayoutTrainGraphs() if graphed else None)
        losses = torch.stack([step(x, y) for _ in range(args.steps)])
        tensors = list(model.parameters()) + step.opt_state["mu"] + step.opt_state["nu"] + list(model.buffers())
        return [losses] + [t.detach().clone() for t in tensors]

    def worst(a: list, b: list) -> float:
        return max((u - v).abs().max().item() for u, v in zip(a, b))

    def eager_ms() -> float:
        model = dtrain.segformer_init(0, SegFormerConfig(), "cuda")
        step = dtrain.make_train_step(model, 6e-5)
        for _ in range(2):
            step(x, y)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.steps):
            step(x, y)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.steps

    torch.backends.cudnn.deterministic = True
    for name, resize in (("CUDA's own backward", cuda_backward_resize), ("two matmuls", segformer.resize_bilinear)):
        with mock.patch.object(segformer, "resize_bilinear", resize), \
                mock.patch.object(dtrain, "resize_bilinear", resize), matmul_precision("highest"):
            first, second, graphed = run(False), run(False), run(True)
            ms = eager_ms()
        print(f"[determinism] {name}, {args.steps} steps at batch {args.batch} x {args.size} px: eager against eager "
              f"max |diff| {worst(first, second):.3e}, graph against eager {worst(graphed, first):.3e} over "
              f"{len(first)} tensors; the eager step {ms:.3f} ms; {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
