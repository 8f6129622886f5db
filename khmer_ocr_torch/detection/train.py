"""SegFormer layout-model fine-tuning in PyTorch: the function of the JAX
package's ``detection/train.py``, under its names.

    python -m khmer_ocr_torch.detection.train [--hf-checkpoint DIR] [--steps 200] [--batch-size 4]
        [--image-size 512] [--lr 6e-5] [--out layout_params.npz] [--device cpu]

Random init as HF's ``SegformerPreTrainedModel._init_weights`` (truncated
normal std 0.02 for dense and conv kernels, zero biases, unit LayerNorm and
BatchNorm); a train step whose forward is the inference forward with the
decode head's BatchNorm on batch statistics (``model.train()`` switches on
nothing else: no drop path, no classifier dropout, as in the JAX package);
HF's loss (logits upsampled to the label resolution, cross-entropy with
``IGNORE_INDEX`` masked); Adam as ``optax.adam``; a synthetic layout-page
generator so the loop runs without DocLayNet. The saved ``.npz`` has the JAX
package's flat slash layout, so files cross between the two packages.

``finetune`` and ``main`` run on the CUDA card unless the caller asks for
another device; without a card they raise. On the card each step replays
the captured CUDA graph of its batch's key (detection/graphs.py), as the
JAX package jits its step; on the CPU it runs eagerly.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
from torch import nn

from ..convert.from_jax import _unflatten, segformer_params_from_jax, segformer_params_to_jax
from ..train.step import adam_update, step_scalars
from .graphs import LayoutTrainGraphs, require_cuda
from .segformer import BN_MOMENTUM, SegFormer, SegFormerConfig, _BatchNorm, resize_bilinear  # noqa: F401

logger = logging.getLogger(__name__)

IGNORE_INDEX = 255  # HF semantic_loss_ignore_index


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def segformer_init(seed: int = 0, cfg: SegFormerConfig | None = None, device="cpu") -> SegFormer:
    """A SegFormer with HF's initialisation drawn from ``torch.Generator``
    seeded by ``seed``: truncated normal std 0.02 on [-2, 2] std for every
    dense and conv kernel (the depthwise one too), zero biases, unit
    LayerNorm scale, BatchNorm scale 1, shift 0, running mean 0 and variance
    1. (The JAX package's draws come from ``jax.random`` and cannot be
    reproduced here: parity runs start both packages from one numpy-seeded
    state, ``convert.from_jax.seeded_segformer_state``.)"""
    gen = torch.Generator().manual_seed(seed)
    model = SegFormer(cfg)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                nn.init.trunc_normal_(m.weight, std=0.02, a=-0.04, b=0.04, generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.LayerNorm, _BatchNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, _BatchNorm):
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)
    return model.to(device)


# ---------------------------------------------------------------------------
# loss and train step
# ---------------------------------------------------------------------------


def segformer_loss(model: SegFormer, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """HF's loss: the logits (B, C, H/4, W/4) upsampled to the labels'
    resolution (half-pixel, no antialias: an upsample), cross-entropy over
    ``log_softmax`` in float32, pixels at ``IGNORE_INDEX`` masked, divided by
    max(#valid, 1): an all-ignored batch gives 0 and finite gradients.

    images: (B, 3, H, W) normalised; labels: (B, H, W) integers. In train
    mode (``model.train()``) the decode head's BatchNorm takes the batch's
    statistics and moves its running pair, the counterpart of the JAX
    package's ``decode_head_train``."""
    logits = resize_bilinear(model(images), labels.shape[1:3]).to(torch.float32)
    labels = labels.to(torch.long)
    valid = labels != IGNORE_INDEX
    logp = torch.log_softmax(logits, dim=1)
    nll = -torch.gather(logp, 1, torch.where(valid, labels, 0)[:, None])[:, 0]
    return torch.where(valid, nll, 0.0).sum() / valid.sum().clamp_min(1)


def step_body(model: SegFormer, opt_state: dict, images: torch.Tensor, labels: torch.Tensor,
              scalars: torch.Tensor) -> torch.Tensor:
    """One step that reads nothing on the host -> the loss (0-d, detached).

    The forward in the model's mode (train mode: the decode head's
    BatchNorm on batch statistics, its running pair moved in place),
    gradients of ``segformer_loss`` for every parameter, Adam (optax's
    ``adam``: eps 1e-8 after the bias-corrected square root) in place with
    the learning rate and bias corrections of ``scalars``, a (1, 3) tensor
    of ``train/step.py::step_scalars``. The BatchNorm running pair is a
    buffer, not a parameter: it takes the batch-statistics update and no
    Adam step, as the JAX package re-inserts it. ``opt_state["count"]`` is
    the caller's to move (``step_scalars`` does), so that the body can be
    captured (detection/graphs.py)."""
    params = list(model.parameters())
    loss = segformer_loss(model, images, labels)
    grads = torch.autograd.grad(loss, params)
    adam_update(params, list(grads), opt_state, scalars[0, 0], scalars[0, 1:])
    return loss.detach()


def make_train_step(model: SegFormer, lr: float, *, graphs=None):
    """-> step(images, labels) -> loss (a 0-d tensor left on the device);
    ``step.opt_state``: Adam's state ({"mu", "nu": lists like the
    parameters, "count": the steps taken}).

    Each step puts the model in train mode, moves Adam's count on the host
    (``step_scalars``) and runs ``step_body``: eagerly, or given ``graphs``
    (a detection/graphs.py::LayoutTrainGraphs, on the card) as the replayed
    CUDA graph of its batch's key, the counterpart of the JAX package's
    jitted step. Given ``graphs``, CPU tensors raise ``ValueError``."""
    params = list(model.parameters())
    device = params[0].device
    opt_state = {"mu": [torch.zeros_like(p) for p in params], "nu": [torch.zeros_like(p) for p in params],
                 "count": 0}

    def step(images, labels):
        model.train()
        if graphs is None:
            return step_body(model, opt_state, images, labels, step_scalars(opt_state, [lr], 0.9, 0.999, device))
        require_cuda("make_train_step(graphs=...)", images, labels)  # before Adam's count moves
        return graphs.step(step_body, model, opt_state, images, labels,
                           step_scalars(opt_state, [lr], 0.9, 0.999, device))

    step.opt_state = opt_state
    return step


# ---------------------------------------------------------------------------
# synthetic layout pages (a stand-in for DocLayNet)
# ---------------------------------------------------------------------------

_SYNTH_CLASSES = (10, 11, 9, 7, 8)  # Text, Title, Table, Picture, Section-header


def synth_layout_batch(rng: np.random.RandomState, batch: int, size: int = 512, max_regions: int = 5):
    """Random white pages with class-coloured regions, the JAX package's
    pages and labels bit for bit (the same draws from ``rng``): text rows
    for Text/Title/Section-header, grid lines for Table, noise for Picture;
    the label map marks each region's rectangle.

    Returns (images (B, 3, S, S) float32 normalised like the detector's
    input, labels (B, S, S) int32); the JAX package's images are the NHWC
    transpose of these."""
    imgs = np.ones((batch, size, size, 3), np.float32)
    labels = np.zeros((batch, size, size), np.int32)
    for b in range(batch):
        for _ in range(rng.randint(1, max_regions + 1)):
            cls = int(_SYNTH_CLASSES[rng.randint(len(_SYNTH_CLASSES))])
            h = rng.randint(size // 16, size // 3)
            w = rng.randint(size // 8, size - 2)
            y = rng.randint(0, size - h)
            x = rng.randint(0, size - w)
            region = imgs[b, y:y + h, x:x + w]
            if cls in (10, 11, 8):  # text-like: dark horizontal stripes
                period = max(h // max(h // 12, 1), 4)
                rows = (np.arange(h) % period) < max(period // 2, 1)
                region[rows] = 0.15 + 0.1 * rng.rand()
            elif cls == 9:  # table: grid lines
                region[::16, :] = 0.1
                region[:, ::32] = 0.1
            else:  # picture: noise patch
                region[:] = rng.rand(h, w, 1) * 0.8
            labels[b, y:y + h, x:x + w] = cls
    # detector input normalisation: (x - 0.5) / 0.5
    return np.ascontiguousarray(((imgs - 0.5) / 0.5).transpose(0, 3, 1, 2)), labels


# ---------------------------------------------------------------------------
# fine-tune loop
# ---------------------------------------------------------------------------


def finetune(model: SegFormer | None = None, cfg: SegFormerConfig | None = None, *, steps: int = 100,
             batch_size: int = 4, image_size: int = 512, lr: float = 6e-5, seed: int = 0, data_iter=None,
             log_every: int = 10, device=None):
    """Fine-tune ``model`` (or train from ``segformer_init(seed, cfg)`` when
    it is None) on layout pages; returns (model, losses as floats).

    ``data_iter``: an iterator of (images (B, 3, H, W), labels (B, H, W))
    numpy batches, e.g. a real DocLayNet pipeline; by default the synthetic
    generator on ``RandomState(seed)``. lr 6e-5 is HF's semantic-segmentation
    fine-tune default. Losses stay on the device between log points. Each
    step runs under ``detector.PRECISION``, the parity mode; on the card as
    the replayed CUDA graph of its batch's key (detection/graphs.py, a cache
    of this call's, freed when it returns), on the CPU eagerly."""
    from ..infer.predictor import resolve_device
    from ..precision import matmul_precision
    from .detector import PRECISION

    device = resolve_device(device)
    model = (model if model is not None else segformer_init(seed, cfg)).to(device)
    step = make_train_step(model, lr, graphs=LayoutTrainGraphs() if device.type == "cuda" else None)
    if data_iter is None:
        rng = np.random.RandomState(seed)

        def gen():
            while True:
                yield synth_layout_batch(rng, batch_size, image_size)

        data_iter = gen()

    losses, pending = [], []
    for i in range(steps):
        images, labels = next(data_iter)
        images, labels = torch.from_numpy(images).to(device), torch.from_numpy(labels).to(device)
        with matmul_precision(PRECISION):
            pending.append(step(images, labels))
        if (i + 1) % log_every == 0 or i + 1 == steps:
            losses.extend(torch.stack(pending).cpu().tolist())
            pending.clear()
            if (i + 1) % log_every == 0:
                logger.info("layout train step %d/%d loss %.4f", i + 1, steps, losses[-1])
    return model, losses


def flatten_params(model: SegFormer) -> dict:
    """The model's weights and BatchNorm statistics -> {slash/path: float32
    array} in the JAX package's tree layout (lists as numeric segments), what
    its ``flatten_params`` gives for the same weights."""
    tree = segformer_params_to_jax(model.state_dict(), model.cfg)

    def flat(node, prefix=""):
        if isinstance(node, dict):
            return {k: v for key, sub in node.items() for k, v in flat(sub, f"{prefix}{key}/").items()}
        if isinstance(node, list):
            return {k: v for i, sub in enumerate(node) for k, v in flat(sub, f"{prefix}{i}/").items()}
        return {prefix[:-1]: node}

    return flat(tree)


def unflatten_params(flat: dict, cfg: SegFormerConfig | None = None) -> dict:
    """The inverse of ``flatten_params``: {slash/path: array} (also a file
    the JAX package saved) -> the SegFormer state dict (CPU tensors) that
    ``SegFormer(cfg).load_state_dict`` or ``segformer.build_model`` takes."""
    tree = _unflatten({tuple(int(s) if s.isdigit() else s for s in k.split("/")): np.asarray(v)
                       for k, v in flat.items()})
    return segformer_params_from_jax(tree, cfg)


def main(argv=None) -> int:
    """``python -m khmer_ocr_torch.detection.train``: fine-tune and save the
    weights as an .npz in the JAX package's layout."""
    import argparse

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s", datefmt="%H:%M:%S")
    p = argparse.ArgumentParser(description="Fine-tune the SegFormer layout model (PyTorch, CUDA)")
    p.add_argument("--hf-checkpoint", type=str, default=None,
                   help="HF checkpoint dir to start from (default: random init)")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--image-size", type=int, default=512)
    p.add_argument("--lr", type=float, default=6e-5)
    p.add_argument("--out", type=str, default="layout_params.npz")
    p.add_argument("--device", type=str, default=None, help="torch device (default: the CUDA card; 'cpu' on request)")
    args = p.parse_args(argv)

    from ..infer.predictor import resolve_device
    from .config import LayoutConfig
    from .segformer import build_model, load_hf_checkpoint

    device = resolve_device(args.device)
    model, cfg = None, SegFormerConfig(num_labels=LayoutConfig().num_labels)
    if args.hf_checkpoint:
        state, cfg = load_hf_checkpoint(args.hf_checkpoint)
        model = build_model(state, cfg, device)
    model, losses = finetune(model, cfg, steps=args.steps, batch_size=args.batch_size, image_size=args.image_size,
                             lr=args.lr, device=device)
    flat = flatten_params(model)
    np.savez(args.out, **flat)
    logger.info("saved %d arrays -> %s (final loss %.4f)", len(flat), args.out, losses[-1])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
