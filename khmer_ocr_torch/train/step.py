"""The training state and the teacher-forced train step.

One step: the batch's lines are augmented, cut and normalised on the device
("lines" layout; "chunks" batches come cut), the model runs in train mode
(BatchNorm on batch statistics, dropout), the loss is the cross-entropy of
``labels[:, 1:]`` given ``labels[:, :-1]``, averaged over the targets that
are not padding, and the gradient moves the params by ``-lr`` times the Adam
direction (b1 0.9, b2 0.999, eps 1e-8, bias-corrected, as optax's
``scale_by_adam``). The learning rate is the caller's per step
(train/schedule.py). Params, moments and BatchNorm statistics are updated in
place, which keeps one copy of each on the device.

K steps run as one body (``step_body``) over a batch dict whose tensors
carry a leading K axis: the counterpart of the JAX package's ``lax.scan``
of its step. The body reads nothing on the host: each step's learning rate
and Adam's two bias corrections come as a (K, 3) tensor on the params'
device (``step_scalars``; ``opt_state["count"]`` stays a host int). So the
same body runs eagerly (the CPU, and the card under a process group) and,
given a ``TrainGraphs`` (train/graphs.py), is captured on the card as one
CUDA graph a shape and replayed, as the JAX package jits its step once.
``make_train_step`` is the body at K = 1, ``make_train_multi_step`` at K.

Randomness (augmentation, then dropout) comes from one ``torch.Generator``
on the device, drawn in a fixed order.

Each step (forward, gradients, Adam) and ``eval_logits`` run under the
matmul precision they are given (``precision.matmul_precision``), as the
JAX package runs its step under ``default_matmul_precision``; ``train()``
passes ``runtime.matmul_precision``. The default here is "highest", the
parity mode, where the JAX package's step makers default to "default".

Data-parallel (``group``, a torch.distributed process group of which each
rank holds its rows of the global batch; parallel/mesh.py): BatchNorm takes
the global batch's statistics, the loss divides by the global count of
targets, and the gradients are summed over the group before Adam, so the
step equals the one-process step on the whole batch and every rank's params
stay equal. Its collectives cannot be captured, so it runs eagerly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import ModelConfig
from ..models.layers import Dropout
from ..models.ocr_model import forward_train, init_model
from ..ops.lines import device_chunk, u8_to_unit, unit_normalize
from ..parallel.mesh import all_reduce_sum_
from ..precision import check_precision, matmul_precision
from ..profiling import span
from .device_augment import augment_lines

ADAM_EPS = 1e-8


def tree_leaves(tree) -> list:
    """The tensors of a nested dict/list tree, in a fixed order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


@dataclasses.dataclass
class TrainState:
    params: dict  # trainable float32 tensors (requires_grad)
    batch_stats: dict  # BatchNorm running statistics
    opt_state: dict  # {"mu": tree like params, "nu": tree like params, "count": int}
    step: int


def init_train_state(model_cfg: ModelConfig, seed: int = 0, device="cpu") -> TrainState:
    """Seeded params (models/ocr_model.py::init_model) and zero moments."""
    params, stats = init_model(model_cfg, seed, device)
    return state_from(params, stats)


def state_from(params: dict, batch_stats: dict, opt_state: dict | None = None, step: int = 0) -> TrainState:
    """A TrainState over these trees (params set to require grad); zero
    moments unless ``opt_state`` is given."""
    params = tree_map(lambda t: t.detach().requires_grad_(True), params)
    if opt_state is None:
        opt_state = {"mu": tree_map(torch.zeros_like, params), "nu": tree_map(torch.zeros_like, params), "count": 0}
    return TrainState(params, batch_stats, opt_state, step)


def batch_to_device(batch: dict, device) -> dict:
    """A batch of numpy arrays -> tensors on ``device`` (through pinned
    memory and an asynchronous copy on a CUDA device)."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t.to(device)
    return out


def batch_chunks(batch: dict, generator, train: bool, chunk_geom: tuple[int, int], augment_prob: float):
    """The model's (B, N, H, CW) input from either batch layout: "chunks"
    as they come; "lines" (uint8) normalised, augmented in training when
    ``augment_prob`` > 0, and cut on the device."""
    if "lines" not in batch:
        return batch["chunks"]
    unit = u8_to_unit(batch["lines"])
    if train and augment_prob > 0.0:
        unit = augment_lines(unit, batch["widths"], generator, augment_prob=augment_prob)
    return device_chunk(unit_normalize(unit), chunk_geom)


def loss_fn(params, batch_stats, batch: dict, model_cfg: ModelConfig, generator=None, train: bool = True,
            chunk_geom: tuple[int, int] = (100, 84), augment_prob: float = 0.0, group=None):
    """-> (masked cross-entropy of the shifted labels, new batch_stats).
    Under a process group: this rank's share of the global loss, its summed
    cross-entropy over the targets of every rank."""
    chunks = batch_chunks(batch, generator, train, chunk_geom, augment_prob)
    drop = Dropout(model_cfg.dropout, deterministic=not train, generator=generator)
    labels = batch["labels"].to(torch.long)
    logits, new_stats = forward_train(params, batch_stats, chunks, batch["chunk_counts"], labels[:, :-1], model_cfg,
                                      drop, train, group)
    targets = labels[:, 1:]
    mask = (targets != model_cfg.pad_idx).to(torch.float32)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    count = mask.sum()
    if group is not None:
        all_reduce_sum_([count], group)
    return (nll * mask).sum() / count.clamp_min(1.0), new_stats


def tree_copy_(dst, src) -> None:
    """Copy each tensor of ``src`` into the tensor of ``dst`` at the same
    place (walked by ``dst``'s keys), in place."""
    if isinstance(dst, dict):
        for k, v in dst.items():
            tree_copy_(v, src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            tree_copy_(d, s)
    elif dst is not src:
        dst.copy_(src)


def step_scalars(opt_state: dict, lrs, b1: float, b2: float, device) -> torch.Tensor:
    """(K, 3) float32 on ``device``: each of K steps' learning rate and
    Adam's bias corrections 1 - b1**count and 1 - b2**count for the counts
    that follow ``opt_state["count"]``, which moves on by K. Computed on the
    host in double precision and rounded once, as a Python scalar is
    rounded to the tensors' float32; shipped in one pinned copy."""
    device = torch.device(device)
    c0 = opt_state["count"]
    rows = [(float(lr), 1.0 - b1 ** (c0 + i), 1.0 - b2 ** (c0 + i)) for i, lr in enumerate(lrs, 1)]
    opt_state["count"] = c0 + len(rows)
    host = torch.tensor(rows, dtype=torch.float32, pin_memory=device.type == "cuda")
    return host.to(device, non_blocking=True)


@torch.no_grad()
def adam_update(params: list, grads: list, opt_state: dict, lr: torch.Tensor, corrections: torch.Tensor,
                b1: float = 0.9, b2: float = 0.999):
    """params -= lr * mu_hat / (sqrt(nu_hat) + eps), the moments of
    ``opt_state`` moved first; all in place. ``lr`` is a 0-d tensor and
    ``corrections`` the two bias corrections (2,) for this step's count,
    both on the params' device (``step_scalars``), so that nothing is read
    on the host. Bit for bit the update of a Python float lr: each scalar is
    rounded to float32 and the ops round where ``addcdiv`` does."""
    mu, nu = tree_leaves(opt_state["mu"]), tree_leaves(opt_state["nu"])
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, grads, alpha=1.0 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
    update = torch._foreach_div(mu, corrections[0])
    denom = torch._foreach_sqrt(torch._foreach_div(nu, corrections[1]))
    torch._foreach_add_(denom, ADAM_EPS)
    torch._foreach_mul_(update, -lr)
    torch._foreach_div_(update, denom)
    torch._foreach_add_(params, update)


def step_body(model_cfg: ModelConfig, chunk_geom: tuple[int, int] = (100, 84), augment_prob: float = 0.0,
              b1: float = 0.9, b2: float = 0.999, group=None):
    """-> body(state, stacked, generator, scalars) -> (loss (K,), grad_norm
    (K,)): K train steps in order over ``stacked`` (a batch dict whose
    tensors carry a leading K axis) with ``scalars`` (K, 3) of
    ``step_scalars``. Params and moments move in place, the BatchNorm
    statistics are copied into ``state.batch_stats`` in place; the body
    reads nothing on the host, so it can be captured (train/graphs.py).
    ``state.step`` is the caller's to move."""

    def body(state: TrainState, stacked: dict, generator, scalars: torch.Tensor):
        leaves = tree_leaves(state.params)
        losses, norms = [], []
        for k in range(scalars.shape[0]):
            loss, new_stats = loss_fn(state.params, state.batch_stats, {key: v[k] for key, v in stacked.items()},
                                      model_cfg, generator, True, chunk_geom, augment_prob, group)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
            loss = loss.detach()
            if group is not None:
                all_reduce_sum_(list(grads) + [loss], group)
            with torch.no_grad():
                norms.append(torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads))))
                adam_update(leaves, list(grads), state.opt_state, scalars[k, 0], scalars[k, 1:], b1, b2)
                tree_copy_(state.batch_stats, new_stats)
            losses.append(loss)
        return torch.stack(losses), torch.stack(norms)

    return body


def _make_steps(model_cfg, chunk_geom, augment_prob, b1, b2, group, precision, graphs):
    """-> run(state, stacked, generator, lrs): ``step_body`` over K = len(lrs)
    steps, eagerly or, given ``graphs``, through its CUDA graph."""
    check_precision(precision)
    if graphs is not None and group is not None:
        raise ValueError("a process group's collectives cannot be captured: its steps run eagerly")
    body = step_body(model_cfg, chunk_geom, augment_prob, b1, b2, group)
    key = (model_cfg, chunk_geom, augment_prob, b1, b2)

    def run(state: TrainState, stacked: dict, generator, lrs):
        device = tree_leaves(state.params)[0].device
        with span("khmer_ocr.train.step"), matmul_precision(precision):
            scalars = step_scalars(state.opt_state, lrs, b1, b2, device)
            if graphs is None:
                loss, norm = body(state, stacked, generator, scalars)
            else:
                loss, norm = graphs.step(key, body, state, stacked, generator, scalars)
        state.step += len(lrs)
        return state, {"loss": loss, "grad_norm": norm}

    return run


def make_train_step(model_cfg: ModelConfig, chunk_geom: tuple[int, int] = (100, 84), augment_prob: float = 0.0,
                    b1: float = 0.9, b2: float = 0.999, group=None, *, precision: str = "highest", graphs=None):
    """-> train_step(state, batch, generator, lr) -> (state, {"loss",
    "grad_norm"}), both 0-d tensors left on the device. ``batch``: a dict of
    tensors on the params' device; under ``group`` this rank's rows, and the
    loss and norm are the global batch's. The step runs under ``precision``;
    given ``graphs`` (a TrainGraphs, on the card) as a replayed CUDA graph."""
    run = _make_steps(model_cfg, chunk_geom, augment_prob, b1, b2, group, precision, graphs)

    def train_step(state: TrainState, batch: dict, generator, lr: float):
        state, m = run(state, {k: v[None] for k, v in batch.items()}, generator, [lr])
        return state, {k: v[0] for k, v in m.items()}

    return train_step


def make_train_multi_step(model_cfg: ModelConfig, chunk_geom: tuple[int, int] = (100, 84),
                          augment_prob: float = 0.0, b1: float = 0.9, b2: float = 0.999, group=None, *,
                          precision: str = "highest", graphs=None):
    """-> multi_step(state, stacked, generator, lrs): K steps in a row over a
    batch dict whose tensors carry a leading K axis, with lrs (K,) Python
    floats; metrics come back as (K,) tensors. Equal to K calls of
    ``make_train_step``'s step (the same body); given ``graphs``, one CUDA
    graph for the K steps."""
    return _make_steps(model_cfg, chunk_geom, augment_prob, b1, b2, group, precision, graphs)


@torch.no_grad()
def eval_logits(params, batch_stats, batch: dict, model_cfg: ModelConfig, chunk_geom: tuple[int, int] = (100, 84),
                *, precision: str = "highest"):
    """Teacher-forced logits in inference mode (the loop's eye test), under
    ``precision``."""
    with matmul_precision(precision):
        chunks = batch_chunks(batch, None, False, chunk_geom, 0.0)
        logits, _ = forward_train(params, batch_stats, chunks, batch["chunk_counts"],
                                  batch["labels"].to(torch.long)[:, :-1], model_cfg, None, False)
    return logits
