"""Data and tensor parallelism over ``torch.distributed``: one process per device.

The JAX package runs one process over a (data, model) device mesh, and
XLA's partitioner makes every sharded array logically global. The port's
counterpart of its data axis is a process group: one process per card over
NCCL, or per CPU over gloo. Every rank holds the whole model and takes its
rows of every batch; what JAX computes over the global batch is computed
here with collectives over the group:

  * BatchNorm in training normalises with the global batch's mean and
    biased variance and moves its running pair with the global unbiased
    variance (``global_batch_norm``, called by models/backbones.py);
  * the loss divides by the global count of targets (train/step.py), so the
    sum of the ranks' gradients is the full batch's gradient;
  * the gradients are summed over the group in one flat bucket before Adam
    (``all_reduce_sum_``), so every rank takes the same step and the params
    stay replicated (rank 0's initial params are broadcast first);
  * serving (infer/predictor.py) decodes each rank's rows and gathers the
    tokens, so every rank returns every string.

Launch a data-parallel run with ``torchrun``, which sets the rank, world size
and rendezvous address in the environment:

    python -m torch.distributed.run --nproc-per-node N -m khmer_ocr_torch.train.cli --data-parallel ...

The model axis (tensor parallelism): ``make_mesh(n_data, n_model)`` places
the world's ranks as the JAX package's ``np.array(devices).reshape(n_data,
n_model)`` does, the model index fastest, and gives this rank its data
group (the ranks of its model index) and its model group (the ranks of its
data index). Over a model group each rank holds its part of the params
(parallel/placement.py: ``shard_params`` on the JAX-layout tree, then
``convert.from_jax.params_from_jax(..., model_group=)``), and the model's
functions take ``model_group=``: attention over the local heads, the FFN
over the local columns, the out-projections and the second FFN weight as
partial sums all-reduced over the group (``reduce_from_model``), the token
embedding as a masked local lookup all-reduced, the vocabulary projection
over the local columns all-gathered (``gather_from_model``). Entering a
parallel region goes through ``copy_to_model``, whose backward all-reduces
the input's gradient, so ``forward_train`` under a model group gives every
rank the one-process gradients of its part, as JAX's partitioner does.
Serve with a mesh under torchrun:

    mesh = make_mesh(n_data, n_model)    # in every process, after init_process_group
    local = shard_params(params, mesh.model_rank, mesh.n_model)
    state = params_from_jax(local, stats, cfg, device, model_group=mesh.model_group)
    tokens = infer_batch(state, lines, counts, cfg, dec_cfg, chunk_geom, model_group=mesh.model_group)
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from .placement import param_sharding, shard_params, spec_for_path  # noqa: F401 (the mesh's placement)


def group_is_up() -> bool:
    """Whether this process has joined a process group."""
    return dist.is_available() and dist.is_initialized()


def init_data_parallel(backend: str | None = None, device=None):
    """Join the process group that ``torchrun`` describes in the environment
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) -> (group,
    device). The device is ``cuda:{LOCAL_RANK}`` unless ``device`` names
    another (``"cpu"``); the backend NCCL on a card and gloo on the CPU
    unless ``backend`` names one. Raises when the environment has no rank:
    a data-parallel run does not quietly train on one device."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        raise RuntimeError("data-parallel training runs under torchrun (python -m torch.distributed.run "
                           "--nproc-per-node N -m khmer_ocr_torch.train.cli --data-parallel ...): no RANK and "
                           "WORLD_SIZE in the environment")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to train data-parallel on the CPU over gloo")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    device = torch.device(device)
    if not group_is_up():
        dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"), init_method="env://")
    return dist.group.WORLD, device


def data_shard(batch: dict, rank: int, world: int) -> dict:
    """This rank's rows of a batch (a dict of arrays or tensors with a
    leading batch axis): the batch padded to a multiple of ``world`` by
    repeating its last row, then cut into ``world`` equal parts in order."""
    b = len(next(iter(batch.values())))
    per = -(-b // world)
    out = {}
    for k, v in batch.items():
        if per * world != b:
            tail = v[-1:].repeat(per * world - b, *([1] * (v.ndim - 1))) if isinstance(v, torch.Tensor) else \
                np.repeat(v[-1:], per * world - b, axis=0)
            v = torch.cat([v, tail]) if isinstance(v, torch.Tensor) else np.concatenate([v, tail])
        out[k] = v[rank * per:(rank + 1) * per]
    return out


def world_of(group) -> tuple[int, int]:
    """(rank, world size) in ``group``; (0, 1) without one."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _unflatten_into(flat: torch.Tensor, tensors: list) -> None:
    # one multi-tensor copy: a copy_ per leaf costs the host a launch each, about 300 of them a train step
    torch._foreach_copy_(tensors, [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in tensors]), tensors)])


@torch.no_grad()
def all_reduce_sum_(tensors: list, group) -> None:
    """Sum ``tensors`` over the group in place, as one flat bucket (one
    collective whatever the count)."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    _unflatten_into(flat, tensors)


@torch.no_grad()
def broadcast_(tensors: list, group) -> None:
    """Every rank's ``tensors`` overwritten with the group's rank 0's, in one
    flat bucket."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.broadcast(flat, src=dist.get_global_rank(group, 0), group=group)
    _unflatten_into(flat, tensors)


def gather_rows(rows: torch.Tensor, group) -> torch.Tensor:
    """Every rank's (n, ...) rows -> (world * n, ...) in rank order on every
    rank. Written as a sum over the group (each rank's block in place, zeros
    elsewhere), which every backend has for CPU and CUDA tensors alike."""
    rank, world = world_of(group)
    out = torch.zeros((world * rows.shape[0], *rows.shape[1:]), dtype=rows.dtype, device=rows.device)
    out[rank * rows.shape[0]:(rank + 1) * rows.shape[0]] = rows
    dist.all_reduce(out, group=group)
    return out


class _GlobalBatchNorm(torch.autograd.Function):
    """y = (x - mean) * rsqrt(var + eps) * scale + bias over NCHW with the
    statistics of every rank's x: the per-channel sum and count, then the
    sum of squared deviations, are summed over the group (two passes, as the
    one-process variance). The backward sums the two gradient sums over the
    group, so each rank's dx is the gradient of the summed loss; the scale
    and bias gradients stay local (the step sums them with the rest)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, group):
        c = x.shape[1]
        stats = torch.cat([x.sum(dim=(0, 2, 3)), x.new_full((1,), x.numel() // c)])
        dist.all_reduce(stats, group=group)
        count = stats[c].clone()
        mean = stats[:c] / count
        xmu = x - mean[:, None, None]
        var = xmu.square().sum(dim=(0, 2, 3))
        dist.all_reduce(var, group=group)
        var = var / count
        invstd = torch.rsqrt(var + eps)
        xhat = xmu * invstd[:, None, None]
        ctx.save_for_backward(xhat, invstd, scale, count)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var, count)
        return xhat * scale[:, None, None] + bias[:, None, None], mean, var, count

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar, _dcount):
        xhat, invstd, scale, count = ctx.saved_tensors
        c = dy.shape[1]
        dbias = dy.sum(dim=(0, 2, 3))
        dscale = (dy * xhat).sum(dim=(0, 2, 3))
        sums = torch.cat([dbias, dscale])
        dist.all_reduce(sums, group=ctx.group)
        sum_dy, sum_dy_xhat = sums[:c, None, None], sums[c:, None, None]
        dx = (scale * invstd)[:, None, None] / count * (count * dy - sum_dy - xhat * sum_dy_xhat)
        return dx, dscale, dbias, None, None


def global_batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float, group):
    """Training BatchNorm over the whole group's batch (NCHW) -> (y, the
    global mean, biased variance and element count per channel)."""
    return _GlobalBatchNorm.apply(x, scale, bias, eps, group)


# --- the model axis ----------------------------------------------------------


@dataclass
class Mesh:
    """This rank's place on a (data, model) grid of ranks and its two groups."""

    data_group: object
    model_group: object
    n_data: int
    n_model: int
    data_rank: int
    model_rank: int


def make_mesh(n_data: int | None = None, n_model: int = 1) -> Mesh:
    """The (data, model) grid over the world's ranks: rank r sits at data
    index r // n_model and model index r % n_model (the JAX package's
    reshape of its device list). Builds every data group, then every model
    group, with ``dist.new_group`` in the same order on every rank (each
    rank must call it), and returns this rank's. ``n_data`` defaults to the
    world size over ``n_model``."""
    if not group_is_up():
        raise RuntimeError("make_mesh needs a process group: call torch.distributed.init_process_group first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a mesh of {n_data} x {n_model} ranks over a world of {world}")
    data_groups = [dist.new_group([d * n_model + m for d in range(n_data)]) for m in range(n_model)]
    model_groups = [dist.new_group([d * n_model + m for m in range(n_model)]) for d in range(n_data)]
    d, m = divmod(rank, n_model)
    return Mesh(data_groups[m], model_groups[d], n_data, n_model, d, m)


def tp_active(group) -> bool:
    """Whether ``group`` splits the model over more than one rank."""
    return group is not None and dist.get_world_size(group) > 1


class _CopyToModel(torch.autograd.Function):
    """Identity forward; all-reduce of the gradient backward (entering a
    parallel region: every rank's part of the region reads the whole input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce forward (the ranks' partial sums); identity backward
    (leaving a parallel region)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """The ranks' (..., n) blocks -> (..., M n) in rank order forward (a sum
    of zero-padded blocks, which every backend has for CPU and CUDA tensors);
    this rank's block of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        rank, size = world_of(group)
        n = x.shape[-1]
        out = x.new_zeros((*x.shape[:-1], size * n))
        out[..., rank * n:(rank + 1) * n] = x
        dist.all_reduce(out, group=group)
        ctx.rank, ctx.n = rank, n
        return out

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n].contiguous(), None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromModel.apply(x, group)


def gather_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return _GatherFromModel.apply(x, group)
