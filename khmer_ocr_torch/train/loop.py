"""The training loop, in the JAX package's order: staged learning rate, a
random subset of the data each epoch, bucketed batches assembled on a
background thread and grouped by shape, losses kept on the device until a
log point, an eye test, per-epoch metrics and checkpoints, and resume.

The device is the caller's choice: ``device=None`` means the CUDA card, and
without one ``train`` raises; ``device="cpu"`` runs the plain PyTorch
versions of the kernels.

The order of the steps is the JAX package's. One ``np.random.default_rng
(seed)`` draws every epoch's sample in turn. ``dispatch_group`` K: the
background thread holds each batch back under its shape key (payload
shape, labels shape) until K batches of that shape have come, stacks them
on the host and dispatches the K steps at once (``make_train_multi_step``,
learning rates ``schedule(step + i)``); at the end of the epoch the partial
groups go singly, shape by shape in the order each shape first came. 1
dispatches every batch as it comes. Log lines and eye tests fire when the
count of dispatched batches reaches their next threshold, the eye test on
the last batch dispatched. Each dispatch ships its batch in one pinned
copy.

On the card each step, or group of K steps, replays a captured CUDA graph
(train/graphs.py), as the JAX package runs a jitted program; the CPU and a
process group of more than one rank run the same steps eagerly.

Randomness on the device (augmentation, dropout) comes from one generator
reseeded by (seed, epoch) at each epoch. A run resumed at an epoch boundary
replays the finished epochs' draws of the sample generator (no image work)
and so continues as the uninterrupted run would; the JAX package's resumed
run starts its sampler again at the seed.

Data-parallel (``process_group``; parallel/mesh.py): every rank draws the
same epoch of global batches, groups them alike and trains on its rows of
each (of each member of a group), with the step of train/step.py under the
group; rank 0's initial params are broadcast, each rank's device draws are
seeded by (seed, epoch) plus its rank, and only rank 0 logs, runs the eye
test and writes metrics and checkpoints.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import queue
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ..config import OCRConfig
from ..infer.predictor import resolve_device
from ..parallel.mesh import broadcast_, data_shard, world_of
from ..profiling import span
from ..tokenizer import Tokenizer
from .checkpoint import load_checkpoint_full, save_checkpoint
from .data import LineDataset
from .schedule import staged_cyclic_lr
from .graphs import TrainGraphs
from .step import (eval_logits, init_train_state, make_train_multi_step, make_train_step, state_from,
                   tree_leaves)

logger = logging.getLogger(__name__)


def _prefetched(gen, depth: int = 2):
    """Run a generator on a background thread behind a bounded queue, so
    that host-side batch assembly overlaps the device's steps. Spans: each
    item's assembly on that thread (``khmer_ocr.train.assemble``), each
    wait for the next item here (``khmer_ocr.train.wait_batch``)."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    err: list[BaseException] = []
    done = object()

    def worker():
        try:
            it = iter(gen)
            while True:
                with span("khmer_ocr.train.assemble"):
                    item = next(it, done)
                if item is done:
                    break
                q.put(item)
        except BaseException as e:  # re-raised on the consumer side
            err.append(e)
        finally:
            q.put(done)

    t = threading.Thread(target=worker, name="khmer-train-prefetch", daemon=True)
    t.start()
    while True:
        with span("khmer_ocr.train.wait_batch"):
            item = q.get()
        if item is done:
            break
        yield item
    t.join()
    if err:
        raise err[0]


def _eye_test(tokenizer: Tokenizer, logits, labels) -> tuple[str, str]:
    """The first sample's target and argmax prediction as text."""
    pred = logits[0].argmax(dim=-1).cpu().numpy()
    true = labels[0, 1:].cpu().numpy()
    skip = {tokenizer.pad_idx, tokenizer.sos_idx, tokenizer.eos_idx}
    to_text = lambda ids: "".join(tokenizer.idx2char.get(int(i), "") for i in ids if int(i) not in skip)
    return to_text(true), to_text(pred)


def _epoch_seed(seed: int, epoch: int) -> int:
    return int(np.random.SeedSequence([seed, epoch]).generate_state(1)[0])


def pack_batch(arrays: dict, pin: bool) -> tuple[torch.Tensor, list]:
    """numpy arrays -> (one uint8 buffer that holds them all, each at an
    offset aligned to 16 bytes, in pinned memory when ``pin``; the layout
    (key, dtype, shape, offset))."""
    layout, size = [], 0
    for k, v in arrays.items():
        dtype = torch.from_numpy(v[:0].reshape(-1)).dtype
        layout.append((k, dtype, v.shape, size))
        size += -(-v.nbytes // 16) * 16
    buf = torch.empty(size, dtype=torch.uint8, pin_memory=pin)
    host = buf.numpy()
    for (_, _, _, offset), v in zip(layout, arrays.values()):
        host[offset:offset + v.nbytes] = np.ascontiguousarray(v).reshape(-1).view(np.uint8)
    return buf, layout


def unpack_batch(buf: torch.Tensor, layout: list) -> dict:
    """The tensors of ``pack_batch``'s layout, as views of ``buf``."""
    out = {}
    for k, dtype, shape, offset in layout:
        n = int(np.prod(shape)) * dtype.itemsize
        out[k] = buf[offset:offset + n].view(dtype).view(shape)
    return out


def train(dataset: LineDataset, config: OCRConfig | None = None, checkpoint_dir="checkpoints", device=None,
          log_every: int = 100, eye_test_every: int = 500, num_epochs: int | None = None, resume_from=None,
          metrics_path=None, process_group=None, dispatch_group: int = 8):
    """Train the configured model on ``dataset``; returns the final
    TrainState. ``resume_from``: a checkpoint directory this loop saved
    (params, statistics, moments and step restored; training continues at
    epoch ``step // steps_per_epoch + 1``, as the JAX package's does).
    ``process_group``: train data-parallel over the group, each rank on
    ``device`` (the batch size, global, must divide among the ranks). ``dispatch_group``: K same-shape
    batches dispatch as one group of K steps (1 turns grouping off), as the
    JAX package's ``train(dispatch_group=)``. Every step and eye test runs
    under ``config.runtime.matmul_precision``."""
    device = resolve_device(device)
    rank, world = world_of(process_group)
    config = config or OCRConfig()
    precision = config.runtime.matmul_precision
    tcfg = config.train
    tokenizer = dataset.tokenizer
    mcfg = dataclasses.replace(config.model, vocab_size=len(tokenizer), pad_idx=tokenizer.pad_idx)

    if tcfg.batch_size % world:
        raise ValueError(f"batch size {tcfg.batch_size} does not divide among {world} ranks")
    if dispatch_group < 1:
        raise ValueError(f"dispatch_group must be at least 1, got {dispatch_group}")
    sample_size = min(tcfg.epoch_sample_size, len(dataset))
    steps_per_epoch = max(sample_size // tcfg.batch_size, 1)
    schedule = staged_cyclic_lr(tcfg, steps_per_epoch)
    state = init_train_state(mcfg, tcfg.seed, device)
    start_epoch = 1
    if resume_from is not None:
        payload, ck_cfg = load_checkpoint_full(resume_from, device)
        if ck_cfg != mcfg:
            raise ValueError(f"checkpoint config {ck_cfg} != model config {mcfg}")
        state = state_from(payload["params"], payload["batch_stats"], payload.get("opt_state"),
                           int(payload.get("step", 0)))
        # the JAX package's start epoch, from the step count; where bucket tails made an epoch longer than
        # steps_per_epoch it skips epochs, as there. The payload's "epoch" is metadata only
        start_epoch = state.step // steps_per_epoch + 1
        logger.info("resumed from %s at step %d (epoch %d)", resume_from, state.step, start_epoch)
    if process_group is not None:
        broadcast_(tree_leaves(state.params) + tree_leaves(state.batch_stats), process_group)
    chunk_geom = (config.preprocess.chunk_width, config.preprocess.chunk_stride)
    aug_prob = tcfg.augment_prob if dataset.device_augment else 0.0
    # a group's collectives cannot be captured: its steps run eagerly; a group of one rank is no group
    group = process_group if world > 1 else None
    graphs = TrainGraphs() if device.type == "cuda" and group is None else None
    step_args = (mcfg, chunk_geom, aug_prob, tcfg.adam_b1, tcfg.adam_b2, group)
    train_step = make_train_step(*step_args, precision=precision, graphs=graphs)
    multi_step = make_train_multi_step(*step_args, precision=precision, graphs=graphs) if dispatch_group > 1 else None
    # labels carry <sos> and <eos>; the teacher-forcing input (len - 1) must fit the decoder's positions
    max_label_len = min(tcfg.max_label_len, mcfg.decode_max_len + 1)
    pin = device.type == "cuda"
    sampler = np.random.default_rng(tcfg.seed)
    for _ in range(1, start_epoch):  # a resumed run takes up the sampler where epochs 1 .. start - 1 leave it
        dataset.epoch_draws(sampler, sample_size)
    generator = torch.Generator(device=device)

    def produce():
        """-> ("group" or "single", packed batch, steps): same-shape batches
        held back until ``dispatch_group`` of them have come, then stacked;
        the partial groups singly at the end of the epoch."""
        groups: dict = {}
        for batch in dataset.epoch_batches(tcfg.batch_size, sampler, sample_size=sample_size,
                                           max_label_len=max_label_len):
            arrays = data_shard(batch.as_dict(), rank, world)
            if multi_step is None:
                yield "single", pack_batch(arrays, pin), 1
                continue
            payload = batch.lines if batch.lines is not None else batch.chunks
            pending = groups.setdefault((payload.shape, batch.labels.shape), [])
            pending.append(arrays)
            if len(pending) == dispatch_group:
                yield "group", pack_batch({k: np.stack([a[k] for a in pending]) for k in arrays}, pin), len(pending)
                pending.clear()
        for pending in groups.values():
            for arrays in pending:
                yield "single", pack_batch(arrays, pin), 1

    ckpt_dir = Path(checkpoint_dir)
    total_epochs = num_epochs or tcfg.num_epochs
    for epoch in range(start_epoch, total_epochs + 1):
        if rank == 0:
            logger.info("epoch %d/%d starting (%d samples, batch %d)", epoch, total_epochs, sample_size,
                        tcfg.batch_size)
        generator.manual_seed(_epoch_seed(tcfg.seed, epoch) + rank)
        epoch_loss, epoch_batches, since_log = 0.0, 0, 0
        next_log, next_eye = log_every, eye_test_every
        pending: list = []
        t0 = ep_t0 = time.perf_counter()
        for kind, (buf, layout), n in _prefetched(produce()):
            batch = unpack_batch(buf.to(device, non_blocking=pin), layout)
            if kind == "group":
                state, metrics = multi_step(state, batch, generator, [schedule(state.step + i) for i in range(n)])
                last = {k: v[-1] for k, v in batch.items()}
            else:
                state, metrics = train_step(state, batch, generator, schedule(state.step))
                last = batch
            pending.append(metrics["loss"].reshape(-1))
            # logs and eye tests by the count of dispatched batches, as the JAX package's after_dispatch
            epoch_batches += n
            since_log += n
            if epoch_batches >= next_log:
                # losses stay on the device between log points: reading one per step would wait for the step
                drained = torch.cat(pending).cpu().numpy()
                pending.clear()
                epoch_loss += float(drained.sum())
                if rank == 0:
                    logger.info("epoch %d batch %d loss %.4f (%.1f lines/s)", epoch, epoch_batches,
                                float(drained[-min(log_every, len(drained)):].mean()),
                                since_log * tcfg.batch_size / (time.perf_counter() - t0))
                next_log += log_every
                since_log, t0 = 0, time.perf_counter()
            if epoch_batches >= next_eye:
                if rank == 0:
                    logits = eval_logits(state.params, state.batch_stats, last, mcfg, chunk_geom, precision=precision)
                    true, pred = _eye_test(tokenizer, logits, last["labels"])
                    logger.info("eye test | TRUE: %s | PRED: %s", true, pred)
                next_eye += eye_test_every
        if pending:
            epoch_loss += float(torch.cat(pending).sum().cpu())
        mean_loss = epoch_loss / max(epoch_batches, 1)
        seconds = time.perf_counter() - ep_t0
        if rank != 0:
            continue
        logger.info("epoch %d done: mean loss %.4f over %d batches", epoch, mean_loss, epoch_batches)
        if metrics_path is not None:
            with open(metrics_path, "a") as f:
                f.write(json.dumps({"epoch": epoch, "mean_loss": mean_loss, "batches": epoch_batches,
                                    "seconds": seconds, "lines_per_sec": epoch_batches * tcfg.batch_size / seconds,
                                    "lr": schedule(state.step - 1), "step": state.step}) + "\n")
        if epoch % tcfg.checkpoint_every_epochs == 0 or epoch == total_epochs:
            path = save_checkpoint(ckpt_dir / f"epoch{epoch:03d}", state.params, state.batch_stats, mcfg,
                                   opt_state=state.opt_state, step=state.step, epoch=epoch)
            logger.info("checkpoint saved: %s", path)
    return state
