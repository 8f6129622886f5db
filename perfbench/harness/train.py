"""A training cell: the recognizer's train step of ``khmer_ocr_torch`` in
``train()``'s order.

``train()`` builds its own ``TrainGraphs`` and runs whole epochs, so the
harness drives its parts in its order instead: the samples through
``LineDataset.epoch_batches`` (the JAX loop's batch order, one sampler
across epochs) on the prefetch thread (``train.loop._prefetched``),
same-shape batches stacked into groups of ``dispatch_group`` and each group
one call of ``make_train_multi_step``, the partial groups flushed singly
through ``make_train_step`` at an epoch's end, one ``TrainGraphs`` for both.

Set-up: the weights seeded on the device; the job's first
``checked_steps`` batches dispatched singly through ``make_train_step``
(Adam's moments read after the first, the params after the last); then,
of the second epoch, the first group or single of each shape, which
captures every graph the window replays (each epoch holds the same number
of batches of each shape, so every epoch meets the same shapes), and the
rest of that epoch assembled and left undispatched. The window runs the
following epochs until ``seconds`` have passed.

The check (``check.check_train``), against the reference
(perfbench/reference/train.py) at float32 with TF32 off:

  * the start: the reference works out the first batches from the samples
    and follows the first steps from the same weights and generator seed;
    the program's losses, first gradient (Adam's first moment after one
    step over 1 - b1) and change of the params after the steps are held to
    it leaf by leaf;
  * the window's path: the window's first group that replays a captured
    graph is taken with the state it starts from (params, moments, Adam's
    count, statistics; the generator seeded anew just before it). The
    reference follows its ``dispatch_group`` steps from that state on the
    same batches, and each step's loss and the params' change over the
    group are held to it.
"""

from __future__ import annotations

import contextlib
import json
import time

import numpy as np

from .context import Run
from .traffic import RealLines, train_samples


def tree_norms(tree, prefix=()) -> dict:
    """{path: float norm} of a tree of tensors."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in tree_norms(sub, prefix + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in tree_norms(sub, prefix + (i,)).items()}
    return {prefix: float(tree.detach().float().norm())}


def tree_sub(a, b):
    if isinstance(a, dict):
        return {k: tree_sub(a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return [tree_sub(x, y) for x, y in zip(a, b)]
    return a.detach() - b


def tree_clone(tree):
    if isinstance(tree, dict):
        return {k: tree_clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_clone(v) for v in tree]
    return tree.detach().clone()


def snapshot(state) -> dict:
    """The train state's tensors, copied on the device, and Adam's count."""
    return {"params": tree_clone(state.params), "mu": tree_clone(state.opt_state["mu"]),
            "nu": tree_clone(state.opt_state["nu"]), "stats": tree_clone(state.batch_stats),
            "count": state.opt_state["count"]}


def run(spec, cell: dict, config: dict, mix: dict, seed: int, seconds: float, traced: bool, device: str,
        t_process: float, control: str | None = None, log=print):
    import torch
    from khmer_ocr_torch.config import TrainConfig
    from khmer_ocr_torch.convert.from_jax import trainable_from_jax
    from khmer_ocr_torch.tokenizer import Tokenizer
    from khmer_ocr_torch.train import graphs as train_graphs
    from khmer_ocr_torch.train.data import LineDataset
    from khmer_ocr_torch.train.graphs import TrainGraphs
    from khmer_ocr_torch.train.loop import _prefetched, pack_batch, unpack_batch
    from khmer_ocr_torch.train.step import make_train_multi_step, make_train_step, state_from

    from . import check as checks
    from . import trace as tracing
    from .serve import model_config
    from ..reference.weights import seeded, tree_map

    tr = cell["train"]
    on_card = device != "cpu"
    real = RealLines(spec.dir / "data")
    texts = json.loads((spec.dir / "data" / "real_lines.json").read_text())["texts"]
    samples = train_samples(mix, real, texts, seed)
    m = config["model"]
    mcfg = model_config(m)
    params, stats = seeded(m, seed, device)
    host = tree_map(lambda t: t.cpu().numpy().copy(), params), tree_map(lambda t: t.cpu().numpy().copy(), stats)
    del params, stats
    # the program gets copies: on the CPU its tensors would share the arrays, which training moves in place
    state = state_from(*trainable_from_jax(tree_map(np.copy, host[0]), tree_map(np.copy, host[1]), mcfg, device=device))
    tok = Tokenizer(spec.dir / "data" / "char2idx.json")
    bs, k, lr, prec = tr["batch_size"], tr["dispatch_group"], tr["lr"], tr["precision"]
    ds = LineDataset([(line, text) for line, text, _ in samples], tok,
                     train_cfg=TrainConfig(batch_size=bs, augment_prob=tr["augment_prob"]), device_augment=True)
    sampler = np.random.default_rng([seed, 5])
    gseed = int(np.random.SeedSequence([seed, 7]).generate_state(1)[0])
    gen = torch.Generator(device=device)
    gen.manual_seed(gseed)
    graphs = TrainGraphs() if on_card else None
    args = (mcfg, (100, 84), tr["augment_prob"], 0.9, 0.999, None)
    single = make_train_step(*args, precision=prec, graphs=graphs)
    multi = make_train_multi_step(*args, precision=prec, graphs=graphs)
    pin = on_card

    def produce(batches):
        """train()'s dispatch order: groups of ``k`` same-shape batches as
        they fill, then the partial groups singly."""
        groups: dict = {}
        for batch in batches:
            arrays = batch.as_dict()
            pending = groups.setdefault((arrays["lines"].shape, arrays["labels"].shape), [])
            pending.append(arrays)
            if len(pending) == k:
                yield "group", pack_batch({n: np.stack([a[n] for a in pending]) for n in arrays}, pin), pending[:]
                pending.clear()
        for pending in groups.values():
            for arrays in pending:
                yield "single", pack_batch(arrays, pin), [arrays]

    shapes: list = []

    def dispatch(kind, packed, arrays):
        nonlocal state
        buf, layout = packed
        batch = unpack_batch(buf.to(device, non_blocking=pin), layout)
        if kind == "group":
            state, metrics = multi(state, batch, gen, [lr] * len(arrays))
        else:
            state, metrics = single(state, batch, gen, lr)
        for a in arrays:
            shapes.extend(zip(a["chunk_counts"].tolist(), (a["labels"][:, :-1] != tok.pad_idx).sum(1).tolist()))
        return metrics

    epoch = ds.epoch_batches(bs, sampler, max_label_len=tr["max_label_len"])
    first, losses = [], []
    init = state_from(*trainable_from_jax(tree_map(np.copy, host[0]), tree_map(np.copy, host[1]), mcfg,
                                          device=device)).params
    for step in range(tr["checked_steps"]):
        arrays = next(epoch).as_dict()
        first.append(arrays)
        metrics = dispatch("single", pack_batch(arrays, pin), [arrays])
        losses.append(float(metrics["loss"]))
        if step == 0:
            grad_norms = {p: n / (1 - 0.9) for p, n in tree_norms(state.opt_state["mu"]).items()}
    update_norms = tree_norms(tree_sub(state.params, init))
    del init
    epoch.close()  # the rest of the first epoch is not dispatched
    seen = set()
    for kind, packed, arrays in produce(ds.epoch_batches(bs, sampler, max_label_len=tr["max_label_len"])):
        key = (kind, arrays[0]["lines"].shape, arrays[0]["labels"].shape)
        if key not in seen:
            seen.add(key)
            dispatch(kind, packed, arrays)
    if on_card:
        torch.cuda.synchronize()
    captured = len(graphs) if graphs is not None else 0
    setup_s = time.time() - t_process
    log(f"set-up {setup_s:.3f} s: {captured} train graphs captured for {len(seen)} shapes of the second epoch")

    window = float(cell.get("trace_seconds", seconds)) if traced else seconds
    shapes.clear()
    steps, attempted = 0, 0
    group = None  # the window's first replayed group, with the state it started from
    group_seed = int(np.random.SeedSequence([gseed, 1]).generate_state(1)[0])
    it = iter(())
    with tracing.traced() if traced else contextlib.nullcontext() as h:
        t0 = time.perf_counter()
        e = 2
        while time.perf_counter() - t0 < window:
            e += 1  # each epoch's generator seeded anew, as train() seeds it
            gen.manual_seed(int(np.random.SeedSequence([gseed, e]).generate_state(1)[0]))
            it = _prefetched(produce(ds.epoch_batches(bs, sampler, max_label_len=tr["max_label_len"])))
            for kind, packed, arrays in it:
                start = None
                if group is None and kind == "group":
                    gen.manual_seed(group_seed)
                    start, replays = snapshot(state), train_graphs.replays
                metrics = dispatch(kind, packed, arrays)
                if start is not None and (not on_card or train_graphs.replays > replays):
                    group = {**start, "after": tree_clone(state.params), "losses": metrics["loss"], "arrays": arrays,
                             "seed": group_seed, "replayed": train_graphs.replays > replays}
                steps += len(arrays)
                attempted += 1
                if time.perf_counter() - t0 >= window:
                    break
        if on_card:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
    for _ in it:  # the prefetch thread finishes its epoch, undispatched, so that it ends
        pass
    if graphs is not None and len(graphs) != captured:
        log(f"WARNING: the window captured {len(graphs) - captured} train graphs")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    result = Run(cell, config, setup_s, h.trace.window_s if traced else t1 - t0, samples=steps * bs,
                 train_shapes=list(shapes), trace=h.trace if traced else None,
                 counters={"steps": steps, "graphs": captured})
    if traced:
        log(f"trace read in {h.read_s:.1f} s: {len(h.trace.device)} device intervals")
    del state, graphs, single, multi
    if on_card:
        torch.cuda.empty_cache()
    if group is not None:
        group["losses"] = group["losses"].tolist()
    program = {"losses": losses, "grad_norms": grad_norms, "update_norms": update_norms, "batches": first,
               "group": group}
    numbers = checks.check_train(spec, cell, config, samples, host, program, seed, gseed, device, control, log)
    return result, numbers, attempted, 0, peak
