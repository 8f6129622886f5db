"""The port's ``train()`` against the JAX package's ``train()``, on the CPU.

Two faults made the port train other steps than the JAX package from the
same data and seed, and each case of the first group below fails on a tree
that has them:

  * T1, the order of the steps. JAX's ``train(dispatch_group=8)`` holds each
    batch back under its shape key until ``dispatch_group`` batches of that
    shape have come, dispatches them as one group, and at the epoch's end
    sends the partial groups singly, shape by shape. The port trained in
    arrival order and had no ``dispatch_group``. Smallest input: 6 lines in
    two widths that alternate, batch 2, one epoch: JAX runs every batch of
    the first shape, then every batch of the second; the port alternated.
  * T2, the sample of each epoch. JAX draws every epoch from one
    ``np.random.default_rng(seed)`` made once a run; the port seeded a new
    generator each epoch from (seed, epoch). Smallest input: 8 samples, seed
    0, epoch 1: JAX shuffles them to [2, 4, 3, 6, 5, 0, 1, 7], the port did
    to [3, 2, 7, 0, 4, 1, 6, 5].

The JAX package's ``train()`` runs in the pytest process, its step makers
(the names ``khmer_ocr_tpu.train.loop`` imports) wrapped to record each
dispatched step; the package itself is untouched. The port runs in torch-only
subprocesses (this file run as a script), its makers wrapped alike. Both
start from one checkpoint of the same numpy-seeded params (step 0) at
tests/test_torch_train.py's RESUME widths (vgg, no BiLSTM, which the JAX
package compiles fastest) with dropout 0 and augmentation 0, on 16 lines of
one chunk and 2 of two, each with its own label, batch 2, two epochs, the
learning rate cycling within each epoch, at ``dispatch_group`` 1, 2 and 8:

  * the sequence of (payload shape, labels shape, learning rate, labels)
    dispatched step by step is JAX's exactly;
  * each epoch's mean loss is JAX's within 1e-4 relative;
  * the final params are JAX's within 2 x (the sum of the learning rates)
    + 1e-6, test_one_step_batch_stats_and_params_match_jax's bound of
    tests/test_torch_train.py summed over the steps: Adam moves a param by
    about lr a step whatever its gradient's size, so a gradient near 0
    (float32 max-pool near-ties route whole terms either way; three steps'
    losses and norms agree within 1e-4, test_three_steps_match_jax) may take
    the other sign in the other package at each step.

Then the port alone: the sample order of two epochs (the shuffle and the
subsample) is one ``default_rng(seed)``'s; a resumed run equals the run that
was not interrupted; on one shape, ``dispatch_group`` 1 and 8 equal the old
loop of single steps bit for bit (augmentation and dropout on); the
partial groups go singly at the epoch's end in the order their shapes first
came; logs and eye tests fire by dispatched count, the eye test on a
group's last batch; ``adam_update`` with a tensor learning rate and bias
corrections equals the update of a Python float lr bit for bit; a K-step
multi step equals K single steps bit for bit; the K-step body reads nothing
on the host (``Tensor.item``, ``__bool__``, ... raise while it runs, with
augmentation and dropout on) and so can be captured; ``TrainGraphs``' keys
and its refusal of CPU tensors (its eviction: tests/test_torch_cuda_graphs.py);
two gloo ranks each train on their rows of every stacked group.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
# tests/test_torch_train.py's RESUME widths, dropout 0
MODEL = dict(vocab_size=124, emb_dim=64, num_heads=4, enc_layers=1, dec_layers=1, enc_ffn_dim=128,
             max_global_len=256, decode_max_len=16, backbone="vgg", use_bilstm=False, dropout=0.0)
GROUPS = (1, 2, 8)
EPOCHS = 2
SEED = 3
KHMER_DIGITS = "០១២៣៤៥៦៧៨៩"


def khmer_number(i: int) -> str:
    return "".join(KHMER_DIGITS[int(c)] for c in str(i))


def samples(counts=(16, 2), seed: int = 0) -> list:
    """Lines of random pixels, ``counts[j]`` of them j + 1 chunks wide
    (widths 60, 150, 230), each labelled by its own number."""
    rs = np.random.RandomState(seed)
    widths = [w for j, n in enumerate(counts) for w in [(60, 150, 230)[j]] * n]
    return [(rs.randint(0, 256, (48, w)).astype(np.uint8), "ក" + khmer_number(i)) for i, w in enumerate(widths)]


def train_cfg(**kw) -> dict:
    """The recipe's fields: batch 2, every sample each epoch, the learning
    rate cycling from the first epoch on, no augmentation."""
    return {**dict(batch_size=2, epoch_sample_size=10_000, checkpoint_every_epochs=100, augment_prob=0.0,
                   stage2_start_epoch=1, seed=SEED), **kw}


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, prefix + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, prefix + (i,)).items()}
    return {"/".join(map(str, prefix)): np.asarray(tree)}


def recording(module, seen: list, as_numpy):
    """Wrap ``module``'s make_train_step and make_train_multi_step so that
    every dispatched step appends (payload shape, labels shape, lr as
    float32, labels) to ``seen``; returns a function that restores them."""
    real_single, real_multi = module.make_train_step, module.make_train_multi_step

    def entry(batch, lr):
        payload = batch["lines"] if "lines" in batch else batch["chunks"]
        return [list(payload.shape), list(batch["labels"].shape), float(np.float32(lr)),
                as_numpy(batch["labels"]).tolist()]

    def single(*a, **kw):
        step = real_single(*a, **kw)

        def spy(state, batch, rng, lr):
            seen.append(entry(batch, lr) + [1])
            return step(state, batch, rng, lr)

        return spy

    def multi(*a, **kw):
        step = real_multi(*a, **kw)

        def spy(state, stacked, rng, lrs):
            seen.extend(entry({k: v[i] for k, v in stacked.items()}, lrs[i]) + [len(lrs)] for i in range(len(lrs)))
            return step(state, stacked, rng, lrs)

        return spy

    module.make_train_step, module.make_train_multi_step = single, multi

    def restore():
        module.make_train_step, module.make_train_multi_step = real_single, real_multi

    return restore


def grouped(arrival: list, k: int) -> list:
    """The JAX package's dispatch order of one epoch's ``arrival`` (entries
    whose first two fields are the shape key) at ``dispatch_group`` k:
    each full group when its k-th batch comes, then the partial groups
    singly in the order their shapes first came."""
    if k == 1:
        return list(arrival)
    out, groups = [], {}
    for e in arrival:
        pending = groups.setdefault((tuple(e[0]), tuple(e[1])), [])
        pending.append(e)
        if len(pending) == k:
            out += pending
            pending.clear()
    return out + [e for pending in groups.values() for e in pending]


if __name__ != "__main__":
    import jax

    def _jax_runs(tmp: Path) -> dict:
        """The JAX package's train() at each dispatch group from the step-0
        checkpoint of the seeded params: the steps, metrics, final params."""
        import khmer_ocr_tpu.train.loop as jloop
        from khmer_ocr_tpu.config import ModelConfig, OCRConfig, TrainConfig
        from khmer_ocr_tpu.train.checkpoint import save_checkpoint
        from khmer_ocr_tpu.train.data import LineDataset
        from khmer_ocr_torch.config import ModelConfig as PortModelConfig
        from khmer_ocr_torch.convert.from_jax import seeded_params

        cfg = ModelConfig(**MODEL)
        save_checkpoint(tmp / "jax_ck0", *seeded_params(PortModelConfig(**MODEL), SEED), cfg, step=0)
        out = {}
        for k in GROUPS:
            seen: list = []
            restore = recording(jloop, seen, np.asarray)
            try:
                ocfg = OCRConfig(model=cfg, train=dataclasses.replace(TrainConfig(), **train_cfg()))
                ds = LineDataset(samples(), train_cfg=ocfg.train, device_augment=True)
                state = jloop.train(ds, ocfg, tmp / f"jax_run{k}", num_epochs=EPOCHS, resume_from=tmp / "jax_ck0",
                                    metrics_path=tmp / f"jax_metrics{k}.jsonl", dispatch_group=k)
            finally:
                restore()
            out[k] = {"seen": seen, "params": _flat(jax.tree.map(np.asarray, state.params)),
                      "epochs": [json.loads(l) for l in (tmp / f"jax_metrics{k}.jsonl").read_text().splitlines()]}
        return out

    @pytest.fixture(scope="module")
    def runs(tmp_path_factory):
        """The port's subprocesses (the main one and two gloo ranks) run
        while this process runs the JAX package's train()."""
        tmp = tmp_path_factory.mktemp("torch_train_loop")
        env = {**os.environ, "OMP_NUM_THREADS": "1"}
        cmds = [[sys.executable, __file__, "port", str(tmp)]] + [
            [sys.executable, __file__, "rank", str(tmp), str(r)] for r in range(2)]
        procs = [subprocess.Popen(c, cwd=REPO, env=env) for c in cmds]
        try:
            ref = _jax_runs(tmp)
            assert [p.wait(timeout=600) for p in procs] == [0] * len(procs), "a port subprocess failed"
        finally:
            for p in procs:
                p.kill()
        meta = json.loads((tmp / "port.json").read_text())
        with np.load(tmp / "port.npz") as z:
            params = {k: z[k] for k in z.files}
        ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(2)]
        return {"jax": ref, "port": meta, "params": params, "ranks": ranks}

    @pytest.mark.parametrize("k", GROUPS)
    def test_dispatch_sequence_equals_jax(runs, k):
        """Step by step: payload shape, labels shape, learning rate, labels
        (which samples), and the size of the dispatch each step went in."""
        want, got = runs["jax"][k]["seen"], runs["port"]["runs"][str(k)]["seen"]
        assert len(want) == len(got) == 18
        assert got == want
        if k > 1:  # the two shapes interleave on arrival, so grouping moved steps
            assert [e[4] for e in got].count(k) >= k and got != runs["port"]["runs"]["1"]["seen"]

    @pytest.mark.parametrize("k", GROUPS)
    def test_epoch_losses_equal_jax(runs, k):
        want, got = runs["jax"][k]["epochs"], runs["port"]["runs"][str(k)]["epochs"]
        assert [e["batches"] for e in got] == [e["batches"] for e in want] == [9, 9]
        assert [e["step"] for e in got] == [e["step"] for e in want]
        np.testing.assert_allclose([e["mean_loss"] for e in got], [e["mean_loss"] for e in want], rtol=1e-4)

    @pytest.mark.parametrize("k", GROUPS)
    def test_final_params_equal_jax(runs, k):
        """Within 2 x the sum of the run's learning rates + 1e-6 (see the
        module's docstring)."""
        want = runs["jax"][k]["params"]
        got = {n[len(f"{k}/"):]: v for n, v in runs["params"].items() if n.startswith(f"{k}/")}
        assert sorted(got) == sorted(want)
        bound = 2 * sum(e[2] for e in runs["jax"][k]["seen"]) + 1e-6
        worst = max(float(np.abs(got[n] - want[n]).max()) for n in want)
        assert worst <= bound, (worst, bound)

    def test_epoch_sample_order_is_one_default_rng(runs):
        """Both epochs of a run drawn in turn from one default_rng(seed): all
        samples shuffled, and a subset of 8 of 18 (``choice``)."""
        for name in ("shuffle", "subset"):
            m = runs["port"]["order"][name]
            assert m["got"] == m["want"] and len(m["got"]) == EPOCHS

    def test_resume_equals_uninterrupted(runs):
        m = runs["port"]["resume"]
        assert m["steps"] == [6, 12, 12] and m["params_equal"] and m["seen_equal"]

    @pytest.mark.parametrize("k", (1, 8))
    def test_one_shape_equals_the_loop_of_single_steps(runs, k):
        """On one shape every group is in arrival order: the losses and
        params of the old loop (a step a batch, the generator seeded by
        (seed, epoch)) bit for bit, with augmentation 0.8 and dropout 0.1."""
        m = runs["port"]["one_shape"][str(k)]
        assert m["losses_equal"] and m["params_equal"] and m["steps"] == 16
        assert m["group_sizes"] == ([1] * 16 if k == 1 else [8] * 16)

    def test_partial_groups_flush_singly_in_first_seen_order(runs):
        """Three shapes at dispatch_group 4: the full groups when they fill,
        then each shape's partial group singly, in first-seen order (the
        batches by their shapes and labels; each step's learning rate
        follows its place)."""
        m = runs["port"]["flush"]
        for arrival, seen in zip(m["arrival"], m["seen"]):
            key = lambda e: (e[0], e[1], e[3])
            assert [key(e) for e in seen] == [key(e) for e in grouped(arrival, 4)]
            n_full = len(arrival) - sum(e[4] == 1 for e in seen)
            assert [e[4] for e in seen] == [4] * n_full + [1] * (len(arrival) - n_full)
            assert 0 < n_full < len(arrival)
            first_seen = list(dict.fromkeys(tuple(e[0]) for e in arrival))
            tail_shapes = list(dict.fromkeys(tuple(e[0]) for e in seen[n_full:]))
            assert tail_shapes == [s for s in first_seen if s in tail_shapes] and len(tail_shapes) >= 2

    def test_logs_and_eye_tests_by_dispatched_count(runs):
        """log_every 3, eye_test_every 5, groups of 4 on one shape of 10
        batches: the thresholds as the JAX package's after_dispatch moves
        them, the eye test on the group's last batch."""
        m = runs["port"]["logs"]
        assert m["group_sizes"] == [4] * 8 + [1, 1]  # an epoch: two groups of 4, then the partial group singly
        assert m["log_batches"] == [4, 8, 9] * EPOCHS  # thresholds 3, 6, 9 (12 not reached)
        assert [n for n, _ in m["eye"]] == [8, 10, 18, 20]  # thresholds 5, 10, counted over the run's dispatches
        assert all(labels == m["seen_labels"][n - 1] for n, labels in m["eye"])

    def test_adam_update_with_tensors_equals_float_lr_bit_for_bit(runs):
        assert runs["port"]["adam_bitwise"] is True

    def test_multi_step_equals_k_single_steps(runs):
        m = runs["port"]["multi"]
        assert m["losses_equal"] and m["norms_equal"] and m["params_equal"] and m["stats_equal"]
        assert m["steps"] == [3, 3]

    def test_step_body_reads_nothing_on_the_host(runs):
        """Tensor.item, __bool__, __int__, __index__, tolist, numpy and cpu
        raise while the K-step body runs (augmentation 0.8, dropout 0.1); a
        probe call shows the patch was live."""
        m = runs["port"]["capturable"]
        assert m["probe_raised"] and m["body_ran"] and m["finite"], m

    def test_train_graphs_keys(runs):
        """A key per shape, per K and per matmul precision, the same for
        another batch of the shape; CPU tensors raise rather than run
        eagerly."""
        m = runs["port"]["graphs"]
        assert m["distinct_keys"] == 4 and m["same_key"]
        assert m["cpu_raises"].startswith("ValueError")

    def test_two_ranks_train_their_rows_of_each_group(runs):
        """dispatch_group 2 over a gloo group of two: each rank's stacked
        batch holds its half of every member's rows, in rank order; the
        ranks' params stay bit-identical, and the epoch's mean loss is one
        process's within 1e-5 relative."""
        ref = runs["port"]["group_reference"]
        r0, r1 = runs["ranks"]
        assert r0["sizes"] == r1["sizes"] == ref["sizes"] and 2 in ref["sizes"]
        for a, b, full in zip(r0["labels"], r1["labels"], ref["labels"]):
            assert a + b == full and len(a) == len(b) == len(full) // 2
        assert r0["params_digest"] == r1["params_digest"]
        assert abs(r0["mean_loss"] - ref["mean_loss"]) <= 1e-5 * abs(ref["mean_loss"])


# ---------------------------------------------------------------------------
# the port's side (torch-only subprocesses)
# ---------------------------------------------------------------------------


def _setup():
    sys.path.insert(0, str(REPO))
    import torch

    torch.set_num_threads(2)
    return torch


def _ocfg(model=None, **kw):
    from khmer_ocr_torch.config import ModelConfig, OCRConfig, TrainConfig

    return OCRConfig(model=ModelConfig(**(model or MODEL)), train=TrainConfig(**train_cfg(**kw)))


def _port_main(tmp: Path) -> None:
    torch = _setup()
    import logging

    import khmer_ocr_torch.train.loop as loop
    from khmer_ocr_torch.convert.from_jax import params_to_jax, seeded_params, trainable_from_jax
    from khmer_ocr_torch.precision import matmul_precision
    from khmer_ocr_torch.train import graphs as tgraphs
    from khmer_ocr_torch.train import step as step_mod
    from khmer_ocr_torch.train.checkpoint import save_checkpoint
    from khmer_ocr_torch.train.data import LineDataset
    from khmer_ocr_torch.train.schedule import staged_cyclic_lr
    from khmer_ocr_torch.train.step import (batch_to_device, init_train_state, make_train_multi_step,
                                            make_train_step, step_body, step_scalars, tree_leaves)

    t0 = time.perf_counter()
    lap = lambda what: print(f"[port] {what}: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    as_np = lambda t: t.numpy()
    ocfg = _ocfg()
    cfg = ocfg.model
    save_checkpoint(tmp / "port_ck0", *trainable_from_jax(*seeded_params(cfg, SEED), cfg), cfg, step=0, epoch=0)
    meta: dict = {"runs": {}}
    params: dict = {}

    def run(k, ds=None, tag="run", cfg_=None, seen=None, **kw):
        seen = [] if seen is None else seen
        restore = recording(loop, seen, as_np)
        try:
            state = loop.train(ds or LineDataset(samples(), train_cfg=(cfg_ or ocfg).train, device_augment=True),
                               cfg_ or ocfg, tmp / f"{tag}{k}", device="cpu", dispatch_group=k,
                               metrics_path=tmp / f"{tag}{k}.jsonl", **kw)
        finally:
            restore()
        epochs = [json.loads(l) for l in (tmp / f"{tag}{k}.jsonl").read_text().splitlines()]
        return state, seen, epochs

    # against the JAX package: from the step-0 checkpoint, at each dispatch group
    for k in GROUPS:
        state, seen, epochs = run(k, num_epochs=EPOCHS, resume_from=tmp / "port_ck0")
        meta["runs"][str(k)] = {"seen": seen, "epochs": epochs}
        p, _ = params_to_jax(state.params, state.batch_stats, cfg)
        params.update({f"{k}/{n}": v for n, v in _flat(p).items()})

    lap("against JAX")
    # the sample order of two epochs: one default_rng(seed); the subset of 8 of 18 by a run of its own
    meta["order"] = {}
    for name, size in (("shuffle", 10_000), ("subset", 8)):
        c = _ocfg(epoch_sample_size=size)
        ds = LineDataset(samples(), train_cfg=c.train, device_augment=True)
        if name == "shuffle":
            seen, epochs = meta["runs"]["1"]["seen"], meta["runs"]["1"]["epochs"]
        else:
            _, seen, epochs = run(1, ds, f"order_{name}", c, num_epochs=EPOCHS)
        rng, want, got = np.random.default_rng(SEED), [], []
        for e in epochs:
            want.append([b.labels.tolist() for b in ds.epoch_batches(2, rng, sample_size=min(size, len(ds)),
                                                                    max_label_len=cfg.decode_max_len + 1)])
            got.append([entry[3] for entry in seen[e["step"] - e["batches"]:e["step"]]])
        meta["order"][name] = {"want": want, "got": got}

    lap("order")
    # a resumed run against the uninterrupted one, at dispatch group 2 on two shapes
    c = _ocfg(checkpoint_every_epochs=1)
    two = lambda: LineDataset(samples((8, 4), seed=7), train_cfg=c.train, device_augment=True)
    s1, seen1, _ = run(2, two(), "resume_a", c, num_epochs=1)
    s2, seen2, _ = run(2, two(), "resume_b", c, num_epochs=2, resume_from=tmp / "resume_a2" / "epoch001")
    s3, seen3, _ = run(2, two(), "resume_c", c, num_epochs=2)
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    meta["resume"] = {"steps": [s1.step, s2.step, s3.step], "params_equal": same(s2.params, s3.params),
                      "seen_equal": seen1 + seen2 == seen3 and 2 in [e[4] for e in seen3]}

    lap("resume")
    # one shape: dispatch groups 1 and 8 against the old loop of single steps
    c = _ocfg(augment_prob=0.8)
    ocfg_drop = dataclasses.replace(c, model=dataclasses.replace(c.model, dropout=0.1))
    one = samples((16,), seed=1)
    meta["one_shape"] = {}
    ref_state = init_train_state(ocfg_drop.model, SEED)
    step = make_train_step(ocfg_drop.model, (100, 84), 0.8)
    schedule, sampler = staged_cyclic_lr(c.train, 8), np.random.default_rng(SEED)
    ds = LineDataset(one, train_cfg=c.train, device_augment=True)
    ref_losses = []
    for epoch in (1, 2):
        gen = torch.Generator().manual_seed(loop._epoch_seed(SEED, epoch))
        for b in ds.epoch_batches(2, sampler, sample_size=16, max_label_len=17):
            ref_state, m = step(ref_state, batch_to_device(b.as_dict(), "cpu"), gen, schedule(ref_state.step))
            ref_losses.append(m["loss"].item())
    for k in (1, 8):
        ds = LineDataset(one, train_cfg=c.train, device_augment=True)
        losses = []
        real = step_mod.loss_fn

        def spy(*a, **kw):
            out = real(*a, **kw)
            losses.append(out[0].item())
            return out

        step_mod.loss_fn = spy
        try:
            state, seen, _ = run(k, ds, "one_shape", ocfg_drop, num_epochs=2)
        finally:
            step_mod.loss_fn = real
        meta["one_shape"][str(k)] = {"losses_equal": losses == ref_losses, "params_equal": same(state.params,
                                                                                                ref_state.params),
                                     "steps": state.step, "group_sizes": [e[4] for e in seen]}

    lap("one shape")
    # the flush: three shapes at dispatch group 4; the arrival order from a run at 1 (the same sampler)
    three = samples((8, 4, 2), seed=2)
    _, arrival, _ = run(1, LineDataset(three, train_cfg=ocfg.train, device_augment=True), "arrival", num_epochs=2)
    _, seen, _ = run(4, LineDataset(three, train_cfg=ocfg.train, device_augment=True), "flush", num_epochs=2)
    half = len(arrival) // 2
    meta["flush"] = {"arrival": [arrival[:half], arrival[half:]], "seen": [seen[:half], seen[half:]]}

    lap("flush")
    # logs and eye tests by dispatched count: groups of 4 on one shape of 10 batches
    logged: list = []
    handler = logging.Handler()
    handler.emit = lambda r: logged.append(r.getMessage())
    logger = logging.getLogger("khmer_ocr_torch.train.loop")
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    seen, eye = [], []
    real_eval = loop.eval_logits

    def eval_spy(params_, stats, batch, *a, **kw):
        eye.append((len(seen), batch["labels"].tolist()))  # steps dispatched so far in the run
        return real_eval(params_, stats, batch, *a, **kw)

    loop.eval_logits = eval_spy
    try:
        run(4, LineDataset(samples((20,), seed=4), train_cfg=ocfg.train, device_augment=True), "logs",
            num_epochs=2, log_every=3, eye_test_every=5, seen=seen)
    finally:
        loop.eval_logits = real_eval
        logger.removeHandler(handler)
    meta["logs"] = {"log_batches": [int(msg.split(" batch ")[1].split()[0]) for msg in logged
                                    if " batch " in msg and " loss " in msg],
                    "eye": eye, "seen_labels": [e[3] for e in seen], "group_sizes": [e[4] for e in seen[:10]]}

    lap("logs")
    # adam_update with tensors against the Python float version, bit for bit
    def adam_float(params_, grads, st, lr, b1=0.9, b2=0.999):
        st["count"] += 1
        c_ = st["count"]
        torch._foreach_mul_(st["mu"], b1)
        torch._foreach_add_(st["mu"], grads, alpha=1.0 - b1)
        torch._foreach_mul_(st["nu"], b2)
        torch._foreach_addcmul_(st["nu"], grads, grads, value=1.0 - b2)
        mu_hat = torch._foreach_div(st["mu"], 1.0 - b1 ** c_)
        denom = torch._foreach_sqrt(torch._foreach_div(st["nu"], 1.0 - b2 ** c_))
        torch._foreach_add_(denom, step_mod.ADAM_EPS)
        torch._foreach_addcdiv_(params_, mu_hat, denom, value=-lr)

    gen = torch.Generator().manual_seed(0)
    shapes = [(7,), (33, 65), (5, 3, 3, 17), (1000,)]
    pa = [torch.randn(s, generator=gen) for s in shapes]
    pb = [t.clone() for t in pa]
    sa = {"mu": [torch.zeros(s) for s in shapes], "nu": [torch.zeros(s) for s in shapes], "count": 0}
    sb = {"mu": [torch.zeros(s) for s in shapes], "nu": [torch.zeros(s) for s in shapes], "count": 0}
    for _ in range(40):
        g = [torch.randn(s, generator=gen) * 10.0 ** float(torch.randint(-7, 2, (), generator=gen)) for s in shapes]
        lr = float(torch.rand((), generator=gen)) * 1e-3
        adam_float(pa, g, sa, lr)
        sc = step_scalars(sb, [lr], 0.9, 0.999, "cpu")[0]
        step_mod.adam_update(pb, g, sb, sc[0], sc[1:])
    meta["adam_bitwise"] = (all(torch.equal(a, b) for a, b in zip(pa, pb)) and sa["count"] == sb["count"]
                            and all(torch.equal(a, b) for a, b in zip(sa["nu"], sb["nu"])))

    # a multi step of 3 against 3 single steps, augmentation and dropout on
    dcfg = dataclasses.replace(cfg, dropout=0.1)
    ds = LineDataset(samples((6,), seed=5), train_cfg=ocfg.train, device_augment=True)
    batches = [batch_to_device(b.as_dict(), "cpu")
               for b in ds.epoch_batches(2, np.random.default_rng(0), max_label_len=cfg.decode_max_len + 1)]
    lrs = [1e-3, 5e-4, 2e-4]
    sa = init_train_state(dcfg, 1)
    single = make_train_step(dcfg, (100, 84), 0.8)
    ga, la, na = torch.Generator().manual_seed(7), [], []
    for b, lr in zip(batches, lrs):
        sa, m = single(sa, b, ga, lr)
        la.append(m["loss"])
        na.append(m["grad_norm"])
    sb = init_train_state(dcfg, 1)
    stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    sb, mb = make_train_multi_step(dcfg, (100, 84), 0.8)(sb, stacked, torch.Generator().manual_seed(7), lrs)
    meta["multi"] = {"losses_equal": torch.equal(torch.stack(la), mb["loss"]),
                     "norms_equal": torch.equal(torch.stack(na), mb["grad_norm"]),
                     "params_equal": same(sa.params, sb.params), "stats_equal": same(sa.batch_stats, sb.batch_stats),
                     "steps": [sa.step, sb.step]}

    # the K-step body with every host read raising
    body = step_body(dcfg, (100, 84), 0.8)
    st = init_train_state(dcfg, 2)
    scalars = step_scalars(st.opt_state, lrs, 0.9, 0.999, "cpu")
    names = ("item", "__bool__", "__int__", "__index__", "tolist", "numpy", "cpu")
    saved = {n: getattr(torch.Tensor, n) for n in names}

    def refuse(self, *a, **kw):
        raise RuntimeError("read on the host")

    probe_raised = body_ran = False
    for n in names:
        setattr(torch.Tensor, n, refuse)
    try:
        try:
            torch.ones(1).item()
        except RuntimeError:
            probe_raised = True
        loss, norm = body(st, stacked, torch.Generator().manual_seed(3), scalars)
        body_ran = True
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)
    meta["capturable"] = {"probe_raised": probe_raised, "body_ran": body_ran,
                          "finite": bool(torch.isfinite(loss).all() and torch.isfinite(norm).all())}

    # TrainGraphs: the keys, CPU tensors refused
    one_batch = {k: v[:1] for k, v in stacked.items()}
    keys = {tgraphs.graph_key(("step",), stacked, 3), tgraphs.graph_key(("step",), one_batch, 1),
            tgraphs.graph_key(("step",), one_batch, 3)}
    with matmul_precision("default"):
        keys.add(tgraphs.graph_key(("step",), one_batch, 1))
    try:
        tgraphs.TrainGraphs().step(("step",), body, st, stacked, torch.Generator(), scalars)
        cpu_raises = "ran"
    except Exception as e:  # asserted on by the test
        cpu_raises = f"{type(e).__name__}: {e}"
    meta["graphs"] = {"distinct_keys": len(keys),
                      "same_key": tgraphs.graph_key(("step",), stacked, 3) == tgraphs.graph_key(
                          ("step",), {k: v.clone() for k, v in stacked.items()}, 3),
                      "cpu_raises": cpu_raises}

    lap("units")
    # the one-process reference of the two gloo ranks
    meta["group_reference"] = _group_run(None, tmp)

    np.savez(tmp / "port.npz", **params)
    (tmp / "port.json").write_text(json.dumps(meta))


def _group_run(group, tmp: Path) -> dict:
    """train() at dispatch group 2 on 8 one-chunk lines at batch 4, over
    ``group``: each dispatched stacked batch's labels and the group sizes."""
    import hashlib

    import khmer_ocr_torch.train.loop as loop
    from khmer_ocr_torch.parallel.mesh import world_of
    from khmer_ocr_torch.train.data import LineDataset
    from khmer_ocr_torch.train.step import tree_leaves

    rank, world = world_of(group)
    c = _ocfg(batch_size=4)
    seen: list = []
    restore = recording(loop, seen, lambda t: t.numpy())
    try:
        ds = LineDataset(samples((16,), seed=6), train_cfg=c.train, device_augment=True)
        run_dir = tmp / f"group{world}_{rank}"
        state = loop.train(ds, c, run_dir, device="cpu", num_epochs=1, dispatch_group=2, process_group=group,
                           metrics_path=run_dir.with_suffix(".jsonl"))
    finally:
        restore()
    metrics = run_dir.with_suffix(".jsonl")
    digest = hashlib.sha256(b"".join(t.detach().numpy().tobytes() for t in tree_leaves(state.params))).hexdigest()
    return {"labels": [e[3] for e in seen], "sizes": [e[4] for e in seen], "params_digest": digest,
            "mean_loss": json.loads(metrics.read_text())["mean_loss"] if metrics.exists() else None}


def _rank_main(tmp: Path, rank: int) -> None:
    _setup()
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp / "store"), 2), rank=rank, world_size=2)
    out = _group_run(dist.group.WORLD, tmp)
    if rank != 0:  # only rank 0 writes the metrics; the test compares rank 0's loss
        out["mean_loss"] = None
    dist.barrier()
    dist.destroy_process_group()
    (tmp / f"rank{rank}.json").write_text(json.dumps(out))


if __name__ == "__main__":
    if sys.argv[1] == "port":
        _port_main(Path(sys.argv[2]))
    else:
        _rank_main(Path(sys.argv[2]), int(sys.argv[3]))
