"""Training in the PyTorch port against the JAX package, on the CPU.

At toy widths with the se_vgg backbone and the BiLSTM, dropout 0 and no
augmentation, the same numpy-seeded params and uint8 line batches (one line
with a padding chunk) go to both packages:

  * one ``train_step`` against JAX's ``make_train_step``: the loss within
    1e-5 relative, the new BatchNorm statistics within 1e-5, the updated
    params within 2 lr + 1e-6 (Adam's first update is g / (|g| + eps), about
    +-1 for any gradient far above eps, so a gradient near 0 may take the
    other sign in the other package);
  * every gradient leaf within 1e-4 x max(1, |ref|), with both packages in
    float64 on the "chunks" layout. In float32 the backbone's leaves differ
    by up to about 1e-2 relative between any two implementations, the
    port's own float32 and float64 runs included: of the half million
    max-pool windows some hold two values within float32 rounding, and the
    window's gradient goes to whichever is larger, so rounding moves whole
    gradient terms. Leaves after the last pool agree in float32 too;
  * three steps' losses and gradient norms within 1e-4 relative;
  * the golden losses that chip_smoke.py holds the card to
    (khmer_ocr_torch/assets/train_golden.json, flagship widths, a small
    batch) are recomputed by the JAX package, and the port's CPU steps meet
    them.

Mirroring tests/test_train.py and tests/test_resume.py: pad columns leave
the loss unchanged, the BatchNorm statistics move, the schedule equals
JAX's, K steps in one call equal K single steps, 50 steps on 4 samples
overfit, the data buckets equal the JAX package's, checkpoints round-trip,
a resumed run continues (and equals the run that was not interrupted), and
the weight bridge's inverse gives the JAX trees back exactly.

The torch side runs in one torch-only subprocess (this file run as a
script); torch compute followed by jitted JAX in one process can hang. The
JAX package's float64 gradients run in a second subprocess beside it.

    python tests/test_torch_train.py golden     # rewrite the golden losses
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "khmer_ocr_torch" / "assets" / "train_golden.json"
TOY = dict(vocab_size=124, emb_dim=64, num_heads=4, enc_layers=1, dec_layers=1, enc_ffn_dim=128,
           max_global_len=512, decode_max_len=64, dropout=0.0)
TINY = dict(vocab_size=30, emb_dim=64, num_heads=4, enc_layers=1, dec_layers=1, enc_ffn_dim=128,
            max_global_len=256, decode_max_len=32)  # tests/test_train.py's TINY
RESUME = dict(vocab_size=124, emb_dim=64, num_heads=4, enc_layers=1, dec_layers=1, enc_ffn_dim=128,
              max_global_len=256, decode_max_len=16, backbone="vgg", use_bilstm=False)
LRS = (1e-3, 5e-4, 2e-4)
# chip_smoke.py's golden steps: the flagship widths (dropout 0) on two lines of 1 and 2 chunks in the
# 2-chunk bucket, 16 label positions, at the recipe's base learning rate; a batch small enough for the
# JAX package's CPU step
GOLDEN_SPEC = dict(seed=0, chunk_counts=[1, 2], lines_seed=11, label_len=16, lrs=[1e-4, 1e-4, 1e-4])
BACKBONES = ("se_vgg", "vgg", "resnet")


def lines_batch(chunk_counts, seed: int, label_len: int, bucket: int | None = None) -> dict:
    """uint8 lines of synthetic_samples, white-padded to one chunk bucket,
    with their widths, chunk counts and <sos>...<eos><pad>* labels."""
    from khmer_ocr_torch.config import PreprocessConfig
    from khmer_ocr_torch.data.synthetic import synthetic_samples
    from khmer_ocr_torch.tokenizer import Tokenizer

    pre, tok = PreprocessConfig(), Tokenizer()
    nb = bucket or max(chunk_counts)
    wb = (nb - 1) * pre.chunk_stride + pre.chunk_width
    samples = synthetic_samples(chunk_counts, seed)
    lines = np.full((len(samples), pre.img_height, wb), 255, np.uint8)
    labels = np.zeros((len(samples), label_len), np.int32)
    widths = np.zeros(len(samples), np.int32)
    for i, (line, text) in enumerate(samples):
        widths[i] = min(line.shape[1], wb)
        lines[i, :, :widths[i]] = line[:, :widths[i]]
        ids = tok.encode(text)
        ids = ids[:label_len - 1] + [tok.eos_idx] if len(ids) > label_len else ids
        labels[i, :len(ids)] = ids
    counts = np.array([pre.num_chunks(int(w)) for w in widths], np.int32)
    return {"lines": lines, "widths": widths, "chunk_counts": counts, "labels": labels}


def tiny_batch(seed: int, b: int = 4, label_len: int = 10, vocab: int = 30) -> dict:
    """tests/test_train.py::_tiny_batch's labels (random ids of a vocabulary
    of 30) on one-chunk synthetic lines."""
    rng = np.random.RandomState(seed)
    labels = np.zeros((b, label_len), np.int32)
    for i in range(b):
        n = rng.randint(4, label_len)
        labels[i, 0], labels[i, 1:n - 1], labels[i, n - 1] = 2, rng.randint(4, vocab, n - 2), 3
    batch = lines_batch([1] * b, seed, label_len)
    return {**batch, "labels": labels}


def toy_batches() -> list[dict]:
    return [lines_batch([1, 2, 2], 20 + i, 16, bucket=2) for i in range(len(LRS))]


def chunks64(batch: dict) -> dict:
    """The "chunks" layout of a lines batch in float64: normalised windows."""
    unit = batch["lines"].astype(np.float64) / 255.0
    wb = unit.shape[2]
    chunks = np.stack([unit[:, :, x:x + 100] for x in range(0, wb - 100 + 1, 84)], axis=1)
    return {"chunks": (chunks - 0.5) / 0.5, "chunk_counts": batch["chunk_counts"], "labels": batch["labels"]}


def _golden_batch() -> dict:
    g = GOLDEN_SPEC
    return lines_batch(g["chunk_counts"], g["lines_seed"], g["label_len"])


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, prefix + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, prefix + (i,)).items()}
    return {"/".join(map(str, prefix)): np.asarray(tree)}


def _golden_jax() -> dict:
    """The JAX package's three steps from the golden spec: losses and
    global gradient norms."""
    import jax
    import jax.numpy as jnp

    from khmer_ocr_tpu.config import ModelConfig
    from khmer_ocr_tpu.train.step import TrainState, make_optimizer, make_train_step
    from khmer_ocr_torch.config import ModelConfig as PortModelConfig
    from khmer_ocr_torch.convert.from_jax import seeded_params

    cfg = ModelConfig(dropout=0.0)
    p, s = seeded_params(PortModelConfig(), GOLDEN_SPEC["seed"])
    opt = make_optimizer()
    params = jax.tree.map(jnp.asarray, p)
    state = TrainState(params, jax.tree.map(jnp.asarray, s), opt.init(params), jnp.zeros((), jnp.int32))
    step = make_train_step(cfg, opt, donate=False)
    batch = {k: jnp.asarray(v) for k, v in _golden_batch().items()}
    losses, norms = [], []
    with jax.default_matmul_precision("highest"):
        for lr in GOLDEN_SPEC["lrs"]:
            state, m = step(state, batch, jax.random.PRNGKey(0), jnp.float32(lr))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    return {"losses": losses, "grad_norms": norms}


def _jax_grads() -> dict:
    """The JAX package's gradients of the first toy batch's loss, in
    float64 on the "chunks" layout."""
    import jax
    import jax.numpy as jnp

    import khmer_ocr_tpu.models.backbones as jax_backbones
    from khmer_ocr_tpu.config import ModelConfig
    from khmer_ocr_tpu.train.step import loss_fn
    from khmer_ocr_torch.config import ModelConfig as PortModelConfig
    from khmer_ocr_torch.convert.from_jax import seeded_params

    cfg = ModelConfig(**TOY)
    p, s = seeded_params(PortModelConfig(**TOY), 3)

    def max_pool(x, window, stride):  # the package's max_pool, with the -inf start it gives float32
        return jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, (1, *window, 1), (1, *stride, 1), "VALID")

    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        # float64 reverse mode needs the -inf start value (jax cannot differentiate its finfo.min start)
        mp.setattr(jax_backbones, "max_pool", max_pool)
        f64 = lambda t: jax.tree.map(lambda v: jnp.asarray(v, jnp.float64), t)
        b64 = {k: jnp.asarray(v) for k, v in chunks64(toy_batches()[0]).items()}
        grads = jax.jit(jax.grad(lambda p, s, b: loss_fn(p, s, b, cfg, jax.random.PRNGKey(0), True)[0]))(
            f64(p), f64(s), b64)
    return _flat(jax.tree.map(np.asarray, grads))


def _jax_toy() -> dict:
    """The JAX package on the toy batches (float32): three steps' losses and
    norms, the params and statistics after the first."""
    import jax
    import jax.numpy as jnp

    from khmer_ocr_tpu.config import ModelConfig
    from khmer_ocr_tpu.train.step import TrainState, make_optimizer, make_train_step
    from khmer_ocr_torch.config import ModelConfig as PortModelConfig
    from khmer_ocr_torch.convert.from_jax import seeded_params

    cfg = ModelConfig(**TOY)
    p, s = seeded_params(PortModelConfig(**TOY), 3)
    params = jax.tree.map(jnp.asarray, p)
    opt = make_optimizer()
    state = TrainState(params, jax.tree.map(jnp.asarray, s), opt.init(params), jnp.zeros((), jnp.int32))
    step = make_train_step(cfg, opt, donate=False)
    losses, norms, after = [], [], []
    with jax.default_matmul_precision("highest"):
        for b, lr in zip(toy_batches(), LRS):
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(0), jnp.float32(lr))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            after.append(state)
    return dict(loss=losses[0], new_stats=_flat(after[0].batch_stats), losses=losses, norms=norms,
                params1=_flat(after[0].params), stats1=_flat(after[0].batch_stats))


if __name__ != "__main__":
    import jax
    import jax.numpy as jnp

    @pytest.fixture(scope="module")
    def runs(tmp_path_factory):
        """Both packages' runs: the port's side and the JAX package's float64
        gradients run in subprocesses while this process computes the rest
        of the JAX side."""
        from khmer_ocr_tpu.config import ModelConfig
        from khmer_ocr_tpu.models.ocr_model import init_model
        from khmer_ocr_torch.config import ModelConfig as PortModelConfig
        from khmer_ocr_torch.convert.from_jax import save_npz, seeded_params

        tmp = tmp_path_factory.mktemp("torch_train")
        for name in BACKBONES:  # the flagship's backbone from the JAX package's init, the others seeded
            cfg = {**TINY, "vocab_size": 124, "backbone": name, "use_bilstm": name == "se_vgg"}
            if name == "se_vgg":
                p, s = jax.tree.map(np.asarray, init_model(jax.random.PRNGKey(5), ModelConfig(**cfg)))
            else:
                p, s = seeded_params(PortModelConfig(**cfg), 5)
            save_npz(tmp / f"jax_{name}.npz", p, s)
        procs = [subprocess.Popen([sys.executable, __file__, side, str(tmp)], cwd=REPO) for side in ("port", "jaxgrads")]
        try:
            ref = {**_jax_toy(), "golden": _golden_jax()}
            assert [p.wait(timeout=600) for p in procs] == [0, 0], "a side's subprocess failed"
        finally:
            for p in procs:
                p.kill()
        with np.load(tmp / "jax_grads.npz") as z:
            ref["grads"] = {k: z[k] for k in z.files}
        with np.load(tmp / "out.npz") as z:
            out = {k: z[k] for k in z.files}
        return {"out": out, "meta": json.loads((tmp / "out.json").read_text()), "tmp": tmp, "jax": ref}

    @pytest.fixture(scope="module")
    def port(runs):
        return runs

    @pytest.fixture(scope="module")
    def jax_run(runs):
        return runs["jax"]

    def test_one_step_loss_matches_jax(port, jax_run):
        assert abs(float(port["out"]["loss0"]) - jax_run["loss"]) <= 1e-5 * abs(jax_run["loss"])

    def test_one_step_gradients_match_jax(port, jax_run):
        """Every leaf, float64 on both sides (see the module's docstring)."""
        out = port["out"]
        names = [k for k in out if k.startswith("grad/")]
        assert sorted(n[5:] for n in names) == sorted(jax_run["grads"])
        for n in names:
            ref = jax_run["grads"][n[5:]]
            err = np.abs(out[n] - ref).max()
            assert err <= 1e-4 * max(1.0, np.abs(ref).max()), (n, err)

    def test_one_step_batch_stats_and_params_match_jax(port, jax_run):
        out = port["out"]
        for name, ref in jax_run["new_stats"].items():
            np.testing.assert_allclose(out[f"newstats/{name}"], ref, rtol=0, atol=1e-5, err_msg=name)
            np.testing.assert_allclose(out[f"stats1/{name}"], jax_run["stats1"][name], rtol=0, atol=1e-5)
        for name, ref in jax_run["params1"].items():
            np.testing.assert_allclose(out[f"params1/{name}"], ref, rtol=0, atol=2 * LRS[0] + 1e-6, err_msg=name)

    def test_three_steps_match_jax(port, jax_run):
        np.testing.assert_allclose(port["out"]["losses"], jax_run["losses"], rtol=1e-4)
        np.testing.assert_allclose(port["out"]["grad_norms"], jax_run["norms"], rtol=1e-4)

    def test_train_golden_is_current_and_met_on_cpu(port):
        """The golden file's spec and numbers are the JAX package's now, and
        the port's three CPU steps at flagship width meet them."""
        golden = json.loads(GOLDEN.read_text())
        assert {k: golden[k] for k in GOLDEN_SPEC} == GOLDEN_SPEC
        ref = port["jax"]["golden"]
        for key in ("losses", "grad_norms"):
            np.testing.assert_allclose(golden[key], ref[key], rtol=1e-5)
            np.testing.assert_allclose(port["meta"]["golden"][key], golden[key], rtol=1e-4)
        assert golden["labels"] == _golden_batch()["labels"].tolist()

    def test_pad_columns_leave_loss_unchanged(port):
        a, b = port["meta"]["pad_loss"]
        assert abs(a - b) <= 1e-5 * abs(a)
        assert 2.0 < a < 8.0  # about ln(124) = 4.8 at initialisation

    def test_train_updates_batch_stats(port):
        assert port["meta"]["stats_moved"] and port["meta"]["step_after_one"] == 1

    def test_schedule_equals_jax():
        from khmer_ocr_tpu.config import TrainConfig
        from khmer_ocr_tpu.train.schedule import staged_cyclic_lr
        from khmer_ocr_torch.config import TrainConfig as PortTrainConfig
        from khmer_ocr_torch.train.schedule import staged_cyclic_lr as port_lr

        for spe in (1, 7, 100):
            ref, got = staged_cyclic_lr(TrainConfig(), spe), port_lr(PortTrainConfig(), spe)
            for step in list(range(0, 40 * spe, max(1, spe // 7))) + [15 * spe, 30 * spe + spe // 2]:
                assert got(step) == ref(step), (spe, step)

    def test_multi_step_equals_single_steps(port):
        m = port["meta"]
        assert m["multi_losses"] == m["single_losses"] and m["multi_params_equal"]

    def test_overfit_sanity(port):
        """50 iterations on 4 samples end below 10% of the initial loss."""
        losses = port["meta"]["overfit"]
        assert np.isfinite(losses).all() and losses[-1] < 0.1 * losses[0], (losses[0], losses[-1])

    @pytest.mark.parametrize("device_augment", [False, True])
    def test_data_buckets_equal_jax(port, device_augment):
        """The port's LineDataset yields the JAX package's batches (layouts,
        bucket shapes, padding repeats, labels) from the same samples and rng."""
        from khmer_ocr_tpu.train.data import LineDataset

        samples = _bucket_samples()
        ref = list(LineDataset(samples, augment=False, device_augment=device_augment)
                   .epoch_batches(batch_size=4, rng=np.random.default_rng(0), num_workers=2))
        tag = "lines" if device_augment else "chunks"
        assert len(ref) == port["meta"][f"n_batches_{tag}"]
        for i, b in enumerate(ref):
            for k, v in b.as_dict().items():
                np.testing.assert_array_equal(port["out"][f"data_{tag}_{i}_{k}"], v)
            assert b.labels.shape[0] == 4 and (b.labels[:, 0] == 2).all()

    def test_checkpoint_round_trip(port):
        assert port["meta"]["checkpoint_equal"]

    def test_resume_continues(port):
        """As tests/test_resume.py: one epoch, then a resume to two continues
        with epoch 2 only; and the resumed run equals the run that was not
        interrupted."""
        m = port["meta"]["resume"]
        assert m["steps"] == [2, 4, 4]
        assert m["logged_resume"] and m["params_moved"]
        assert m["equal_to_uninterrupted"]

    @pytest.mark.parametrize("name", BACKBONES)
    def test_weight_bridge_round_trip_is_exact(port, name):
        """JAX init_model -> the port (inference and training layouts) -> JAX."""
        from khmer_ocr_torch.convert.from_jax import load_npz

        p, s, _ = load_npz(port["tmp"] / f"jax_{name}.npz")
        for layout in ("merged", "split"):
            with np.load(port["tmp"] / f"back_{name}_{layout}.npz") as z:
                back = {k: z[k] for k in z.files}
            ref = {**{f"params/{k}": v for k, v in _flat(p).items()},
                   **{f"batch_stats/{k}": v for k, v in _flat(s).items()}}
            assert sorted(back) == sorted(ref)
            for k, v in ref.items():
                np.testing.assert_array_equal(back[k], v, err_msg=k)


def _bucket_samples() -> list:
    """Lines of several widths (and one 30 px high, resized by PIL) for the
    bucket tables."""
    rs = np.random.RandomState(4)
    widths = (60, 80, 150, 300, 420, 900, 1300, 60, 300)
    texts = ("១២", "ក", "១២៣៤៥", "ab", "សួស្តី", "១២៣៤៥៦៧៨៩", "ក" * 70, "x", "yz")
    samples = [(rs.randint(0, 256, (48, w)).astype(np.uint8), t) for w, t in zip(widths, texts)]
    return samples + [(np.full((30, 120), 255, np.uint8), "១២៣")]


def _port_main(tmp: Path) -> None:
    import dataclasses
    import logging

    sys.path.insert(0, str(REPO))
    import torch

    from khmer_ocr_torch.config import ModelConfig, OCRConfig, TrainConfig
    from khmer_ocr_torch.convert.from_jax import (load_npz, params_from_jax, params_to_jax, save_npz, seeded_params,
                                                  trainable_from_jax)
    from khmer_ocr_torch.train.checkpoint import load_checkpoint_full, save_checkpoint
    from khmer_ocr_torch.train.data import LineDataset
    from khmer_ocr_torch.train.loop import train
    from khmer_ocr_torch.train.step import (batch_to_device, init_train_state, loss_fn, make_train_multi_step,
                                            make_train_step, state_from, tree_leaves)

    import time

    torch.set_num_threads(4)
    out, meta = {}, {}
    t0 = time.perf_counter()
    lap = lambda what: print(f"[port] {what}: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    cfg = ModelConfig(**TOY)

    def fresh():
        return state_from(*trainable_from_jax(*seeded_params(cfg, 3), cfg))

    def jax_layout(prefix, params, stats):
        p, s = params_to_jax(params, stats, cfg)
        out.update({f"{prefix}/{k}": v for k, v in _flat(p).items()})
        return s

    batches = [batch_to_device(b, "cpu") for b in toy_batches()]
    state = fresh()
    with torch.no_grad():
        loss, new_stats = loss_fn(state.params, state.batch_stats, batches[0], cfg)
    out["loss0"] = np.float64(loss.item())
    out.update({f"newstats/{k}": v for k, v in _flat(params_to_jax(state.params, new_stats, cfg)[1]).items()})
    s64 = state_from(*(_map_tree(lambda t: t.detach().double(), tree) for tree in (state.params, state.batch_stats)))
    loss64, _ = loss_fn(s64.params, s64.batch_stats, batch_to_device(chunks64(toy_batches()[0]), "cpu"), cfg)
    it = iter(torch.autograd.grad(loss64, tree_leaves(s64.params)))
    jax_layout("grad", _map_tree(lambda _: next(it), s64.params), s64.batch_stats)

    step = make_train_step(cfg)
    gen = torch.Generator().manual_seed(0)
    initial_stats = {k: v.copy() for k, v in _flat(state.batch_stats).items()}
    losses, norms = [], []
    for i, (b, lr) in enumerate(zip(batches, LRS)):
        state, m = step(state, b, gen, lr)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        if i == 0:
            s1 = jax_layout("params1", state.params, state.batch_stats)
            out.update({f"stats1/{k}": v for k, v in _flat(s1).items()})
            meta["step_after_one"] = state.step
            meta["stats_moved"] = any(not np.array_equal(v, _flat(state.batch_stats)[k])
                                      for k, v in initial_stats.items())
    out["losses"], out["grad_norms"] = np.array(losses), np.array(norms)
    meta["single_losses"] = losses

    multi = make_train_multi_step(cfg)
    stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    ms, mm = multi(fresh(), stacked, torch.Generator().manual_seed(0), LRS)
    meta["multi_losses"] = mm["loss"].tolist()
    meta["multi_params_equal"] = all(torch.equal(a, b) for a, b in zip(tree_leaves(ms.params),
                                                                      tree_leaves(state.params)))

    with torch.no_grad():
        base = batches[0]
        padded = {**base, "labels": torch.cat([base["labels"], torch.zeros(3, 6, dtype=base["labels"].dtype)], 1)}
        meta["pad_loss"] = [loss_fn(state.params, state.batch_stats, b, cfg, train=False)[0].item()
                            for b in (base, padded)]

    lap("toy steps")
    # the golden steps at the flagship widths
    gcfg = ModelConfig(dropout=0.0)
    gstate = state_from(*trainable_from_jax(*seeded_params(ModelConfig(), GOLDEN_SPEC["seed"]), gcfg))
    gbatch = batch_to_device(_golden_batch(), "cpu")
    gstep, gl, gn = make_train_step(gcfg), [], []
    for lr in GOLDEN_SPEC["lrs"]:
        gstate, m = gstep(gstate, gbatch, torch.Generator().manual_seed(0), lr)
        gl.append(m["loss"].item())
        gn.append(m["grad_norm"].item())
    meta["golden"] = {"losses": gl, "grad_norms": gn}
    del gstate

    lap("golden")
    # overfit: 4 one-chunk samples, 50 steps at lr 1e-3, dropout 0.1
    tiny = ModelConfig(**TINY)
    ostate, ostep = init_train_state(tiny, 1), make_train_step(tiny)
    obatch = batch_to_device(tiny_batch(3), "cpu")
    ogen, olosses = torch.Generator().manual_seed(1), []
    for _ in range(50):
        ostate, m = ostep(ostate, obatch, ogen, 1e-3)
        olosses.append(m["loss"].item())
    meta["overfit"] = olosses

    lap("overfit")
    for device_augment in (False, True):
        tag = "lines" if device_augment else "chunks"
        ds = LineDataset(_bucket_samples(), device_augment=device_augment)
        got = list(ds.epoch_batches(batch_size=4, rng=np.random.default_rng(0), num_workers=2))
        meta[f"n_batches_{tag}"] = len(got)
        for i, b in enumerate(got):
            out.update({f"data_{tag}_{i}_{k}": v for k, v in b.as_dict().items()})

    save_checkpoint(tmp / "ck", state.params, state.batch_stats, cfg, opt_state=state.opt_state, step=state.step,
                    epoch=1)
    payload, ck_cfg = load_checkpoint_full(tmp / "ck")
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    meta["checkpoint_equal"] = (ck_cfg == cfg and payload["step"] == state.step and payload["epoch"] == 1
                                and same(payload["params"], state.params)
                                and same(payload["batch_stats"], state.batch_stats)
                                and same(payload["opt_state"]["mu"], state.opt_state["mu"])
                                and same(payload["opt_state"]["nu"], state.opt_state["nu"])
                                and payload["opt_state"]["count"] == state.opt_state["count"])

    lap("data, checkpoint")
    # resume, as tests/test_resume.py
    ocfg = OCRConfig(model=ModelConfig(**RESUME))
    ocfg = dataclasses.replace(ocfg, train=dataclasses.replace(TrainConfig(), batch_size=4, epoch_sample_size=8,
                                                               checkpoint_every_epochs=1))
    ds = LineDataset([(np.full((30, 120), 255, np.uint8), "១២៣") for _ in range(8)])
    logged = []
    handler = logging.Handler()
    handler.emit = lambda r: logged.append(r.getMessage())
    logging.getLogger("khmer_ocr_torch.train.loop").addHandler(handler)
    logging.getLogger("khmer_ocr_torch.train.loop").setLevel(logging.INFO)
    s1 = train(ds, ocfg, tmp / "run", device="cpu", num_epochs=1)
    p1 = [t.detach().clone() for t in tree_leaves(s1.params)]
    s2 = train(ds, ocfg, tmp / "run", device="cpu", num_epochs=2, resume_from=tmp / "run" / "epoch001")
    s3 = train(ds, ocfg, tmp / "straight", device="cpu", num_epochs=2)
    meta["resume"] = {"steps": [s1.step, s2.step, s3.step],
                      "logged_resume": any("resumed from" in m for m in logged),
                      "params_moved": not torch.equal(p1[0], tree_leaves(s2.params)[0]),
                      "equal_to_uninterrupted": same(s2.params, s3.params)}

    lap("resume")
    for name in BACKBONES:
        bcfg = ModelConfig(**{**TINY, "vocab_size": 124, "backbone": name, "use_bilstm": name == "se_vgg"})
        p, s, _ = load_npz(tmp / f"jax_{name}.npz")
        save_npz(tmp / f"back_{name}_merged.npz", *params_to_jax(params_from_jax(p, s, bcfg), None, bcfg))
        save_npz(tmp / f"back_{name}_split.npz", *params_to_jax(*trainable_from_jax(p, s, bcfg), bcfg))

    np.savez(tmp / "out.npz", **out)
    (tmp / "out.json").write_text(json.dumps(meta))


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


def _write_golden() -> None:
    sys.path.insert(0, str(REPO))
    import os

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    ref = _golden_jax()
    GOLDEN.write_text(json.dumps({**GOLDEN_SPEC, "labels": _golden_batch()["labels"].tolist(), **ref,
                                  "made_by": "tests/test_torch_train.py golden: the JAX package's make_train_step "
                                             "(Adam direction, lax.scan BiLSTM), CPU, float32, matmul precision "
                                             "highest, flagship ModelConfig with dropout 0, seeded_params(seed)"},
                                 indent=1) + "\n")
    print(f"wrote {GOLDEN}: {ref}")


def _jax_grads_main(tmp: Path) -> None:
    sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_platforms", "cpu")
    np.savez(tmp / "jax_grads.npz", **_jax_grads())


if __name__ == "__main__":
    if sys.argv[1] == "golden":
        _write_golden()
    elif sys.argv[1] == "jaxgrads":
        _jax_grads_main(Path(sys.argv[2]))
    else:
        _port_main(Path(sys.argv[2]))
