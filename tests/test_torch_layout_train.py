"""SegFormer layout training in the PyTorch port against the JAX package, on the CPU.

At tests/test_detection_train.py's TINY widths the same numpy-seeded weights
(``convert.from_jax.seeded_segformer_state``; the JAX side takes them through
its ``convert_hf_state_dict``) and the same synthetic pages go to both
packages' trainers (``detection/train.py``):

  * ``synth_layout_batch`` gives the JAX package's pages and labels bit for
    bit (the port's images are the NCHW transpose), for several seeds and
    sizes;
  * one step: the loss within 1e-5 relative, every gradient leaf within
    1e-4 x max(1, |ref|), the new BatchNorm running pair within 1e-6. Both
    packages compute in float32: the SegFormer has no max pool, so no
    near-tie routes a whole gradient term differently;
  * three Adam steps at lr 1e-3: the losses within 1e-4 relative;
  * an .npz written by the port loads through the JAX package's
    ``unflatten_params`` and the reverse, leaf for leaf exactly, and
    ``segformer_params_to_jax`` inverts ``segformer_params_from_jax``
    exactly;
  * the golden losses that chip_smoke.py holds the card to
    (khmer_ocr_torch/assets/layout_train_golden.json: three JAX steps at the
    MiT-b0 widths on a batch of two 128 px pages, lr 6e-5) are the JAX
    package's now, and the port's CPU steps meet them within 1e-4.

Mirroring tests/test_detection_train.py's five tests on the port: init and
forward shapes, a fixed batch overfits with the running pair moving, an
all-ignored batch gives loss 0 with finite gradients, ``finetune`` runs and
its .npz round-trips, the synthetic labels are valid classes.

The torch side runs in one torch-only subprocess (this file run as a
script); torch compute followed by jitted JAX in one process can hang.

    python tests/test_torch_layout_train.py golden     # rewrite the golden losses
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "khmer_ocr_torch" / "assets" / "layout_train_golden.json"
TINY = dict(num_labels=12, depths=(1, 1, 1, 1), hidden_sizes=(8, 16, 24, 32), num_heads=(1, 2, 3, 4),
            sr_ratios=(8, 4, 2, 1), mlp_ratio=2, decoder_hidden=16)  # tests/test_detection_train.py's TINY
SEED = 4
LR, N_STEPS = 1e-3, 3
SYNTH_CASES = [(0, 64, 2), (1, 64, 5), (7, 128, 5), (11, 96, 3)]  # (seed, size, max_regions)
# chip_smoke.py's golden steps: MiT-b0 widths, 12 labels, seeded_segformer_state(seed), two 128 px pages
GOLDEN_SPEC = dict(seed=0, pages_seed=0, batch=2, size=128, lr=6e-5, steps=3)


def step_batches(synth_layout_batch):
    """The parity steps' batches, two 64 px pages each, from one package's
    ``synth_layout_batch`` (each side uses its own; they are equal)."""
    rng = np.random.RandomState(SEED)
    return [synth_layout_batch(rng, 2, 64, max_regions=3) for _ in range(N_STEPS)]


def golden_batch(synth_layout_batch):
    g = GOLDEN_SPEC
    return synth_layout_batch(np.random.RandomState(g["pages_seed"]), g["batch"], g["size"])


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, prefix + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, prefix + (i,)).items()}
    return {"/".join(map(str, prefix)): np.asarray(tree)}


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------


def _jax_tree(cfg_kw: dict, seed: int):
    """The seeded HF state through the JAX package's converter."""
    import jax
    import jax.numpy as jnp

    from khmer_ocr_tpu.detection.segformer import SegFormerConfig, convert_hf_state_dict
    from khmer_ocr_torch.convert.from_jax import seeded_segformer_state
    from khmer_ocr_torch.detection.segformer import SegFormerConfig as PortCfg

    return jax.tree.map(jnp.asarray, convert_hf_state_dict(seeded_segformer_state(PortCfg(**cfg_kw), seed),
                                                           SegFormerConfig(**cfg_kw)))


def _jax_steps(cfg_kw: dict, seed: int, batches, lr: float) -> dict:
    """The JAX package's loss and gradients of the first (NHWC) batch, its
    new running pair, and the losses of one Adam step on each batch."""
    import jax
    import jax.numpy as jnp
    import optax

    from khmer_ocr_tpu.detection.segformer import SegFormerConfig
    from khmer_ocr_tpu.detection.train import make_train_step, segformer_loss

    cfg = SegFormerConfig(**cfg_kw)
    params = _jax_tree(cfg_kw, seed)
    x0, y0 = jnp.asarray(batches[0][0]), jnp.asarray(batches[0][1])
    (loss, stats), grads = jax.jit(jax.value_and_grad(lambda p: segformer_loss(p, x0, y0, cfg), has_aux=True))(params)
    losses = []
    opt = optax.adam(lr)
    opt_state = opt.init(params)
    step = make_train_step(cfg, opt)
    for x, y in batches:
        params, opt_state, l = step(params, opt_state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(l))
    return {"loss": float(loss), "grads": _flat(jax.tree.map(np.asarray, grads)),
            "bn": {k: np.asarray(v) for k, v in stats.items()}, "losses": losses}


def _golden_jax() -> list:
    from khmer_ocr_tpu.detection.train import synth_layout_batch

    g = GOLDEN_SPEC
    return _jax_steps({}, g["seed"], [golden_batch(synth_layout_batch)] * g["steps"], g["lr"])["losses"]


if __name__ != "__main__":
    import jax

    @pytest.fixture(scope="module")
    def runs(tmp_path_factory):
        """The port's side in a torch-only subprocess (given a JAX-written
        .npz to load) while this process runs the JAX side."""
        from khmer_ocr_tpu.detection.segformer import SegFormerConfig
        from khmer_ocr_tpu.detection.train import flatten_params, segformer_init, synth_layout_batch

        tmp = tmp_path_factory.mktemp("torch_layout_train")
        jax_params = segformer_init(jax.random.PRNGKey(9), SegFormerConfig(**TINY))
        np.savez(tmp / "jax_written.npz", **flatten_params(jax_params))
        np.savez(tmp / "jax_seeded.npz", **_flat(jax.tree.map(np.asarray, _jax_tree(TINY, SEED))))
        proc = subprocess.Popen([sys.executable, __file__, "port", str(tmp)], cwd=REPO)
        try:
            ref = _jax_steps(TINY, SEED, step_batches(synth_layout_batch), LR)
            ref["golden"] = _golden_jax()
            assert proc.wait(timeout=600) == 0, "the port's subprocess failed"
        finally:
            proc.kill()
        with np.load(tmp / "out.npz") as z:
            out = {k: z[k] for k in z.files}
        return {"out": out, "meta": json.loads((tmp / "out.json").read_text()), "tmp": tmp, "jax": ref,
                "jax_params": jax_params}

    @pytest.mark.parametrize("seed,size,max_regions", SYNTH_CASES)
    def test_synth_layout_batch_equals_jax(runs, seed, size, max_regions):
        from khmer_ocr_tpu.detection.train import synth_layout_batch

        images, labels = synth_layout_batch(np.random.RandomState(seed), 3, size, max_regions)
        tag = f"synth_{seed}_{size}_{max_regions}"
        np.testing.assert_array_equal(runs["out"][f"{tag}_images"].transpose(0, 2, 3, 1), images)
        np.testing.assert_array_equal(runs["out"][f"{tag}_labels"], labels)

    def test_one_step_loss_matches_jax(runs):
        ref = runs["jax"]["loss"]
        assert abs(float(runs["out"]["loss0"]) - ref) <= 1e-5 * abs(ref)

    def test_one_step_gradients_match_jax(runs):
        out, ref = runs["out"], runs["jax"]["grads"]
        names = sorted(k[5:] for k in out if k.startswith("grad/"))
        assert names == sorted(k for k in ref if not k.endswith(("bn/mean", "bn/var")))
        for n in names:
            err = np.abs(out[f"grad/{n}"] - ref[n]).max()
            assert err <= 1e-4 * max(1.0, np.abs(ref[n]).max()), (n, err)

    def test_one_step_batch_norm_pair_matches_jax(runs):
        for k in ("mean", "var"):
            np.testing.assert_allclose(runs["out"][f"bn_{k}"], runs["jax"]["bn"][k], rtol=0, atol=1e-6, err_msg=k)

    def test_three_steps_match_jax(runs):
        np.testing.assert_allclose(runs["out"]["losses"], runs["jax"]["losses"], rtol=1e-4)

    def test_layout_golden_is_current_and_met_on_cpu(runs):
        """The golden file's spec and losses are the JAX package's now, and
        the port's three CPU steps at the MiT-b0 widths meet them."""
        golden = json.loads(GOLDEN.read_text())
        assert {k: golden[k] for k in GOLDEN_SPEC} == GOLDEN_SPEC
        np.testing.assert_allclose(golden["losses"], runs["jax"]["golden"], rtol=1e-5)
        np.testing.assert_allclose(runs["meta"]["golden"], golden["losses"], rtol=1e-4)

    def test_port_npz_loads_in_jax(runs):
        """An .npz the port wrote (after finetune) through the JAX package's
        ``unflatten_params``, against the JAX init tree as template."""
        from khmer_ocr_tpu.detection.train import flatten_params, unflatten_params

        with np.load(runs["tmp"] / "port_written.npz") as z:
            flat = {k: z[k] for k in z.files}
        rebuilt = flatten_params(unflatten_params(flat, runs["jax_params"]))
        assert sorted(rebuilt) == sorted(flat)
        for k, v in rebuilt.items():
            np.testing.assert_array_equal(v, flat[k], err_msg=k)

    def test_jax_npz_loads_in_port(runs):
        """The JAX package's init, saved by its ``flatten_params``, read by the
        port's ``unflatten_params`` into a SegFormer and flattened again."""
        with np.load(runs["tmp"] / "jax_written.npz") as z:
            ref = {k: z[k] for k in z.files}
        with np.load(runs["tmp"] / "jax_back.npz") as z:
            back = {k: z[k] for k in z.files}
        assert sorted(back) == sorted(ref)
        for k, v in ref.items():
            np.testing.assert_array_equal(back[k], v, err_msg=k)

    def test_segformer_params_to_jax_inverts_the_bridge(runs):
        """The JAX package's converted tree of the seeded state -> the port's
        state (``segformer_params_from_jax``) -> ``segformer_params_to_jax``."""
        with np.load(runs["tmp"] / "jax_seeded.npz") as z:
            ref = {k: z[k] for k in z.files}
        with np.load(runs["tmp"] / "bridge_back.npz") as z:
            back = {k: z[k] for k in z.files}
        assert sorted(back) == sorted(ref)
        for k, v in ref.items():
            np.testing.assert_array_equal(back[k], v, err_msg=k)

    # tests/test_detection_train.py's five tests, on the port

    def test_init_forward_shapes(runs):
        m = runs["meta"]["init"]
        assert m["logits"] == [2, 12, 16, 16] and m["maps"] == [[2, 64, 64], [2, 64, 64]] and m["heat_max"] <= 1.0 + 1e-6
        assert m["trunc"] <= 0.04 + 1e-7 and m["unit_ln"] and m["zero_bias"] and m["bn_init"]

    def test_train_step_overfits_fixed_batch(runs):
        m = runs["meta"]["overfit"]
        assert np.isfinite(m["last"]) and m["last"] < 0.5 * m["first"], (m["first"], m["last"])
        assert m["bn_moved"]  # the running pair is state: it tracks the batch statistics

    def test_loss_ignore_index(runs):
        m = runs["meta"]["ignore"]
        assert m["loss"] == 0.0 and m["grads_finite"]

    def test_finetune_runs_and_save_roundtrip(runs):
        m = runs["meta"]["finetune"]
        assert m["n_losses"] == 4 and m["finite"] and m["roundtrip_equal"]

    def test_synth_layout_batch_labels_valid(runs):
        m = runs["meta"]["synth"]
        assert m["images"] == [3, 3, 128, 128] and m["labels"] == [3, 128, 128]
        assert m["min"] >= -1.0 - 1e-6 and m["max"] <= 1.0 + 1e-6
        assert set(m["classes"]) <= {0, 7, 8, 9, 10, 11}

    def test_eval_mode_forward_unchanged_by_training_branch(runs):
        """A train-mode forward moves the running pair; eval mode reads it, and
        the model in eval mode gives the logits of a fresh build of its state."""
        assert runs["meta"]["eval_equal"]


# ---------------------------------------------------------------------------
# the port's side (torch only)
# ---------------------------------------------------------------------------


def _port_main(tmp: Path) -> None:
    sys.path.insert(0, str(REPO))
    import torch

    from khmer_ocr_torch.convert.from_jax import seeded_segformer_state, segformer_params_to_jax
    from khmer_ocr_torch.detection.segformer import SegFormer, SegFormerConfig, build_model, predict_maps
    from khmer_ocr_torch.detection.train import (IGNORE_INDEX, finetune, flatten_params, make_train_step,
                                                 segformer_init, segformer_loss, synth_layout_batch,
                                                 unflatten_params)

    torch.set_num_threads(4)
    cfg = SegFormerConfig(**TINY)
    out, meta = {}, {}
    t = torch.from_numpy

    for seed, size, max_regions in SYNTH_CASES:
        images, labels = synth_layout_batch(np.random.RandomState(seed), 3, size, max_regions)
        out[f"synth_{seed}_{size}_{max_regions}_images"], out[f"synth_{seed}_{size}_{max_regions}_labels"] = \
            images, labels

    with np.load(tmp / "jax_seeded.npz") as z:
        np.savez(tmp / "bridge_back.npz", **_flat(segformer_params_to_jax(unflatten_params(dict(z), cfg), cfg)))
    state = seeded_segformer_state(cfg, SEED)

    # one step: loss, gradients, the new running pair
    batches = step_batches(synth_layout_batch)
    model = build_model(state, cfg).train()
    x0, y0 = t(batches[0][0]), t(batches[0][1])
    loss = segformer_loss(model, x0, y0)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    out["loss0"] = np.float64(loss.item())
    gstate = {**dict(zip(names, grads)), **dict(model.named_buffers())}
    out.update({f"grad/{k}": v for k, v in _flat(segformer_params_to_jax(gstate, cfg)).items()
                if not k.endswith(("bn/mean", "bn/var"))})
    out["bn_mean"] = model.decode_head.batch_norm.running_mean.numpy().copy()
    out["bn_var"] = model.decode_head.batch_norm.running_var.numpy().copy()

    # three steps
    model = build_model(state, cfg)
    step = make_train_step(model, LR)
    out["losses"] = np.array([step(t(x), t(y)).item() for x, y in batches])

    # the golden steps at the MiT-b0 widths
    gmodel = build_model(seeded_segformer_state(SegFormerConfig(), GOLDEN_SPEC["seed"]), SegFormerConfig())
    gstep, (gx, gy) = make_train_step(gmodel, GOLDEN_SPEC["lr"]), golden_batch(synth_layout_batch)
    meta["golden"] = [gstep(t(gx), t(gy)).item() for _ in range(GOLDEN_SPEC["steps"])]
    del gmodel, gstep

    # the five mirrored tests
    model = segformer_init(0, cfg)
    weights = [m.weight for m in model.modules() if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d))]
    with torch.no_grad():
        x = torch.zeros(2, 3, 64, 64)
        logits = model.eval()(x)
        cm, hm = predict_maps(model, x, (64, 64))
    meta["init"] = {"logits": list(logits.shape), "maps": [list(cm.shape), list(hm.shape)],
                    "heat_max": hm.max().item(), "trunc": max(w.abs().max().item() for w in weights),
                    "unit_ln": all(bool((m.weight == 1).all()) for m in model.modules()
                                   if isinstance(m, torch.nn.LayerNorm)),
                    "zero_bias": all(bool((m.bias == 0).all()) for m in model.modules()
                                     if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d)) and m.bias is not None),
                    "bn_init": bool((model.decode_head.batch_norm.running_var == 1).all()
                                    and (model.decode_head.batch_norm.running_mean == 0).all())}

    model = segformer_init(1, cfg)
    step = make_train_step(model, 3e-3)
    images, labels = synth_layout_batch(np.random.RandomState(0), 2, 64, max_regions=2)
    bn_before = model.decode_head.batch_norm.running_mean.clone()
    losses = [step(t(images), t(labels)).item() for _ in range(30)]
    meta["overfit"] = {"first": losses[0], "last": losses[-1],
                       "bn_moved": not torch.allclose(model.decode_head.batch_norm.running_mean, bn_before)}

    model = segformer_init(2, cfg).train()
    images = t(np.random.RandomState(0).rand(1, 3, 64, 64).astype(np.float32))
    loss = segformer_loss(model, images, torch.full((1, 64, 64), IGNORE_INDEX, dtype=torch.int32))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    meta["ignore"] = {"loss": loss.item(), "grads_finite": all(bool(torch.isfinite(g).all()) for g in grads)}

    model, losses = finetune(cfg=cfg, steps=4, batch_size=1, image_size=64, lr=1e-3, seed=3, device="cpu")
    flat = flatten_params(model)
    np.savez(tmp / "port_written.npz", **flat)
    with np.load(tmp / "port_written.npz") as z:
        loaded = {k: z[k] for k in z.files}
    rebuilt = SegFormer(cfg)
    rebuilt.load_state_dict(unflatten_params(loaded, cfg))
    again = flatten_params(rebuilt)
    meta["finetune"] = {"n_losses": len(losses), "finite": bool(np.isfinite(losses).all()),
                        "roundtrip_equal": sorted(again) == sorted(flat)
                        and all(np.array_equal(again[k], v) for k, v in flat.items())}

    images, labels = synth_layout_batch(np.random.RandomState(7), 3, 128)
    meta["synth"] = {"images": list(images.shape), "labels": list(labels.shape), "min": float(images.min()),
                     "max": float(images.max()), "classes": sorted(int(c) for c in np.unique(labels))}

    with np.load(tmp / "jax_written.npz") as z:
        jax_flat = {k: z[k] for k in z.files}
    jm = SegFormer(cfg)
    jm.load_state_dict(unflatten_params(jax_flat, cfg))
    np.savez(tmp / "jax_back.npz", **flatten_params(jm))

    # eval mode after training reads the moved running pair, as a fresh build of the state does
    with torch.no_grad():
        x = t(batches[0][0])
        trained = model.eval()(x)
        fresh = build_model(model.state_dict(), cfg)(x)
    meta["eval_equal"] = bool(torch.equal(trained, fresh))

    np.savez(tmp / "out.npz", **out)
    (tmp / "out.json").write_text(json.dumps(meta))


def _write_golden() -> None:
    sys.path.insert(0, str(REPO))
    import os

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    losses = _golden_jax()
    GOLDEN.write_text(json.dumps({**GOLDEN_SPEC, "losses": losses,
                                  "made_by": "tests/test_torch_layout_train.py golden: the JAX package's "
                                             "detection/train.py make_train_step with optax.adam(lr), CPU, float32, "
                                             "SegFormerConfig() (MiT-b0, 12 labels) from seeded_segformer_state(seed), "
                                             "the same batch synth_layout_batch(RandomState(pages_seed), batch, size) "
                                             "each step"}, indent=1) + "\n")
    print(f"wrote {GOLDEN}: {losses}")


if __name__ == "__main__":
    if sys.argv[1] == "golden":
        _write_golden()
    else:
        _port_main(Path(sys.argv[2]))
