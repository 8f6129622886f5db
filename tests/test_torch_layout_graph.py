"""The layout model's train step and forwards as device programs, on the CPU.

On the card the port runs the SegFormer train step and the detector's
forwards as captured CUDA graphs (khmer_ocr_torch/detection/graphs.py), the
counterparts of the JAX package's jitted step and of its ``_jit_predict``;
chip_smoke.py holds the graphs to the eager path bit for bit there. Here,
where no graph can be captured, at tests/test_detection_train.py's TINY
widths (MiT depth 1 a stage, hidden sizes <= 32) on 64 px pages:

  * ``make_train_step``'s eager step (``step_body`` after ``step_scalars``)
    equals the step before the split bit for bit over three steps: losses,
    parameters, both Adam moments, the BatchNorm running pair; Adam's count
    moves once a step, on the host, and the body moves it not at all, moves
    the running pair, and reads nothing on the host (``Tensor.item``,
    ``__bool__``, ... raise while it runs), so it can be captured;
  * the port's ``finetune`` from ``seeded_segformer_state`` against the JAX
    package's ``finetune(params=..., data_iter=...)`` on the same synthetic
    pages (NHWC there, NCHW here): four losses within 1e-4 relative;
  * ``predict_maps_batch`` of 5 pages at group 4 runs two forwards of 4 (the
    short group padded with zero pages, as the JAX package pads it) and its
    maps equal the JAX package's but at near-tied pixels (top-two logits of
    JAX closer than 1e-4 at model resolution), as tests/test_torch_segformer.py
    counts them;
  * the graphs' keys part what a captured graph cannot serve (shapes,
    dtypes, output size, packing, matmul and cuDNN switches, train or eval
    mode) and nothing else (the cache that holds them:
    tests/test_torch_cuda_graphs.py); each runner refuses CPU tensors with
    ValueError (no eager fallback), before Adam's count moves;
  * the upsample whose backward takes no atomics on the card
    (``segformer._Upsample``): the forward equals ``F.interpolate``'s bit
    for bit and the gradient equals its float64 gradient within float32
    rounding, while ``resize_bilinear`` keeps ``F.interpolate``'s backward
    on CPU tensors;
  * tests/test_torch_isolation.py covers the new module.

The torch side runs in one torch-only subprocess (this file run as a
script); torch compute followed by jitted JAX in one process can hang.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
TINY = dict(num_labels=12, depths=(1, 1, 1, 1), hidden_sizes=(8, 16, 24, 32), num_heads=(1, 2, 3, 4),
            sr_ratios=(8, 4, 2, 1), mlp_ratio=2, decoder_hidden=16)  # tests/test_detection_train.py's TINY
SEED = 4
LR, STEPS = 1e-3, 4
TILE, GROUP = 64, 4
PAGES = [(80, 60), (70, 90), (64, 64), (100, 50), (60, 80)]  # (height, width): 5 pages, a group of 4 and 1
NEAR_TIE = 1e-4
# what each variation of a key's inputs does to the key: True, another key
TRAIN_KEYS = {"same": False, "batch": True, "size": True, "labels_dtype": True, "mode": True, "precision": True,
              "cudnn_tf32": True}
FORWARD_KEYS = {"same": False, "batch": True, "size": True, "out_hw": True, "compact": True, "precision": True,
                "mode": True}
UPSAMPLES = [((16, 16), (64, 64)), ((8, 8), (16, 16)), ((33, 20), (128, 128)), ((5, 7), (5, 9))]
REFUSALS = ("layout_train_graphs", "detection_graphs", "make_train_step")


def train_batches(synth_layout_batch) -> list:
    """The fine-tune's batches, two 64 px pages each, from one package's
    ``synth_layout_batch`` (each side uses its own; they are equal up to
    the layout)."""
    rng = np.random.RandomState(SEED)
    return [synth_layout_batch(rng, 2, TILE, max_regions=3) for _ in range(STEPS)]


def pages():
    from PIL import Image

    rs = np.random.RandomState(1)
    return [Image.fromarray(rs.randint(150, 256, (h, w, 3), np.uint8)) for h, w in PAGES]


# ---------------------------------------------------------------------------
# the tests: the JAX package in the pytest process
# ---------------------------------------------------------------------------


if __name__ != "__main__":
    import jax

    def _top_two_margin(logits):
        """The top-two logit gap of each pixel at model resolution, where the
        batched path takes its argmax."""
        from khmer_ocr_tpu.detection.segformer import _resize_bilinear

        top = jax.lax.top_k(_resize_bilinear(logits, (TILE, TILE)), 2)[0]
        return top[..., 0] - top[..., 1]

    def _jax_side() -> dict:
        """JAX's finetune losses from the seeded state, and its batched maps
        of the pages with their near-tied pixels."""
        import cv2
        import jax.numpy as jnp

        from khmer_ocr_torch.convert.from_jax import seeded_segformer_state
        from khmer_ocr_torch.detection.segformer import SegFormerConfig as PortCfg
        from khmer_ocr_tpu.detection.config import LayoutConfig
        from khmer_ocr_tpu.detection.detector import LayoutInference
        from khmer_ocr_tpu.detection.preprocess import prepare_image
        from khmer_ocr_tpu.detection.segformer import SegFormerConfig, convert_hf_state_dict, segformer_logits
        from khmer_ocr_tpu.detection.train import finetune, synth_layout_batch

        cfg = SegFormerConfig(**TINY)
        params = jax.tree.map(jnp.asarray, convert_hf_state_dict(seeded_segformer_state(PortCfg(**TINY), SEED), cfg))
        _, losses = finetune(params=params, cfg=cfg, steps=STEPS, lr=LR, data_iter=iter(train_batches(
            synth_layout_batch)), log_every=100)
        page_list = pages()
        det = LayoutInference(None, config=LayoutConfig(image_size=TILE), params=params, seg_cfg=cfg)
        with jax.default_matmul_precision("highest"):
            maps = det.predict_maps_batch(page_list, group=GROUP)
            margins = np.asarray(jax.jit(lambda p, x: _top_two_margin(segformer_logits(p, x, cfg)))(
                params, jnp.asarray(np.concatenate([prepare_image(p, TILE)[1] for p in page_list]))))
        out = {"losses": losses}
        for i, ((_, cm, hm), (h, w), margin) in enumerate(zip(maps, PAGES, margins)):
            out[f"cm/{i}"], out[f"hm/{i}"] = cm, hm
            out[f"tied/{i}"] = cv2.resize((margin < NEAR_TIE).astype(np.uint8), (w, h),
                                          interpolation=cv2.INTER_NEAREST).astype(bool)
        return out

    @pytest.fixture(scope="module")
    def runs(tmp_path_factory):
        """The port's side in a torch-only subprocess while this process
        runs the JAX side."""
        tmp = tmp_path_factory.mktemp("torch_layout_graph")
        proc = subprocess.Popen([sys.executable, __file__, "port", str(tmp)], cwd=REPO)
        try:
            ref = _jax_side()
            assert proc.wait(timeout=600) == 0, "the port's subprocess failed"
        finally:
            proc.kill()
        with np.load(tmp / "out.npz") as z:
            out = {k: z[k] for k in z.files}
        return {"out": out, "meta": json.loads((tmp / "out.json").read_text()), "jax": ref}

    def test_step_body_equals_the_step_before_the_split(runs):
        m = runs["meta"]["split"]
        assert m == {"losses": True, "params": True, "mu": True, "nu": True, "buffers": True}, m

    def test_adam_count_moves_once_a_step(runs):
        m = runs["meta"]["count"]
        assert m["after_each_step"] == [1, 2, 3] and m["body_moves"] == 0, m

    def test_body_reads_nothing_on_the_host(runs):
        m = runs["meta"]["capturable"]
        assert m["probe_raised"] and m["body_ran"] and m["finite"] and m["bn_moved"], m

    def test_finetune_matches_jax(runs):
        got, want = runs["meta"]["finetune"], runs["jax"]["losses"]
        assert len(got) == len(want) == STEPS
        np.testing.assert_allclose(got, want, rtol=1e-4)

    def test_short_group_padded_to_the_group(runs):
        assert runs["meta"]["forwards"] == [[GROUP, 3, TILE, TILE]] * 2

    @pytest.mark.parametrize("page", range(len(PAGES)))
    def test_batched_maps_equal_jax(runs, page):
        cm, hm = runs["out"][f"cm/{page}"], runs["out"][f"hm/{page}"]
        ref = runs["jax"]
        assert cm.shape == ref[f"cm/{page}"].shape == PAGES[page]
        differ = cm != ref[f"cm/{page}"]
        print(f"page {page}: {int(ref[f'tied/{page}'].sum())} near-tied pixels, {int(differ.sum())} class ids differ")
        assert not (differ & ~ref[f"tied/{page}"]).any()
        np.testing.assert_allclose(hm, ref[f"hm/{page}"], atol=1 / 255 + 1e-6)

    @pytest.mark.parametrize("case", TRAIN_KEYS)
    def test_train_key(runs, case):
        assert runs["meta"]["train_keys"][case] == TRAIN_KEYS[case]

    @pytest.mark.parametrize("case", FORWARD_KEYS)
    def test_forward_key(runs, case):
        assert runs["meta"]["forward_keys"][case] == FORWARD_KEYS[case]

    @pytest.mark.parametrize("runner", REFUSALS)
    def test_runner_refuses_cpu_tensors(runs, runner):
        m = runs["meta"]["refusals"][runner]
        assert m["error"].startswith("ValueError") and m["count"] == 0, m

    @pytest.mark.parametrize("shapes", UPSAMPLES, ids=[f"{a[0]}x{a[1]}-{b[0]}x{b[1]}" for a, b in UPSAMPLES])
    def test_upsample_backward_without_atomics(runs, shapes):
        m = runs["meta"]["upsample"][str(shapes)]
        assert m["forward_equal"] and m["cpu_backward_is_interpolate"], m
        assert m["grad_err"] <= 1e-6 * max(1.0, m["grad_scale"]), m

    def test_isolation_covers_the_graphs_module():
        spec = importlib.util.spec_from_file_location("torch_isolation", REPO / "tests" / "test_torch_isolation.py")
        iso = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(iso)
        assert "khmer_ocr_torch/detection/graphs.py" in iso.PORT_FILES
        assert "khmer_ocr_torch.detection.graphs" in iso._PAGE_PATH and "khmer_ocr_torch.detection.graphs" in \
            iso._TRAINING


# ---------------------------------------------------------------------------
# the port's side (torch only)
# ---------------------------------------------------------------------------


def _port_main(tmp: Path) -> None:
    sys.path.insert(0, str(REPO))
    import torch
    import torch.nn.functional as F

    from khmer_ocr_torch.convert.from_jax import seeded_segformer_state
    from khmer_ocr_torch.detection import graphs as dgraphs
    from khmer_ocr_torch.detection.config import LayoutConfig
    from khmer_ocr_torch.detection.detector import LayoutInference, maps_body
    from khmer_ocr_torch.detection.segformer import SegFormerConfig, _Upsample, build_model, resize_bilinear
    from khmer_ocr_torch.detection.train import (finetune, make_train_step, segformer_loss, step_body,
                                                 synth_layout_batch)
    from khmer_ocr_torch.precision import matmul_precision
    from khmer_ocr_torch.train.step import adam_update, step_scalars

    torch.set_num_threads(4)
    cfg = SegFormerConfig(**TINY)
    state = seeded_segformer_state(cfg, SEED)
    batches = [tuple(torch.from_numpy(a) for a in b) for b in train_batches(synth_layout_batch)]
    out, meta = {}, {}

    def model_state(model, opt_state) -> dict:
        return {"params": [p.detach().clone() for p in model.parameters()],
                "mu": [t.clone() for t in opt_state["mu"]], "nu": [t.clone() for t in opt_state["nu"]],
                "buffers": [t.clone() for t in model.buffers()]}

    # the step before the split into step_body and its caller, as it was
    def step_before(model, lr):
        params = list(model.parameters())
        opt_state = {"mu": [torch.zeros_like(p) for p in params], "nu": [torch.zeros_like(p) for p in params],
                     "count": 0}

        def step(images, labels):
            model.train()
            loss = segformer_loss(model, images, labels)
            grads = torch.autograd.grad(loss, params)
            sc = step_scalars(opt_state, [lr], 0.9, 0.999, params[0].device)[0]
            adam_update(params, list(grads), opt_state, sc[0], sc[1:])
            return loss.detach()

        return step, opt_state

    old_model, new_model = build_model(state, cfg), build_model(state, cfg)
    old, old_opt = step_before(old_model, LR)
    new = make_train_step(new_model, LR)
    old_losses, new_losses, counts = [], [], []
    for x, y in batches[:3]:
        old_losses.append(old(x, y))
        new_losses.append(new(x, y))
        counts.append(new.opt_state["count"])
    a, b = model_state(old_model, old_opt), model_state(new_model, new.opt_state)
    meta["split"] = {"losses": torch.equal(torch.stack(old_losses), torch.stack(new_losses)),
                     **{k: all(torch.equal(u, v) for u, v in zip(a[k], b[k])) for k in a}}

    # the body: Adam's count untouched, the running pair moved, no host read
    model = build_model(state, cfg).train()
    step = make_train_step(model, LR)
    scalars = step_scalars(step.opt_state, [LR], 0.9, 0.999, "cpu")
    count = step.opt_state["count"]
    bn_before = model.decode_head.batch_norm.running_mean.clone()
    names = ("item", "__bool__", "__int__", "__index__", "__float__", "tolist", "numpy", "cpu")
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
        loss = step_body(model, step.opt_state, *batches[0], scalars)
        loss = step_body(model, step.opt_state, *batches[1], scalars)
        body_ran = True
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)
    meta["count"] = {"after_each_step": counts, "body_moves": step.opt_state["count"] - count}
    meta["capturable"] = {"probe_raised": probe_raised, "body_ran": body_ran, "finite": bool(torch.isfinite(loss)),
                          "bn_moved": not torch.equal(model.decode_head.batch_norm.running_mean, bn_before)}

    # finetune from the seeded state on the batches
    _, losses = finetune(build_model(state, cfg), cfg, steps=STEPS, lr=LR, data_iter=(
        (x.numpy(), y.numpy()) for x, y in batches), log_every=100, device="cpu")
    meta["finetune"] = losses

    # predict_maps_batch of 5 pages at group 4: the forwards it runs
    det = LayoutInference(None, config=LayoutConfig(image_size=TILE), params=state, seg_cfg=cfg, device="cpu")
    forwards, packed_maps = [], det.packed_maps

    def spy(pixels):
        forwards.append(list(pixels.shape))
        return packed_maps(pixels)

    det.packed_maps = spy
    for i, (_, cm, hm) in enumerate(det.predict_maps_batch(pages(), group=GROUP)):
        out[f"cm/{i}"], out[f"hm/{i}"] = cm, hm
    meta["forwards"] = forwards

    # the graphs' keys: what each variation of the inputs does to them
    images, labels = batches[0]
    model = build_model(state, cfg).train()

    def tf32_off():
        torch.backends.cudnn.allow_tf32 = False
        return torch.backends.cudnn

    base = dgraphs.train_key(model, images, labels)
    variations = {"same": lambda: dgraphs.train_key(model, images.clone(), labels.clone()),
                  "batch": lambda: dgraphs.train_key(model, images[:1], labels[:1]),
                  "size": lambda: dgraphs.train_key(model, images[..., :32, :32], labels[:, :32, :32]),
                  "labels_dtype": lambda: dgraphs.train_key(model, images, labels.long()),
                  "mode": lambda: dgraphs.train_key(model.eval(), images, labels)}
    meta["train_keys"] = {k: f() != base for k, f in variations.items()}
    model.train()
    with matmul_precision("default"):
        meta["train_keys"]["precision"] = dgraphs.train_key(model, images, labels) != base
    was = torch.backends.cudnn.allow_tf32
    try:
        tf32_off()
        meta["train_keys"]["cudnn_tf32"] = dgraphs.train_key(model, images, labels) != base
    finally:
        torch.backends.cudnn.allow_tf32 = was
    model.eval()
    pixels = torch.zeros(GROUP, 3, TILE, TILE)
    base = dgraphs.forward_key(model, pixels, (TILE, TILE), True)
    variations = {"same": lambda: dgraphs.forward_key(model, pixels.clone(), [TILE, TILE], 1),
                  "batch": lambda: dgraphs.forward_key(model, pixels[:3], (TILE, TILE), True),
                  "size": lambda: dgraphs.forward_key(model, pixels[..., :32, :32], (TILE, TILE), True),
                  "out_hw": lambda: dgraphs.forward_key(model, pixels, (2 * TILE, TILE), True),
                  "compact": lambda: dgraphs.forward_key(model, pixels, (TILE, TILE), False),
                  "mode": lambda: dgraphs.forward_key(model.train(), pixels, (TILE, TILE), True)}
    meta["forward_keys"] = {k: f() != base for k, f in variations.items()}
    model.eval()
    with matmul_precision("default"):
        meta["forward_keys"]["precision"] = dgraphs.forward_key(model, pixels, (TILE, TILE), True) != base

    # every runner refuses CPU tensors, before Adam's count moves
    refusals = {}
    step = make_train_step(model, LR, graphs=dgraphs.LayoutTrainGraphs())
    runners = {
        "layout_train_graphs": lambda: dgraphs.LayoutTrainGraphs().step(
            step_body, model, step.opt_state, images, labels, torch.zeros(1, 3)),
        "detection_graphs": lambda: dgraphs.DetectionGraphs().forward(
            maps_body(model, (TILE, TILE), True), model, pixels, (TILE, TILE), True),
        "make_train_step": lambda: step(images, labels)}
    for name, run in runners.items():
        try:
            run()
            error = "ran"
        except Exception as e:  # asserted on by the test
            error = f"{type(e).__name__}: {e}"
        refusals[name] = {"error": error, "count": step.opt_state["count"]}
    meta["refusals"] = refusals

    # the upsample without atomics against F.interpolate
    meta["upsample"] = {}
    gen = torch.Generator().manual_seed(0)
    for (hi, wi), (ho, wo) in UPSAMPLES:
        x = torch.randn(2, 3, hi, wi, generator=gen, dtype=torch.float64)
        g = torch.randn(2, 3, ho, wo, generator=gen, dtype=torch.float64)
        x64 = x.clone().requires_grad_()
        (ref,) = torch.autograd.grad(F.interpolate(x64, size=(ho, wo), mode="bilinear", align_corners=False), x64, g)
        x32 = x.float().requires_grad_()
        y = _Upsample.apply(x32, (ho, wo))
        (got,) = torch.autograd.grad(y, x32, g.float())
        interp = F.interpolate(x32, size=(ho, wo), mode="bilinear", align_corners=False)
        (cpu_ref,) = torch.autograd.grad(interp, x32, g.float())
        (cpu_got,) = torch.autograd.grad(resize_bilinear(x32, (ho, wo)), x32, g.float())
        meta["upsample"][str(((hi, wi), (ho, wo)))] = {
            "forward_equal": torch.equal(y, interp), "grad_err": (got.double() - ref).abs().max().item(),
            "grad_scale": ref.abs().max().item(), "cpu_backward_is_interpolate": torch.equal(cpu_got, cpu_ref)}

    np.savez(tmp / "out.npz", **out)
    (tmp / "out.json").write_text(json.dumps(meta))


if __name__ == "__main__":
    _port_main(Path(sys.argv[2]))
