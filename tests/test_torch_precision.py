"""The port's float32 matmul precision, scoped to each call as the JAX
package scopes ``default_matmul_precision``, on the CPU.

Torch keeps three process-wide switches for float32 work: ``torch.backends.
cuda.matmul.allow_tf32``, ``torch.backends.cudnn.allow_tf32`` and
``torch.get_float32_matmul_precision()``. ``khmer_ocr_torch/precision.py::
matmul_precision`` sets them for a region and puts back what it found.

* The scope itself, in the pytest process (it sets switches, it computes
  nothing): the switches inside for each precision and after a normal exit
  and an exception, from both "all off" and a fresh torch process's state
  (cuDNN's TF32 on); the gate between threads: one precision overlaps,
  another waits, a nested other precision raises.
* Every entry point that computes, in a torch-only subprocess (this file
  run as a script; torch compute followed by jitted JAX in one process can
  hang): a Predictor at "default" (the smallest input of ROADMAP's fault
  F1, then ``warmup`` and ``predict_batch``), ``LayoutInference`` and
  ``finetune`` at "highest", ``train()`` at the config's precision (fault
  F2): the switches as each found them after it returns, and inside, read
  by hooks on the functions they call, the precision asked for.
* One ``make_train_step(..., precision="default")`` step at 2 + 2 layers,
  D = 32 against the JAX package's ``make_train_step(..., precision=
  "default")`` on the same numpy-seeded params and lines, within
  tests/test_torch_train.py's tolerances (on the CPU "default" is float32
  in both packages, so it is the float32 step).
* ``process_pages`` with recognition at "default" and the detector at
  "highest", a queue of one page: it ends within its time limit and reads
  the texts of the same run with recognition at "highest".

Every wait on a thread or an event has a timeout, so a deadlock fails.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
WAIT = 5.0  # seconds any wait on a thread or an event may take
ALL_OFF = (False, False, "highest")
FRESH = (False, True, "highest")  # a fresh torch process: cuDNN's TF32 on, matmul's off
INSIDE = {"highest": (False, False, "highest"), "high": (True, True, "high"), "default": (True, True, "high")}
SMALL = dict(vocab_size=124, emb_dim=32, num_heads=4, enc_layers=2, dec_layers=2, enc_ffn_dim=64,
             max_global_len=256, decode_max_len=32, dropout=0.0)  # 2 + 2 layers at D = 32
SEED, LR = 3, 1e-3
N_PAGES = 2

sys.path.insert(0, str(REPO))


def lines_batch(chunk_counts, seed: int, label_len: int) -> dict:
    """uint8 synthetic lines white-padded to one chunk bucket, with widths,
    chunk counts and <sos>...<eos><pad>* labels."""
    from khmer_ocr_torch.config import PreprocessConfig
    from khmer_ocr_torch.data.synthetic import synthetic_samples
    from khmer_ocr_torch.tokenizer import Tokenizer

    pre, tok = PreprocessConfig(), Tokenizer()
    wb = (max(chunk_counts) - 1) * pre.chunk_stride + pre.chunk_width
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


def step_batch() -> dict:
    return lines_batch([1, 2, 2], 21, 16)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, prefix + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, prefix + (i,)).items()}
    return {"/".join(map(str, prefix)): np.asarray(tree)}


# ---------------------------------------------------------------------------
# the port's entry points, in a torch-only subprocess
# ---------------------------------------------------------------------------


def _port_main(tmp: Path) -> None:
    import dataclasses

    import torch
    from PIL import Image
    from safetensors.numpy import save_file

    import khmer_ocr_torch.detection.detector as detector
    import khmer_ocr_torch.detection.train as dtrain
    import khmer_ocr_torch.infer.predictor as predictor
    import khmer_ocr_torch.train.step as step_mod
    from khmer_ocr_torch.config import ModelConfig, OCRConfig, RuntimeConfig, TrainConfig
    from khmer_ocr_torch.convert.from_jax import params_to_jax, seeded_params, seeded_segformer_state, trainable_from_jax
    from khmer_ocr_torch.data.pages import compose_pages
    from khmer_ocr_torch.detection.segformer import SegFormerConfig, hf_config
    from khmer_ocr_torch.pipeline.engine import KhmerOCRPipeline
    from khmer_ocr_torch.precision import switches
    from khmer_ocr_torch.train.data import LineDataset
    from khmer_ocr_torch.train.loop import train
    from khmer_ocr_torch.train.step import batch_to_device, make_train_step, state_from

    torch.set_num_threads(4)
    res: dict = {"fresh": switches()}
    seen: list = []  # (tag, switches) recorded inside the hooked functions

    def hook(module, name, tag):
        real = getattr(module, name)

        def spy(*args, **kw):
            seen.append((tag(args, kw) if callable(tag) else tag, switches()))
            return real(*args, **kw)

        setattr(module, name, spy)

    def set_state(state):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = state[:2]
        torch.set_float32_matmul_precision(state[2])

    def take():
        out = list(seen)
        seen.clear()
        return out

    hook(predictor, "infer_batch", "infer_batch")
    hook(detector, "predict_maps", "predict_maps")
    hook(dtrain, "segformer_loss", "segformer_loss")
    hook(step_mod, "forward_train", lambda a, kw: "forward_train" if a[7] else "eval_forward")
    hook(step_mod, "adam_update", "adam_update")

    # F1's smallest input: the flagship widths at "default"
    default = OCRConfig(runtime=RuntimeConfig(matmul_precision="default"))
    predictor.set_parity_mode()
    before = switches()
    pred = predictor.Predictor(*seeded_params(default.model, 0), default.model, device="cpu", config=default)
    after_ctor = switches()
    pred.predict(np.full((48, 200), 255, np.uint8), beam_width=1, max_len=2)
    res["predict"] = dict(before=before, after_ctor=after_ctor, after=switches(), inside=take())

    # warmup and predict_batch at "default" on a small model, from a fresh process's switches
    small = ModelConfig(**{**SMALL, "decode_max_len": 8})
    pred = predictor.Predictor(*seeded_params(small, 1), small, device="cpu", config=default)
    set_state(tuple(res["fresh"]))
    before = switches()
    pred.warmup(beam_widths=(1,), batch_size=1, chunk_buckets=(1, 2))
    res["warmup"] = dict(before=before, after_ctor=before, after=switches(), inside=take())
    with np.load(REPO / "khmer_ocr_torch" / "assets" / "real_lines.npz") as z:
        lines = [z[f"line_{i}"] for i in range(16 * N_PAGES)]
    res["predict_batch"] = dict(before=before, after_ctor=before)
    pred.predict_batch(lines[:3], beam_width=3, max_len=4)
    res["predict_batch"].update(after=switches(), inside=take())

    # LayoutInference at "highest", built and called with TF32 on
    predictor.set_matmul_precision("default")
    pages = [Image.fromarray(p) for p in compose_pages(lines)[0]]
    before = switches()
    layout = detector.LayoutInference(None, params=seeded_segformer_state(None, 0), device="cpu")
    after_ctor = switches()
    maps = layout.predict_maps(pages[0])
    res["layout"] = dict(before=before, after_ctor=after_ctor, after=switches(), inside=take(),
                         classes=int(np.unique(maps[1]).size))
    packed = layout.packed_maps(np.concatenate([detector.prepare_image(p, 512)[1] for p in pages]))
    res["packed_maps"] = dict(before=before, after_ctor=after_ctor, after=switches(), inside=take(),
                              shape=list(packed.shape))

    # finetune at "highest", from a fresh process's switches
    set_state(tuple(res["fresh"]))
    tiny = SegFormerConfig(num_labels=12, depths=(1, 1, 1, 1), hidden_sizes=(8, 16, 24, 32), num_heads=(1, 2, 3, 4),
                           sr_ratios=(8, 4, 2, 1), mlp_ratio=2, decoder_hidden=16)
    _, losses = dtrain.finetune(cfg=tiny, steps=2, batch_size=1, image_size=64, lr=1e-3, seed=3, device="cpu")
    res["finetune"] = dict(before=tuple(res["fresh"]), after_ctor=tuple(res["fresh"]), after=switches(),
                           inside=take(), losses=losses)

    # F2: train() at the config's precision, an eye test every batch
    for precision, start in (("default", "highest"), ("highest", "default")):
        predictor.set_matmul_precision(start)
        before = switches()
        cfg = OCRConfig(model=ModelConfig(**{**SMALL, "backbone": "vgg", "use_bilstm": False, "decode_max_len": 16}),
                        runtime=RuntimeConfig(matmul_precision=precision),
                        train=dataclasses.replace(TrainConfig(), batch_size=4, epoch_sample_size=8))
        ds = LineDataset([(np.full((30, 120), 255, np.uint8), "១២៣") for _ in range(8)])
        state = train(ds, cfg, tmp / f"run_{precision}", device="cpu", num_epochs=1, log_every=1, eye_test_every=1)
        res[f"train/{precision}"] = dict(before=before, after_ctor=before, after=switches(), inside=take(),
                                         steps=state.step)

    # one step at "default" on the JAX package's inputs
    predictor.set_parity_mode()
    cfg = ModelConfig(**SMALL)
    state = state_from(*trainable_from_jax(*seeded_params(cfg, SEED), cfg))
    state, m = make_train_step(cfg, precision="default")(state, batch_to_device(step_batch(), "cpu"),
                                                          torch.Generator().manual_seed(0), LR)
    take()
    p, s = params_to_jax(state.params, state.batch_stats, cfg)
    np.savez(tmp / "step.npz", loss=m["loss"].item(), grad_norm=m["grad_norm"].item(),
             **{f"params/{k}": v for k, v in _flat(p).items()}, **{f"stats/{k}": v for k, v in _flat(s).items()})

    # process_pages: recognition at "default" against "highest", the detector at "highest", a queue of one
    (tmp / "layout").mkdir()
    (tmp / "layout" / "config.json").write_text(json.dumps(hf_config(SegFormerConfig())))
    save_file({k: v for k, v in seeded_segformer_state(None, 0).items() if v.ndim},
              str(tmp / "layout" / "model.safetensors"))
    paths = []
    for i, page in enumerate(pages):
        paths.append(tmp / f"page{i}.png")
        page.save(paths[-1])
    predictor.set_parity_mode()
    for precision in ("default", "highest"):
        rec = predictor.Predictor(*seeded_params(small, 1), small, device="cpu",
                                  config=OCRConfig(runtime=RuntimeConfig(matmul_precision=precision)))

        def recognize(crops, beam_width, batch_size, model_path=None, vocab_path=None, rec=rec):
            return rec.predict_batch(crops, beam_width=beam_width, batch_size=batch_size, max_len=8)

        pipe = KhmerOCRPipeline(engine="custom", layout_model_dir=str(tmp / "layout"), recognize_fn=recognize,
                                device="cpu")
        out: list = []
        t = threading.Thread(target=lambda: out.append(pipe.process_pages(
            paths, beam_width=1, batch_size=8, pages_per_batch=1, queue_depth=1, flush_lines=1)), daemon=True)
        t.start()
        t.join(timeout=120)
        res[f"pages/{precision}"] = dict(finished=not t.is_alive(), texts=out[0] if out else None,
                                         inside=take(), after=switches())
    (tmp / "port.json").write_text(json.dumps(res, ensure_ascii=False))


# ---------------------------------------------------------------------------
# the JAX package's step, in the pytest process
# ---------------------------------------------------------------------------


def _jax_step() -> dict:
    import jax
    import jax.numpy as jnp

    from khmer_ocr_tpu.config import ModelConfig
    from khmer_ocr_tpu.train.step import TrainState, make_optimizer, make_train_step
    from khmer_ocr_torch.config import ModelConfig as PortModelConfig
    from khmer_ocr_torch.convert.from_jax import seeded_params

    p, s = seeded_params(PortModelConfig(**SMALL), SEED)
    params = jax.tree.map(jnp.asarray, p)
    opt = make_optimizer()
    state = TrainState(params, jax.tree.map(jnp.asarray, s), opt.init(params), jnp.zeros((), jnp.int32))
    step = make_train_step(ModelConfig(**SMALL), opt, precision="default", donate=False)
    state, m = step(state, {k: jnp.asarray(v) for k, v in step_batch().items()}, jax.random.PRNGKey(0),
                    jnp.float32(LR))
    return dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), params=_flat(state.params),
                stats=_flat(state.batch_stats))


if __name__ != "__main__":
    from khmer_ocr_torch.precision import PRECISIONS, matmul_precision, switches

    def _set(state):
        import torch

        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = state[:2]
        torch.set_float32_matmul_precision(state[2])

    @pytest.fixture
    def restore_switches():
        saved = switches()
        yield
        _set(saved)

    @pytest.mark.parametrize("start", [ALL_OFF, FRESH], ids=["all_off", "fresh_process"])
    @pytest.mark.parametrize("precision", PRECISIONS)
    @pytest.mark.parametrize("exit_by", ["return", "exception"])
    def test_scope_sets_and_restores_the_three_switches(restore_switches, start, precision, exit_by):
        _set(start)
        with pytest.raises(RuntimeError) if exit_by == "exception" else contextlib.nullcontext():
            with matmul_precision(precision):
                assert switches() == INSIDE[precision]
                if exit_by == "exception":
                    raise RuntimeError("inside the scope")
        assert switches() == start

    def test_unknown_precision_raises(restore_switches):
        with pytest.raises(ValueError):
            with matmul_precision("medium"):
                pass

    def test_same_precision_regions_overlap(restore_switches):
        _set(ALL_OFF)
        both_in = threading.Barrier(2, timeout=WAIT)
        inside, errors = [], []

        def region():
            try:
                with matmul_precision("default"):
                    both_in.wait()  # both threads are inside their scopes at once
                    inside.append(switches())
                    both_in.wait()
            except Exception as e:  # reported below
                errors.append(e)

        threads = [threading.Thread(target=region) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        assert not errors and not any(t.is_alive() for t in threads)
        assert inside == [INSIDE["default"]] * 2
        assert switches() == ALL_OFF

    def test_other_precision_waits_for_the_first_to_exit(restore_switches):
        _set(FRESH)
        first_in, first_go, second_in = threading.Event(), threading.Event(), threading.Event()
        seen = {}

        def first():
            with matmul_precision("default"):
                first_in.set()
                first_go.wait(WAIT)
                seen["first"] = switches()

        def second():
            with matmul_precision("highest"):
                second_in.set()
                seen["second"] = switches()

        a = threading.Thread(target=first)
        a.start()
        assert first_in.wait(WAIT)
        b = threading.Thread(target=second)
        b.start()
        assert not second_in.wait(0.3)  # "highest" waits while "default" is held
        first_go.set()
        a.join(timeout=WAIT)
        assert second_in.wait(WAIT)
        b.join(timeout=WAIT)
        assert not a.is_alive() and not b.is_alive()
        assert seen == {"first": INSIDE["default"], "second": INSIDE["highest"]}
        assert switches() == FRESH

    def test_gate_under_stress_never_overlaps_two_precisions(restore_switches):
        """16 threads, each entering scopes of random precisions 200 times
        with the interpreter switching threads every microsecond: inside
        every scope the switches are its own precision's, so no region of
        another precision overlapped it."""
        _set(FRESH)
        interval, bad, done = sys.getswitchinterval(), [], []

        def worker(seed):
            rs = np.random.RandomState(seed)
            for _ in range(200):
                precision = PRECISIONS[rs.randint(len(PRECISIONS))]
                with matmul_precision(precision):
                    for _ in range(3):
                        if switches() != INSIDE[precision]:
                            bad.append((precision, switches()))
            done.append(seed)

        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads) and sorted(done) == list(range(16))
        assert not bad, bad[:3]
        assert switches() == FRESH

    def test_nested_scopes_in_one_thread(restore_switches):
        _set(FRESH)
        with matmul_precision("default"):
            with matmul_precision("default"):  # the same precision: nothing changes
                assert switches() == INSIDE["default"]
            assert switches() == INSIDE["default"]
            with pytest.raises(ValueError):
                with matmul_precision("highest"):
                    pass
            assert switches() == INSIDE["default"]
        assert switches() == FRESH

    # --- the entry points, from the subprocess ------------------------------

    @pytest.fixture(scope="module")
    def runs(tmp_path_factory):
        tmp = tmp_path_factory.mktemp("torch_precision")
        proc = subprocess.Popen([sys.executable, __file__, str(tmp)], cwd=REPO, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        try:
            jax_step = _jax_step()
            _, err = proc.communicate(timeout=600)
        finally:
            proc.kill()
        assert proc.returncode == 0, err[-3000:]
        with np.load(tmp / "step.npz") as z:
            port_step = {k: z[k] for k in z.files}
        return json.loads((tmp / "port.json").read_text()), port_step, jax_step

    def _tags(entry):
        return sorted({tag for tag, _ in entry["inside"]})

    @pytest.mark.parametrize("entry", ["predict", "warmup", "predict_batch"])
    def test_predictor_scopes_its_precision_to_the_call(runs, entry):
        """F1: a Predictor at "default" sets no switch when built, runs its
        decode under TF32 and leaves the switches as it found them."""
        got = runs[0][entry]
        assert got["before"] == got["after_ctor"] == got["after"]
        assert _tags(got) == ["infer_batch"]
        assert [tuple(s) for _, s in got["inside"]] == [INSIDE["default"]] * len(got["inside"])
        if entry == "warmup":
            assert tuple(got["before"]) == FRESH  # cuDNN's TF32 on before: on again after
            assert len(got["inside"]) == 2  # one batch a chunk bucket

    @pytest.mark.parametrize("entry", ["layout", "packed_maps", "finetune"])
    def test_layout_model_runs_at_highest_and_restores(runs, entry):
        got = runs[0][entry]
        assert got["before"] == got["after_ctor"] == got["after"]
        tag = "segformer_loss" if entry == "finetune" else "predict_maps"
        assert _tags(got) == [tag]
        assert [tuple(s) for _, s in got["inside"]] == [INSIDE["highest"]] * len(got["inside"])
        if entry == "finetune":
            assert len(got["inside"]) == 2 and np.isfinite(got["losses"]).all()
        else:
            assert tuple(got["before"]) == INSIDE["default"]  # TF32 on around the detector, off inside it

    @pytest.mark.parametrize("precision", ["default", "highest"])
    def test_train_runs_under_the_configured_precision(runs, precision):
        """F2: every step's forward and Adam update and every eye test run
        under ``runtime.matmul_precision``; the switches are restored."""
        got = runs[0][f"train/{precision}"]
        assert got["before"] == got["after"] and tuple(got["before"]) != INSIDE[precision]
        assert [tuple(s) for _, s in got["inside"]] == [INSIDE[precision]] * len(got["inside"])
        counts = {t: sum(tag == t for tag, _ in got["inside"]) for t in ("forward_train", "adam_update", "eval_forward")}
        assert counts == {"forward_train": got["steps"], "adam_update": got["steps"], "eval_forward": got["steps"]}
        assert got["steps"] == 2

    def test_default_precision_step_matches_jax(runs):
        _, port, ref = runs
        assert abs(float(port["loss"]) - ref["loss"]) <= 1e-5 * abs(ref["loss"])
        assert abs(float(port["grad_norm"]) - ref["grad_norm"]) <= 1e-4 * abs(ref["grad_norm"])
        assert sorted(k[7:] for k in port if k.startswith("params/")) == sorted(ref["params"])
        for name, want in ref["params"].items():
            np.testing.assert_allclose(port[f"params/{name}"], want, rtol=0, atol=2 * LR + 1e-6, err_msg=name)
        for name, want in ref["stats"].items():
            np.testing.assert_allclose(port[f"stats/{name}"], want, rtol=0, atol=1e-5, err_msg=name)

    def test_process_pages_with_two_precisions_ends_and_reads_the_same_texts(runs):
        res = runs[0]
        mixed, plain = res["pages/default"], res["pages/highest"]
        assert mixed["finished"] and plain["finished"]
        assert mixed["texts"] == plain["texts"] and len(mixed["texts"]) == N_PAGES
        for entry, rec in ((mixed, "default"), (plain, "highest")):
            tags = {tag: {tuple(s) for t, s in entry["inside"] if t == tag} for tag in ("predict_maps", "infer_batch")}
            assert tags == {"predict_maps": {INSIDE["highest"]}, "infer_batch": {INSIDE[rec]}}
            assert tuple(entry["after"]) == ALL_OFF


if __name__ == "__main__":
    _port_main(Path(sys.argv[1]))
