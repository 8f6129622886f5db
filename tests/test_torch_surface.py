"""The port's public surface against the JAX package's, and the four faults
that a walk of it found.

* Every module of khmer_ocr_tpu/ has a counterpart at the same relative path
  in khmer_ocr_torch/ (``ops/pallas/`` maps onto ``ops/kernels/`` through
  the kernel table, K1-K3's entry points onto their wrappers). Each public
  name that a JAX module defines at top level (a function, a class, or an
  UPPER_CASE constant) is defined or imported there, or served by its
  ``__getattr__``; so are the public methods and dataclass fields of the
  classes both define, and each keyword parameter of the functions both
  define (JAX's plumbing parameters aside: ``PLUMBING``). What the port
  leaves out by design stands in ``EXCEPTIONS``, each entry with a reason
  that ROADMAP.md states in "Not ported, by design" or "Deviations kept"; a
  name the port renamed or moved stands in ``RENAMED`` with the port's
  name, which must exist. Both packages are read with ``ast``; neither is
  imported for this.
* E1: each subpackage's ``__all__`` is the JAX package's (``parallel``
  without ``batch_sharding`` and ``replicate``, ``utils`` without the XLA
  compile cache), and ``from khmer_ocr_torch.<sub> import <name>`` gives
  the submodule's own object, while importing the subpackage loads no
  torch, Pillow or OpenCV.
* T3: a resumed ``train()`` starts at ``step // steps_per_epoch + 1``, as
  the JAX package's: 6 lines of one width at batch 4 (two steps an epoch,
  ``steps_per_epoch`` 1), one epoch, then a resume from ``epoch001`` with
  ``num_epochs=3`` runs epoch 3 alone and ends at step 4 in both.
* E2: ``native/imageio.py`` returns float32 ``uint8 / 255`` by default and
  uint8 with ``as_uint8=True``, and binds ``resize_gray_mem_batch``. The
  JAX package's loader is not called here: its build races other workers
  on one temporary name.
* E3: ``preprocess.binarize_image`` takes a PIL image and returns a mode-L
  PIL image, as the JAX package's; an array still gives an array.
* ``utils/`` (``StageTimes``, ``stage_timer``, ``profile_trace``,
  ``setup_logging``) and the port's console scripts in pyproject.toml.

The torch-side checks run in one subprocess (this file run as a script);
the JAX package's ``train()`` runs in the pytest process.
"""

from __future__ import annotations

import ast
import dataclasses
import functools
import json
import logging
import subprocess
import sys
import tomllib
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = REPO / "khmer_ocr_tpu", REPO / "khmer_ocr_torch"
JAX_MODULES = sorted(p.relative_to(JAX_PKG).as_posix() for p in JAX_PKG.rglob("*.py"))
SUBPACKAGES = sorted(p.parent.name for p in JAX_PKG.glob("*/__init__.py"))
PLUMBING = frozenset({"ctx", "rng", "key", "interpret", "use_pallas", "donate", "mesh", "devices", "optimizer",
                      "template"})

# each reason is the bold title of a bullet of ROADMAP.md's "Not ported, by design" or "Deviations kept"
CACHE = "`utils/cache.py::enable_compilation_cache`"
MOSAIC = "The Mosaic and XLA switches"
TRANSFER = "`RuntimeConfig.transfer_uint8` and `transfer_lines`"
GROUPED = "Grouped dispatch and `max_group_combos`"
MESH = "`RuntimeConfig.mesh_data_axis` and `mesh_model_axis`"
FUNCTIONAL = "The functional model API"
XLA_STEP = "The XLA decode step's alternatives"
RENAMES = "Names renamed or moved"

# (JAX module, name) or (JAX module, "function(parameter)"), "Class.field" for members -> reason
EXCEPTIONS = {
    ("config.py", "DecodeConfig.fused_mode"): MOSAIC,
    ("config.py", "RuntimeConfig.mesh_data_axis"): MESH,
    ("config.py", "RuntimeConfig.mesh_model_axis"): MESH,
    ("config.py", "RuntimeConfig.max_group_combos"): GROUPED,
    ("config.py", "RuntimeConfig.transfer_uint8"): TRANSFER,
    ("config.py", "RuntimeConfig.transfer_lines"): TRANSFER,
    ("preprocess.py", "PreparedBatch.chunks"): TRANSFER,
    ("parallel/mesh.py", "DATA_AXIS"): MESH,
    ("parallel/mesh.py", "MODEL_AXIS"): MESH,
    ("parallel/mesh.py", "batch_sharding"): MESH,
    ("parallel/mesh.py", "replicate"): MESH,
    ("parallel/mesh.py", "stacked_batch_sharding"): MESH,
    ("utils/cache.py", "enable_compilation_cache"): CACHE,
    ("detection/segformer.py", "encoder_forward"): FUNCTIONAL,
    ("detection/segformer.py", "decode_head_forward"): FUNCTIONAL,
    ("detection/segformer.py", "segformer_logits"): FUNCTIONAL,
    ("detection/segformer.py", "predict_maps(params)"): FUNCTIONAL,
    ("detection/segformer.py", "predict_maps(cfg)"): FUNCTIONAL,
    ("detection/segformer.py", "convert_hf_state_dict(cfg)"): FUNCTIONAL,
    ("detection/train.py", "decode_head_train"): FUNCTIONAL,
    ("detection/train.py", "segformer_loss(params)"): FUNCTIONAL,
    ("detection/train.py", "segformer_loss(cfg)"): FUNCTIONAL,
    ("detection/train.py", "make_train_step(cfg)"): FUNCTIONAL,
    ("detection/train.py", "finetune(params)"): FUNCTIONAL,
    ("detection/train.py", "flatten_params(tree)"): FUNCTIONAL,
    ("detection/train.py", "flatten_params(prefix)"): FUNCTIONAL,
    ("models/backbones.py", "conv2d(stride)"): FUNCTIONAL,
    ("models/backbones.py", "conv2d(padding)"): FUNCTIONAL,
    ("models/backbones.py", "max_pool"): FUNCTIONAL,
    ("models/backbones.py", "conv_bn_relu(new_stats)"): FUNCTIONAL,
    ("models/backbones.py", "se_vgg_apply(s)"): FUNCTIONAL,
    ("models/backbones.py", "vgg_apply(s)"): FUNCTIONAL,
    ("models/backbones.py", "resnet_apply(s)"): FUNCTIONAL,
    **{("models/backbones.py", n): FUNCTIONAL for n in ("conv_init", "bn_init", "se_init", "se_vgg_init", "vgg_init",
                                                        "basic_block_init", "resnet_init", "BACKBONE_INIT")},
    ("models/bilstm.py", "lstm_dir_init"): FUNCTIONAL,
    ("models/bilstm.py", "bilstm_init"): FUNCTIONAL,
    **{("models/layers.py", n): FUNCTIONAL for n in ("RngStream", "Ctx", "linear_init", "xavier_linear_init",
                                                     "mha_init", "ln_init", "encoder_layer_init",
                                                     "decoder_layer_init", "trunc_normal")},
    ("train/step.py", "make_optimizer"): FUNCTIONAL,
    **{("models/layers.py", n): XLA_STEP for n in ("mha_precompute_kv", "mha_step", "mha_step_grouped",
                                                   "mha_project_kv_step")},
    ("models/ocr_model.py", "pack_decode_params(fused)"): XLA_STEP,
    ("models/ocr_model.py", "pack_decode_params(head_dtype)"): XLA_STEP,
    ("models/ocr_model.py", "decode_step(lineage_idx)"): XLA_STEP,
    ("models/ocr_model.py", "decode_step(fused)"): XLA_STEP,
    ("models/ocr_model.py", "decode_step(head)"): XLA_STEP,
    ("ops/pallas/lstm.py", "MAX_TILE"): MOSAIC,
    ("ops/pallas/lstm.py", "pallas_lstm_available"): MOSAIC,
    ("ops/pallas/lstm.py", "lstm_recurrence(hidden)"): MOSAIC,
    ("ops/pallas/lstm.py", "lstm_recurrence_vjp(hidden)"): MOSAIC,
    **{("ops/pallas/decode_step.py", n): MOSAIC for n in ("LN_EPS", "VMEM_BUDGET", "VMEM_LIMIT", "choose_tile",
                                                          "fused_step_available", "should_use_fused",
                                                          "head_fusion_compatible")},
    **{("ops/pallas/decode_loop.py", n): MOSAIC for n in ("NEG_INF", "LN_EPS", "megakernel_available")},
    **{("ops/pallas/decode_loop.py", f"should_use_megakernel({p})"): MOSAIC
       for p in ("b_rows", "d", "f", "num_heads", "itemsize")},
}

# (JAX module, name) -> the port's module and name; the reason is RENAMES
RENAMED = {
    ("evaluate.py", "make_tpu_recognizer"): ("evaluate.py", "make_recognizer"),
    ("train/step.py", "make_eval_logits_fn"): ("train/step.py", "eval_logits"),
    ("models/backbones.py", "SE_VGG_CHANNELS"): ("convert/from_jax.py", "SE_VGG_CHANNELS"),
    ("models/backbones.py", "RESNET_STAGES"): ("convert/from_jax.py", "RESNET_STAGES"),
}

# the TPU kernels' entry points -> their wrappers in the port (PERF.md's kernel table)
KERNELS = {
    "K1": (("ops/pallas/lstm.py", "lstm_recurrence"), ("ops/kernels/lstm.py", "lstm_recurrence")),
    "K1b": (("ops/pallas/lstm.py", "lstm_recurrence_vjp"), ("ops/kernels/lstm.py", "LSTMRecurrence")),
    "K2": (("ops/pallas/decode_step.py", "fused_decoder_layer_step"),
           ("ops/kernels/decode_step.py", "decoder_layer_step")),
    "K3": (("ops/pallas/decode_loop.py", "fused_beam_decode"), ("ops/kernels/decode_loop.py", "fused_beam_decode")),
}

# subpackage __all__: what the port leaves out of the JAX package's, and adds to it
LEFT_OUT = {"parallel": {"batch_sharding", "replicate"}, "utils": {"enable_compilation_cache"}}
ADDED = {"decode": {"topk_iter"}}
# where the port's object lives when the JAX package's __init__ takes it from another submodule
SOURCE = {("parallel", "param_sharding"): "placement"}


# ---- the ast walk --------------------------------------------------------------------------------------------------


def port_rel(rel: str) -> str:
    return rel.replace("ops/pallas/", "ops/kernels/")


@functools.cache
def parse(path: Path) -> ast.Module | None:
    return ast.parse(path.read_text(encoding="utf-8")) if path.exists() else None


def is_public(name: str) -> bool:
    return not name.startswith("_")


def public_names(tree: ast.Module) -> dict:
    """Top-level functions, classes and UPPER_CASE constants -> their nodes."""
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) and is_public(node.name):
            out[node.name] = node
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for t in node.targets if isinstance(node, ast.Assign) else [node.target]:
                if isinstance(t, ast.Name) and is_public(t.id) and t.id.isupper():
                    out[t.id] = node
    return out


def bound_names(tree: ast.Module) -> dict:
    """Every name bound at the module's top level -> its node (defs, classes,
    assignments, imports)."""
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, ast.Assign):
            out.update({t.id: node for t in node.targets if isinstance(t, ast.Name)})
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out[node.target.id] = node
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update({(a.asname or a.name).split(".")[0]: node for a in node.names})
    return out


def static_all(tree: ast.Module) -> list[str]:
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return [ast.literal_eval(e) for e in node.value.elts]
    return []


def served_names(tree: ast.Module) -> set[str]:
    """Names a module's ``__getattr__`` serves: the strings its body compares
    ``name`` with, or, where ``__getattr__`` is assigned (``_exports.py``'s
    ``lazy_getattr``), the module's ``__all__``."""
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == "__getattr__":
            return {c.value for c in ast.walk(node) if isinstance(c, ast.Constant) and isinstance(c.value, str)}
        if isinstance(node, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "__getattr__"
                                                for t in node.targets):
            return set(static_all(tree))
    return set()


def resolve(path: Path, name: str, depth: int = 0):
    """The node that defines ``name`` in the port's module ``path``, through
    its relative imports."""
    tree = parse(path)
    node = bound_names(tree).get(name) if tree is not None else None
    if isinstance(node, ast.ImportFrom) and node.level and depth < 8:
        base = path.parent
        for _ in range(node.level - 1):
            base = base.parent
        mod = base.joinpath(*node.module.split(".")) if node.module else base
        target = mod.with_suffix(".py") if mod.with_suffix(".py").exists() else mod / "__init__.py"
        for a in node.names:
            if (a.asname or a.name) == name:
                return resolve(target, a.name, depth + 1)
    return node


def params(fn) -> list[str]:
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs if x.arg not in ("self", "cls")]


def fields(cls: ast.ClassDef) -> list[str]:
    return [n.target.id for n in cls.body if isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name)]


def methods(cls: ast.ClassDef) -> dict:
    return {n.name: n for n in cls.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def missing_params(label: str, jfn, pfn) -> list[str]:
    return [f"{label}({p})" for p in params(jfn) if p not in PLUMBING and p not in params(pfn)]


def gaps(rel: str) -> list[str]:
    """What the port's counterpart of the JAX module ``rel`` lacks: names,
    "Class.member" and "function(parameter)" entries."""
    jtree = parse(JAX_PKG / rel)
    ppath = PORT_PKG / port_rel(rel)
    ptree = parse(ppath)
    renamed = {name for (mod, name) in RENAMED if mod == rel}
    kernels = {name: PORT_PKG / pmod for (mod, name), (pmod, _) in KERNELS.values() if mod == rel}
    wrappers = {name: pname for (mod, name), (_, pname) in KERNELS.values() if mod == rel}
    out = []
    for name, wrapper in kernels.items():  # a wrapper takes its TPU kernel's parameters
        jnode, pnode = public_names(jtree)[name], resolve(wrapper, wrappers[name])
        if isinstance(pnode, ast.ClassDef):  # an autograd Function: its forward
            pnode = methods(pnode)["forward"]
        if isinstance(jnode, ast.FunctionDef):
            out += missing_params(name, jnode, pnode)
    if ptree is None:
        return sorted(out + [n for n in public_names(jtree) if n not in renamed and n not in kernels])
    bound, served = bound_names(ptree), served_names(ptree)
    for name, jnode in public_names(jtree).items():
        if name in renamed or name in kernels:
            continue
        if name not in bound and name not in served:
            out.append(name)
            continue
        pnode = resolve(ppath, name)
        funcs = (ast.FunctionDef, ast.AsyncFunctionDef)
        if isinstance(jnode, funcs) and isinstance(pnode, funcs):
            out += missing_params(name, jnode, pnode)
        if isinstance(jnode, ast.ClassDef) and isinstance(pnode, ast.ClassDef):
            out += [f"{name}.{f}" for f in fields(jnode) if is_public(f) and f not in fields(pnode)]
            pm = methods(pnode)
            for m, jm in methods(jnode).items():
                if m in pm:
                    if is_public(m) or m == "__init__":
                        out += missing_params(f"{name}.{m}", jm, pm[m])
                elif is_public(m):
                    out.append(f"{name}.{m}")
    return sorted(out)


def roadmap_sections() -> str:
    text = (REPO / "ROADMAP.md").read_text(encoding="utf-8")
    by_design = text[text.index("\nNot ported, by design"):text.index("### Queue 2")]
    kept = text[text.index("Deviations kept from the reference."):text.index("Record each new fault with:")]
    return by_design + kept


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_module_surface_is_the_jax_package_s(rel):
    """Each public name, member and keyword parameter of the JAX module is in
    the port's counterpart, or in the exception table."""
    unexplained = [g for g in gaps(rel) if (rel, g) not in EXCEPTIONS]
    assert not unexplained, f"khmer_ocr_torch/{port_rel(rel)} lacks {unexplained}"


def test_every_exception_is_a_gap():
    """No entry of the table is stale: each names something the port lacks."""
    found = {(rel, g) for rel in JAX_MODULES for g in gaps(rel)}
    assert not set(EXCEPTIONS) - found, sorted(set(EXCEPTIONS) - found)


@pytest.mark.parametrize("reason", sorted({*EXCEPTIONS.values(), RENAMES}))
def test_every_reason_stands_in_the_roadmap(reason):
    assert f"**{reason}" in roadmap_sections()


@pytest.mark.parametrize("old", sorted(RENAMED), ids=[f"{m}::{n}" for m, n in sorted(RENAMED)])
def test_renamed_name_exists_in_the_port(old):
    jmod, jname = old
    pmod, pname = RENAMED[old]
    assert jname in public_names(parse(JAX_PKG / jmod))
    assert pname in bound_names(parse(PORT_PKG / pmod)), f"khmer_ocr_torch/{pmod} has no {pname}"
    assert f"`{pname}`" in roadmap_sections() and f"`{jname}`" in roadmap_sections()


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_kernel_entry_point_has_its_wrapper(kernel):
    (jmod, jname), (pmod, pname) = KERNELS[kernel]
    assert isinstance(public_names(parse(JAX_PKG / jmod)).get(jname), (ast.FunctionDef, ast.Assign))
    assert isinstance(bound_names(parse(PORT_PKG / pmod)).get(pname), (ast.FunctionDef, ast.ClassDef))


# ---- E1: the subpackages' exports ----------------------------------------------------------------------------------


def jax_exports(sub: str) -> dict[str, str]:
    """The JAX subpackage's ``__all__`` -> the submodule each name is imported from."""
    tree = parse(JAX_PKG / sub / "__init__.py")
    source = {a.asname or a.name: node.module for node in tree.body if isinstance(node, ast.ImportFrom)
              for a in node.names}
    return {name: source[name] for name in static_all(tree)}


def port_exports(sub: str) -> dict[str, str]:
    """The names the port's subpackage must serve -> its submodule of each."""
    return {name: SOURCE.get((sub, name), module) for name, module in jax_exports(sub).items()
            if name not in LEFT_OUT.get(sub, ())}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_all_equals_jax(sub):
    got = static_all(parse(PORT_PKG / sub / "__init__.py"))
    assert len(got) == len(set(got))
    assert set(got) == set(port_exports(sub)) | ADDED.get(sub, set())


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_surface")
    spec = {sub: port_exports(sub) for sub in SUBPACKAGES}
    (tmp / "exports.json").write_text(json.dumps(spec))
    subprocess.run([sys.executable, __file__, str(tmp)], cwd=REPO, check=True, timeout=300)
    return json.loads((tmp / "result.json").read_text())


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_names_resolve_to_the_submodule_s_own(port_run, sub):
    """``from khmer_ocr_torch.<sub> import <name>`` works, and gives the very
    object of the submodule the name comes from."""
    assert port_run["exports"][sub] == {name: "same" for name in port_exports(sub)}


def test_importing_the_subpackages_loads_no_torch_pillow_or_opencv(port_run):
    assert port_run["light_import"] == []


# ---- T3: the epoch a resumed train() starts at ---------------------------------------------------------------------

TINY = dict(vocab_size=124, emb_dim=64, num_heads=4, enc_layers=1, dec_layers=1, enc_ffn_dim=128,
            max_global_len=256, decode_max_len=16, backbone="vgg", use_bilstm=False)
RESUME_TRAIN = dict(batch_size=4, epoch_sample_size=8, checkpoint_every_epochs=1, seed=0)


def resume_samples():
    """6 lines of one width: an epoch is a batch of 4 and a padded tail of 2,
    and ``steps_per_epoch`` is 6 // 4 = 1."""
    return [(np.full((30, 120), 255, np.uint8), "១២៣") for _ in range(6)]


def record_resume(tmp: Path, train, dataset, cfg, **kw) -> dict:
    """One epoch, then a resume from its checkpoint with num_epochs=3 -> the
    steps, the resumed run's epochs and checkpoints, and its log's start."""
    logged = []
    handler = logging.Handler()
    handler.emit = lambda r: logged.append(r.getMessage())
    log = logging.getLogger(train.__module__)
    log.addHandler(handler)
    old_level = log.level
    log.setLevel(logging.INFO)
    try:
        first = train(dataset, cfg, checkpoint_dir=tmp / "first", num_epochs=1, **kw)
        resumed = train(dataset, cfg, checkpoint_dir=tmp / "resumed", num_epochs=3,
                        resume_from=tmp / "first" / "epoch001", metrics_path=tmp / "resumed.jsonl", **kw)
    finally:
        log.removeHandler(handler)
        log.setLevel(old_level)
    metrics = [json.loads(line) for line in (tmp / "resumed.jsonl").read_text().splitlines()]
    return {"first_step": int(first.step), "final_step": int(resumed.step),
            "epochs": [(m["epoch"], m["batches"]) for m in metrics],
            "checkpoints": sorted(p.name for p in (tmp / "resumed").iterdir()),
            "start": [m.rsplit("(", 1)[-1] for m in logged if m.startswith("resumed from")]}


@pytest.fixture(scope="module")
def jax_resume(tmp_path_factory):
    from khmer_ocr_tpu.config import ModelConfig, OCRConfig, TrainConfig
    from khmer_ocr_tpu.train.data import LineDataset
    from khmer_ocr_tpu.train.loop import train

    cfg = OCRConfig(model=ModelConfig(**TINY), train=dataclasses.replace(TrainConfig(), **RESUME_TRAIN))
    return record_resume(tmp_path_factory.mktemp("jax_resume"), train, LineDataset(resume_samples()), cfg)


def test_resume_ends_at_the_jax_package_s_step(port_run, jax_resume):
    assert jax_resume["first_step"] == port_run["resume"]["first_step"] == 2
    assert jax_resume["final_step"] == port_run["resume"]["final_step"] == 4


def test_resume_runs_the_jax_package_s_epochs(port_run, jax_resume):
    assert jax_resume["epochs"] == [(3, 2)]
    assert [tuple(e) for e in port_run["resume"]["epochs"]] == jax_resume["epochs"]


def test_resume_saves_the_jax_package_s_checkpoints(port_run, jax_resume):
    assert port_run["resume"]["checkpoints"] == jax_resume["checkpoints"] == ["epoch003"]


def test_resume_logs_the_jax_package_s_start_epoch(port_run, jax_resume):
    assert port_run["resume"]["start"] == jax_resume["start"] == ["epoch 3)"]


# ---- E2: the native image loader -----------------------------------------------------------------------------------

MODES = ("L", "RGB", "RGBA")


def pil_line(img, out_h: int = 48, min_w: int = 50):
    from PIL import Image

    w = max(min_w, int(out_h * img.width / img.height))
    return np.asarray(img.convert("L").resize((w, out_h), Image.Resampling.BILINEAR))


def make_image(mode: str, seed: int):
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(20, 60)), int(rng.integers(40, 300))
    shape = (h, w) if mode == "L" else (h, w, len(mode))
    return Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8), mode)


@pytest.fixture(scope="module")
def native():
    from khmer_ocr_torch.native import imageio

    if imageio.load_imageio_library() is None and imageio.unavailable_reason():
        pytest.skip(f"the native loader did not compile here: {imageio.unavailable_reason()}")
    return imageio


@pytest.mark.parametrize("mode", MODES)
def test_load_resize_gray_returns_float_over_255_by_default(native, tmp_path, mode):
    img = make_image(mode, len(mode))
    img.save(tmp_path / "line.png")
    got = native.load_resize_gray(tmp_path / "line.png")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, pil_line(img).astype(np.float32) / 255.0)


@pytest.mark.parametrize("mode", MODES)
def test_load_resize_gray_as_uint8_is_pillow_s_pixels(native, tmp_path, mode):
    img = make_image(mode, 10 + len(mode))
    img.save(tmp_path / "line.png")
    got = native.load_resize_gray(tmp_path / "line.png", as_uint8=True)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, pil_line(img))


@pytest.mark.parametrize("mode", MODES)
def test_resize_gray_mem_float_by_default_and_uint8_on_request(native, mode):
    img = make_image(mode, 20 + len(mode))
    arr = np.asarray(img)
    got, raw = native.resize_gray_mem(arr), native.resize_gray_mem(arr, as_uint8=True)
    assert got.dtype == np.float32 and raw.dtype == np.uint8
    np.testing.assert_array_equal(raw, pil_line(img))
    np.testing.assert_array_equal(got, raw.astype(np.float32) / 255.0)


def test_resize_gray_mem_batch_equals_resize_gray_mem_row_by_row(native):
    images = [np.asarray(make_image(MODES[i % 3], 30 + i)) for i in range(7)]
    images.append(images[0][:, ::2])  # a strided view
    buf, widths, errs = native.resize_gray_mem_batch(images, cap_w=256, n_threads=3)
    assert buf.shape == (len(images), 48, 256) and buf.dtype == np.uint8
    assert errs.tolist() == [0] * len(images)
    for i, arr in enumerate(images):
        one = native.resize_gray_mem(arr, cap_w=256, as_uint8=True)
        assert widths[i] >= one.shape[1]
        np.testing.assert_array_equal(buf[i, :, :min(int(widths[i]), 256)], one, err_msg=str(i))


def test_resize_gray_mem_batch_marks_arrays_it_cannot_take(native):
    good = np.asarray(make_image("L", 40))
    images = [good, good.astype(np.float32) / 255.0, np.zeros((4, 5, 2), np.uint8), good]
    out = np.zeros((6, 48, 512), np.uint8)
    buf, widths, errs = native.resize_gray_mem_batch(images, cap_w=512, out=out)
    assert errs.tolist() == [0, 2, 2, 0] and widths[1] == widths[2] == 0
    assert buf.base is out or buf.base is out.base
    np.testing.assert_array_equal(buf[3, :, :widths[3]], native.resize_gray_mem(good, cap_w=512, as_uint8=True))


def test_without_the_library_every_entry_returns_none(monkeypatch, tmp_path):
    from khmer_ocr_torch.native import imageio

    monkeypatch.setattr(imageio, "load_imageio_library", lambda: None)
    arr = np.zeros((10, 20), np.uint8)
    assert imageio.load_resize_gray(tmp_path / "none.png") is None
    assert imageio.load_resize_gray(tmp_path / "none.png", as_uint8=True) is None
    assert imageio.load_resize_gray_batch([tmp_path / "none.png"]) is None
    assert imageio.resize_gray_mem(arr) is None
    assert imageio.resize_gray_mem_batch([arr]) is None


# ---- E3: binarize_image --------------------------------------------------------------------------------------------


@pytest.fixture
def opencv_without_ipp():
    """OpenCV's own Otsu code: with Intel IPP, which of two exactly tied
    levels wins depends on IPP's arithmetic (tests/test_torch_eval.py)."""
    import cv2

    saved = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        yield
    finally:
        cv2.ipp.setUseIPP(saved)


def ink_line(seed: int) -> np.ndarray:
    """A light page with dark strokes and noise, uint8 (H, W)."""
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(20, 60)), int(rng.integers(60, 300))
    arr = rng.normal(225, 12, (h, w))
    for _ in range(int(rng.integers(3, 12))):
        r, c = int(rng.integers(0, h)), int(rng.integers(0, w))
        arr[max(0, r - 3):r + 3, max(0, c - 6):c + 6] = rng.normal(40, 10)
    return np.clip(arr, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_binarize_image_takes_and_gives_pil_as_the_jax_package(opencv_without_ipp, seed):
    from PIL import Image

    from khmer_ocr_torch.preprocess import binarize_image
    from khmer_ocr_tpu.preprocess import binarize_image as jax_binarize_image

    img = Image.fromarray(ink_line(seed))
    got, want = binarize_image(img), jax_binarize_image(img)
    assert isinstance(got, Image.Image) and got.mode == want.mode == "L" and got.size == want.size
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_binarize_image_of_an_array_is_an_array(opencv_without_ipp):
    from PIL import Image

    from khmer_ocr_torch.preprocess import binarize_image
    from khmer_ocr_tpu.preprocess import binarize_image as jax_binarize_image

    arr = ink_line(3)
    got = binarize_image(arr)
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, np.asarray(jax_binarize_image(Image.fromarray(arr))))


# ---- utils/ --------------------------------------------------------------------------------------------------------


def test_stage_times_summary_equals_jax():
    from khmer_ocr_torch.utils import StageTimes
    from khmer_ocr_tpu.utils.profiling import StageTimes as JaxStageTimes

    port, ref = StageTimes(), JaxStageTimes()
    for name, seconds in [("decode", 0.5), ("encode", 0.125), ("decode", 0.25), ("prepare", 0.0625)]:
        port.add(name, seconds)
        ref.add(name, seconds)
    assert port.summary() == ref.summary() and port == StageTimes(ref.totals, ref.counts)


def test_stage_timer_adds_the_block_s_seconds():
    import time

    from khmer_ocr_torch.utils import StageTimes, stage_timer

    times = StageTimes()
    for _ in range(2):
        with stage_timer(times, "sleep"):
            time.sleep(0.01)
    assert times.counts == {"sleep": 2} and times.totals["sleep"] >= 0.02


def test_stage_timer_waits_on_a_tensor_and_refuses_other_syncs(port_run):
    assert port_run["utils"]["tensor_sync_counts"] == {"step": 1}
    assert port_run["utils"]["bad_sync"].startswith("TypeError")


def test_profile_trace_writes_a_chrome_trace_on_the_cpu(port_run):
    files = port_run["utils"]["trace_files"]
    assert len(files) == 1 and files[0]["name"].startswith("trace_") and files[0]["name"].endswith(".json")
    assert files[0]["yielded"] and files[0]["events"] > 0 and files[0]["matmul"]


def test_profile_trace_disabled_writes_nothing(port_run):
    assert port_run["utils"]["disabled"] == {"yielded": None, "files": []}


def test_setup_logging_configures_as_the_jax_package(monkeypatch):
    from khmer_ocr_torch.utils import setup_logging
    from khmer_ocr_tpu.utils.logging import setup_logging as jax_setup_logging

    calls = []
    monkeypatch.setattr(logging, "basicConfig", lambda **kw: calls.append(kw))
    setup_logging(logging.DEBUG)
    jax_setup_logging(logging.DEBUG)
    setup_logging()
    jax_setup_logging()
    assert calls[0] == calls[1] and calls[2] == calls[3] and calls[0]["level"] == logging.DEBUG


# ---- console scripts -----------------------------------------------------------------------------------------------

SCRIPTS = tomllib.loads((REPO / "pyproject.toml").read_text(encoding="utf-8"))["project"]["scripts"]
JAX_SCRIPTS = sorted(k for k, v in SCRIPTS.items() if v.startswith("khmer_ocr_tpu."))


@pytest.mark.parametrize("script", JAX_SCRIPTS)
def test_console_script_has_a_port_counterpart(script):
    """khmer-ocr-X -> khmer-ocr-torch-X, on the port's module of the same
    relative path, whose ``main`` exists."""
    port = script.replace("khmer-ocr", "khmer-ocr-torch", 1)
    assert port in SCRIPTS
    module, func = SCRIPTS[port].split(":")
    assert module == SCRIPTS[script].split(":")[0].replace("khmer_ocr_tpu", "khmer_ocr_torch", 1) and func == "main"
    path = REPO.joinpath(*module.split(".")).with_suffix(".py")
    assert isinstance(bound_names(parse(path)).get("main"), ast.FunctionDef)


# ---- the torch side (this file run as a script) --------------------------------------------------------------------


def _exports_main(spec: dict) -> dict:
    import importlib

    out = {}
    for sub, names in spec.items():
        got = {}
        for name, module in names.items():
            try:
                scope: dict = {}
                exec(f"from khmer_ocr_torch.{sub} import {name}", scope)
                own = getattr(importlib.import_module(f"khmer_ocr_torch.{sub}.{module}"), name)
                got[name] = "same" if scope[name] is own else f"another object than {sub}.{module}'s"
            except Exception as e:  # recorded and asserted on by the tests
                got[name] = f"{type(e).__name__}: {e}"
        out[sub] = got
    return out


def _utils_main(tmp: Path) -> dict:
    import torch

    from khmer_ocr_torch.utils import StageTimes, profile_trace, stage_timer

    res = {}
    times = StageTimes()
    with stage_timer(times, "step", sync=torch.ones(3) * 2):
        pass
    res["tensor_sync_counts"] = times.counts
    try:
        with stage_timer(StageTimes(), "step", sync=[1.0]):
            pass
        res["bad_sync"] = "returned"
    except Exception as e:  # recorded and asserted on by the tests
        res["bad_sync"] = f"{type(e).__name__}: {e}"
    with profile_trace(tmp / "traces") as path:
        torch.randn(64, 64) @ torch.randn(64, 64)
    files = []
    for p in sorted((tmp / "traces").iterdir()):
        events = json.loads(p.read_text())["traceEvents"]
        files.append({"name": p.name, "yielded": p == path, "events": len(events),
                      "matmul": any("mm" in str(e.get("name", "")) for e in events)})
    res["trace_files"] = files
    with profile_trace(tmp / "off", enabled=False) as path:
        torch.ones(2) + 1
    res["disabled"] = {"yielded": path, "files": sorted(p.name for p in (tmp / "off").glob("*"))}
    return res


def _port_main(tmp: Path) -> None:
    sys.path.insert(0, str(REPO))
    subs = [s for s in SUBPACKAGES if s not in ("decode", "native")]  # these two import eagerly, as before
    probe = (f"import json, sys\nimport {', '.join(f'khmer_ocr_torch.{s}' for s in subs)}\n"
             "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'PIL', 'cv2', 'jax'))))")
    light = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True, check=True)
    res = {"light_import": json.loads(light.stdout.strip().splitlines()[-1]),
           "exports": _exports_main(json.loads((tmp / "exports.json").read_text()))}

    from khmer_ocr_torch.config import ModelConfig, OCRConfig, TrainConfig
    from khmer_ocr_torch.train.data import LineDataset
    from khmer_ocr_torch.train.loop import train

    cfg = OCRConfig(model=ModelConfig(**TINY), train=dataclasses.replace(TrainConfig(), **RESUME_TRAIN))
    (tmp / "resume").mkdir()
    res["resume"] = record_resume(tmp / "resume", train, LineDataset(resume_samples()), cfg, device="cpu")
    res["utils"] = _utils_main(tmp)
    (tmp / "result.json").write_text(json.dumps(res))


if __name__ == "__main__":
    _port_main(Path(sys.argv[1]))
