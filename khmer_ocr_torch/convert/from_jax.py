"""Weights from the JAX package's layout into the port's state, with numpy only.

The JAX package keeps its weights as a ``params`` tree and a ``batch_stats``
tree (nested dicts, lists for the encoder and decoder layers). This module
takes those trees as nested dicts of numpy arrays, however they were loaded,
and never imports JAX:

  * ``params_from_jax`` builds the port's state for the se_vgg, vgg and
    resnet backbones: conv kernels HWIO -> OIHW, BatchNorm ``scale``/``bias``
    joined with the ``mean``/``var`` statistics (inside ResNet's ``layerN``
    block lists too), dense layers kept as (in, out), LSTM ``w_ih``/``w_hh``
    with their i, f, g, o column blocks as they are, the decoder's
    ``tok_emb``/``pos_emb``/``out``.
    Every leaf is consumed exactly once and every port parameter is set;
    anything else raises.
    ``trainable_from_jax`` makes the training state instead: the same
    params without the statistics, and the statistics apart.
    ``params_to_jax`` is the inverse of both: a model trained by the port
    loads into the JAX package. ``params_from_jax(..., model_group=)``
    takes one rank's part of a tree cut by
    ``parallel/placement.py::shard_params`` for a tensor-parallel model
    group and cuts the biases of the split columns to match.
  * ``save_npz``/``load_npz`` carry such a tree in one compressed .npz
    file, each leaf in its checkpoint dtype: bfloat16 leaves as their uint16
    bit patterns, widened exactly to float32 at load, the rest as float32.
  * ``seeded_params`` makes a tree in the JAX layout from a numpy seed, with
    PyTorch's default initial scales, for runs without trained weights.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

from ..config import ModelConfig
from ..parallel.placement import MODEL_AXIS, local_shape, path_str, spec_for_path

SE_VGG_CHANNELS = [(1, 64), (64, 128), (128, 256), (256, 256), (256, 512), (512, 512), (512, 512)]
SE_BLOCKS = (("se3", 256), ("se4", 512), ("se5", 512))
RESNET_STAGES = [(64, 128, 1), (128, 256, 2), (256, 512, 2), (512, 512, 1)]  # (cin, cout, BasicBlocks)


def _mha_layout(prefix: tuple, d: int) -> list:
    xav = ("u", math.sqrt(6.0 / (2 * d)))
    out = []
    for n in ("q", "k", "v"):
        out += [(prefix + (n, "w"), (d, d), xav), (prefix + (n, "b"), (d,), ("zeros",))]
    out += [(prefix + ("o", "w"), (d, d), ("u", 1 / math.sqrt(d))), (prefix + ("o", "b"), (d,), ("zeros",))]
    return out


def _ln_layout(prefix: tuple, d: int) -> list:
    return [(prefix + ("scale",), (d,), ("ones",)), (prefix + ("bias",), (d,), ("zeros",))]


def _linear_layout(prefix: tuple, din: int, dout: int) -> list:
    u = ("u", 1 / math.sqrt(din))
    return [(prefix + ("w",), (din, dout), u), (prefix + ("b",), (dout,), u)]


def _conv_layout(prefix: tuple, k: int, cin: int, cout: int, bias: bool) -> list:
    u = ("u", 1 / math.sqrt(cin * k * k))
    return [(prefix + ("w",), (k, k, cin, cout), u)] + ([(prefix + ("b",), (cout,), u)] if bias else [])


def _bn_layout(p_prefix: tuple, s_prefix: tuple, c: int) -> tuple[list, list]:
    return ([(p_prefix + ("scale",), (c,), ("bn_scale",)), (p_prefix + ("bias",), (c,), ("bn_bias",))],
            [(s_prefix + ("mean",), (c,), ("bn_mean",)), (s_prefix + ("var",), (c,), ("bn_var",))])


def _backbone_layout(name: str) -> tuple[list, list]:
    """The backbone's params (under "backbone") and batch_stats (at the top of
    that tree) for se_vgg, vgg or resnet."""
    p, s = [], []

    def conv_bn(path: tuple, k: int, cin: int, cout: int, bias: bool, bn_path: tuple | None) -> None:
        p.extend(_conv_layout(("backbone",) + path, k, cin, cout, bias))
        if bn_path is not None:
            bp, bs = _bn_layout(("backbone",) + bn_path, bn_path, cout)
            p.extend(bp)
            s.extend(bs)

    if name in ("se_vgg", "vgg"):
        for i, (cin, cout) in enumerate(SE_VGG_CHANNELS):
            conv = f"conv{i + 1}"
            has_bn = name == "se_vgg" or i < 6  # VGG's conv7 is a plain conv
            conv_bn((conv,), 3, cin, cout, True, (f"bn_{conv}",) if has_bn else None)
        if name == "se_vgg":
            for se, c in SE_BLOCKS:
                p += _linear_layout(("backbone", se, "fc1"), c, c // 16)
                p += _linear_layout(("backbone", se, "fc2"), c // 16, c)
        return p, s
    if name == "resnet":
        conv_bn(("stem_conv",), 3, 1, 64, False, ("stem_bn",))
        for i, (cin, cout, n_blocks) in enumerate(RESNET_STAGES):
            c = cin
            for j in range(n_blocks):
                blk = (f"layer{i + 1}", j)
                conv_bn(blk + ("conv1",), 3, c, cout, False, blk + ("bn1",))
                conv_bn(blk + ("conv2",), 3, cout, cout, False, blk + ("bn2",))
                if c != cout:
                    conv_bn(blk + ("short_conv",), 1, c, cout, False, blk + ("short_bn",))
                c = cout
        return p, s
    raise NotImplementedError(f"backbone {name!r} (se_vgg, vgg or resnet)")


def layout(cfg: ModelConfig) -> tuple[list, list]:
    """The JAX layout of ``cfg``'s trees: ([(path, shape, init)] of params,
    [(path, shape, init)] of batch_stats), in a fixed order. Paths are tuples
    of dict keys and list indices."""
    d, v = cfg.emb_dim, cfg.vocab_size
    hid = d // 2
    p, s = _backbone_layout(cfg.backbone)
    p += _linear_layout(("patch", "proj"), 1024, d)
    p += [(("patch", "pos_emb"), (cfg.patch_max, d), ("tn", 0.02))]
    for i in range(cfg.enc_layers):
        p += _mha_layout(("enc", i, "self"), d)
        p += _ln_layout(("enc", i, "ln1"), d) + _ln_layout(("enc", i, "ln2"), d)
        p += _linear_layout(("enc", i, "lin1"), d, cfg.enc_ffn_dim)
        p += _linear_layout(("enc", i, "lin2"), cfg.enc_ffn_dim, d)
    p += [(("global_pos",), (cfg.max_global_len, d), ("tn", 0.02))]
    p += [(("dec", "tok_emb"), (v, d), ("emb",)), (("dec", "pos_emb"), (cfg.decode_max_len, d), ("tn", 0.1))]
    for i in range(cfg.dec_layers):
        pre = ("dec", "layers", i)
        p += _mha_layout(pre + ("self",), d) + _mha_layout(pre + ("cross",), d)
        p += _ln_layout(pre + ("ln1",), d) + _ln_layout(pre + ("ln2",), d) + _ln_layout(pre + ("ln3",), d)
        p += _linear_layout(pre + ("lin1",), d, cfg.dec_ffn_dim)
        p += _linear_layout(pre + ("lin2",), cfg.dec_ffn_dim, d)
    p += _linear_layout(("dec", "out"), d, v)
    if cfg.use_bilstm:
        u = ("u", 1 / math.sqrt(hid))
        for dr in ("fw", "bw"):
            p += [(("bilstm", dr, "w_ih"), (d, 4 * hid), u), (("bilstm", dr, "w_hh"), (hid, 4 * hid), u),
                  (("bilstm", dr, "b_ih"), (4 * hid,), u), (("bilstm", dr, "b_hh"), (4 * hid,), u)]
    return p, s


def _flatten(tree, prefix: tuple = ()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, prefix + (i,)))
        return out
    return {prefix: tree}


def _unflatten(flat: dict):
    root: dict = {}
    for path, leaf in flat.items():
        node = root
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [fix(node[i]) for i in range(len(node))]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def _port_leaves(params, batch_stats, cfg: ModelConfig, n_model: int = 1):
    """JAX-layout trees -> ({path: float32 array} of the params in the port's
    layout, {path: array} of the statistics at their JAX paths). With
    ``n_model`` > 1 the params are one rank's part of a model axis of that
    many ranks (parallel/placement.py)."""
    flat_p, flat_s = _flatten(params), _flatten(batch_stats)
    p_layout, s_layout = layout(cfg)

    def take(flat, path, shape, what):
        if path not in flat:
            raise ValueError(f"{what} leaf {'/'.join(map(str, path))} is missing")
        arr = np.asarray(flat.pop(path), dtype=np.float32)
        if arr.shape != shape:
            raise ValueError(f"{what} leaf {'/'.join(map(str, path))} has shape {arr.shape}, expected {shape}")
        return arr

    out_p, out_s = {}, {}
    for path, shape, _ in p_layout:
        arr = take(flat_p, path, local_shape(path_str(path), shape, n_model), "params")
        if path[0] == "backbone" and len(shape) == 4:
            arr = arr.transpose(3, 2, 0, 1)  # conv kernels HWIO -> OIHW
        out_p[path] = arr
    for path, shape, _ in s_layout:
        out_s[path] = take(flat_s, path, shape, "batch_stats")
    if flat_p or flat_s:
        extra = sorted("/".join(map(str, k)) for k in list(flat_p) + list(flat_s))
        raise ValueError(f"leaves the port does not use: {extra[:8]}{' ...' if len(extra) > 8 else ''}")
    return out_p, out_s


def _tensors(flat: dict, device):
    import torch

    return _unflatten({k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in flat.items()})


def params_from_jax(params, batch_stats, cfg: ModelConfig, device="cpu", model_group=None):
    """JAX-layout trees (nested dicts/lists of numpy arrays, any float dtype)
    -> the port's inference state: nested dicts of float32 tensors on
    ``device``, the BatchNorm statistics merged into the backbone's params.
    ``model_group``: a tensor-parallel group; ``params`` is then this rank's
    part (``shard_params``), and the biases of its split columns (q, k, v,
    lin1, the vocabulary projection, whole in the JAX package's placement)
    are cut to its columns, so the decoder's packed self-QKV and the memory
    K/V projections hold the local heads only."""
    rank, n_model = 0, 1
    if model_group is not None:
        from ..parallel.mesh import world_of

        rank, n_model = world_of(model_group)
    out, stats = _port_leaves(params, batch_stats, cfg, n_model)
    if n_model > 1:
        for path, arr in out.items():
            if path[-1] == "b" and spec_for_path(path_str(path[:-1] + ("w",)), 2) == (None, MODEL_AXIS):
                n = arr.shape[0] // n_model
                out[path] = arr[rank * n:(rank + 1) * n]
    out.update({("backbone",) + path: arr for path, arr in stats.items()})
    return _tensors(out, device)


def trainable_from_jax(params, batch_stats, cfg: ModelConfig, device="cpu"):
    """JAX-layout trees -> the port's training state (params, batch_stats):
    the params as ``params_from_jax`` makes them without the statistics, and
    the statistics apart, at their JAX paths."""
    out, stats = _port_leaves(params, batch_stats, cfg)
    return _tensors(out, device), _tensors(stats, device)


def params_to_jax(params, batch_stats, cfg: ModelConfig):
    """The port's params (tensors or arrays) -> JAX-layout numpy trees
    (params, batch_stats): conv kernels OIHW -> HWIO, the statistics split
    back out. ``batch_stats`` is the training state's statistics tree, or
    None when they are merged into ``params`` (the inference state)."""
    def array(v):  # a copy: the trees stay apart from tensors that training updates in place
        return np.array(v.detach().cpu() if hasattr(v, "detach") else v, dtype=np.float32)

    flat_p = {k: array(v) for k, v in _flatten(params).items()}
    flat_s = flat_p if batch_stats is None else {("backbone",) + k: array(v) for k, v in _flatten(batch_stats).items()}
    p_layout, s_layout = layout(cfg)
    out_p, out_s = {}, {}
    for path, shape, _ in p_layout:
        arr = flat_p[path]
        out_p[path] = arr.transpose(2, 3, 1, 0) if path[0] == "backbone" and len(shape) == 4 else arr
    for path, _, _ in s_layout:
        out_s[path] = flat_s[("backbone",) + path]
    return _unflatten(out_p), _unflatten(out_s)


def seeded_params(cfg: ModelConfig, seed: int = 0):
    """(params, batch_stats) in the JAX layout from a numpy seed.

    PyTorch's default initial scales: conv, linear and LSTM weights and
    biases U(+-1/sqrt(fan_in)); attention q/k/v Xavier-uniform with zero
    bias; LayerNorm 1/0; positions N(0, s) clipped at 2s; token embeddings
    N(0, 1) with the pad row zero. BatchNorm is randomised around the
    variance a default-initialised 3x3 conv produces (about 1/3 of its input's),
    so that activations keep their scale through the seven conv blocks."""
    rs = np.random.RandomState(seed)
    p_layout, s_layout = layout(cfg)

    def make(shape, init):
        kind = init[0]
        if kind == "u":
            return rs.uniform(-init[1], init[1], size=shape)
        if kind == "zeros":
            return np.zeros(shape)
        if kind == "ones":
            return np.ones(shape)
        if kind == "tn":
            return np.clip(rs.standard_normal(shape), -2.0, 2.0) * init[1]
        if kind == "emb":
            e = rs.standard_normal(shape)
            e[cfg.pad_idx] = 0.0
            return e
        if kind == "bn_scale":
            return rs.uniform(0.8, 1.2, size=shape)
        if kind == "bn_bias":
            return rs.standard_normal(shape) * 0.1
        if kind == "bn_mean":
            return rs.standard_normal(shape) * 0.05
        if kind == "bn_var":
            return rs.uniform(0.25, 0.45, size=shape)
        raise ValueError(kind)

    params = {path: make(shape, init).astype(np.float32) for path, shape, init in p_layout}
    stats = {path: make(shape, init).astype(np.float32) for path, shape, init in s_layout}
    return _unflatten(params), _unflatten(stats)


_CFG_KEY = "__model_config__"
_DTYPES_KEY = "__dtypes__"


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 values given as their uint16 bit patterns -> float32, exactly."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(np.float32)




def save_npz(path, params, batch_stats, cfg: ModelConfig | None = None) -> Path:
    """One compressed .npz holding both trees and, optionally, the config.
    bfloat16 leaves keep their 16 bits (stored as uint16, their dtype
    recorded); every other leaf is stored as float32."""
    import dataclasses

    blobs, dtypes = {}, {}
    for name, tree in (("params", params), ("batch_stats", batch_stats)):
        for key, leaf in _flatten(tree).items():
            blob = "/".join((name,) + tuple(map(str, key)))
            arr = np.asarray(leaf)
            if arr.dtype.name == "bfloat16":
                blobs[blob], dtypes[blob] = arr.view(np.uint16), "bfloat16"
            else:
                blobs[blob] = arr.astype(np.float32)
    if cfg is not None:
        blobs[_CFG_KEY] = np.frombuffer(json.dumps(dataclasses.asdict(cfg)).encode(), np.uint8)
    if dtypes:
        blobs[_DTYPES_KEY] = np.frombuffer(json.dumps(dtypes).encode(), np.uint8)
    path = Path(path)
    np.savez_compressed(path, **blobs)
    return path


def load_npz(path):
    """-> (params, batch_stats, cfg or None) as written by ``save_npz``, every
    leaf float32 (bfloat16 leaves widened exactly)."""
    flat = {"params": {}, "batch_stats": {}}
    cfg = None
    with np.load(path) as z:
        dtypes = json.loads(bytes(z[_DTYPES_KEY]).decode()) if _DTYPES_KEY in z.files else {}
        for key in z.files:
            if key == _CFG_KEY:
                cfg = ModelConfig(**json.loads(bytes(z[key]).decode()))
                continue
            if key == _DTYPES_KEY:
                continue
            name, *rest = key.split("/")
            leaf = bf16_bits_to_f32(z[key]) if dtypes.get(key) == "bfloat16" else z[key]
            flat[name][tuple(int(r) if r.isdigit() else r for r in rest)] = leaf
    return _unflatten(flat["params"]), _unflatten(flat["batch_stats"]), cfg


# ---------------------------------------------------------------------------
# The SegFormer layout model
# ---------------------------------------------------------------------------


def _segformer_layout(cfg) -> list[tuple[str, tuple, tuple, str]]:
    """[(HF key, JAX tree path, HF shape, kind)] of every SegFormer leaf, in
    HF's state-dict order. kind: "conv" (JAX HWIO, HF OIHW; the depthwise
    (3,3,1,C) too), "dense" (JAX (in, out), HF (out, in)), "bias", "ln_scale",
    "ln_bias", "bn_scale", "bn_bias", "bn_mean", "bn_var"."""
    out = []

    def dense(key, path, cin, cout):
        out.extend([(f"{key}.weight", path + ("w",), (cout, cin), "dense"),
                    (f"{key}.bias", path + ("b",), (cout,), "bias")])

    def ln(key, path, c):
        out.extend([(f"{key}.weight", path + ("scale",), (c,), "ln_scale"),
                    (f"{key}.bias", path + ("bias",), (c,), "ln_bias")])

    def conv(key, path, cin, cout, k, bias=True):
        out.append((f"{key}.weight", path + ("w",), (cout, cin, k, k), "conv"))
        if bias:
            out.append((f"{key}.bias", path + ("b",), (cout,), "bias"))

    enc = "segformer.encoder"
    for i, c in enumerate(cfg.hidden_sizes):
        st = ("stages", i)
        cin = 3 if i == 0 else cfg.hidden_sizes[i - 1]
        conv(f"{enc}.patch_embeddings.{i}.proj", st + ("patch",), cin, c, cfg.patch_sizes[i])
        ln(f"{enc}.patch_embeddings.{i}.layer_norm", st + ("patch_ln",), c)
        hid = c * cfg.mlp_ratio
        for j in range(cfg.depths[i]):
            pre, bp = f"{enc}.block.{i}.{j}", st + ("blocks", j)
            ln(f"{pre}.layer_norm_1", bp + ("ln1",), c)
            for name, short in (("query", "q"), ("key", "k"), ("value", "v")):
                dense(f"{pre}.attention.self.{name}", bp + ("attn", short), c, c)
            if cfg.sr_ratios[i] > 1:
                conv(f"{pre}.attention.self.sr", bp + ("attn", "sr"), c, c, cfg.sr_ratios[i])
                ln(f"{pre}.attention.self.layer_norm", bp + ("attn", "sr_ln"), c)
            dense(f"{pre}.attention.output.dense", bp + ("attn", "o"), c, c)
            ln(f"{pre}.layer_norm_2", bp + ("ln2",), c)
            dense(f"{pre}.mlp.dense1", bp + ("mlp", "dense1"), c, hid)
            out.extend([(f"{pre}.mlp.dwconv.dwconv.weight", bp + ("mlp", "dw_w"), (hid, 1, 3, 3), "conv"),
                        (f"{pre}.mlp.dwconv.dwconv.bias", bp + ("mlp", "dw_b"), (hid,), "bias")])
            dense(f"{pre}.mlp.dense2", bp + ("mlp", "dense2"), hid, c)
        ln(f"{enc}.layer_norm.{i}", st + ("final_ln",), c)
    dh = cfg.decoder_hidden
    for i, c in enumerate(cfg.hidden_sizes):
        dense(f"decode_head.linear_c.{i}.proj", ("head", "linear_c", i), c, dh)
    conv("decode_head.linear_fuse", ("head", "fuse"), dh * len(cfg.hidden_sizes), dh, 1, bias=False)
    for name, short, kind in (("weight", "scale", "bn_scale"), ("bias", "bias", "bn_bias"),
                              ("running_mean", "mean", "bn_mean"), ("running_var", "var", "bn_var")):
        out.append((f"decode_head.batch_norm.{name}", ("head", "bn", short), (dh,), kind))
    conv("decode_head.classifier", ("head", "classifier"), dh, cfg.num_labels, 1)
    return out


def segformer_params_from_jax(tree, cfg=None, device="cpu") -> dict:
    """The JAX package's SegFormer tree (nested dicts/lists of numpy arrays:
    HWIO convs, (in, out) dense layers, the depthwise ``dw_w`` as (3,3,1,C),
    BatchNorm ``scale``/``bias``/``mean``/``var``; what its
    ``convert_hf_state_dict`` gives and its ``detection/train.py`` trains)
    -> the port's SegFormer state: {key: float32 tensor on ``device``} with
    ``detection/segformer.py``'s keys. Every leaf is consumed exactly once."""
    import torch

    from ..detection.segformer import SegFormerConfig

    flat = _flatten(tree)
    state = {}
    for key, path, shape, kind in _segformer_layout(cfg or SegFormerConfig()):
        if path not in flat:
            raise ValueError(f"SegFormer leaf {'/'.join(map(str, path))} is missing")
        arr = np.asarray(flat.pop(path), np.float32)
        arr = arr.transpose(3, 2, 0, 1) if kind == "conv" else arr.T if kind == "dense" else arr
        if arr.shape != shape:
            raise ValueError(f"SegFormer leaf {'/'.join(map(str, path))} gives {arr.shape}, expected {shape}")
        state[key.removeprefix("segformer.")] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    if flat:
        raise ValueError(f"SegFormer leaves the port does not use: {sorted(map(str, flat))[:8]}")
    return state


def segformer_params_to_jax(state: dict, cfg=None) -> dict:
    """The inverse of ``segformer_params_from_jax``: a SegFormer state (the
    port's keys, HF's ``segformer.`` prefix optional, ``num_batches_tracked``
    ignored; tensors or numpy arrays) -> the JAX package's tree of float32
    numpy arrays. Every leaf of the layout must be there, and no other."""
    from ..detection.segformer import SegFormerConfig, convert_hf_state_dict

    state = convert_hf_state_dict(state)
    flat = {}
    for key, path, shape, kind in _segformer_layout(cfg or SegFormerConfig()):
        key = key.removeprefix("segformer.")
        if key not in state:
            raise ValueError(f"SegFormer key {key} is missing")
        v = state.pop(key)
        arr = np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v, np.float32)
        if arr.shape != shape:
            raise ValueError(f"SegFormer key {key} has shape {arr.shape}, expected {shape}")
        flat[path] = arr.transpose(2, 3, 1, 0) if kind == "conv" else arr.T if kind == "dense" else arr
    if state:
        raise ValueError(f"SegFormer keys the layout does not have: {sorted(state)[:8]}")
    return _unflatten(flat)


def seeded_segformer_state(cfg=None, seed: int = 0) -> dict:
    """An HF-keyed SegFormer state dict ({key: numpy array}, the
    ``segformer.`` prefix and ``num_batches_tracked`` included) from a numpy
    seed, drawn leaf by leaf in HF's order from ``RandomState(seed)``:

      * conv and dense weights N(0, 1/fan_in), fan_in = input channels per
        group x kernel area (not HF's N(0, 0.02^2), whose logits sit so close
        to zero that rounding decides the argmax);
      * biases, LayerNorm and BatchNorm shifts N(0, 0.1^2);
      * LayerNorm and BatchNorm scales 1 + N(0, 0.1^2);
      * BatchNorm running mean 0.2 N(0, 1), running variance U(0, 1) + 0.5
        (the HF oracle's statistics).

    So the logits spread O(1) and near-tied pixels are rare."""
    from ..detection.segformer import SegFormerConfig

    rs = np.random.RandomState(seed)
    state = {}
    for key, _, shape, kind in _segformer_layout(cfg or SegFormerConfig()):
        if kind in ("conv", "dense"):
            fan_in = int(np.prod(shape[1:]))
            arr = rs.standard_normal(shape) / np.sqrt(fan_in)
        elif kind in ("ln_scale", "bn_scale"):
            arr = 1.0 + 0.1 * rs.standard_normal(shape)
        elif kind == "bn_mean":
            arr = 0.2 * rs.standard_normal(shape)
        elif kind == "bn_var":
            arr = rs.uniform(0.0, 1.0, shape) + 0.5
        else:
            arr = 0.1 * rs.standard_normal(shape)
        state[key] = arr.astype(np.float32)
    state["decode_head.batch_norm.num_batches_tracked"] = np.zeros((), np.int64)
    return state
