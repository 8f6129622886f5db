"""Weights from the JAX package's layout into the port's state, with numpy only.

The JAX package keeps its weights as a ``params`` tree and a ``batch_stats``
tree (nested dicts, lists for the encoder and decoder layers). This module
takes those trees as nested dicts of numpy arrays, however they were loaded,
and never imports JAX:

  * ``params_from_jax`` builds the port's state: conv kernels HWIO -> OIHW,
    BatchNorm ``scale``/``bias`` joined with the ``mean``/``var`` statistics,
    dense layers kept as (in, out), LSTM ``w_ih``/``w_hh`` with their i, f, g, o
    column blocks as they are, the decoder's ``tok_emb``/``pos_emb``/``out``.
    Every leaf is consumed exactly once and every port parameter is set;
    anything else raises.
  * ``save_npz``/``load_npz`` carry such a tree in one .npz file.
  * ``seeded_params`` makes a tree in the JAX layout from a numpy seed, with
    PyTorch's default initial scales, for runs without trained weights.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

from ..config import ModelConfig

SE_VGG_CHANNELS = [(1, 64), (64, 128), (128, 256), (256, 256), (256, 512), (512, 512), (512, 512)]
SE_BLOCKS = (("se3", 256), ("se4", 512), ("se5", 512))


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


def layout(cfg: ModelConfig) -> tuple[list, list]:
    """The JAX layout of ``cfg``'s trees: ([(path, shape, init)] of params,
    [(path, shape, init)] of batch_stats), in a fixed order. Paths are tuples
    of dict keys and list indices."""
    if cfg.backbone != "se_vgg":
        raise NotImplementedError(f"backbone {cfg.backbone!r} is not ported yet (se_vgg only)")
    d, v = cfg.emb_dim, cfg.vocab_size
    hid = d // 2
    p, s = [], []
    for i, (cin, cout) in enumerate(SE_VGG_CHANNELS):
        name = f"conv{i + 1}"
        u = ("u", 1 / math.sqrt(cin * 9))
        p += [(("backbone", name, "w"), (3, 3, cin, cout), u), (("backbone", name, "b"), (cout,), u)]
        p += [(("backbone", f"bn_{name}", "scale"), (cout,), ("bn_scale",)),
              (("backbone", f"bn_{name}", "bias"), (cout,), ("bn_bias",))]
        s += [((f"bn_{name}", "mean"), (cout,), ("bn_mean",)), ((f"bn_{name}", "var"), (cout,), ("bn_var",))]
    for name, c in SE_BLOCKS:
        p += _linear_layout(("backbone", name, "fc1"), c, c // 16)
        p += _linear_layout(("backbone", name, "fc2"), c // 16, c)
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


def params_from_jax(params, batch_stats, cfg: ModelConfig, device="cpu"):
    """JAX-layout trees (nested dicts/lists of numpy arrays, any float dtype)
    -> the port's state: nested dicts of float32 tensors on ``device``."""
    import torch

    flat_p, flat_s = _flatten(params), _flatten(batch_stats)
    p_layout, s_layout = layout(cfg)
    out = {}

    def take(flat, path, shape, what):
        if path not in flat:
            raise ValueError(f"{what} leaf {'/'.join(map(str, path))} is missing")
        arr = np.asarray(flat.pop(path), dtype=np.float32)
        if arr.shape != shape:
            raise ValueError(f"{what} leaf {'/'.join(map(str, path))} has shape {arr.shape}, expected {shape}")
        return arr

    for path, shape, _ in p_layout:
        arr = take(flat_p, path, shape, "params")
        if path[0] == "backbone" and path[1].startswith("conv") and path[2] == "w":
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        out[path] = arr
    for path, shape, _ in s_layout:
        out[("backbone",) + path] = take(flat_s, path, shape, "batch_stats")
    if flat_p or flat_s:
        extra = sorted("/".join(map(str, k)) for k in list(flat_p) + list(flat_s))
        raise ValueError(f"leaves the port does not use: {extra[:8]}{' ...' if len(extra) > 8 else ''}")
    return _unflatten({k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in out.items()})


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


def save_npz(path, params, batch_stats, cfg: ModelConfig | None = None) -> Path:
    """One .npz holding both trees (as float32) and, optionally, the config."""
    import dataclasses

    blobs = {}
    for name, tree in (("params", params), ("batch_stats", batch_stats)):
        for key, leaf in _flatten(tree).items():
            blobs["/".join((name,) + tuple(map(str, key)))] = np.asarray(leaf, dtype=np.float32)
    if cfg is not None:
        blobs[_CFG_KEY] = np.frombuffer(json.dumps(dataclasses.asdict(cfg)).encode(), np.uint8)
    path = Path(path)
    np.savez(path, **blobs)
    return path


def load_npz(path):
    """-> (params, batch_stats, cfg or None) as written by ``save_npz``."""
    flat = {"params": {}, "batch_stats": {}}
    cfg = None
    with np.load(path) as z:
        for key in z.files:
            if key == _CFG_KEY:
                cfg = ModelConfig(**json.loads(bytes(z[key]).decode()))
                continue
            name, *rest = key.split("/")
            flat[name][tuple(int(r) if r.isdigit() else r for r in rest)] = z[key]
    return _unflatten(flat["params"]), _unflatten(flat["batch_stats"]), cfg
