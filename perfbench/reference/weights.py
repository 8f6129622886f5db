"""The weights both sides are given, made or read by the benchmark alone.

  * ``read_index``: a trained checkpoint through its index file
    (``perfbench/data/flagship_index.json``, a frozen copy of the one the
    repository ships): for each leaf of the Orbax checkpoint, its path,
    dtype, shape, the byte range of its zstd-compressed chunk (or the chunk
    inline) and the chunk's sha256. Each chunk is checked, decompressed with
    the system's libzstd and widened to float32.
  * ``seeded``: a tree made on the device from the seed, in two large draws
    of a ``torch.Generator`` (one uniform, one normal) cut into leaves and
    scaled per leaf: PyTorch's default initial scales, BatchNorm randomised
    around the scale of a default-initialised conv's output.

Both return JAX-layout trees (``layout``): nested dicts, lists for layers,
conv kernels HWIO, BatchNorm statistics apart.
"""

from __future__ import annotations

import base64
import ctypes
import ctypes.util
import hashlib
import json
import math
from pathlib import Path

import numpy as np
import torch

SE_VGG_CHANNELS = [(1, 64), (64, 128), (128, 256), (256, 256), (256, 512), (512, 512), (512, 512)]
SE_BLOCKS = (("se3", 256), ("se4", 512), ("se5", 512))
RESNET_STAGES = [(64, 128, 1), (128, 256, 2), (256, 512, 2), (512, 512, 1)]  # (cin, cout, BasicBlocks)


def layout(m: dict) -> tuple[list, list]:
    """([(path, shape, init)] of the params, the same of the statistics) of
    the configuration's "model" dict."""
    d, v, hid = m["emb_dim"], m["vocab_size"], m["emb_dim"] // 2
    p, s = [], []

    def lin(pre, din, dout):
        u = ("u", 1 / math.sqrt(din))
        p.extend([(pre + ("w",), (din, dout), u), (pre + ("b",), (dout,), u)])

    def conv(pre, k, cin, cout, bias):
        u = ("u", 1 / math.sqrt(cin * k * k))
        p.append((pre + ("w",), (k, k, cin, cout), u))
        if bias:
            p.append((pre + ("b",), (cout,), u))

    def bn(pre, stat, c):
        p.extend([(pre + ("scale",), (c,), ("bn_scale",)), (pre + ("bias",), (c,), ("bn_bias",))])
        s.extend([(stat + ("mean",), (c,), ("bn_mean",)), (stat + ("var",), (c,), ("bn_var",))])

    def mha(pre):
        xav = ("u", math.sqrt(6.0 / (2 * d)))
        for n in ("q", "k", "v"):
            p.extend([(pre + (n, "w"), (d, d), xav), (pre + (n, "b"), (d,), ("zeros",))])
        p.extend([(pre + ("o", "w"), (d, d), ("u", 1 / math.sqrt(d))), (pre + ("o", "b"), (d,), ("zeros",))])

    def ln(pre):
        p.extend([(pre + ("scale",), (d,), ("ones",)), (pre + ("bias",), (d,), ("zeros",))])

    if m["backbone"] == "se_vgg":
        for i, (cin, cout) in enumerate(SE_VGG_CHANNELS):
            conv(("backbone", f"conv{i + 1}"), 3, cin, cout, True)
            bn(("backbone", f"bn_conv{i + 1}"), (f"bn_conv{i + 1}",), cout)
        for se, c in SE_BLOCKS:
            lin(("backbone", se, "fc1"), c, c // 16)
            lin(("backbone", se, "fc2"), c // 16, c)
    elif m["backbone"] == "resnet":
        conv(("backbone", "stem_conv"), 3, 1, 64, False)
        bn(("backbone", "stem_bn"), ("stem_bn",), 64)
        for i, (cin, cout, n) in enumerate(RESNET_STAGES):
            c = cin
            for j in range(n):
                blk = (f"layer{i + 1}", j)
                conv(("backbone",) + blk + ("conv1",), 3, c, cout, False)
                bn(("backbone",) + blk + ("bn1",), blk + ("bn1",), cout)
                conv(("backbone",) + blk + ("conv2",), 3, cout, cout, False)
                bn(("backbone",) + blk + ("bn2",), blk + ("bn2",), cout)
                if c != cout:
                    conv(("backbone",) + blk + ("short_conv",), 1, c, cout, False)
                    bn(("backbone",) + blk + ("short_bn",), blk + ("short_bn",), cout)
                c = cout
    else:
        raise ValueError(f"backbone {m['backbone']!r}: se_vgg or resnet")
    lin(("patch", "proj"), 1024, d)
    p.append((("patch", "pos_emb"), (m["patch_max"], d), ("tn", 0.02)))
    for i in range(m["enc_layers"]):
        mha(("enc", i, "self"))
        ln(("enc", i, "ln1"))
        ln(("enc", i, "ln2"))
        lin(("enc", i, "lin1"), d, m["enc_ffn_dim"])
        lin(("enc", i, "lin2"), m["enc_ffn_dim"], d)
    p.append((("global_pos",), (m["max_global_len"], d), ("tn", 0.02)))
    p.append((("dec", "tok_emb"), (v, d), ("emb",)))
    p.append((("dec", "pos_emb"), (m["decode_max_len"], d), ("tn", 0.1)))
    for i in range(m["dec_layers"]):
        pre = ("dec", "layers", i)
        mha(pre + ("self",))
        mha(pre + ("cross",))
        for n in ("ln1", "ln2", "ln3"):
            ln(pre + (n,))
        lin(pre + ("lin1",), d, m["dec_ffn_dim"])
        lin(pre + ("lin2",), m["dec_ffn_dim"], d)
    lin(("dec", "out"), d, v)
    if m["use_bilstm"]:
        u = ("u", 1 / math.sqrt(hid))
        for dr in ("fw", "bw"):
            p.extend([(("bilstm", dr, "w_ih"), (d, 4 * hid), u), (("bilstm", dr, "w_hh"), (hid, 4 * hid), u),
                      (("bilstm", dr, "b_ih"), (4 * hid,), u), (("bilstm", dr, "b_hh"), (4 * hid,), u)])
    return p, s


def unflatten(flat: dict):
    """{path tuple: leaf} -> nested dicts, with lists where every key of a level is an int."""
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


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


# (low, high) of a uniform draw, or (mean, std) of a normal one clipped at 2 std, by init kind
_UNIFORM = {"bn_scale": (0.8, 1.2), "bn_var": (0.25, 0.45)}
_NORMAL = {"bn_bias": 0.1, "bn_mean": 0.05, "emb": 1.0}


def seeded(m: dict, seed: int, device, cross_query_scale: float = 1.0) -> tuple[dict, dict]:
    """(params, stats) trees of float32 tensors on ``device`` from ``seed``.
    ``cross_query_scale`` multiplies the decoder's cross-attention query
    weights, so that each step attends to a few memory positions, as a
    trained decoder does, and the tokens depend on the line."""
    p_layout, s_layout = layout(m)
    entries = p_layout + s_layout
    sizes = [math.prod(shape) for _, shape, _ in entries]
    total = sum(sizes)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    uni = torch.rand(total, generator=gen, device=device)
    nrm = torch.randn(total, generator=gen, device=device).clamp_(-2.0, 2.0)
    lo, hi, mul, add, use_n = [], [], [], [], []
    for _, _, init in entries:
        kind = init[0]
        if kind == "u":
            row = (2 * init[1], -init[1], 0.0)
        elif kind in _UNIFORM:
            a, b = _UNIFORM[kind]
            row = (b - a, a, 0.0)
        elif kind == "tn":
            row = (init[1], 0.0, 1.0)
        elif kind in _NORMAL:
            row = (_NORMAL[kind], 0.0, 1.0)
        elif kind in ("zeros", "ones"):
            row = (0.0, 1.0 if kind == "ones" else 0.0, 0.0)
        else:
            raise ValueError(kind)
        mul.append(row[0])
        add.append(row[1])
        use_n.append(row[2])
    rep = torch.tensor(sizes, device=device)
    per = lambda vals: torch.repeat_interleave(torch.tensor(vals, device=device), rep)  # noqa: E731
    flat = torch.where(per(use_n) > 0, nrm, uni) * per(mul) + per(add)
    leaves = flat.split(sizes)
    out = {}
    for (path, shape, init), leaf in zip(entries, leaves):
        leaf = leaf.view(shape)
        if init[0] == "emb":
            leaf[m["pad_idx"]] = 0.0
        if path[0] == "dec" and path[-3:] == ("cross", "q", "w"):
            leaf.mul_(cross_query_scale)
        out[path] = leaf
    params = unflatten({k: out[k] for k, _, _ in p_layout})
    stats = unflatten({k: out[k] for k, _, _ in s_layout})
    return params, stats


_ZSTD: ctypes.CDLL | None = None


def _zstd_decompress(data: bytes, size: int) -> bytes:
    global _ZSTD
    if _ZSTD is None:
        lib = ctypes.CDLL(ctypes.util.find_library("zstd") or "libzstd.so.1")
        lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t]
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        _ZSTD = lib
    out = ctypes.create_string_buffer(size)
    got = _ZSTD.ZSTD_decompress(out, size, data, len(data))
    if _ZSTD.ZSTD_isError(got) or got != size:
        raise ValueError(f"zstd: {size} bytes expected, got error or {got}")
    return out.raw


def read_index(index_path: Path, root: Path) -> tuple[dict, dict]:
    """(params, stats) numpy float32 trees of the checkpoint that the index
    describes; ``root``: the directory its "checkpoint" is relative to."""
    index = json.loads(Path(index_path).read_text())
    checkpoint = root / index["checkpoint"]
    trees: dict = {"params": {}, "batch_stats": {}}
    for e in index["leaves"]:
        if "inline" in e:
            chunk = base64.b64decode(e["inline"])
        else:
            with open(checkpoint / e["file"], "rb") as f:
                f.seek(e["offset"])
                chunk = f.read(e["length"])
        if hashlib.sha256(chunk).hexdigest() != e["sha256"]:
            raise ValueError(f"leaf {e['path']}: chunk does not match its sha256")
        shape = tuple(e["shape"])
        n = math.prod(shape)
        if e["dtype"] == "bfloat16":
            bits = np.frombuffer(_zstd_decompress(chunk, 2 * n), "<u2").astype(np.uint32) << 16
            arr = bits.view(np.float32)
        elif e["dtype"] == "<f4":
            arr = np.frombuffer(_zstd_decompress(chunk, 4 * n), "<f4")
        else:
            raise ValueError(f"leaf {e['path']}: dtype {e['dtype']}")
        tree, *rest = e["path"]
        trees[tree][tuple(rest)] = arr.astype(np.float32).reshape(shape)
    return unflatten(trees["params"]), unflatten(trees["batch_stats"])
