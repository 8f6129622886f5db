"""One decoder layer at one decode position: CUDA kernel K2
(``csrc/decoder_layer_step.cu``) and its plain PyTorch version.

``decoder_layer_step(weights, x, pos, self_k, self_v, mem_k, mem_v,
mem_valid_f, lineage, num_heads=, window=, lanes=)`` returns the layer output
(B, D) and writes this position's k and v IN PLACE into ``self_k``/``self_v``
at slot ``pos``; no other cache slot changes. ``weights`` is the dict of
``layer_weights``. ``lineage`` (B, window) int32 holds image-local beam
parents (None for greedy); slot ``pos`` reads the lane itself whatever the
table says. Any number of lanes: the kernel runs one thread-block cluster
per image and group of its lanes (``geometry.k2_geometry``), one CTA per
attention head. A CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ...models.layers import decoder_layer_step as _layer_step_plain
from . import build
from .geometry import MAX_CLUSTER, SMEM_LIMIT, k2_geometry

WEIGHT_FIELDS = (
    "qkv_w", "qkv_b", "so_w", "so_b", "ln1_s", "ln1_b",
    "cq_w", "cq_b", "co_w", "co_b", "ln2_s", "ln2_b",
    "l1_w", "l1_b", "l2_w", "l2_b", "ln3_s", "ln3_b",
)

launches = 0  # kernel launches since the last reset_launches()


def reset_launches() -> None:
    global launches
    launches = 0


def layer_weights(lp: dict) -> dict:
    """A packed decoder layer (models/layers.py::pack_step_params) as the
    kernel's 18 contiguous operands."""
    src = {
        "qkv_w": lp["self_qkv"]["w"], "qkv_b": lp["self_qkv"]["b"],
        "so_w": lp["self"]["o"]["w"], "so_b": lp["self"]["o"]["b"],
        "ln1_s": lp["ln1"]["scale"], "ln1_b": lp["ln1"]["bias"],
        "cq_w": lp["cross"]["q"]["w"], "cq_b": lp["cross"]["q"]["b"],
        "co_w": lp["cross"]["o"]["w"], "co_b": lp["cross"]["o"]["b"],
        "ln2_s": lp["ln2"]["scale"], "ln2_b": lp["ln2"]["bias"],
        "l1_w": lp["lin1"]["w"], "l1_b": lp["lin1"]["b"],
        "l2_w": lp["lin2"]["w"], "l2_b": lp["lin2"]["b"],
        "ln3_s": lp["ln3"]["scale"], "ln3_b": lp["ln3"]["bias"],
    }
    return {k: v.contiguous() for k, v in src.items()}


def _layer_params(wt: dict) -> dict:
    """The packed-layer dict of models/layers.py from the kernel operands."""
    lin = lambda w, b: {"w": wt[w], "b": wt[b]}
    ln = lambda s, b: {"scale": wt[s], "bias": wt[b]}
    return {
        "self_qkv": lin("qkv_w", "qkv_b"),
        "self": {"o": lin("so_w", "so_b")},
        "ln1": ln("ln1_s", "ln1_b"),
        "cross": {"q": lin("cq_w", "cq_b"), "o": lin("co_w", "co_b")},
        "ln2": ln("ln2_s", "ln2_b"),
        "lin1": lin("l1_w", "l1_b"),
        "lin2": lin("l2_w", "l2_b"),
        "ln3": ln("ln3_s", "ln3_b"),
    }


def decoder_layer_step_plain(weights, x, pos, self_k, self_v, mem_k, mem_v, mem_valid_f, lineage=None, *,
                             num_heads: int, window: int, lanes: int = 1):
    """The plain decode step (models/layers.py::decoder_layer_step) with the
    lineage turned into absolute rows, slot ``pos`` patched to self."""
    b = x.shape[0]
    w = min(window, self_k.shape[1])
    idx = None
    if lineage is not None:
        rows = torch.arange(b, device=x.device)[:, None]
        lin_abs = lineage[:, :w].long() + lanes * (rows // lanes)
        idx = torch.where(torch.arange(w, device=x.device)[None, :] == pos, rows, lin_abs)
    out, _, _ = _layer_step_plain(_layer_params(weights), num_heads, x, pos, self_k, self_v, mem_k, mem_v,
                                  mem_valid_f > 0, window=w, lineage_idx=idx)
    return out


def decoder_layer_step(weights, x, pos, self_k, self_v, mem_k, mem_v, mem_valid_f, lineage=None, *,
                       num_heads: int, window: int, lanes: int = 1):
    if x.device.type == "cpu":
        return decoder_layer_step_plain(weights, x, pos, self_k, self_v, mem_k, mem_v, mem_valid_f, lineage,
                                        num_heads=num_heads, window=window, lanes=lanes)
    return decoder_layer_step_kernel(weights, x, pos, self_k, self_v, mem_k, mem_v, mem_valid_f, lineage,
                                     num_heads=num_heads, window=window, lanes=lanes)


def decoder_layer_step_kernel(weights, x, pos, self_k, self_v, mem_k, mem_v, mem_valid_f, lineage=None, *,
                              num_heads: int, window: int, lanes: int = 1, split: int | None = None):
    """The kernel on CUDA tensors, with ``geometry.k2_geometry``'s CTAs per
    head or ``split`` (1 or 2) if given."""
    global launches
    name = "decoder_layer_step"
    b, d = x.shape
    n_img, tm, _ = mem_k.shape
    cache_len = self_k.shape[1]
    f = weights["l1_w"].shape[1]
    w = min(window, cache_len)
    tensors = {"x": x, "self_k": self_k, "self_v": self_v, "mem_k": mem_k, "mem_v": mem_v,
               "mem_valid_f": mem_valid_f, **weights}
    if lineage is not None:
        tensors["lineage"] = lineage
    for key, t in tensors.items():
        if not t.is_cuda or t.device != x.device:
            raise RuntimeError(f"{name}: {key} must be a CUDA tensor on {x.device}, got {t.device}")
        want = torch.int32 if key == "lineage" else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name}: {key} must be {want}, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be contiguous and 16-byte aligned")
    expect = {
        "self_k": (b, cache_len, d), "self_v": (b, cache_len, d), "mem_k": (n_img, tm, d),
        "mem_v": (n_img, tm, d), "mem_valid_f": (n_img, tm),
        "qkv_w": (d, 3 * d), "qkv_b": (3 * d,), "so_w": (d, d), "so_b": (d,), "cq_w": (d, d), "cq_b": (d,),
        "co_w": (d, d), "co_b": (d,), "l1_w": (d, f), "l1_b": (f,), "l2_w": (f, d), "l2_b": (d,),
        **{k: (d,) for k in ("ln1_s", "ln1_b", "ln2_s", "ln2_b", "ln3_s", "ln3_b")},
    }
    if lineage is not None:
        expect["lineage"] = (b, w)
    for key, shape in expect.items():
        if tuple(tensors[key].shape) != shape:
            raise ValueError(f"{name}: {key} has shape {tuple(tensors[key].shape)}, expected {shape}")
    if lanes < 1 or n_img * lanes != b:
        raise ValueError(f"{name}: {b} rows are not {n_img} images x {lanes} lanes")
    group, _, ctas = k2_geometry(n_img, lanes, num_heads, tm)
    split = ctas // num_heads if split is None else split
    if split not in (1, 2) or num_heads * split > MAX_CLUSTER or d % num_heads or (d // num_heads) % (4 * split) \
            or f % (num_heads * split) or (f // (num_heads * split)) % 4:
        raise ValueError(f"{name}: D={d}, F={f}, heads={num_heads}, {split} CTA(s) a head (needs at most "
                         f"{MAX_CLUSTER} CTAs, D/(heads x split) and F/(heads x split) multiples of 4)")
    if not 0 <= pos < w:
        raise ValueError(f"{name}: pos {pos} outside the window {w}")
    lib = build.load(name)
    smem = lib.decoder_layer_step_smem_bytes(group, d, num_heads, f, split)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: needs {smem} bytes of shared memory, more than {SMEM_LIMIT}")
    out = torch.empty_like(x)
    ptrs = [x, self_k, self_v, mem_k, mem_v, mem_valid_f, lineage, *(weights[k] for k in WEIGHT_FIELDS), out]
    arr = (ctypes.c_void_p * len(ptrs))(*[None if t is None else t.data_ptr() for t in ptrs])
    fn = lib.decoder_layer_step_launch
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(ctypes.cast(arr, ctypes.c_void_p), n_img, lanes, group, d, num_heads, f, cache_len, tm, pos, w, split,
             stream)
    build.check(err, name)
    launches += 1
    return out
