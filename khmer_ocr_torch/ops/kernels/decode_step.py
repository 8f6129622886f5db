"""One decoder layer at one decode position: CUDA kernel K2
(``csrc/decoder_layer_step.cu``), its tensor-parallel blocks
(``csrc/decoder_block.cu``) and their plain PyTorch versions.

``decoder_layer_step(weights, x, pos, self_k, self_v, mem_k, mem_v,
mem_valid_f, lineage, num_heads=, window=, lanes=, head=)`` returns the layer
output (B, D) and writes this position's k and v IN PLACE into
``self_k``/``self_v`` at slot ``pos``; no other cache slot changes. ``pos``
is a one-element int32 tensor on the card, which the kernel reads there
(the TPU kernel's scalar-prefetch ``pos_ref``), so one launch captured in a
CUDA graph serves every position its replays reach (decode/graphs.py); the
caller keeps ``0 <= pos < window``, which the kernel cannot check. The
plain version takes that tensor or a Python int.
``weights`` is the dict of ``layer_weights``. ``lineage`` (B, window) int32
holds image-local beam parents (None for greedy); slot ``pos`` reads the lane
itself whatever the table says. Any number of lanes. Two routes, which
``geometry.k2_route`` picks from the launch's shapes, storage type and head:
the cluster route (``csrc/decoder_layer_step.cu``) runs one thread-block
cluster per image and group of its lanes (``geometry.k2_geometry``), one CTA
per attention head; in float32 from the library bounded for one CTA an SM,
or, for launches with more clusters than that holds at once, for two
(``geometry.k2_two_ctas_an_sm``). The card route
(``csrc/decoder_layer_card.cu``: float32, greedy, up to 32 rows, no head)
spreads every projection's columns over the whole card, so that each weight
byte is read by one CTA for every row of the batch, and the attention over
(row, head) CTAs, in a chain of ``CARD_KERNELS`` launches; it takes the
batches for which the cluster route would need a second wave (greedy
batches of 31-32 images).

Storage type: x, the caches, the memory K/V and the weight matrices are
all float32 or all bfloat16 (the serving speed mode); biases, LayerNorm
parameters and ``mem_valid_f`` are float32 either way (``layer_weights``
widens them). In bfloat16 every product's input is rounded to bfloat16 and
every sum is float32, as in the TPU kernel (``_dot``); q, k, v and the
cross q are rounded where they are made, the attention weights before the
weighted sum of V, and the output.

``head=(out_w (D, Vp) in the storage type, out_b (Vp,) float32, v_real)``
(``head_weights``) also returns the log-probs (B, Vp) float32 of the decode
head: the logits rounded to the storage type, the bias rounded to it added
and the sum rounded again, then a log-softmax over the first ``v_real``
columns; the others are NEG_INF.

``decoder_block(kind, ...)`` is one of the three launches a layer takes
under a tensor-parallel model group ("self", "cross", "ffn", and "finish"
for the last layer's LayerNorm), each returning the block's residual and
its (B, D) partial sum for the caller to all-reduce
(models/ocr_model.py::tp_layer_step).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ...models.layers import NEG_INF, layer_norm, write_slot
from ...models.layers import decoder_layer_step as _layer_step_plain
from . import build
from .geometry import (CARD_MAX_ROWS, MAX_CLUSTER, SMEM_LIMIT, k2_card_fits, k2_card_split, k2_geometry, k2_route,
                       k2_two_ctas_an_sm)

WEIGHT_FIELDS = (
    "qkv_w", "qkv_b", "so_w", "so_b", "ln1_s", "ln1_b",
    "cq_w", "cq_b", "co_w", "co_b", "ln2_s", "ln2_b",
    "l1_w", "l1_b", "l2_w", "l2_b", "ln3_s", "ln3_b",
)

MATRIX_FIELDS = ("qkv_w", "so_w", "cq_w", "co_w", "l1_w", "l2_w")  # in the storage type; the rest float32
BLOCK_KINDS = {"finish": 0, "self": 1, "cross": 2, "ffn": 3}
HEAD_COLS = 128  # the head's vocabulary padded to a multiple of this, as the TPU kernel pads it
CARD_KERNELS = 7  # kernels one layer step launches on the card route (csrc/decoder_layer_card.cu)


def layer_weights(lp: dict) -> dict:
    """A packed decoder layer (models/layers.py::pack_step_params) as the
    kernel's 18 contiguous operands: the matrices in their dtype, the
    vectors widened to float32."""
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
    return {k: (v if k in MATRIX_FIELDS else v.float()).contiguous() for k, v in src.items()}


def head_weights(out: dict) -> tuple:
    """The decode head's operands from the vocabulary projection ``out``
    ({"w" (D, V), "b" (V,)}): (out_w (D, Vp) in the weight's dtype, out_b
    (Vp,) float32, V), Vp = V padded with zeros to a multiple of
    ``HEAD_COLS``."""
    w, b = out["w"], out["b"]
    d, v = w.shape
    vp = HEAD_COLS * -(-v // HEAD_COLS)
    hw = torch.zeros(d, vp, dtype=w.dtype, device=w.device)
    hw[:, :v] = w
    hb = torch.zeros(vp, dtype=torch.float32, device=w.device)
    hb[:v] = b
    return hw, hb, v


def head_columns_fit(vp: int, d: int, num_heads: int, split: int, itemsize: int) -> bool:
    """Whether the kernel can fuse a head of ``vp`` padded columns: at most
    D of them (the head's weight tile shares the layer's), split evenly
    into vectors of 16 bytes over the cluster's num_heads x split CTAs."""
    return vp <= d and vp % ((16 // itemsize) * num_heads * split) == 0


def head_fits(n_img: int, lanes: int, num_heads: int, tm: int, d: int, vocab: int, dtype) -> bool:
    """Whether a launch of these shapes (``k2_geometry``'s CTAs a head) can
    fuse the decode head of ``vocab`` columns in ``dtype``; the decode runs
    the normal head where it cannot, as the JAX package gates its head
    (``head_fusion_compatible``)."""
    split = k2_geometry(n_img, lanes, num_heads, tm)[2] // num_heads
    return head_columns_fit(HEAD_COLS * -(-vocab // HEAD_COLS), d, num_heads, split, dtype.itemsize)


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    """float32 ``x`` rounded to ``dtype`` and widened back (the identity for float32)."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (float32 values) @ w with x rounded to w's dtype and float32 sums."""
    return x @ w if w.dtype == torch.float32 else _round(x, w.dtype) @ w.float()


def _attend(q: torch.Tensor, k, v, valid, num_heads: int, dtype) -> torch.Tensor:
    """Attention of the query rows q (N, K, DA) float32 over keys and values
    (N, T, DA) shared by the K rows of each N, masked by valid (N, T) bool,
    over ``num_heads`` heads of DA/num_heads columns -> (N, K, DA) float32.
    In float32 the softmax's weights multiply V; in a lower ``dtype`` the
    unnormalised weights exp(logit - max) are rounded to it first and the
    sum is divided by theirs, as the kernels do."""
    n, kk, da = q.shape
    t = k.shape[1]
    hd = da // num_heads
    kh = k.float().reshape(n, t, num_heads, hd)
    vh = v.float().reshape(n, t, num_heads, hd)
    logits = torch.einsum("nkhe,nthe->ntkh", q.reshape(n, kk, num_heads, hd), kh) / math.sqrt(hd)
    logits = logits.masked_fill(~valid[:, :, None, None], NEG_INF)
    if dtype == torch.float32:
        out = torch.einsum("ntkh,nthe->nkhe", torch.softmax(logits, dim=1), vh)
    else:
        e = torch.exp(logits - logits.max(dim=1, keepdim=True).values).masked_fill(~valid[:, :, None, None], 0.0)
        out = torch.einsum("ntkh,nthe->nkhe", _round(e, dtype), vh) / e.sum(dim=1)[..., None]
    return out.reshape(n, kk, da)


def _self_rows(self_k, self_v, x, pos, lineage, window, lanes):
    """The (B, window, DA) keys and values each row reads, through the
    lineage (image-local parents; slot pos is the row itself), and which
    slots are attendable."""
    b = x.shape[0]
    w = min(window, self_k.shape[1])
    rows = torch.arange(b, device=x.device)[:, None]
    t = torch.arange(w, device=x.device)[None, :]
    idx = rows.expand(b, w)
    if lineage is not None:
        idx = torch.where(t == pos, rows, lineage[:, :w].long() + lanes * (rows // lanes))
    return self_k[idx, t], self_v[idx, t], (t <= pos).expand(b, w)


def _layer_step_lowp(wt, x, pos, self_k, self_v, mem_k, mem_v, mem_valid_f, lineage, num_heads, window, lanes):
    """The layer step in a storage type below float32, with the kernel's
    rounding points: the tensor-parallel blocks of one rank holding every
    head, the partial sums whole."""
    kw = dict(num_heads=num_heads, window=window, lanes=lanes, dtype=x.dtype)
    xr, part = decoder_block_plain("self", wt, x, None, pos, self_k, self_v, lineage=lineage, **kw)
    xr, part = decoder_block_plain("cross", wt, xr, part, mem_k=mem_k, mem_v=mem_v, mem_valid_f=mem_valid_f,
                                   prologue=(wt["so_b"], wt["ln1_s"], wt["ln1_b"]), **kw)
    xr, part = decoder_block_plain("ffn", wt, xr, part, prologue=(wt["co_b"], wt["ln2_s"], wt["ln2_b"]), **kw)
    xr, _ = decoder_block_plain("finish", wt, xr, part, prologue=(wt["l2_b"], wt["ln3_s"], wt["ln3_b"]),
                                round_x=True, **kw)
    return xr.to(x.dtype)


def decode_head_plain(x: torch.Tensor, head) -> torch.Tensor:
    """The decode head on the layer output x (B, D): (B, Vp) float32 log-probs."""
    hw, hb, v_real = head
    cdt = hw.dtype
    lg = _round(_round(_dot(x.float(), hw), cdt) + _round(hb, cdt), cdt)
    real = torch.arange(hw.shape[1], device=x.device) < v_real
    lg = lg.masked_fill(~real, NEG_INF)
    lse = torch.logsumexp(lg, dim=-1, keepdim=True)
    return (lg - lse).masked_fill(~real, NEG_INF)


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
                             num_heads: int, window: int, lanes: int = 1, head=None):
    """The plain decode step (models/layers.py::decoder_layer_step in
    float32, ``_layer_step_lowp`` in bfloat16) with the lineage turned into
    absolute rows, slot ``pos`` patched to self; with ``head`` also its
    log-probs. ``pos``: a Python int or a one-element integer tensor, used
    on the device (no host read)."""
    if x.dtype != torch.float32:
        out = _layer_step_lowp(weights, x, pos, self_k, self_v, mem_k, mem_v, mem_valid_f, lineage, num_heads,
                               window, lanes)
        return out if head is None else (out, decode_head_plain(out, head))
    b = x.shape[0]
    w = min(window, self_k.shape[1])
    idx = None
    if lineage is not None:
        rows = torch.arange(b, device=x.device)[:, None]
        lin_abs = lineage[:, :w].long() + lanes * (rows // lanes)
        idx = torch.where(torch.arange(w, device=x.device)[None, :] == pos, rows, lin_abs)
    out, _, _ = _layer_step_plain(_layer_params(weights), num_heads, x, pos, self_k, self_v, mem_k, mem_v,
                                  mem_valid_f > 0, window=w, lineage_idx=idx)
    return out if head is None else (out, decode_head_plain(out, head))


def decoder_layer_step(weights, x, pos, self_k, self_v, mem_k, mem_v, mem_valid_f, lineage=None, *,
                       num_heads: int, window: int, lanes: int = 1, head=None):
    if x.device.type == "cpu":
        return decoder_layer_step_plain(weights, x, pos, self_k, self_v, mem_k, mem_v, mem_valid_f, lineage,
                                        num_heads=num_heads, window=window, lanes=lanes, head=head)
    return decoder_layer_step_kernel(weights, x, pos, self_k, self_v, mem_k, mem_v, mem_valid_f, lineage,
                                     num_heads=num_heads, window=window, lanes=lanes, head=head)


def _check_operands(name: str, tensors: dict, device, storage: set, cdt) -> None:
    """Every operand a CUDA tensor on ``device``, contiguous and 16-byte
    aligned but for "pos": the ``storage`` keys of dtype ``cdt``, "lineage"
    and "pos" int32, the rest float32."""
    for key, t in tensors.items():
        if t is None:
            continue
        if not t.is_cuda or t.device != device:
            raise RuntimeError(f"{name}: {key} must be a CUDA tensor on {device}, got {t.device}")
        want = torch.int32 if key in ("lineage", "pos") else cdt if key in storage else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name}: {key} must be {want}, got {t.dtype}")
        if key != "pos" and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name}: {key} must be contiguous and 16-byte aligned")


def decoder_layer_step_kernel(weights, x, pos, self_k, self_v, mem_k, mem_v, mem_valid_f, lineage=None, *,
                              num_heads: int, window: int, lanes: int = 1, split: int | None = None, head=None,
                              ctas_an_sm: int | None = None, route: str | None = None):
    """The kernel on CUDA tensors, by ``geometry.k2_route``'s route or
    ``route`` ("card" or "cluster") if given. The cluster route with
    ``geometry.k2_geometry``'s CTAs per head or ``split`` (1 or 2) if given,
    and in float32 the library bounded for ``geometry.k2_two_ctas_an_sm``'s
    CTAs an SM or ``ctas_an_sm`` (1 or 2) if given."""
    name = "decoder_layer_step"
    cdt = x.dtype
    if cdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: x must be float32 or bfloat16, got {cdt}")
    vw = 16 // cdt.itemsize
    b, d = x.shape
    n_img, tm, _ = mem_k.shape
    cache_len = self_k.shape[1]
    f = weights["l1_w"].shape[1]
    w = min(window, cache_len)
    head_w, head_b, v_real = head if head is not None else (None, None, 0)
    tensors = {"x": x, "self_k": self_k, "self_v": self_v, "mem_k": mem_k, "mem_v": mem_v,
               "mem_valid_f": mem_valid_f, "lineage": lineage, "head_w": head_w, "head_b": head_b,
               "pos": pos if isinstance(pos, torch.Tensor) else None, **weights}
    _check_operands(name, tensors, x.device, {"x", "self_k", "self_v", "mem_k", "mem_v", "head_w", *MATRIX_FIELDS},
                    cdt)
    if not isinstance(pos, torch.Tensor) or pos.numel() != 1:
        raise TypeError(f"{name}: pos must be a one-element int32 tensor on the card (the kernel reads it there), "
                        f"got {type(pos).__name__}")
    expect = {
        "self_k": (b, cache_len, d), "self_v": (b, cache_len, d), "mem_k": (n_img, tm, d),
        "mem_v": (n_img, tm, d), "mem_valid_f": (n_img, tm),
        "qkv_w": (d, 3 * d), "qkv_b": (3 * d,), "so_w": (d, d), "so_b": (d,), "cq_w": (d, d), "cq_b": (d,),
        "co_w": (d, d), "co_b": (d,), "l1_w": (d, f), "l1_b": (f,), "l2_w": (f, d), "l2_b": (d,),
        **{k: (d,) for k in ("ln1_s", "ln1_b", "ln2_s", "ln2_b", "ln3_s", "ln3_b")},
    }
    if lineage is not None:
        expect["lineage"] = (b, w)
    vp = 0
    if head is not None:
        vp = head_w.shape[1]
        expect.update(head_w=(d, vp), head_b=(vp,))
    for key, shape in expect.items():
        if tuple(tensors[key].shape) != shape:
            raise ValueError(f"{name}: {key} has shape {tuple(tensors[key].shape)}, expected {shape}")
    if lanes < 1 or n_img * lanes != b:
        raise ValueError(f"{name}: {b} rows are not {n_img} images x {lanes} lanes")
    group, clusters, ctas = k2_geometry(n_img, lanes, num_heads, tm)
    if route is None:  # a lineage at one lane (a beam of 1 called directly) keeps the cluster route
        route = "cluster" if lineage is not None else k2_route(n_img, lanes, tm, cdt.itemsize, head is not None, d,
                                                              num_heads, f)
    if route == "card":
        if (cdt != torch.float32 or head is not None or not k2_card_fits(d, num_heads, f) or lanes != 1
                or lineage is not None or b > CARD_MAX_ROWS):
            raise ValueError(f"{name}: the card route takes float32 greedy batches of at most {CARD_MAX_ROWS} rows "
                             f"without the head at widths it fits (D={d}, heads={num_heads}, F={f}), got {cdt}, "
                             f"{b} rows, {lanes} lane(s), lineage {lineage is not None}, head {head is not None}")
        return _card_launch(weights, x, pos, self_k, self_v, mem_k, mem_v, mem_valid_f, num_heads, f)
    if route != "cluster":
        raise ValueError(f"{name}: route {route!r}: 'card' or 'cluster'")
    split = ctas // num_heads if split is None else split
    if ctas_an_sm is None:
        ctas_an_sm = 2 if k2_two_ctas_an_sm(clusters, num_heads * split) else 1
    if ctas_an_sm not in (1, 2):
        raise ValueError(f"{name}: ctas_an_sm {ctas_an_sm}: 1 or 2")
    if split not in (1, 2) or num_heads * split > MAX_CLUSTER or d % num_heads or (d // num_heads) % (vw * split) \
            or f % (num_heads * split) or (f // (num_heads * split)) % vw:
        raise ValueError(f"{name}: D={d}, F={f}, heads={num_heads}, {split} CTA(s) a head (needs at most "
                         f"{MAX_CLUSTER} CTAs, D/(heads x split) and F/(heads x split) multiples of {vw})")
    if head is not None and not (head_columns_fit(vp, d, num_heads, split, cdt.itemsize) and 1 <= v_real <= vp):
        raise ValueError(f"{name}: the head's {vp} columns must be a multiple of {vw * num_heads * split} and at "
                         f"most D={d}, with 1 <= v_real={v_real} <= {vp}")
    lib = build.load(build.library_name(name, cdt, two_ctas=ctas_an_sm == 2))
    smem = lib.decoder_layer_step_smem_bytes(group, d, num_heads, f, split, vw)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: needs {smem} bytes of shared memory, more than {SMEM_LIMIT}")
    out = torch.empty_like(x)
    logp = None if head is None else torch.empty(b, vp, dtype=torch.float32, device=x.device)
    ptrs = [x, self_k, self_v, mem_k, mem_v, mem_valid_f, lineage, *(weights[k] for k in WEIGHT_FIELDS), out,
            head_w, head_b, logp]
    arr = (ctypes.c_void_p * len(ptrs))(*[None if t is None else t.data_ptr() for t in ptrs])
    fn = lib.decoder_layer_step_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(ctypes.cast(arr, ctypes.c_void_p), pos.data_ptr(), n_img, lanes, group, d, num_heads, f, cache_len, tm, w,
             split, int(cdt == torch.bfloat16), vp, v_real, stream)
    build.check(err, name)
    build.count_launch(stream, k2=1, k2_bf16=int(cdt == torch.bfloat16), k2_head=int(head is not None))
    return out if head is None else (out, logp)


def _card_launch(weights, x, pos, self_k, self_v, mem_k, mem_v, mem_valid_f, num_heads, f):
    """The card route's launches on checked operands -> the layer output (B, D)."""
    b, d = x.shape
    split = [k2_card_split(n, k) for n, k in ((3 * d, d), (d, d), (f, d), (d, f))]  # qkv, co, l1, l2
    cols = [nc for nc, _ in split] + [parts for _, parts in split]
    out = torch.empty_like(x)
    scratch = torch.empty(b * (5 * d + f + split[-1][1] * d + num_heads * d), dtype=torch.float32, device=x.device)
    ptrs = [x, self_k, self_v, mem_k, mem_v, mem_valid_f, *(weights[k] for k in WEIGHT_FIELDS), out, scratch]
    arr = (ctypes.c_void_p * len(ptrs))(*[t.data_ptr() for t in ptrs])
    col_arr = (ctypes.c_int * len(cols))(*cols)
    lib = build.load("decoder_layer_card")
    fn = lib.decoder_layer_card_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(ctypes.cast(arr, ctypes.c_void_p), pos.data_ptr(), ctypes.cast(col_arr, ctypes.c_void_p), b, d,
             num_heads, f, self_k.shape[1], mem_k.shape[1], stream)
    build.check(err, "decoder_layer_step (card route)")
    build.count_launch(stream, k2=1, k2_card=1)
    return out


_BLOCK_WEIGHTS = {"self": ("qkv_w", "qkv_b", "so_w"), "cross": ("cq_w", "cq_b", "co_w"),
                  "ffn": ("l1_w", "l1_b", "l2_w"), "finish": ()}


def decoder_block_plain(kind, weights, x, part=None, pos=0, self_k=None, self_v=None, mem_k=None, mem_v=None,
                        mem_valid_f=None, lineage=None, *, num_heads: int, window: int = 1, lanes: int = 1,
                        prologue=None, round_x: bool = False, dtype=torch.float32):
    """One tensor-parallel block of the local heads (see ``decoder_block``)."""
    xf = x.float()
    if part is not None:
        pb, ln_s, ln_b = prologue
        xf = layer_norm({"scale": ln_s, "bias": ln_b}, xf + (part + pb))
    if round_x:
        xf = _round(xf, dtype)
    if kind == "finish":
        return xf, None
    b = xf.shape[0]
    if kind == "self":
        da = weights["qkv_w"].shape[1] // 3
        qkv = _round(_dot(xf, weights["qkv_w"]) + weights["qkv_b"], dtype)
        write_slot(self_k, pos, qkv[:, da:2 * da])
        write_slot(self_v, pos, qkv[:, 2 * da:])
        k_read, v_read, valid = _self_rows(self_k, self_v, xf, pos, lineage, window, lanes)
        o = _attend(qkv[:, None, :da], k_read, v_read, valid, num_heads, dtype)[:, 0]
        return xf, _dot(o, weights["so_w"])
    if kind == "cross":
        da = weights["cq_w"].shape[1]
        qc = _round(_dot(xf, weights["cq_w"]) + weights["cq_b"], dtype)
        n_img = mem_k.shape[0]
        o = _attend(qc.reshape(n_img, b // n_img, da), mem_k, mem_v, mem_valid_f > 0, num_heads, dtype)
        return xf, _dot(o.reshape(b, da), weights["co_w"])
    if kind != "ffn":
        raise ValueError(f"decoder_block: unknown kind {kind!r} (one of {sorted(BLOCK_KINDS)})")
    return xf, _dot(torch.relu(_dot(xf, weights["l1_w"]) + weights["l1_b"]), weights["l2_w"])


def decoder_block(kind, weights, x, part=None, pos=0, self_k=None, self_v=None, mem_k=None, mem_v=None,
                  mem_valid_f=None, lineage=None, *, num_heads: int, window: int = 1, lanes: int = 1,
                  prologue=None, round_x: bool = False, dtype=torch.float32):
    """One tensor-parallel block -> (x_out (B, D) float32, part (B, D) float32,
    None for "finish"). ``weights``: the rank's ``layer_weights`` (local
    columns and rows), ``num_heads`` its local heads, ``dtype`` the storage
    type. ``part`` (B, D), the all-reduced partial sum of the block before,
    with ``prologue`` = (its bias, LayerNorm scale, LayerNorm bias): the
    block first sets x = LN(x + (part + bias)), then rounds x to ``dtype``
    when ``round_x`` (a layer's output). "self" also writes the local
    heads' k and v at slot ``pos`` of the local caches."""
    if x.device.type == "cpu":
        return decoder_block_plain(kind, weights, x, part, pos, self_k, self_v, mem_k, mem_v, mem_valid_f, lineage,
                                   num_heads=num_heads, window=window, lanes=lanes, prologue=prologue,
                                   round_x=round_x, dtype=dtype)
    return decoder_block_kernel(kind, weights, x, part, pos, self_k, self_v, mem_k, mem_v, mem_valid_f, lineage,
                                num_heads=num_heads, window=window, lanes=lanes, prologue=prologue,
                                round_x=round_x, dtype=dtype)


def decoder_block_kernel(kind, weights, x, part=None, pos=0, self_k=None, self_v=None, mem_k=None, mem_v=None,
                         mem_valid_f=None, lineage=None, *, num_heads: int, window: int = 1, lanes: int = 1,
                         prologue=None, round_x: bool = False, dtype=torch.float32, split: int | None = None):
    """The block kernel on CUDA tensors: one cluster per image and group of
    lanes with one CTA per local head, or two for the cross block of a
    long memory (``geometry.k2_geometry`` on the block's memory length; the
    other blocks read no memory), or ``split`` (1 or 2) if given."""
    name = "decoder_block"
    if kind not in BLOCK_KINDS:
        raise ValueError(f"{name}: unknown kind {kind!r} (one of {sorted(BLOCK_KINDS)})")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: the storage type must be float32 or bfloat16, got {dtype}")
    if kind == "finish" and part is None:
        raise ValueError(f"{name}: finish needs the partial sum and its prologue")
    vw = 16 // dtype.itemsize
    b, d = x.shape
    da = weights["cq_w"].shape[1]
    fl = weights["l1_w"].shape[1]
    hd = da // num_heads if num_heads else 0
    if not num_heads or da % num_heads or num_heads > MAX_CLUSTER:
        raise ValueError(f"{name}: local width {da} over {num_heads} local heads (at most {MAX_CLUSTER})")
    pb, ln_s, ln_b = prologue if part is not None else (None, None, None)
    w0, b0, w1 = (weights[k] for k in _BLOCK_WEIGHTS[kind]) if kind != "finish" else (None, None, None)
    n_img, tm, cache_len, w = b // lanes, 1, 1, 1
    if kind == "cross":
        n_img, tm, _ = mem_k.shape
    if kind == "self":
        cache_len = self_k.shape[1]
        w = min(window, cache_len)
        if tuple(self_k.shape) != (b, cache_len, da) or tuple(self_v.shape) != (b, cache_len, da):
            raise ValueError(f"{name}: the caches must be ({b}, L, {da})")
        if lineage is not None and tuple(lineage.shape) != (b, w):
            raise ValueError(f"{name}: lineage has shape {tuple(lineage.shape)}, expected {(b, w)}")
        if not 0 <= pos < w:
            raise ValueError(f"{name}: pos {pos} outside the window {w}")
    if kind == "cross" and (tuple(mem_k.shape) != (n_img, tm, da) or tuple(mem_v.shape) != (n_img, tm, da)
                            or tuple(mem_valid_f.shape) != (n_img, tm)):
        raise ValueError(f"{name}: memory K/V must be (images, Tm, {da}) and mem_valid_f (images, Tm)")
    if lanes < 1 or n_img * lanes != b:
        raise ValueError(f"{name}: {b} rows are not {n_img} images x {lanes} lanes")
    tensors = {"x": x, "part": part, "pb": pb, "ln_s": ln_s, "ln_b": ln_b, "w0": w0, "b0": b0, "w1": w1}
    if kind == "self":
        tensors.update(self_k=self_k, self_v=self_v, lineage=lineage)
    if kind == "cross":
        tensors.update(mem_k=mem_k, mem_v=mem_v, mem_valid_f=mem_valid_f)
    _check_operands(name, tensors, x.device, {"self_k", "self_v", "mem_k", "mem_v", "w0", "w1"}, dtype)
    group, _, ctas = k2_geometry(n_img, lanes, num_heads, tm)
    split = ctas // num_heads if split is None else split
    ncta = num_heads * split
    if split not in (1, 2) or ncta > MAX_CLUSTER or hd % (vw * split) or d % ncta or (d // ncta) % vw \
            or fl % ncta or (fl // ncta) % vw:
        raise ValueError(f"{name}: D={d}, local FFN width {fl}, {num_heads} local heads of {hd}, {split} CTA(s) a "
                         f"head (needs at most {MAX_CLUSTER} CTAs, the head width over the CTAs a head, D/CTAs and "
                         f"FFN/CTAs multiples of {vw})")
    lib = build.load(build.library_name(name, dtype))
    smem = lib.decoder_block_smem_bytes(group, d, da, hd, fl, split, vw)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: needs {smem} bytes of shared memory, more than {SMEM_LIMIT}")
    x_out = torch.empty(b, d, dtype=torch.float32, device=x.device)
    part_out = None if kind == "finish" else torch.empty(b, d, dtype=torch.float32, device=x.device)
    ptrs = [x, part, pb, ln_s, ln_b, x_out, part_out, tensors.get("self_k"), tensors.get("self_v"),
            tensors.get("mem_k"), tensors.get("mem_v"), tensors.get("mem_valid_f"), tensors.get("lineage"), w0, b0,
            w1]
    arr = (ctypes.c_void_p * len(ptrs))(*[None if t is None else t.data_ptr() for t in ptrs])
    fn = lib.decoder_block_launch
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 15 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(ctypes.cast(arr, ctypes.c_void_p), BLOCK_KINDS[kind], int(round_x), n_img, lanes, group, d, da, hd, fl,
             cache_len, tm, pos, w, split, int(dtype == torch.bfloat16), stream)
    build.check(err, name)
    build.count_launch(stream, k2_block=1)
    return x_out, part_out
