"""Transformer building blocks (post-LN, ReLU) and the plain decode step.

Parameters are plain dicts of tensors in the JAX package's layout: dense
weights are (in, out), applied as ``x @ w + b``; LayerNorm has "scale" and
"bias". K/V caches are merged-head (..., T, D).

Training passes a ``Dropout`` (rate, deterministic flag, generator) to
``mha``, ``ffn``, ``encoder_layer`` and ``decoder_layer``: dropout on the
attention weights and on every residual branch, as the JAX package's
``Ctx.drop``. Without one (inference) they compute what they computed
before, op for op.

``decoder_layer_step`` is the plain decode step of one decoder layer; it
updates the self-attention caches in place at slot ``pos``. On the card the
decode loop runs the hand-written kernel instead (ops/kernels/decode_step.py),
which is held against this function.

``model_group`` (``mha``, ``ffn``, ``encoder_layer``, ``decoder_layer``):
a tensor-parallel process group over which the params are split
(parallel/placement.py). Each rank then holds its heads' columns of q, k,
v and the matching rows of ``o``, its columns of ``lin1`` and rows of
``lin2`` (with the biases of the split columns); the partial sums of the
row-split products are all-reduced before their bias (parallel/mesh.py).
Without a group, or with a group of one rank, nothing changes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..parallel.mesh import copy_to_model, reduce_from_model, tp_active, world_of

NEG_INF = -1e30  # finite stand-in for -inf; masked softmax weights underflow to exactly 0
LN_EPS = 1e-5


def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def layer_norm(p: dict, x: torch.Tensor, eps: float = LN_EPS) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:  # (B, T, D) -> (B, H, T, hd)
    b, t, d = x.shape
    return x.reshape(b, t, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:  # (B, H, T, hd) -> (B, T, D)
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


@dataclass
class Dropout:
    """Inverted dropout for training: zero with probability ``rate``, scale
    the rest by 1 / (1 - rate); the identity when ``deterministic`` or at
    rate 0. The keep mask is drawn from ``generator``, which must live on
    the device of the tensors it drops."""

    rate: float = 0.0
    deterministic: bool = True
    generator: torch.Generator | None = None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.deterministic or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=self.generator, device=x.device, dtype=x.dtype) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def mha(p: dict, num_heads: int, q_in, kv_in, key_padding_mask=None, causal: bool = False, drop=None,
        model_group=None):
    """Multi-head attention. key_padding_mask: (B, Tk) bool, True = padding;
    ``causal`` masks keys after each query (Tq == Tk); ``drop`` applies to
    the attention weights. Under ``model_group``: this rank's heads."""
    if tp_active(model_group):
        same = kv_in is q_in
        q_in = copy_to_model(q_in, model_group)
        kv_in = q_in if same else copy_to_model(kv_in, model_group)
        num_heads //= world_of(model_group)[1]
    q = _split_heads(dense(p["q"], q_in), num_heads)
    k = _split_heads(dense(p["k"], kv_in), num_heads)
    v = _split_heads(dense(p["v"], kv_in), num_heads)
    hd = q.shape[-1]
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd)
    if causal:
        tq, tk = logits.shape[-2:]
        allowed = torch.ones(tq, tk, dtype=torch.bool, device=logits.device).tril()
        logits = logits.masked_fill(~allowed, NEG_INF)
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, :], NEG_INF)
    w = torch.softmax(logits, dim=-1)
    if drop is not None:
        w = drop(w)
    return _out_proj(p["o"], _merge_heads(torch.einsum("bhqk,bhkd->bhqd", w, v)), model_group)


def _out_proj(p: dict, x: torch.Tensor, model_group) -> torch.Tensor:
    """``dense(p, x)``; under a model group x holds this rank's rows of the
    product, whose partial sums are all-reduced before the bias."""
    if tp_active(model_group):
        return reduce_from_model(x @ p["w"], model_group) + p["b"]
    return dense(p, x)


def ffn(p: dict, x: torch.Tensor, drop=None, model_group=None) -> torch.Tensor:
    if tp_active(model_group):
        x = copy_to_model(x, model_group)
    h = torch.relu(dense(p["lin1"], x))
    if drop is not None:
        h = drop(h)
    return _out_proj(p["lin2"], h, model_group)


def encoder_layer(p: dict, num_heads: int, x: torch.Tensor, drop=None, model_group=None,
                  key_padding_mask=None) -> torch.Tensor:
    d = drop or _identity
    sa = mha(p["self"], num_heads, x, x, key_padding_mask=key_padding_mask, drop=drop, model_group=model_group)
    x = layer_norm(p["ln1"], x + d(sa))
    return layer_norm(p["ln2"], x + d(ffn(p, x, drop, model_group)))


def decoder_layer(p: dict, num_heads: int, x, memory, tgt_key_padding_mask=None, memory_key_padding_mask=None,
                  drop=None, model_group=None):
    """Teacher-forced decoder layer: causal, padding-masked self-attention,
    cross-attention over the memory, FFN; post-LN."""
    d = drop or _identity
    sa = mha(p["self"], num_heads, x, x, key_padding_mask=tgt_key_padding_mask, causal=True, drop=drop,
             model_group=model_group)
    x = layer_norm(p["ln1"], x + d(sa))
    ca = mha(p["cross"], num_heads, x, memory, key_padding_mask=memory_key_padding_mask, drop=drop,
             model_group=model_group)
    x = layer_norm(p["ln2"], x + d(ca))
    return layer_norm(p["ln3"], x + d(ffn(p, x, drop, model_group)))


def pack_step_params(p: dict) -> dict:
    """A decoder layer's params plus the packed (D, 3D) self-QKV projection."""
    packed = dict(p)
    packed["self_qkv"] = {
        "w": torch.cat([p["self"][n]["w"] for n in ("q", "k", "v")], dim=1).contiguous(),
        "b": torch.cat([p["self"][n]["b"] for n in ("q", "k", "v")], dim=0).contiguous(),
    }
    return packed


def _attend_merged(p_o: dict, num_heads: int, q, k_read, v_read, valid_mask):
    """One query per row over a merged-head (B, T, D) K/V window.
    valid_mask: (B, T) bool, True = attendable."""
    b, d = q.shape
    hd = d // num_heads
    t = k_read.shape[1]
    logits = torch.einsum("bhe,bthe->bth", q.reshape(b, num_heads, hd),
                          k_read.reshape(b, t, num_heads, hd)) / math.sqrt(hd)
    logits = logits.masked_fill(~valid_mask[:, :, None], NEG_INF)
    attn = torch.softmax(logits, dim=1)  # over T, per head
    out = torch.einsum("bth,bthe->bhe", attn, v_read.reshape(b, t, num_heads, hd)).reshape(b, d)
    return dense(p_o, out)


def _attend_merged_grouped(p_o: dict, num_heads: int, q, k_read, v_read, valid_mask):
    """`_attend_merged` where groups of K query rows (an image's beam lanes)
    share one (B, Tm, D) memory K/V; valid_mask: (B, Tm)."""
    bk, d = q.shape
    b, t, _ = k_read.shape
    lanes = bk // b
    hd = d // num_heads
    qh = q.reshape(b, lanes, num_heads, hd)
    logits = torch.einsum("bkhe,bthe->btkh", qh, k_read.reshape(b, t, num_heads, hd)) / math.sqrt(hd)
    logits = logits.masked_fill(~valid_mask[:, :, None, None], NEG_INF)
    attn = torch.softmax(logits, dim=1)  # over Tm, per (lane, head)
    out = torch.einsum("btkh,bthe->bkhe", attn, v_read.reshape(b, t, num_heads, hd))
    return dense(p_o, out.reshape(bk, d))


def _attend_beam(p_o: dict, num_heads: int, q, self_k, self_v, parent_idx, valid_mask):
    """Beam self-attention read through the lineage: row b reads slot t of
    row parent_idx[b, t] (absolute rows; slot pos maps to b itself)."""
    t_idx = torch.arange(parent_idx.shape[1], device=parent_idx.device)[None, :]
    k_read = self_k[parent_idx, t_idx]
    v_read = self_v[parent_idx, t_idx]
    return _attend_merged(p_o, num_heads, q, k_read, v_read, valid_mask)


def write_slot(cache: torch.Tensor, pos, rows: torch.Tensor) -> None:
    """cache[:, pos] = rows (in the cache's dtype), IN PLACE. ``pos``: a
    Python int, or a one-element integer tensor read on its device (no host
    read, so the write can be captured in a CUDA graph)."""
    if isinstance(pos, torch.Tensor):
        cache.index_copy_(1, pos.reshape(1).long(), rows.unsqueeze(1).to(cache.dtype))
    else:
        cache[:, pos] = rows


def decoder_layer_step(p: dict, num_heads: int, x, pos, self_k, self_v, mem_k, mem_v, mem_valid,
                       window: int | None = None, lineage_idx=None):
    """One decoder layer at position ``pos`` (an int or a one-element
    integer tensor: ``write_slot``) for a batch of lanes.

    ``p``: a layer of ``pack_step_params`` (packed self-QKV).
    x: (B, D). self_k/self_v: (B, L, D) caches, written IN PLACE at slot
    ``pos``. mem_k/mem_v: (B or B/K, Tm, D) memory projections; mem_valid:
    bool (same rows, Tm). ``window`` (pos < window): self-attention reads the
    first ``window`` slots. ``lineage_idx`` (B, w) int64: absolute row that
    wrote each slot of each lane's history, slot ``pos`` mapped to self.
    Returns (x_out, self_k, self_v)."""
    b, d = x.shape
    qkv = dense(p["self_qkv"], x)
    q_t, k_t, v_t = qkv[:, :d], qkv[:, d:2 * d], qkv[:, 2 * d:]
    write_slot(self_k, pos, k_t)
    write_slot(self_v, pos, v_t)
    w = self_k.shape[1] if window is None else min(window, self_k.shape[1])
    attendable = (torch.arange(w, device=x.device)[None, :] <= pos).expand(b, w)
    k_read, v_read = self_k[:, :w], self_v[:, :w]
    if lineage_idx is not None:
        sa = _attend_beam(p["self"]["o"], num_heads, q_t, k_read, v_read, lineage_idx[:, :w], attendable)
    else:
        sa = _attend_merged(p["self"]["o"], num_heads, q_t, k_read, v_read, attendable)
    x = layer_norm(p["ln1"], x + sa)
    q_c = dense(p["cross"]["q"], x)
    if mem_k.shape[0] != b:
        ca = _attend_merged_grouped(p["cross"]["o"], num_heads, q_c, mem_k, mem_v, mem_valid)
    else:
        ca = _attend_merged(p["cross"]["o"], num_heads, q_c, mem_k, mem_v, mem_valid)
    x = layer_norm(p["ln2"], x + ca)
    x = layer_norm(p["ln3"], x + ffn(p, x))
    return x, self_k, self_v
