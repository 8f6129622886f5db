"""Transformer building blocks (post-LN, ReLU) and the plain decode step.

Parameters are plain dicts of tensors in the JAX package's layout: dense
weights are (in, out), applied as ``x @ w + b``; LayerNorm has "scale" and
"bias". K/V caches are merged-head (..., T, D).

``decoder_layer_step`` is the plain decode step of one decoder layer; it
updates the self-attention caches in place at slot ``pos``. On the card the
decode loop runs the hand-written kernel instead (ops/kernels/decode_step.py),
which is held against this function.
"""

from __future__ import annotations

import math

import torch

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


def mha(p: dict, num_heads: int, q_in, kv_in):
    """Unmasked multi-head attention (the encoder's, within one chunk)."""
    q = _split_heads(dense(p["q"], q_in), num_heads)
    k = _split_heads(dense(p["k"], kv_in), num_heads)
    v = _split_heads(dense(p["v"], kv_in), num_heads)
    hd = q.shape[-1]
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd)
    w = torch.softmax(logits, dim=-1)
    return dense(p["o"], _merge_heads(torch.einsum("bhqk,bhkd->bhqd", w, v)))


def ffn(p: dict, x: torch.Tensor) -> torch.Tensor:
    return dense(p["lin2"], torch.relu(dense(p["lin1"], x)))


def encoder_layer(p: dict, num_heads: int, x: torch.Tensor) -> torch.Tensor:
    x = layer_norm(p["ln1"], x + mha(p["self"], num_heads, x, x))
    return layer_norm(p["ln2"], x + ffn(p, x))


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


def decoder_layer_step(p: dict, num_heads: int, x, pos: int, self_k, self_v, mem_k, mem_v, mem_valid,
                       window: int | None = None, lineage_idx=None):
    """One decoder layer at position ``pos`` for a batch of lanes.

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
    self_k[:, pos] = k_t
    self_v[:, pos] = v_t
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
