"""The chunk-and-merge recognition model: encode and the incremental decode step.

CNN backbone over fixed 48x100 chunks -> patch projection (32 tokens per
chunk) -> per-chunk transformer encoder -> per-line concatenation + learned
global positions -> BiLSTM -> transformer decoder over characters.

A batch is a static (B, N, H, W) tensor with per-line chunk counts; chunks of
one line are contiguous along N, so the merge is a reshape and padding chunks
land at the tail. The decoder runs one position at a time over preallocated
caches; on the card each decoder layer of each step is one launch of kernel K2
(ops/kernels/decode_step.py).

``params`` is the port's state: nested dicts of tensors as made by
convert/from_jax.py (BatchNorm statistics folded into the backbone's
``bn_conv*`` entries).
"""

from __future__ import annotations

import torch

from ..config import ModelConfig
from ..ops.kernels.decode_step import decoder_layer_step, layer_weights
from . import backbones
from .bilstm import bilstm_apply
from .layers import dense, encoder_layer, pack_step_params

CHUNK_TOKENS = 32  # patch tokens per 48x100 chunk
# The decode loops run on the host, and an early-exit test needs a device
# sync, so it is made every EXIT_CHECK_EVERY steps. The exits are provably
# safe, so the tokens do not depend on this value.
EXIT_CHECK_EVERY = 4


def patch_apply(p: dict, f: torch.Tensor) -> torch.Tensor:
    """(B, 2, 32, C) backbone features -> (B, 32, D) tokens: each width
    column's two rows are concatenated (h-major, then c) and projected."""
    b = f.shape[0]
    x = f.permute(0, 2, 1, 3).reshape(b, CHUNK_TOKENS, -1)
    return dense(p["proj"], x) + p["pos_emb"][:CHUNK_TOKENS]


def encode(params: dict, chunks: torch.Tensor, chunk_counts: torch.Tensor, cfg: ModelConfig):
    """chunks: (B, N, H, W) normalised; chunk_counts: (B,) valid chunks.
    Returns (memory (B, N*32, D), pad_mask (B, N*32) True = padding)."""
    b, n, h, w = chunks.shape
    f = backbones.BACKBONE_APPLY[cfg.backbone](params["backbone"], chunks.reshape(b * n, h, w, 1))
    tok = patch_apply(params["patch"], f)
    for lp in params["enc"]:
        tok = encoder_layer(lp, cfg.num_heads, tok)
    t = n * CHUNK_TOKENS
    memory = tok.reshape(b, t, tok.shape[-1]) + params["global_pos"][:t]
    lengths = chunk_counts.to(torch.long) * CHUNK_TOKENS
    if cfg.use_bilstm:
        memory = bilstm_apply(params["bilstm"], memory, lengths)
    pad_mask = torch.arange(t, device=memory.device)[None, :] >= lengths[:, None]
    return memory, pad_mask


def init_decode_state(params: dict, memory, pad_mask, cfg: ModelConfig, lanes: int = 1,
                      cache_len: int | None = None) -> dict:
    """Per-layer memory K/V (one copy per image, shared by its ``lanes``) and
    zeroed self-attention caches (B*lanes, cache_len, D)."""
    b, _, d = memory.shape
    n = cfg.decode_max_len if cache_len is None else min(cache_len, cfg.decode_max_len)
    layers = params["dec"]["layers"]
    mem_kv = [(dense(lp["cross"]["k"], memory).contiguous(), dense(lp["cross"]["v"], memory).contiguous())
              for lp in layers]
    self_kv = [(memory.new_zeros(b * lanes, n, d), memory.new_zeros(b * lanes, n, d)) for _ in layers]
    mem_valid = ~pad_mask
    return {"mem_kv": mem_kv, "self_kv": self_kv, "mem_valid": mem_valid,
            "mem_valid_f": mem_valid.to(memory.dtype).contiguous()}


def pack_decode_params(params: dict) -> dict:
    """Decoder layers with the packed self-QKV, and each layer's kernel operands."""
    dec = dict(params["dec"])
    dec["layers"] = [pack_step_params(lp) for lp in dec["layers"]]
    dec["layers_kernel"] = [layer_weights(lp) for lp in dec["layers"]]
    return {**params, "dec": dec}


def decode_step(params: dict, state: dict, tokens: torch.Tensor, pos: int, cfg: ModelConfig,
                window: int | None = None, lineage_local=None) -> torch.Tensor:
    """One decode step for all lanes: tokens (B,) at position ``pos`` ->
    logits (B, V). The self caches in ``state`` are updated in place.
    ``lineage_local`` (B, window) int32: image-local beam parents (beam only).
    ``params`` come from ``pack_decode_params``."""
    dec = params["dec"]
    x = dec["tok_emb"][tokens] + dec["pos_emb"][pos]
    sk0, _ = state["self_kv"][0]
    lanes = sk0.shape[0] // state["mem_kv"][0][0].shape[0]
    w = window if window is not None else sk0.shape[1]
    for lw, (sk, sv), (mk, mv) in zip(dec["layers_kernel"], state["self_kv"], state["mem_kv"]):
        x = decoder_layer_step(lw, x, pos, sk, sv, mk, mv, state["mem_valid_f"], lineage_local,
                               num_heads=cfg.num_heads, window=w, lanes=lanes)
    return dense(dec["out"], x)


def decode_windows(max_len: int, base: int = 32) -> tuple[int, ...]:
    """Geometric cache-window schedule: (32, 64, 128, ..., max_len)."""
    windows = []
    w = base
    while w < max_len:
        windows.append(w)
        w *= 2
    windows.append(max_len)
    return tuple(windows)
