"""The chunk-and-merge recognition model: encode, the teacher-forced decode
(training) and the incremental decode step.

CNN backbone over fixed 48x100 chunks -> patch projection (32 tokens per
chunk) -> per-chunk transformer encoder -> per-line concatenation + learned
global positions -> BiLSTM -> transformer decoder over characters.

A batch is a static (B, N, H, W) tensor with per-line chunk counts; chunks of
one line are contiguous along N, so the merge is a reshape and padding chunks
land at the tail. The decoder runs one position at a time over preallocated
caches; on the card each decoder layer of each step is one launch of kernel K2
(ops/kernels/decode_step.py), or the whole beam decode is one launch of
kernel K3 (ops/kernels/decode_loop.py).

The backbone is the configuration's: se_vgg (the flagship, with the BiLSTM),
or the vgg and resnet baselines (without it).

``params`` is the port's state: nested dicts of tensors as made by
convert/from_jax.py (BatchNorm statistics folded into the backbone's
``bn_conv*`` entries). Training keeps the trainable params and the
BatchNorm statistics apart (``init_model``) and passes the statistics to
``encode``/``forward_train`` as ``batch_stats``.

The compute dtype follows the params: bfloat16 params (the serving speed
mode, infer/predictor.py) give bfloat16 activations, caches and memory;
the BatchNorm statistics stay float32 and are cast where they are used,
the BiLSTM's recurrence runs in float32, ``mem_valid_f`` is float32.

``model_group``: a tensor-parallel process group over which the params are
split (parallel/placement.py); the encoder's and the decoder's attention
and FFN take their local heads and columns (models/layers.py), the token
embedding is a masked lookup of the local vocabulary rows all-reduced, the
vocabulary projection the local columns all-gathered, and each decode
step's layer runs as three blocks with an all-reduce after each
(``tp_decode_layers``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..config import ModelConfig
from ..convert.from_jax import seeded_params, trainable_from_jax
from ..ops.kernels.decode_step import decoder_block, decoder_layer_step, layer_weights
from ..parallel.mesh import copy_to_model, gather_from_model, reduce_from_model, tp_active, world_of
from . import backbones
from .bilstm import bilstm_apply
from .layers import decoder_layer, dense, encoder_layer, pack_step_params

CHUNK_TOKENS = 32  # patch tokens per 48x100 chunk
# The decode loops run their steps in chunks of EXIT_CHECK_EVERY (on the
# card each chunk is one replay of a captured CUDA graph, decode/graphs.py)
# and test the early exit, which needs a device sync, between chunks. The
# exits are provably safe, so the tokens do not depend on this value.
EXIT_CHECK_EVERY = 4


def patch_apply(p: dict, f: torch.Tensor) -> torch.Tensor:
    """(B, 2, 32, C) backbone features -> (B, 32, D) tokens: each width
    column's two rows are concatenated (h-major, then c) and projected."""
    b = f.shape[0]
    x = f.permute(0, 2, 1, 3).reshape(b, CHUNK_TOKENS, -1)
    return dense(p["proj"], x) + p["pos_emb"][:CHUNK_TOKENS]


def init_model(cfg: ModelConfig, seed: int = 0, device="cpu") -> tuple[dict, dict]:
    """(params, batch_stats) for training from a numpy seed
    (convert/from_jax.py::seeded_params): float32 trees on ``device``, the
    BatchNorm statistics apart from the trainable params."""
    return trainable_from_jax(*seeded_params(cfg, seed), cfg, device=device)


def encode(params: dict, chunks: torch.Tensor, chunk_counts: torch.Tensor, cfg: ModelConfig, train: bool = False,
           drop=None, batch_stats: dict | None = None, group=None, model_group=None):
    """chunks: (B, N, H, W) normalised; chunk_counts: (B,) valid chunks.
    Returns (memory (B, N*32, D), pad_mask (B, N*32) True = padding), and in
    ``train`` mode also the BatchNorm statistics the batch moved
    (``batch_stats`` holds the running ones; without it they are read from
    ``params``). ``drop``: the encoder layers' dropout (layers.Dropout).
    ``group``: the process group of data-parallel training, over whose
    whole batch the backbone's BatchNorm takes its statistics;
    ``model_group`` the tensor-parallel group of the encoder layers."""
    b, n, h, w = chunks.shape
    f, new_stats = backbones.BACKBONE_APPLY[cfg.backbone](params["backbone"], chunks.reshape(b * n, h, w, 1),
                                                          batch_stats, train, group)
    tok = patch_apply(params["patch"], f)
    for lp in params["enc"]:
        tok = encoder_layer(lp, cfg.num_heads, tok, drop, model_group)
    t = n * CHUNK_TOKENS
    memory = tok.reshape(b, t, tok.shape[-1]) + params["global_pos"][:t]
    lengths = chunk_counts.to(torch.long) * CHUNK_TOKENS
    if cfg.use_bilstm:
        memory = bilstm_apply(params["bilstm"], memory, lengths)
    pad_mask = torch.arange(t, device=memory.device)[None, :] >= lengths[:, None]
    return (memory, pad_mask, new_stats) if train else (memory, pad_mask)


def embed(tok_emb: torch.Tensor, tokens: torch.Tensor, model_group=None) -> torch.Tensor:
    """Token embedding rows; under a model group ``tok_emb`` holds this
    rank's block of the vocabulary, looked up where the token falls in it
    (zeros elsewhere) and summed over the group."""
    if not tp_active(model_group):
        return tok_emb[tokens]
    rank = world_of(model_group)[0]
    n = tok_emb.shape[0]
    local = tokens - rank * n
    inside = (local >= 0) & (local < n)
    rows = tok_emb[local.clamp(0, n - 1)] * inside[..., None].to(tok_emb.dtype)
    return reduce_from_model(rows, model_group)


def vocab_logits(out: dict, x: torch.Tensor, model_group=None) -> torch.Tensor:
    """The vocabulary projection; under a model group this rank's columns,
    gathered in rank order."""
    if not tp_active(model_group):
        return dense(out, x)
    return gather_from_model(dense(out, copy_to_model(x, model_group)), model_group)


def decode_train(params: dict, memory, memory_pad_mask, tgt_tokens, cfg: ModelConfig, drop=None, model_group=None):
    """Teacher-forced decode: tgt_tokens (B, T) -> logits (B, T, V), with a
    causal mask and the target's padding masked."""
    dec = params["dec"]
    t = tgt_tokens.shape[1]
    max_t = dec["pos_emb"].shape[0]
    if t > max_t:
        raise ValueError(f"target length {t} exceeds the decoder's positional embedding ({max_t}); "
                         f"truncate labels to decode_max_len + 1 (see train/data.py label buckets)")
    x = embed(dec["tok_emb"], tgt_tokens, model_group) + dec["pos_emb"][:t][None]
    tgt_pad = tgt_tokens == cfg.pad_idx
    for lp in dec["layers"]:
        x = decoder_layer(lp, cfg.num_heads, x, memory, tgt_key_padding_mask=tgt_pad,
                          memory_key_padding_mask=memory_pad_mask, drop=drop, model_group=model_group)
    return vocab_logits(dec["out"], x, model_group)


def forward_train(params: dict, batch_stats: dict, chunks, chunk_counts, tgt_in, cfg: ModelConfig, drop=None,
                  train: bool = True, group=None, model_group=None):
    """(chunks, tgt_in) -> (logits, new batch_stats): the teacher-forced forward."""
    if train:
        memory, pad_mask, new_stats = encode(params, chunks, chunk_counts, cfg, True, drop, batch_stats, group,
                                             model_group)
    else:
        memory, pad_mask = encode(params, chunks, chunk_counts, cfg, False, drop, batch_stats,
                                  model_group=model_group)
        new_stats = batch_stats
    return decode_train(params, memory, pad_mask, tgt_in, cfg, drop, model_group), new_stats


def memory_kv(params: dict, memory) -> list:
    """Each decoder layer's cross-attention K and V of the memory (B, Tm, D)
    (this rank's heads' columns under a model group)."""
    return [(dense(lp["cross"]["k"], memory).contiguous(), dense(lp["cross"]["v"], memory).contiguous())
            for lp in params["dec"]["layers"]]


def init_decode_state(params: dict, memory, memory_pad_mask, cfg: ModelConfig, lanes: int = 1,
                      cache_len: int | None = None) -> dict:
    """Per-layer memory K/V (one copy per image, shared by its ``lanes``) and
    zeroed self-attention caches (B*lanes, cache_len, D), in the memory's
    dtype; under a model group of M ranks both hold the local heads' D/M
    columns. ``mem_valid_f`` is float32 whatever the dtype, as in the JAX
    package."""
    b = memory.shape[0]
    n = cfg.decode_max_len if cache_len is None else min(cache_len, cfg.decode_max_len)
    mem_kv = memory_kv(params, memory)
    self_kv = [(memory.new_zeros(b * lanes, n, mk.shape[-1]), memory.new_zeros(b * lanes, n, mk.shape[-1]))
               for mk, _ in mem_kv]
    mem_valid = ~memory_pad_mask
    return {"mem_kv": mem_kv, "self_kv": self_kv, "mem_valid": mem_valid,
            "mem_valid_f": mem_valid.to(torch.float32).contiguous()}


def pack_decode_params(params: dict) -> dict:
    """Decoder layers with the packed self-QKV, and each layer's kernel operands."""
    dec = dict(params["dec"])
    dec["layers"] = [pack_step_params(lp) for lp in dec["layers"]]
    dec["layers_kernel"] = [layer_weights(lp) for lp in dec["layers"]]
    return {**params, "dec": dec}


def decode_hidden(params: dict, state: dict, tokens: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig,
                  window: int | None = None, lineage_local=None, layer_step=None, head=None, model_group=None):
    """The decoder layers of one step for all lanes: tokens (B,) at position
    ``pos`` (a 0-d int32 tensor on the tokens' device, read there, as the
    JAX package's traced ``pos``) -> the last layer's output (B, D), and with ``head``
    (ops/kernels/decode_step.py::head_weights) also its log-probs (B, Vp)
    from the last layer's launch. The self caches in ``state`` are updated
    in place. ``lineage_local`` (B, window) int32: image-local beam parents
    (beam only). ``params`` come from ``pack_decode_params``. ``layer_step``
    replaces the layer (default: the kernel K2 wrapper). Under a model group
    of more than one rank each layer is ``tp_decode_layers``' three blocks
    (no head), which take ``pos`` by value: that path reads it on the host
    (its all-reduces wait on the host anyway)."""
    dec = params["dec"]
    layer_step = layer_step or decoder_layer_step
    x = embed(dec["tok_emb"], tokens, model_group) + dec["pos_emb"].index_select(0, pos.reshape(1))
    sk0, _ = state["self_kv"][0]
    lanes = sk0.shape[0] // state["mem_kv"][0][0].shape[0]
    w = window if window is not None else sk0.shape[1]
    if tp_active(model_group):
        return tp_decode_layers(dec["layers_kernel"], state, x, int(pos), cfg, w, lineage_local, lanes, model_group)
    last = len(dec["layers_kernel"]) - 1
    for li, (lw, (sk, sv), (mk, mv)) in enumerate(zip(dec["layers_kernel"], state["self_kv"], state["mem_kv"])):
        extra = {"head": head} if head is not None and li == last else {}
        x = layer_step(lw, x, pos, sk, sv, mk, mv, state["mem_valid_f"], lineage_local,
                       num_heads=cfg.num_heads, window=w, lanes=lanes, **extra)
    return x


def decode_step(params: dict, state: dict, tokens: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig,
                window: int | None = None, lineage_local=None, layer_step=None, model_group=None) -> torch.Tensor:
    """One decode step for all lanes: tokens (B,) at position ``pos`` ->
    logits (B, V) (``decode_hidden``, then the vocabulary projection)."""
    x = decode_hidden(params, state, tokens, pos, cfg, window, lineage_local, layer_step, model_group=model_group)
    return vocab_logits(params["dec"]["out"], x, model_group)


def tp_decode_layers(layers: list, state: dict, x: torch.Tensor, pos: int, cfg: ModelConfig, window: int,
                     lineage_local, lanes: int, model_group, block=None) -> torch.Tensor:
    """Every decoder layer of one step under a model group: each layer's
    self, cross and FFN blocks (ops/kernels/decode_step.py::decoder_block,
    kernel K2's tensor-parallel form on the card), the partial sum of each
    all-reduced over the group before the next block's residual, bias and
    LayerNorm; a last launch takes the last layer's LN3. x: the embedded
    tokens (B, D); returns the last layer's output in x's dtype."""
    block = block or decoder_block
    cdt = x.dtype
    heads = cfg.num_heads // world_of(model_group)[1]
    kw = dict(num_heads=heads, window=window, lanes=lanes, dtype=cdt)
    xr, part, prologue = x.float(), None, None
    for lw, (sk, sv), (mk, mv) in zip(layers, state["self_kv"], state["mem_kv"]):
        xr, part = block("self", lw, xr, part, pos, sk, sv, lineage=lineage_local, prologue=prologue,
                         round_x=prologue is not None, **kw)
        dist.all_reduce(part, group=model_group)
        xr, part = block("cross", lw, xr, part, pos, mem_k=mk, mem_v=mv, mem_valid_f=state["mem_valid_f"],
                         prologue=(lw["so_b"], lw["ln1_s"], lw["ln1_b"]), **kw)
        dist.all_reduce(part, group=model_group)
        xr, part = block("ffn", lw, xr, part, prologue=(lw["co_b"], lw["ln2_s"], lw["ln2_b"]), **kw)
        dist.all_reduce(part, group=model_group)
        prologue = (lw["l2_b"], lw["ln3_s"], lw["ln3_b"])
    xr, _ = block("finish", layers[-1], xr, part, prologue=prologue, round_x=True, **kw)
    return xr.to(cdt)


def decode_windows(max_len: int, base: int = 32) -> tuple[int, ...]:
    """Geometric cache-window schedule: (32, 64, 128, ..., max_len)."""
    windows = []
    w = base
    while w < max_len:
        windows.append(w)
        w *= 2
    windows.append(max_len)
    return tuple(windows)
