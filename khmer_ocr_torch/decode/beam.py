"""Batched beam search over fixed-K lanes.

The same search as the JAX package's ``decode/beam.py``:
  * each beam expands its own top-K tokens; candidates are the union of the
    per-beam top-Ks;
  * every <eos> candidate retires with length-normalised score raw / (pos + 2)
    and replaces an image's best completion only on strict improvement;
  * the next K beams are the best K non-<eos> candidates, ties to the lowest
    flat (beam-major) index;
  * the answer is the best completion if any, else the top running beam.

Beams share prefixes through a pointer table: ``lineage[b, l, t]`` is the
image-local lane that wrote self-cache slot t of lane l's history, and the
decode step reads the caches through it instead of reordering them.

The steps run per cache window (32, 64, 128, 256) with the position on the
device: each step reads and advances a 0-d int32 ``pos`` and indexes the
tokens, lineage and length denominators with it, with no host read. On the
card the steps run as captured CUDA graphs of ``EXIT_CHECK_EVERY`` steps,
replayed window by window (decode/graphs.py), as the JAX package runs one
``lax.while_loop`` per window; on CPU tensors, under a model group (gloo's
collectives cannot be captured) or with ``eager=True`` (the graphs' oracle)
the same chunks run from a Python loop. The early exit is provably safe:
log-probs are <= 0, so a running beam with raw score s can never complete
above s / (max_len + 1); once that bound is <= the best completion for
every image, no later step changes an answer. Testing it needs a device
sync, so it runs between chunks; the tokens are the same for any chunk
length. On CUDA tensors a step's bookkeeping (log-softmax, top-K,
retirement, the next beams, tokens and lineage) is one launch of kernel K5
(ops/kernels/beam_step.py), which updates the state in place; on CPU
tensors it is ``torch.log_softmax`` and ``beam_advance``.

With ``DecodeConfig.mega_mode == "1"`` and inside the envelope of kernel K3
(2 <= K <= 4, Tm <= 128, max_len <= 64, vocab <= 128), the whole search runs
in one launch instead (ops/kernels/decode_loop.py): every step, no early exit,
the same tokens. Outside it the step loop runs, as in the JAX package.

``DecodeConfig.head_mode == "1"`` (None reads ``KHMER_OCR_FUSED_HEAD``)
fuses the decode head into the last layer's launch of kernel K2: it returns
the log-probs itself (ops/kernels/decode_step.py::head_weights). Opt-in
and beam-only, as in the JAX package; the tokens are the same. Where the
head does not fit K2's launch (a padded vocabulary wider than D, or not
split evenly over the CTAs: ``decode_step.head_fits``), the normal head
runs, as the JAX package's ``head_fusion_compatible`` gates it.

``model_group``: a tensor-parallel group over which the params are split.
Each layer step is then K2's three blocks with an all-reduce after each,
the logits are gathered over the group, and every rank runs the same
search. K3 and the fused head stay off under a group of more than one rank
(the whole decode in one launch leaves no point for a collective, and the
head's vocabulary columns are split); the tokens are the same.
"""

from __future__ import annotations

import os

import torch

from ..config import DecodeConfig, ModelConfig
from ..cuda_graphs import GraphCache, switches
from ..models import ocr_model
from ..models.layers import NEG_INF
from ..models.ocr_model import decode_hidden, decode_step, init_decode_state, pack_decode_params
from ..ops.kernels.beam_step import search_step
from ..ops.kernels.decode_loop import fused_beam_decode, should_use_megakernel
from ..ops.kernels.decode_step import head_fits, head_weights
from ..parallel.mesh import world_of
from . import graphs

_BIG = 2**30


def topk_iter(x: torch.Tensor, k: int):
    """Top-k over the last axis by k (max, lowest index among ties, mask)
    passes: the values and indices of XLA's TopK, ties included."""
    cols = torch.arange(x.shape[-1], device=x.device).expand_as(x)
    vals, idxs = [], []
    cur = x
    for _ in range(k):
        m = cur.max(dim=-1, keepdim=True).values
        i = torch.where(cur == m, cols, _BIG).min(dim=-1, keepdim=True).values
        vals.append(m)
        idxs.append(i)
        cur = torch.where(cols == i, torch.full_like(cur, NEG_INF), cur)
    return torch.cat(vals, -1), torch.cat(idxs, -1)


def beam_state(b: int, k: int, cache_len: int, dec_cfg: DecodeConfig, dev) -> dict:
    """The search state of ``b`` images x ``k`` lanes before the first step,
    ``pos`` (0-d int32) the position on the device."""
    max_len = dec_cfg.max_len
    tokens = torch.full((b, k, max_len + 2), dec_cfg.pad_idx, dtype=torch.long, device=dev)
    tokens[:, :, 0] = dec_cfg.sos_idx
    scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0  # lane 0 seeds the search
    return {
        "tokens": tokens,
        "scores": scores,
        "best_done_score": torch.full((b,), NEG_INF, dtype=torch.float32, device=dev),
        "best_done_tokens": torch.full((b, max_len + 2), dec_cfg.pad_idx, dtype=torch.long, device=dev),
        "lineage": torch.arange(k, dtype=torch.int32, device=dev)[None, :, None].expand(b, k, cache_len).contiguous(),
        "img": torch.arange(b, device=dev),
        # length denominators as device scalars: true division, as the reference does
        "lens": torch.arange(max_len + 2, dtype=torch.float32, device=dev),
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
    }


def beam_advance(st: dict, logp: torch.Tensor, pos: torch.Tensor, dec_cfg: DecodeConfig) -> None:
    """One step of the search on the log-probs (B, K, V) of position ``pos``
    (a 0-d integer tensor, used on the device): completions, the next K
    beams, tokens and lineage. Updates ``st``."""
    b, k, _ = logp.shape
    img, tokens, scores, lineage = st["img"], st["tokens"], st["scores"], st["lineage"]
    at = pos.reshape(1).long()

    top_lp, top_ids = topk_iter(logp, k)  # (B, K, K) per-beam candidates
    cand = scores[:, :, None] + top_lp
    is_eos = top_ids == dec_cfg.eos_idx

    # completed candidates, normalised by len(seq) = pos + 2
    norm = cand / st["lens"].index_select(0, at + 2)
    eos_norm = torch.where(is_eos, norm, torch.full_like(norm, NEG_INF)).max(dim=2).values
    best_beam = torch.argmax(eos_norm, dim=1)
    step_best = eos_norm[img, best_beam]
    improved = step_best > st["best_done_score"]
    done_tok = tokens[img, best_beam].index_fill_(1, at + 1, dec_cfg.eos_idx)
    st["best_done_tokens"] = torch.where(improved[:, None], done_tok, st["best_done_tokens"])
    st["best_done_score"] = torch.where(improved, step_best, st["best_done_score"])

    # next beams: best K non-eos candidates, ties -> lowest flat index
    flat = torch.where(is_eos, torch.full_like(cand, NEG_INF), cand).reshape(b, k * k)
    st["scores"], flat_idx = topk_iter(flat, k)
    parent = flat_idx // k  # (B, K) image-local
    new_tok = torch.gather(top_ids.reshape(b, k * k), 1, flat_idx)
    tokens = torch.gather(tokens, 1, parent[:, :, None].expand(-1, -1, tokens.shape[2]))
    st["tokens"] = tokens.index_copy_(2, at + 1, new_tok[:, :, None])
    # inherit the parent's pointer rows; slot pos now belongs to the parent
    lineage = torch.gather(lineage, 1, parent[:, :, None].expand(-1, -1, lineage.shape[2]).to(torch.long))
    st["lineage"] = lineage.index_copy_(2, at, parent.to(torch.int32)[:, :, None])


def beam_answer(st: dict) -> torch.Tensor:
    """The best completion of each image, else its lane 0: (B, max_len + 2)."""
    has_done = st["best_done_score"] > NEG_INF / 2
    return torch.where(has_done[:, None], st["best_done_tokens"], st["tokens"][:, 0])


def use_fused_head(dec_cfg: DecodeConfig, model_cfg: ModelConfig, memory, model_group=None) -> bool:
    """Whether beam_decode fuses the decode head into K2's last launch: the
    switch is on, no model group splits the vocabulary, and the head fits
    the launch K2 makes for this batch (``decode_step.head_fits``)."""
    mode = dec_cfg.head_mode if dec_cfg.head_mode is not None else os.environ.get("KHMER_OCR_FUSED_HEAD")
    b, tm, _ = memory.shape
    return (mode == "1" and world_of(model_group)[1] == 1
            and head_fits(b, dec_cfg.beam_width, model_cfg.num_heads, tm, model_cfg.emb_dim, model_cfg.vocab_size,
                          memory.dtype))


def beam_step(params: dict, state: dict, st: dict, w: int, model_cfg: ModelConfig, dec_cfg: DecodeConfig,
              head=None, model_group=None) -> None:
    """One step of the search at the device position ``st["pos"]`` and cache
    window ``w``: the layers (K2 on the card), the head, the search's
    bookkeeping (``search_step``: kernel K5 on the card, in place; on CPU
    tensors log-softmax and ``beam_advance``); then ``pos`` + 1, on the
    device. No host read: the body of a graph."""
    b, k = st["scores"].shape
    pos = st["pos"]
    cur = st["tokens"].index_select(2, pos.reshape(1)).reshape(b * k)
    lineage = st["lineage"][:, :, :w].reshape(b * k, w).contiguous()
    if head is not None:  # K2's fused head gives the log-probs
        _, logp = decode_hidden(params, state, cur, pos, model_cfg, window=w, lineage_local=lineage, head=head)
        search_step(st, logp, pos, dec_cfg, log_probs=True, vocab=head[2])
    else:
        logits = decode_step(params, state, cur, pos, model_cfg, window=w, lineage_local=lineage,
                             model_group=model_group)
        search_step(st, logits.float(), pos, dec_cfg, log_probs=False)
    pos.add_(1)


def beam_finished(st: dict, max_len: int) -> bool:
    """The provably-safe exit (module docstring), read on the host."""
    bound = st["scores"].max(dim=1).values / (st["lens"][max_len] + 1.0)
    return bool(torch.all(bound <= st["best_done_score"]))


def _beam_shape(packed: dict, memory, memory_pad_mask, model_cfg: ModelConfig, dec_cfg: DecodeConfig,
                fused_head: bool, model_group=None) -> graphs.StepGraphs:
    """A decode shape (decode/graphs.py) made for this batch: the head, the
    decode state and the search state, and the step body over them."""
    b, k, device = memory.shape[0], dec_cfg.beam_width, memory.device
    head = head_weights(packed["dec"]["out"]) if fused_head else None
    state = init_decode_state(packed, memory, memory_pad_mask, model_cfg, lanes=k, cache_len=dec_cfg.max_len)
    n = state["self_kv"][0][0].shape[1]
    st = beam_state(b, k, n, dec_cfg, device)

    def fill(memory, pad):
        graphs.fill_decode_state(state, packed, memory, pad)
        for key, t in beam_state(b, k, n, dec_cfg, device).items():
            st[key].copy_(t)

    def run(w, steps):
        graphs.run_steps(st, steps, lambda cur: beam_step(packed, state, cur, w, model_cfg, dec_cfg, head,
                                                          model_group))

    return graphs.StepGraphs(run, fill, st, state)


def beam_decode(params: dict, memory, memory_pad_mask, model_cfg: ModelConfig, dec_cfg: DecodeConfig,
                stats: dict | None = None, model_group=None, eager: bool = False,
                graph_cache: GraphCache | None = None):
    """memory: (B, T, D). Returns the best tokens (B, max_len + 2), <sos> first.
    ``stats`` (optional dict) receives "steps", the decode steps run, "mega",
    the batches (0 or 1) decoded by the whole-decode path (one launch of
    kernel K3 on the card), and, from the step loop, "head": whether the
    head was fused, and "replays": the CUDA graph replays that ran the
    steps (0 for the Python loop). On the card the steps run as captured
    graphs (decode/graphs.py), kept in ``graph_cache`` (None: captured for
    this call alone), unless a model group of more than one rank splits the
    params or ``eager`` asks for the Python loop."""
    b, tm, _ = memory.shape
    k = dec_cfg.beam_width
    max_len = dec_cfg.max_len
    ranks = world_of(model_group)[1]
    # the whole decode in one launch inside its envelope, as the JAX package routes it
    if should_use_megakernel(k, max_len, tm, model_cfg.vocab_size, mode=dec_cfg.mega_mode, model_ranks=ranks):
        if stats is not None:
            stats.update(steps=0, mega=1)
        return fused_beam_decode(params, memory, memory_pad_mask, model_cfg, dec_cfg)

    fused_head = use_fused_head(dec_cfg, model_cfg, memory, model_group)
    cache = None
    if memory.is_cuda and ranks == 1 and not eager:
        cache = graph_cache if graph_cache is not None else GraphCache()
    packed = cache.shared(params, pack_decode_params) if cache is not None else pack_decode_params(params)
    # the shape's key: everything its graphs and buffers were made for but the params
    key = ("beam", b, k, tm, memory.dtype, memory.device, max_len, dec_cfg.sos_idx, dec_cfg.eos_idx, dec_cfg.pad_idx,
           fused_head, ocr_model.decoder_layer_step, search_step, switches())
    r0 = graphs.replays
    tokens, steps = graphs.decode(
        cache, key, lambda: _beam_shape(packed, memory, memory_pad_mask, model_cfg, dec_cfg, fused_head, model_group),
        (memory, memory_pad_mask), max_len, lambda st: beam_finished(st, max_len), beam_answer)
    if stats is not None:
        stats.update(steps=steps, mega=0, head=int(fused_head), replays=graphs.replays - r0)
    return tokens
