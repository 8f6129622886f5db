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

The step loop runs on the host, one loop per cache window (32, 64, 128,
256). The early exit is provably safe: log-probs are <= 0, so a running beam
with raw score s can never complete above s / (max_len + 1); once that bound
is <= the best completion for every image, no later step changes an answer.
Testing it needs a device sync, so it runs every ``EXIT_CHECK_EVERY`` steps;
the tokens are the same for any value.
"""

from __future__ import annotations

import torch

from ..config import DecodeConfig, ModelConfig
from ..models.layers import NEG_INF
from ..models.ocr_model import (EXIT_CHECK_EVERY, decode_step, decode_windows, init_decode_state,
                                pack_decode_params)

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


def beam_decode(params: dict, memory, memory_pad_mask, model_cfg: ModelConfig, dec_cfg: DecodeConfig,
                stats: dict | None = None):
    """memory: (B, T, D). Returns the best tokens (B, max_len + 2), <sos> first.
    ``stats`` (optional dict) receives "steps": the decode steps run."""
    dev = memory.device
    b = memory.shape[0]
    k = dec_cfg.beam_width
    max_len = dec_cfg.max_len
    state = init_decode_state(params, memory, memory_pad_mask, model_cfg, lanes=k, cache_len=max_len)
    params = pack_decode_params(params)
    cache_len = state["self_kv"][0][0].shape[1]

    tokens = torch.full((b, k, max_len + 2), dec_cfg.pad_idx, dtype=torch.long, device=dev)
    tokens[:, :, 0] = dec_cfg.sos_idx
    scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0  # lane 0 seeds the search
    best_done_score = torch.full((b,), NEG_INF, dtype=torch.float32, device=dev)
    best_done_tokens = torch.full((b, max_len + 2), dec_cfg.pad_idx, dtype=torch.long, device=dev)
    lineage = torch.arange(k, dtype=torch.int32, device=dev)[None, :, None].expand(b, k, cache_len).contiguous()
    img = torch.arange(b, device=dev)
    # length denominators as device scalars: true division, as the reference does
    lens = torch.arange(max_len + 2, dtype=torch.float32, device=dev)
    bound_den = lens[max_len] + 1.0

    pos = 0
    done = False
    for w in decode_windows(max_len):
        while not done and pos < min(w, max_len):
            if pos % EXIT_CHECK_EVERY == 0:
                bound = scores.max(dim=1).values / bound_den
                if bool(torch.all(bound <= best_done_score)):
                    done = True
                    break
            cur = tokens[:, :, pos].reshape(b * k)
            logits = decode_step(params, state, cur, pos, model_cfg, window=w,
                                 lineage_local=lineage[:, :, :w].reshape(b * k, w).contiguous())
            logp = torch.log_softmax(logits.float(), dim=-1).reshape(b, k, -1)

            top_lp, top_ids = topk_iter(logp, k)  # (B, K, K) per-beam candidates
            cand = scores[:, :, None] + top_lp
            is_eos = top_ids == dec_cfg.eos_idx

            # completed candidates, normalised by len(seq) = pos + 2
            norm = cand / lens[pos + 2]
            eos_norm = torch.where(is_eos, norm, torch.full_like(norm, NEG_INF)).max(dim=2).values
            best_beam = torch.argmax(eos_norm, dim=1)
            step_best = eos_norm[img, best_beam]
            improved = step_best > best_done_score
            done_tok = tokens[img, best_beam].clone()
            done_tok[:, pos + 1] = dec_cfg.eos_idx
            best_done_tokens = torch.where(improved[:, None], done_tok, best_done_tokens)
            best_done_score = torch.where(improved, step_best, best_done_score)

            # next beams: best K non-eos candidates, ties -> lowest flat index
            flat = torch.where(is_eos, torch.full_like(cand, NEG_INF), cand).reshape(b, k * k)
            scores, flat_idx = topk_iter(flat, k)
            parent = flat_idx // k  # (B, K) image-local
            new_tok = torch.gather(top_ids.reshape(b, k * k), 1, flat_idx)
            tokens = torch.gather(tokens, 1, parent[:, :, None].expand(-1, -1, tokens.shape[2])).clone()
            tokens[:, :, pos + 1] = new_tok
            # inherit the parent's pointer rows; slot pos now belongs to the parent
            lineage = torch.gather(lineage, 1, parent[:, :, None].expand(-1, -1, cache_len).to(torch.long))
            lineage[:, :, pos] = parent.to(torch.int32)
            pos += 1
        if done:
            break
    if stats is not None:
        stats["steps"] = pos
    has_done = best_done_score > NEG_INF / 2
    return torch.where(has_done[:, None], best_done_tokens, tokens[:, 0])
