"""Batched greedy decoding over cached decode steps.

Start at <sos>, take the argmax (lowest index on ties) each step, stop a line
at <eos>; finished lines keep stepping with their outputs frozen to <pad>. One
loop per cache window; the batch exits once every line has finished (the
test needs a device sync, so it runs every ``EXIT_CHECK_EVERY`` steps, which
does not change the tokens). On the card each layer step is kernel K2 with
one lane per image and no lineage.
"""

from __future__ import annotations

import torch

from ..config import DecodeConfig, ModelConfig
from ..models.ocr_model import (EXIT_CHECK_EVERY, decode_step, decode_windows, init_decode_state,
                                pack_decode_params)


def greedy_decode(params: dict, memory, memory_pad_mask, model_cfg: ModelConfig, dec_cfg: DecodeConfig,
                  stats: dict | None = None):
    """memory: (B, T, D) -> tokens (B, max_len + 1) with the leading <sos>.
    ``stats`` (optional dict) receives "steps": the decode steps run."""
    stats = {} if stats is None else stats
    b = memory.shape[0]
    max_len = dec_cfg.max_len
    state = init_decode_state(params, memory, memory_pad_mask, model_cfg, cache_len=max_len)
    params = pack_decode_params(params)
    tokens = torch.full((b, max_len + 1), dec_cfg.pad_idx, dtype=torch.long, device=memory.device)
    tokens[:, 0] = dec_cfg.sos_idx
    finished = torch.zeros(b, dtype=torch.bool, device=memory.device)
    pos = 0
    for w in decode_windows(max_len):
        while pos < min(w, max_len):
            if pos % EXIT_CHECK_EVERY == 0 and bool(finished.all()):
                stats["steps"] = pos
                return tokens
            logits = decode_step(params, state, tokens[:, pos], pos, model_cfg, window=w)
            nxt = torch.argmax(logits, dim=-1)
            nxt = torch.where(finished, torch.full_like(nxt, dec_cfg.pad_idx), nxt)
            tokens[:, pos + 1] = nxt
            finished = finished | (nxt == dec_cfg.eos_idx)
            pos += 1
    stats["steps"] = pos
    return tokens
