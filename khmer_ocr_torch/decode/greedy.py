"""Batched greedy decoding over cached decode steps.

Start at <sos>, take the argmax (lowest index on ties) each step, stop a line
at <eos>; finished lines keep stepping with their outputs frozen to <pad>.
The steps run per cache window with the position on the device, in chunks of
``EXIT_CHECK_EVERY``: on the card each chunk is one replay of a captured CUDA
graph (decode/graphs.py), as the JAX package runs one ``lax.while_loop`` per
window; on CPU tensors, under a model group or with ``eager=True`` a Python
loop runs them. The batch exits once every line has finished (the test
needs a device sync, so it runs between chunks, which does not change the
tokens). On the card each layer step is kernel K2 with one lane per image
and no lineage. The argmax is taken over the logits in float32.
``model_group``: a tensor-parallel group (see decode/beam.py).
"""

from __future__ import annotations

import torch

from ..config import DecodeConfig, ModelConfig
from ..cuda_graphs import GraphCache, switches
from ..models import ocr_model
from ..models.ocr_model import decode_step, init_decode_state, pack_decode_params
from ..parallel.mesh import world_of
from . import graphs


def greedy_state(b: int, dec_cfg: DecodeConfig, dev) -> dict:
    """The tokens (<sos>, then <pad>), the finished flags and the device
    position ``pos`` (0-d int32) of ``b`` lines before the first step."""
    tokens = torch.full((b, dec_cfg.max_len + 1), dec_cfg.pad_idx, dtype=torch.long, device=dev)
    tokens[:, 0] = dec_cfg.sos_idx
    return {"tokens": tokens, "finished": torch.zeros(b, dtype=torch.bool, device=dev),
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def greedy_step(params: dict, state: dict, st: dict, w: int, model_cfg: ModelConfig, dec_cfg: DecodeConfig,
                model_group=None) -> None:
    """One step at the device position ``st["pos"]`` and cache window ``w``,
    then ``pos`` + 1, on the device. No host read: the body of a graph."""
    pos = st["pos"]
    at = pos.reshape(1).long()
    cur = st["tokens"].index_select(1, at)[:, 0]
    logits = decode_step(params, state, cur, pos, model_cfg, window=w, model_group=model_group)
    nxt = torch.argmax(logits.float(), dim=-1)
    nxt = torch.where(st["finished"], torch.full_like(nxt, dec_cfg.pad_idx), nxt)
    st["tokens"].index_copy_(1, at + 1, nxt[:, None])
    st["finished"].logical_or_(nxt == dec_cfg.eos_idx)
    pos.add_(1)


def greedy_finished(st: dict) -> bool:
    """Whether every line has finished, read on the host."""
    return bool(st["finished"].all())


def _greedy_shape(packed: dict, memory, memory_pad_mask, model_cfg: ModelConfig, dec_cfg: DecodeConfig,
                  model_group=None) -> graphs.StepGraphs:
    """A decode shape (decode/graphs.py) made for this batch: the decode
    state and the tokens, and the step body over them."""
    b, device = memory.shape[0], memory.device
    state = init_decode_state(packed, memory, memory_pad_mask, model_cfg, cache_len=dec_cfg.max_len)
    st = greedy_state(b, dec_cfg, device)

    def fill(memory, pad):
        graphs.fill_decode_state(state, packed, memory, pad)
        for key, t in greedy_state(b, dec_cfg, device).items():
            st[key].copy_(t)

    def run(w, steps):
        graphs.run_steps(st, steps, lambda cur: greedy_step(packed, state, cur, w, model_cfg, dec_cfg, model_group))

    return graphs.StepGraphs(run, fill, st, state)


def greedy_decode(params: dict, memory, memory_pad_mask, model_cfg: ModelConfig, dec_cfg: DecodeConfig,
                  stats: dict | None = None, model_group=None, eager: bool = False,
                  graph_cache: GraphCache | None = None):
    """memory: (B, T, D) -> tokens (B, max_len + 1) with the leading <sos>.
    ``stats`` (optional dict) receives "steps": the decode steps run, and
    "replays": the CUDA graph replays that ran them (0 for the Python
    loop). On the card the steps run as captured graphs, kept in
    ``graph_cache`` (None: captured for this call alone), unless a model
    group of more than one rank splits the params or ``eager`` asks for the
    Python loop."""
    stats = {} if stats is None else stats
    b, tm, _ = memory.shape
    max_len = dec_cfg.max_len
    cache = None
    if memory.is_cuda and world_of(model_group)[1] == 1 and not eager:
        cache = graph_cache if graph_cache is not None else GraphCache()
    packed = cache.shared(params, pack_decode_params) if cache is not None else pack_decode_params(params)
    key = ("greedy", b, tm, memory.dtype, memory.device, max_len, dec_cfg.sos_idx, dec_cfg.eos_idx, dec_cfg.pad_idx,
           ocr_model.decoder_layer_step, switches())
    r0 = graphs.replays
    tokens, steps = graphs.decode(
        cache, key, lambda: _greedy_shape(packed, memory, memory_pad_mask, model_cfg, dec_cfg, model_group),
        (memory, memory_pad_mask), max_len, greedy_finished, lambda st: st["tokens"].clone())
    stats.update(steps=steps, replays=graphs.replays - r0)
    return tokens
