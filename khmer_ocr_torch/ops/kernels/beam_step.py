"""One step of the beam search's bookkeeping: CUDA kernel K5
(``csrc/beam_step.cu``) and its plain PyTorch version.

``search_step(st, x, pos, dec_cfg, log_probs=, vocab=)`` advances the search
state ``st`` (``decode/beam.py::beam_state``) by the step at position
``pos`` on x (B * K, Vx) float32, one row a lane: its logits, or its
log-probs when ``log_probs`` (kernel K2's fused head gives them), of which
the first ``vocab`` columns (all by default) are the vocabulary. The plain
version is the step loop's torch code: ``torch.log_softmax`` unless
``log_probs``, then ``decode/beam.py::beam_advance``, which replaces the
state's tensors. The kernel writes the same values into the state's own
tensors, in place (the running scores, the best completion and its score,
the tokens, the lineage), in one launch. ``pos`` is a one-element int32
tensor on the card, which the kernel reads there, so one launch captured in
a CUDA graph serves every position of its replays; the caller keeps ``pos
+ 2`` within the tokens' ``max_len + 2`` slots and ``pos`` below the
lineage's slots, which the kernel cannot check.

Envelope, read from the tensors' shapes: any number of images and any
vocabulary; 1 <= K <= 32 lanes (one warp a lane, in one block an image);
the image's tokens and lineage within a block's shared memory. The kernel's
log-softmax takes its sums in another order than torch's, so its log-probs
may differ from ``torch.log_softmax``'s in the last bits; on log-probs the
two versions agree bit for bit.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...config import DecodeConfig
from . import build
from .geometry import SMEM_LIMIT

MAX_LANES = 32  # csrc/beam_step.cu::MAX_LANES


def search_step(st: dict, x: torch.Tensor, pos: torch.Tensor, dec_cfg: DecodeConfig, *, log_probs: bool,
                vocab: int | None = None) -> None:
    if x.device.type == "cpu":
        return search_step_plain(st, x, pos, dec_cfg, log_probs=log_probs, vocab=vocab)
    return search_step_kernel(st, x, pos, dec_cfg, log_probs=log_probs, vocab=vocab)


def search_step_plain(st: dict, x: torch.Tensor, pos: torch.Tensor, dec_cfg: DecodeConfig, *, log_probs: bool,
                      vocab: int | None = None) -> None:
    """The torch ops of the step (``beam_advance`` replaces ``st``'s tensors)."""
    from ...decode.beam import beam_advance  # decode/beam.py imports this module

    b, k = st["scores"].shape
    x = x if vocab is None else x[:, :vocab]
    logp = x if log_probs else torch.log_softmax(x.float(), dim=-1)
    beam_advance(st, logp.reshape(b, k, -1), pos, dec_cfg)


@functools.cache
def _launcher():
    fn = build.load("beam_step").beam_step_launch
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(k: int, lp: int, c: int) -> int:
    """Bytes of one block's shared memory (beam_step.cu::smem_bytes): the
    image's tokens (8 bytes each) and lineage, the candidates and the next
    beams."""
    return 8 * k * lp + 4 * (k * c + 2 * k * k + 4 * k)


def search_step_kernel(st: dict, x: torch.Tensor, pos: torch.Tensor, dec_cfg: DecodeConfig, *, log_probs: bool,
                       vocab: int | None = None) -> None:
    """The kernel on CUDA tensors: one launch, the state updated in place."""
    name = "beam_step"
    b, k = st["scores"].shape
    lp, c = st["tokens"].shape[2], st["lineage"].shape[2]
    vx = x.shape[-1]
    v = vx if vocab is None else vocab
    if not 1 <= k <= MAX_LANES:
        raise ValueError(f"{name}: {k} lanes; the kernel takes 1 to {MAX_LANES} (a warp a lane in one block)")
    if not 1 <= v <= vx:
        raise ValueError(f"{name}: vocab {v} outside the {vx} columns of x")
    tensors = {"x": (x, torch.float32, (b * k, vx)), "pos": (pos, torch.int32, None),
               "lens": (st["lens"], torch.float32, (lp,)), "scores": (st["scores"], torch.float32, (b, k)),
               "best_done_score": (st["best_done_score"], torch.float32, (b,)),
               "tokens": (st["tokens"], torch.int64, (b, k, lp)),
               "best_done_tokens": (st["best_done_tokens"], torch.int64, (b, lp)),
               "lineage": (st["lineage"], torch.int32, (b, k, c))}
    for key, (t, dtype, shape) in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} must be {dtype}, got {t.dtype}")
        if shape is None and t.numel() != 1:
            raise ValueError(f"{name}: {key} must hold one element (the position, read on the card)")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    smem = smem_bytes(k, lp, c)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: {k} lanes of {lp} tokens and {c} lineage slots need {smem} bytes of shared "
                         f"memory, more than {SMEM_LIMIT}")
    for key, (t, _, _) in tensors.items():
        if not t.is_cuda or t.device != x.device:
            raise RuntimeError(f"{name}: {key} must be a CUDA tensor on {x.device}, got {t.device}")
    ptrs = [t.data_ptr() for t, _, _ in tensors.values()]
    arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _launcher()(ctypes.cast(arr, ctypes.c_void_p), b, k, v, vx, lp, c, dec_cfg.eos_idx, int(not log_probs),
                      stream)
    build.check(err, name)
    build.count_launch(stream, k5=1)
