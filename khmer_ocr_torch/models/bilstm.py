"""Bidirectional LSTM context smoother over the merged chunk memory.

One bidirectional layer, input D, hidden D/2 per direction, gate order i, f,
g, o. The input projection ``x @ W_ih + b_ih + b_hh`` for all steps is one
matrix product per direction; the serial recurrences of both directions go
to ops/kernels/lstm.py in one call (kernel K1 on the card, one launch; its
plain version on the CPU). The backward direction is length-aware: each row
is reversed within its valid length before the recurrence and reversed back
after, so bucket padding never reaches valid positions. Parameters per
direction: "w_ih" (D, 4H), "w_hh" (H, 4H), "b_ih", "b_hh" (4H,).

Where autograd records (training), the recurrence goes through
``LSTMRecurrence`` (the forward with cell states, then kernel K1b's adjoint
on the card); otherwise through the forward alone. The device picks kernel
or plain version, so there is no switch between the two.

In bfloat16 (the serving speed mode) the recurrence runs in float32, as the
JAX package runs its kernel: the input gates and W_hh are widened, and h is
rounded back to the input's dtype.
"""

from __future__ import annotations

import torch

from ..ops.kernels.lstm import LSTMRecurrence, lstm_recurrence


def input_gates(p: dict, x: torch.Tensor) -> torch.Tensor:
    """(B, T, D) -> the recurrence's input gates (B, T, 4H)."""
    return torch.matmul(x, p["w_ih"]) + (p["b_ih"] + p["b_hh"])


def _recurrence(xg: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    if torch.is_grad_enabled() and (xg.requires_grad or w_hh.requires_grad):
        return LSTMRecurrence.apply(xg, w_hh)
    return lstm_recurrence(xg, w_hh)


def lstm_scan(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Unidirectional LSTM over (B, T, D) -> (B, T, H)."""
    return _recurrence(input_gates(p, x).contiguous(), p["w_hh"])


def flip_within_length(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse each (T, ...) row of x within its valid prefix length."""
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)[None, :]
    lengths = lengths.to(torch.long)[:, None]
    idx = torch.where(pos < lengths, lengths - 1 - pos, pos)
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand_as(x)
    return torch.gather(x, 1, idx)


def bilstm_apply(p: dict, x: torch.Tensor, lengths: torch.Tensor | None = None) -> torch.Tensor:
    """concat(forward, length-aware backward) -> (B, T, 2H); the two
    directions' recurrences in one stacked call."""
    if lengths is None:
        flip = lambda y: torch.flip(y, dims=(1,))
    else:
        flip = lambda y: flip_within_length(y, lengths)
    xg = torch.stack([input_gates(p["fw"], x), input_gates(p["bw"], flip(x))])
    w_hh = torch.stack([p["fw"]["w_hh"], p["bw"]["w_hh"]])
    if xg.dtype in (torch.bfloat16, torch.float16):
        h = _recurrence(xg.float(), w_hh.float()).to(xg.dtype)
    else:
        h = _recurrence(xg, w_hh)
    return torch.cat([h[0], flip(h[1])], dim=-1)
