"""Bidirectional LSTM context smoother over the merged chunk memory.

One bidirectional layer, input D, hidden D/2 per direction, gate order i, f,
g, o. The input projection ``x @ W_ih + b_ih + b_hh`` for all steps is one
matrix product; the serial recurrence goes to ops/kernels/lstm.py (kernel K1
on the card, its plain version on the CPU). The backward direction is
length-aware: each row is reversed within its valid length before the
recurrence and reversed back after, so bucket padding never reaches valid
positions. Parameters per direction: "w_ih" (D, 4H), "w_hh" (H, 4H), "b_ih",
"b_hh" (4H,).
"""

from __future__ import annotations

import torch

from ..ops.kernels.lstm import lstm_recurrence


def lstm_scan(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Unidirectional LSTM over (B, T, D) -> (B, T, H)."""
    xg = torch.matmul(x, p["w_ih"]) + (p["b_ih"] + p["b_hh"])
    return lstm_recurrence(xg.contiguous(), p["w_hh"])


def flip_within_length(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse each (T, ...) row of x within its valid prefix length."""
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)[None, :]
    lengths = lengths.to(torch.long)[:, None]
    idx = torch.where(pos < lengths, lengths - 1 - pos, pos)
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand_as(x)
    return torch.gather(x, 1, idx)


def bilstm_apply(p: dict, x: torch.Tensor, lengths: torch.Tensor | None = None) -> torch.Tensor:
    """concat(forward, length-aware backward) -> (B, T, 2H)."""
    fw = lstm_scan(p["fw"], x)
    if lengths is None:
        bw = torch.flip(lstm_scan(p["bw"], torch.flip(x, dims=(1,))), dims=(1,))
    else:
        bw = flip_within_length(lstm_scan(p["bw"], flip_within_length(x, lengths)), lengths)
    return torch.cat([fw, bw], dim=-1)
