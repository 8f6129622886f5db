"""LSTM recurrence: CUDA kernel K1 (``csrc/lstm_recurrence.cu``) and its
plain PyTorch version.

``lstm_recurrence(xg, w_hh)`` runs the recurrence of one direction from a
zero state: xg (B, T, 4H) are the precomputed input gates (x @ W_ih + b_ih +
b_hh), w_hh (H, 4H), gate order i, f, g, o. Returns h for every step, (B, T,
H). A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

launches = 0  # kernel launches since the last reset_launches()


def reset_launches() -> None:
    global launches
    launches = 0


def lstm_recurrence_plain(xg: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """The recurrence as a Python loop over t (the yardstick of the kernel)."""
    b, t, _ = xg.shape
    hidden = w_hh.shape[0]
    h = xg.new_zeros(b, hidden)
    c = xg.new_zeros(b, hidden)
    out = xg.new_empty(b, t, hidden)
    for step in range(t):
        gates = xg[:, step] + h @ w_hh
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        g = torch.tanh(g)
        c = f * c + i * g
        h = o * torch.tanh(c)
        out[:, step] = h
    return out


def lstm_recurrence(xg: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    if xg.device.type == "cpu" and w_hh.device.type == "cpu":
        return lstm_recurrence_plain(xg, w_hh)
    return _launch(xg, w_hh)


def _launch(xg: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    global launches
    if not (xg.is_cuda and w_hh.is_cuda and xg.device == w_hh.device):
        raise RuntimeError(f"lstm_recurrence: needs CUDA tensors on one device, got {xg.device} and {w_hh.device}")
    if xg.dtype != torch.float32 or w_hh.dtype != torch.float32:
        raise TypeError(f"lstm_recurrence: float32 only, got {xg.dtype} and {w_hh.dtype}")
    if xg.dim() != 3 or w_hh.dim() != 2:
        raise ValueError(f"lstm_recurrence: xg (B, T, 4H) and w_hh (H, 4H), got {tuple(xg.shape)}, {tuple(w_hh.shape)}")
    b, t, g = xg.shape
    hidden = w_hh.shape[0]
    if g != 4 * hidden or w_hh.shape[1] != 4 * hidden or 4 * hidden > 1024:
        raise ValueError(f"lstm_recurrence: shapes {tuple(xg.shape)}, {tuple(w_hh.shape)} (needs 4H <= 1024)")
    if not (xg.is_contiguous() and w_hh.is_contiguous()):
        raise ValueError("lstm_recurrence: inputs must be contiguous")
    out = torch.empty(b, t, hidden, device=xg.device, dtype=torch.float32)
    if b == 0 or t == 0:
        return out
    lib = build.load("lstm_recurrence")
    fn = lib.lstm_recurrence_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(xg.device).cuda_stream
    build.check(fn(xg.data_ptr(), w_hh.data_ptr(), out.data_ptr(), b, t, hidden, stream), "lstm_recurrence")
    launches += 1
    return out
