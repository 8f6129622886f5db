"""LSTM recurrence: CUDA kernel K1 (``csrc/lstm_recurrence.cu``) and its
plain PyTorch version, and the recurrence's autograd function.

``lstm_recurrence(xg, w_hh)`` runs the recurrence from a zero state: xg (B,
T, 4H) are the precomputed input gates (x @ W_ih + b_ih + b_hh), w_hh (H,
4H), gate order i, f, g, o. Returns h for every step, (B, T, H), and with
``with_cell=True`` also the cell states c, (B, T, H). With a leading
direction axis, xg (2, B, T, 4H) and w_hh (2, H, 4H), the two directions'
independent recurrences run in one launch and the results are (2, B, T, H).
A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.

The kernel has two routes, chosen by ``geometry.k1_route`` from the shape:
clusters that keep W_hh on chip for small batches, one CTA per batch tile
for large ones.

``LSTMRecurrence`` makes the recurrence differentiable, as the JAX
package's ``lstm_recurrence_vjp``: the forward runs with cells and saves
(xg, W_hh, h, c); the backward takes the pre-activation gates of every
step in one matrix product, runs the serial adjoint (kernel K1b,
ops/kernels/lstm_backward.py) and takes dW_hh in one more product.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, lstm_backward
from .geometry import CLUSTER_HIDDEN, k1_route


def _lstm_one(xg: torch.Tensor, w_hh: torch.Tensor):
    b, t, _ = xg.shape
    hidden = w_hh.shape[0]
    h = xg.new_zeros(b, hidden)
    c = xg.new_zeros(b, hidden)
    out = xg.new_empty(b, t, hidden)
    cells = xg.new_empty(b, t, hidden)
    for step in range(t):
        gates = xg[:, step] + h @ w_hh
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        g = torch.tanh(g)
        c = f * c + i * g
        h = o * torch.tanh(c)
        out[:, step] = h
        cells[:, step] = c
    return out, cells


def lstm_recurrence_plain(xg: torch.Tensor, w_hh: torch.Tensor, with_cell: bool = False):
    """The recurrence as a Python loop over t, and over the direction axis if
    there is one (the yardstick of the kernel)."""
    if xg.dim() == 4:
        h, c = (torch.stack(z) for z in zip(*[_lstm_one(x, w) for x, w in zip(xg, w_hh)]))
    else:
        h, c = _lstm_one(xg, w_hh)
    return (h, c) if with_cell else h


def lstm_recurrence(xg: torch.Tensor, w_hh: torch.Tensor, with_cell: bool = False):
    if xg.device.type == "cpu" and w_hh.device.type == "cpu":
        return lstm_recurrence_plain(xg, w_hh, with_cell)
    return lstm_recurrence_route(xg, w_hh, with_cell=with_cell)


def lstm_recurrence_route(xg: torch.Tensor, w_hh: torch.Tensor, route: tuple[int, int] | None = None,
                          with_cell: bool = False):
    """The kernel on CUDA tensors, by ``k1_route``'s route or the one given."""
    if not (xg.is_cuda and w_hh.is_cuda and xg.device == w_hh.device):
        raise RuntimeError(f"lstm_recurrence: needs CUDA tensors on one device, got {xg.device} and {w_hh.device}")
    if xg.dtype != torch.float32 or w_hh.dtype != torch.float32:
        raise TypeError(f"lstm_recurrence: float32 only, got {xg.dtype} and {w_hh.dtype}")
    stacked = xg.dim() == 4
    if xg.dim() not in (3, 4) or w_hh.dim() != xg.dim() - 1 or (stacked and xg.shape[0] != w_hh.shape[0]):
        raise ValueError(f"lstm_recurrence: xg ([ndir,] B, T, 4H) and w_hh ([ndir,] H, 4H), "
                         f"got {tuple(xg.shape)}, {tuple(w_hh.shape)}")
    ndir = xg.shape[0] if stacked else 1
    b, t, g = xg.shape[-3:]
    hidden = w_hh.shape[-2]
    if g != 4 * hidden or w_hh.shape[-1] != 4 * hidden or 4 * hidden > 1024:
        raise ValueError(f"lstm_recurrence: shapes {tuple(xg.shape)}, {tuple(w_hh.shape)} (needs 4H <= 1024)")
    if not (xg.is_contiguous() and w_hh.is_contiguous()):
        raise ValueError("lstm_recurrence: inputs must be contiguous")
    kind, rows = k1_route(b, hidden, ndir) if route is None else route
    if kind and hidden != CLUSTER_HIDDEN:
        raise ValueError(f"lstm_recurrence: the cluster route is compiled for H={CLUSTER_HIDDEN}, got {hidden}")
    out = torch.empty(*xg.shape[:-1], hidden, device=xg.device, dtype=torch.float32)
    cells = torch.empty_like(out) if with_cell else None
    if b == 0 or t == 0 or ndir == 0:
        return (out, cells) if with_cell else out
    lib = build.load("lstm_recurrence")
    fn = lib.lstm_recurrence_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(xg.device).cuda_stream
    err = fn(xg.data_ptr(), w_hh.data_ptr(), out.data_ptr(), cells.data_ptr() if with_cell else None, ndir, b, t,
             hidden, kind, rows, stream)
    build.check(err, f"lstm_recurrence (route {kind}, {rows} rows)")
    build.count_launch(stream, k1=1)
    return (out, cells) if with_cell else out


class LSTMRecurrence(torch.autograd.Function):
    """Differentiable ``lstm_recurrence(xg, w_hh)`` -> h, with or without a
    direction axis. Backward: gates = xg + h[t-1] @ W_hh (one matmul), dz by
    ``lstm_backward.lstm_adjoint`` (K1b on the card), dxg = dz, dW_hh =
    sum over rows and t of h[t-1]^T dz (one matmul)."""

    @staticmethod
    def forward(ctx, xg, w_hh):
        h, c = lstm_recurrence(xg, w_hh, with_cell=True)
        ctx.save_for_backward(xg, w_hh, h, c)
        return h

    @staticmethod
    def backward(ctx, dh):
        xg, w_hh, h, c = ctx.saved_tensors
        h_prev = torch.cat([torch.zeros_like(h[..., :1, :]), h[..., :-1, :]], dim=-2)
        hp = h_prev.reshape(*h.shape[:-3], -1, h.shape[-1])  # ([ndir,] B*T, H)
        gates = (xg.reshape(*hp.shape[:-1], -1) + hp @ w_hh).reshape(xg.shape)
        dz = lstm_backward.lstm_adjoint(gates, c, dh.contiguous(), w_hh)
        dw = hp.transpose(-1, -2) @ dz.reshape(*hp.shape[:-1], -1)
        return dz, dw
