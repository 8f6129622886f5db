"""The LSTM's adjoint recurrence: CUDA kernel K1b (``csrc/lstm_backward.cu``)
and its plain PyTorch version.

``lstm_adjoint(gates, c, dh, w_hh)`` runs the serial part of the LSTM's
backward from a zero (dh, dc) carry at the last step, t running downwards:
gates (B, T, 4H) are the pre-activation gates xg + h[t-1] @ W_hh, c (B, T,
H) the forward's cell states, dh (B, T, H) the gradient of the loss with
respect to h, w_hh (H, 4H), gate order i, f, g, o. Returns dz (B, T, 4H),
the gradient with respect to the pre-activation gates, which is also d xg.
With a leading direction axis on every argument the directions run in one
launch. A CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. ops/kernels/lstm.py::LSTMRecurrence builds the backward
around it.

The kernel has two routes, chosen by ``geometry.k1b_route`` from the shape:
clusters of 8 CTAs that keep W_hh in registers (hidden width 192), and one
CTA per batch tile that streams W_hh^T from L2 (other widths).
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .geometry import CLUSTER_HIDDEN, k1b_route


def _adjoint_one(gates, c, dh, w_hh):
    b, t, _ = gates.shape
    hidden = w_hh.shape[0]
    dz = gates.new_empty(gates.shape)
    dh_next = gates.new_zeros(b, hidden)
    dc_next = gates.new_zeros(b, hidden)
    for step in range(t - 1, -1, -1):
        i, f, g, o = gates[:, step].chunk(4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        g = torch.tanh(g)
        c_prev = c[:, step - 1] if step > 0 else torch.zeros_like(dh_next)
        tanh_c = torch.tanh(c[:, step])
        d = dh[:, step] + dh_next
        do = d * tanh_c
        dc = d * o * (1.0 - tanh_c * tanh_c) + dc_next
        di, dg, df = dc * g, dc * i, dc * c_prev
        dz[:, step] = torch.cat([di * i * (1 - i), df * f * (1 - f), dg * (1 - g * g), do * o * (1 - o)], dim=-1)
        dh_next = dz[:, step] @ w_hh.t()
        dc_next = dc * f
    return dz


def lstm_adjoint_plain(gates, c, dh, w_hh):
    """The adjoint as a Python loop over t, the transcription of the JAX
    package's reverse scan (the yardstick of the kernel)."""
    if gates.dim() == 4:
        return torch.stack([_adjoint_one(*args) for args in zip(gates, c, dh, w_hh)])
    return _adjoint_one(gates, c, dh, w_hh)


def lstm_adjoint(gates, c, dh, w_hh):
    if all(x.device.type == "cpu" for x in (gates, c, dh, w_hh)):
        return lstm_adjoint_plain(gates, c, dh, w_hh)
    return lstm_adjoint_kernel(gates, c, dh, w_hh)


def lstm_adjoint_kernel(gates, c, dh, w_hh, route: tuple[int, int] | None = None):
    """The kernel on CUDA tensors, by ``geometry.k1b_route``'s (route, rows)
    or the one given: route 0 is the tile route, 8 the cluster route."""
    args = (gates, c, dh, w_hh)
    if not all(x.is_cuda and x.device == gates.device for x in args):
        raise RuntimeError(f"lstm_adjoint: needs CUDA tensors on one device, got {[str(x.device) for x in args]}")
    if any(x.dtype != torch.float32 for x in args):
        raise TypeError(f"lstm_adjoint: float32 only, got {[x.dtype for x in args]}")
    stacked = gates.dim() == 4
    lead = gates.shape[:-1]
    hidden = w_hh.shape[-2]
    if (gates.dim() not in (3, 4) or c.shape != dh.shape or c.shape != lead + (hidden,)
            or w_hh.shape != gates.shape[:1] * stacked + (hidden, 4 * hidden) or gates.shape[-1] != 4 * hidden
            or 4 * hidden > 1024):
        raise ValueError(f"lstm_adjoint: gates ([ndir,] B, T, 4H), c and dh ([ndir,] B, T, H), w_hh ([ndir,] H, 4H) "
                         f"with 4H <= 1024, got {[tuple(x.shape) for x in args]}")
    if not all(x.is_contiguous() for x in (gates, c, dh)):
        raise ValueError("lstm_adjoint: gates, c and dh must be contiguous")
    ndir = gates.shape[0] if stacked else 1
    b, t = lead[-2:]
    kind, rows = k1b_route(b, hidden, ndir) if route is None else route
    if kind and hidden != CLUSTER_HIDDEN:
        raise ValueError(f"lstm_adjoint: the cluster route is compiled for H={CLUSTER_HIDDEN}, got {hidden}")
    dz = torch.empty_like(gates)
    if b == 0 or t == 0 or ndir == 0:
        return dz
    # the cluster route reads W_hh (H, 4H) as it is; the tile route W_hh^T (4H, H), so that
    # neighbouring threads read neighbouring units
    w = w_hh.contiguous() if kind else w_hh.transpose(-1, -2).contiguous()
    lib = build.load("lstm_backward")
    fn = lib.lstm_backward_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(gates.device).cuda_stream
    err = fn(gates.data_ptr(), c.data_ptr(), dh.data_ptr(), w.data_ptr(), dz.data_ptr(), ndir, b, t, hidden, kind,
             rows, stream)
    build.check(err, f"lstm_adjoint (route {kind}, {rows} rows)")
    build.count_launch(stream, k1b=1)
    return dz
