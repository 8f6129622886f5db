"""The train step as captured CUDA graphs: the counterpart of the JAX
package's jitted train step.

The JAX package runs each step as one jitted program (its learning rate
traced, so one program serves every step) and a group of K same-shape steps
as one ``lax.scan`` in one program. Here the body of K steps
(train/step.py::step_body: device augmentation and the cut into chunks, the
forward with K1 saving its cell states, ``torch.autograd.grad`` through K1b,
the gradient norm, Adam and the BatchNorm statistics in place) is captured
once per key as one CUDA graph and replayed for every later batch of the
key. A key is the batch's shapes and dtypes, K, the step's settings (model
configuration with its dropout rate, chunk geometry, augmentation
probability, Adam's betas) and torch's matmul and cuDNN switches.

A key's graph (``StepGraph``) reads static buffers made outside the graphs'
memory pool: the stacked batch, the (K, 3) learning rates and bias
corrections (train/step.py::step_scalars), both copied in before each
replay, and the metrics (K,) it writes; params, moments and statistics are
the train state's own tensors, moved in place. Nothing allocated inside a
capture outlives it, and the steps never run concurrently, so every graph
of one ``TrainGraphs`` shares one memory pool, which holds about the
largest step's intermediates rather than their sum.

Capture: a key's first batch runs the body eagerly on a side stream (the
real steps: kernels built and loaded, cuBLAS's and cuDNN's handles made for
that stream outside any capture), then the body is captured on that stream
with the step's ``torch.Generator`` registered with the graph, so that each
replay draws the next numbers and advances the generator as the eager steps
do. K1's and K1b's launch counts move from the capture to each replay. The
graphs keep the train state and generator they were captured with: others
drop every key. A capture or replay failure raises; nothing falls back to
the eager body.

``TrainGraphs`` is a ``GraphCache`` (decode/graphs.py): its owner (a
``train()`` call, or the caller of a step maker) holds it, so its buffers
and graphs are freed with it, and it evicts the least recently used keys
beyond a budget of bytes, each key counted by its static buffers and by
what its capture added to the pool.
"""

from __future__ import annotations

import logging

import torch

from ..decode.graphs import GraphCache, _side_stream, precision_key, tensor_bytes
from ..infer.encode_graph import pool_bytes
from ..ops.kernels import lstm, lstm_backward
from .step import tree_leaves

logger = logging.getLogger(__name__)

# since the last reset_counts(): graphs captured, the steps their first batches ran eagerly, replays, and the
# steps run by replays
captures = 0
captured_steps = 0
replays = 0
replayed_steps = 0


def reset_counts() -> None:
    global captures, captured_steps, replays, replayed_steps
    captures = captured_steps = replays = replayed_steps = 0


def _kernel_counts() -> tuple[int, int]:
    return lstm.launches, lstm_backward.launches


def _add_kernel_counts(delta: tuple[int, int]) -> None:
    lstm.launches += delta[0]
    lstm_backward.launches += delta[1]


def graph_key(step_key, stacked: dict, k: int) -> tuple:
    """The key of K steps of ``step_key``'s settings over ``stacked``: its
    shapes and dtypes, K, and torch's matmul and cuDNN switches (a captured
    graph replays the kernels they picked)."""
    shapes = tuple((name, tuple(v.shape), v.dtype) for name, v in sorted(stacked.items()))
    return step_key, shapes, k, precision_key(), torch.backends.cudnn.allow_tf32


class StepGraph:
    """The K steps of one key, captured. ``__init__`` runs the first batch
    eagerly (its metrics are ``first``) and captures; ``replay`` runs a later
    batch. ``nbytes``: its static buffers and what its capture added to
    ``pool``; ``capture_s``: the seconds the eager steps and the capture took."""

    def __init__(self, body, state, stacked: dict, generator, scalars: torch.Tensor, pool):
        global captures, captured_steps
        self.device = scalars.device
        self.inputs = {k: torch.empty_like(v) for k, v in stacked.items()}
        self.scalars = torch.empty_like(scalars)
        self.loss = torch.empty(scalars.shape[0], device=self.device)
        self.grad_norm = torch.empty_like(self.loss)
        self._fill(stacked, scalars)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        current = torch.cuda.current_stream(self.device)
        side = _side_stream(self.device)
        start.record(current)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self._run(body, state, generator)
            self.first = (self.loss.clone(), self.grad_norm.clone())
        current.wait_stream(side)
        before, pool_before = _kernel_counts(), pool_bytes(pool)
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(generator)
        with torch.cuda.graph(self.graph, pool=pool, stream=side, capture_error_mode="thread_local"):
            self._run(body, state, generator)
        # the capture launched nothing: its K1 and K1b counts move to each replay
        self.counts = tuple(a - b for a, b in zip(_kernel_counts(), before))
        _add_kernel_counts(tuple(-d for d in self.counts))
        end.record(current)
        end.synchronize()
        self.capture_s = start.elapsed_time(end) / 1e3
        self.pool_added = pool_bytes(pool) - pool_before
        self.nbytes = tensor_bytes([self.inputs, self.scalars, self.loss, self.grad_norm]) + self.pool_added
        captures += 1
        captured_steps += scalars.shape[0]

    def _fill(self, stacked: dict, scalars: torch.Tensor) -> None:
        for k, v in stacked.items():
            self.inputs[k].copy_(v, non_blocking=True)
        self.scalars.copy_(scalars, non_blocking=True)

    def _run(self, body, state, generator) -> None:
        loss, grad_norm = body(state, self.inputs, generator, self.scalars)
        self.loss.copy_(loss)
        self.grad_norm.copy_(grad_norm)

    def replay(self, stacked: dict, scalars: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        global replays, replayed_steps
        self._fill(stacked, scalars)
        self.graph.replay()
        _add_kernel_counts(self.counts)
        replays += 1
        replayed_steps += self.loss.shape[0]
        return self.loss.clone(), self.grad_norm.clone()


class TrainGraphs(GraphCache):
    """The captured train steps of one owner, by key (see the module's
    docstring). ``budget``: the bytes its keys may hold (None:
    ``decode.graphs.CACHE_SHARE`` of the card's memory)."""

    def run(self, key, body, state, stacked: dict, generator, scalars: torch.Tensor):
        """``body(state, stacked, generator, scalars)`` through the graph of
        this key (``key``: the step's settings), captured at its first batch.
        -> (loss (K,), grad_norm (K,)), tensors of their own."""
        if not scalars.is_cuda or generator.device.type != "cuda":
            raise ValueError(f"TrainGraphs: the steps run on a CUDA device, got {scalars.device}")
        full = graph_key(key, stacked, scalars.shape[0])
        with self.lock:
            self.bind((tree_leaves(state.params)[0], state.opt_state["mu"], state.batch_stats, generator))
            graph = self.shapes.get(full)
            if graph is not None:
                self.shapes.move_to_end(full)
                return graph.replay(stacked, scalars)
            shapes = {k: tuple(v.shape[1:]) for k, v in stacked.items() if k in ("lines", "chunks", "labels")}
            logger.info("capturing the train step for %s, %d step(s) a replay", shapes, scalars.shape[0])
            graph = self.get(full, lambda: StepGraph(body, state, stacked, generator, scalars, self.pool()))
            logger.info("captured in %.2f s; the pool grew by %.1f MiB", graph.capture_s, graph.pool_added / 2**20)
            return graph.first

    def bind(self, owner) -> None:
        """Another train state or generator than the last drops every key
        (the graphs read and write the first ones' tensors)."""
        if self._params is None or len(owner) != len(self._params) or any(
                a is not b for a, b in zip(owner, self._params)):
            self.shapes.clear()
            self._params, self._packed = owner, None
