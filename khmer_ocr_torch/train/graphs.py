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

``StepGraph`` serves the layout model's graphs too (detection/graphs.py).
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
from ..profiling import span
from .step import tree_leaves

logger = logging.getLogger(__name__)

# since the last reset_counts(): graphs captured, the steps their first batches ran eagerly, replays, and the
# steps run by replays
captures = 0
captured_steps = 0
replays = 0
replayed_steps = 0
SCALARS = "_scalars"  # the step scalars' name among a graph's inputs


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
    """One key's work, captured: ``body(inputs) -> tuple of tensors`` over
    static buffers on ``device`` made like ``inputs`` (a dict of tensors,
    on the host or the device). ``__init__`` fills them, runs the body
    once eagerly on the side stream of ``role`` and captures it there;
    ``outputs`` are static tensors outside the pool that hold the eager
    run's results until the first ``replay``, which copies other inputs
    in and replays. ``generator``: the torch.Generator the body draws from,
    registered with the graph so that each replay draws the next numbers
    (None: the body draws nothing). ``counts``: the K1 and K1b launches of
    one replay; ``nbytes``: the static buffers and what the capture added
    to ``pool``; ``capture_s``: the seconds of the eager run and the
    capture."""

    def __init__(self, body, inputs: dict, device: torch.device, pool, generator=None, role: str = "decode"):
        self.device = device
        self.inputs = {k: torch.empty(v.shape, dtype=v.dtype, device=device) for k, v in inputs.items()}
        self._fill(inputs)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        current = torch.cuda.current_stream(device)
        side = _side_stream(device, role)
        start.record(current)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            first = body(self.inputs)
        current.wait_stream(side)
        # made on the caller's stream, outside the pool; the capture's device sync comes before the eager
        # results' memory is used again on the side stream
        self.outputs = tuple(t.detach().clone() for t in first)
        del first
        before, pool_before = _kernel_counts(), pool_bytes(pool)
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        with torch.cuda.graph(self.graph, pool=pool, stream=side, capture_error_mode="thread_local"):
            for out, t in zip(self.outputs, body(self.inputs)):
                out.copy_(t)
        # the capture launched nothing: its K1 and K1b counts move to each replay
        self.counts = tuple(a - b for a, b in zip(_kernel_counts(), before))
        _add_kernel_counts(tuple(-d for d in self.counts))
        end.record(current)
        end.synchronize()
        self.capture_s = start.elapsed_time(end) / 1e3
        self.pool_added = pool_bytes(pool) - pool_before
        self.nbytes = tensor_bytes([self.inputs, self.outputs]) + self.pool_added

    def _fill(self, inputs: dict) -> None:
        for k, v in inputs.items():
            self.inputs[k].copy_(v, non_blocking=True)

    def replay(self, inputs: dict) -> None:
        """Copy ``inputs`` into the static buffers and replay on the current
        stream; the results land in ``outputs``."""
        self._fill(inputs)
        self.graph.replay()
        _add_kernel_counts(self.counts)


class TrainGraphs(GraphCache):
    """The captured train steps of one owner, by key (see the module's
    docstring). ``budget``: the bytes its keys may hold (None:
    ``decode.graphs.CACHE_SHARE`` of the card's memory)."""

    def run(self, key, body, state, stacked: dict, generator, scalars: torch.Tensor):
        """``body(state, stacked, generator, scalars)`` through the graph of
        this key (``key``: the step's settings), captured at its first batch.
        -> (loss (K,), grad_norm (K,)), tensors of their own."""
        global captures, captured_steps, replays, replayed_steps
        if not scalars.is_cuda or generator.device.type != "cuda":
            raise ValueError(f"TrainGraphs: the steps run on a CUDA device, got {scalars.device}")
        full = graph_key(key, stacked, scalars.shape[0])
        with self.lock:
            # another train state or generator than the last drops every key (the graphs read and write the
            # first ones' tensors)
            self.bind((tree_leaves(state.params)[0], state.opt_state["mu"], state.batch_stats, generator))
            inputs = {**stacked, SCALARS: scalars}
            graph = self.shapes.get(full)
            if graph is not None:
                self.shapes.move_to_end(full)
                graph.replay(inputs)
                replays += 1
                replayed_steps += scalars.shape[0]
            else:
                shapes = {k: tuple(v.shape[1:]) for k, v in stacked.items() if k in ("lines", "chunks", "labels")}
                logger.info("capturing the train step for %s, %d step(s) a replay", shapes, scalars.shape[0])

                def run(inp):
                    return body(state, {k: v for k, v in inp.items() if k != SCALARS}, generator, inp[SCALARS])

                with span("khmer_ocr.train.capture"):
                    graph = self.get(full, lambda: StepGraph(run, inputs, scalars.device, self.pool(), generator))
                captures += 1
                captured_steps += scalars.shape[0]
                logger.info("captured in %.2f s; the pool grew by %.1f MiB", graph.capture_s,
                            graph.pool_added / 2**20)
            return tuple(t.clone() for t in graph.outputs)
