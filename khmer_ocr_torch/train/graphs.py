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

A key's graph (``cuda_graphs.StepGraph``) reads static buffers made outside
the graphs' memory pool: the stacked batch, the (K, 3) learning rates and
bias corrections (train/step.py::step_scalars), both copied in before each
replay, and the metrics (K,) it writes; params, moments and statistics are
the train state's own tensors, moved in place. Nothing allocated inside a
capture outlives it, and the steps never run concurrently, so every graph
of one ``TrainGraphs`` shares one memory pool, which holds about the
largest step's intermediates rather than their sum.

Capture: a key's first batch runs the body eagerly on the side stream (the
real steps), then the body is captured on that stream with the step's
``torch.Generator`` registered with the graph, so that each replay draws
the next numbers and advances the generator as the eager steps do. The
graphs keep the train state and generator they were captured with: others
drop every key. ``TrainGraphs`` is a ``cuda_graphs.GraphCache``: its owner
(a ``train()`` call, or the caller of a step maker) holds it, so its
buffers and graphs are freed with it, and it evicts the least recently used
keys beyond a budget of bytes.
"""

from __future__ import annotations

import logging

import torch

from ..cuda_graphs import GraphCache, StepGraph, side_stream, switches
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


def graph_key(step_key, stacked: dict, k: int) -> tuple:
    """The key of K steps of ``step_key``'s settings over ``stacked``: its
    shapes and dtypes, K, and torch's switches."""
    shapes = tuple((name, tuple(v.shape), v.dtype) for name, v in sorted(stacked.items()))
    return step_key, shapes, k, switches()


class TrainGraphs(GraphCache):
    """The captured train steps of one owner, by key (see the module's
    docstring). ``budget``: the bytes its keys may hold (None:
    ``cuda_graphs.CACHE_SHARE`` of the card's memory)."""

    def step(self, key, body, state, stacked: dict, generator, scalars: torch.Tensor):
        """``body(state, stacked, generator, scalars)`` through the graph of
        this key (``key``: the step's settings), captured at its first batch.
        -> (loss (K,), grad_norm (K,)), tensors of their own."""
        global captures, captured_steps, replays, replayed_steps
        if not scalars.is_cuda or generator.device.type != "cuda":
            raise ValueError(f"TrainGraphs: the steps run on a CUDA device, got {scalars.device}")
        k = scalars.shape[0]

        def make():
            shapes = {n: tuple(v.shape[1:]) for n, v in stacked.items() if n in ("lines", "chunks", "labels")}
            logger.info("capturing the train step for %s, %d step(s) a replay", shapes, k)
            with span("khmer_ocr.train.capture"):
                graph = StepGraph(lambda inp: body(state, {n: v for n, v in inp.items() if n != SCALARS}, generator,
                                                   inp[SCALARS]),
                                  inputs, scalars.device, side_stream(scalars.device), self.pool(), generator)
            logger.info("captured in %.2f s; the pool grew by %.1f MiB", graph.capture_s, graph.pool_added / 2**20)
            return graph

        inputs = {**stacked, SCALARS: scalars}
        # another train state or generator than the last drops every key (the graphs read and write the first
        # ones' tensors)
        bound = (tree_leaves(state.params)[0], state.opt_state["mu"], state.batch_stats, generator)
        out, captured = self.run(graph_key(key, stacked, k), bound, inputs, make,
                                 lambda g: tuple(t.clone() for t in g.outputs))
        if captured:
            captures += 1
            captured_steps += k
        else:
            replays += 1
            replayed_steps += k
        return out
