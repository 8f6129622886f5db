"""The layout model's two jitted programs as captured CUDA graphs: the
counterpart of the JAX package's jitted SegFormer train step and of its
jitted forward, one program per (configuration, output size, packing).

Both are ``cuda_graphs.StepGraph``s: a key's first call runs eagerly on a
side stream (cuDNN's algorithm choice, cuBLAS's and cuDNN's handles and
workspaces made outside any capture), then is captured on that stream;
every later call of the key copies its inputs into the graph's static
buffers and replays on the caller's current stream. Every output is a
static buffer outside the graphs' memory pool and nothing allocated in a
capture outlives it, so the graphs of one cache share one pool. CPU tensors
raise ``ValueError``: the CPU runs the eager path, which is the oracle.

- ``LayoutTrainGraphs``: the train step (detection/train.py::step_body:
  the train-mode forward, ``torch.autograd.grad``, Adam with its learning
  rate and bias corrections read from a (1, 3) device tensor, the
  BatchNorm running pair moved in place). The graphs read and write the
  model's own parameters and buffers and the optimizer state's moments:
  another model or optimizer state drops every key. Its owner is the
  ``finetune`` call (or the caller of ``make_train_step``).
- ``DetectionGraphs``: ``segformer.predict_maps`` at one key, (batch, 3, S,
  S) pixels, the output size and the packing, the maps copied to the host
  under the cache's lock. Its owner is the ``LayoutInference``; its
  captures run on a side stream of their own, since ``process_pages``
  detects on a worker thread while the main thread captures and replays
  the decode's graphs on the decode's side stream.

A key holds torch's switches and the model's train/eval mode (a
train-mode forward moves the BatchNorm pair). Each cache is a
``cuda_graphs.GraphCache`` bounded by bytes; the JAX package keeps its
jitted programs for the process.
"""

from __future__ import annotations

import logging

import torch

from ..cuda_graphs import GraphCache, StepGraph, side_stream, switches

logger = logging.getLogger(__name__)

# since the last reset_counts(): train-step graphs captured and replayed, forward graphs captured and replayed
step_captures = 0
step_replays = 0
forward_captures = 0
forward_replays = 0


def reset_counts() -> None:
    global step_captures, step_replays, forward_captures, forward_replays
    step_captures = step_replays = forward_captures = forward_replays = 0


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """ValueError unless every tensor lies on a CUDA device."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: the graphs run on a CUDA device, got a tensor on {t.device}")


def train_key(model, images: torch.Tensor, labels: torch.Tensor) -> tuple:
    """The key of a train step: the batch's shapes and dtypes, the model's
    mode and torch's switches. The learning rate is an input, as the JAX
    package traces it."""
    return "step", tuple(images.shape), images.dtype, tuple(labels.shape), labels.dtype, model.training, switches()


def forward_key(model, pixels: torch.Tensor, out_hw, compact: bool) -> tuple:
    """The key of a forward: the pixels' shape and dtype, the output size,
    the packing (or the two exact maps), the model's mode and torch's
    switches."""
    return ("forward", tuple(pixels.shape), pixels.dtype, tuple(int(v) for v in out_hw), bool(compact),
            model.training, switches())


class LayoutTrainGraphs(GraphCache):
    """The captured layout train steps of one owner (see the module's
    docstring). ``budget``: the bytes its keys may hold (None:
    ``cuda_graphs.CACHE_SHARE`` of the card's memory)."""

    def step(self, body, model, opt_state: dict, images: torch.Tensor, labels: torch.Tensor,
             scalars: torch.Tensor) -> torch.Tensor:
        """``body(model, opt_state, images, labels, scalars)`` through the
        graph of its key, captured at the key's first batch -> the loss, a
        0-d tensor of its own."""
        global step_captures, step_replays
        require_cuda("LayoutTrainGraphs", images, labels, scalars)
        inputs = {"images": images, "labels": labels, "scalars": scalars}

        def make():
            graph = StepGraph(lambda inp: (body(model, opt_state, inp["images"], inp["labels"], inp["scalars"]),),
                              inputs, images.device, side_stream(images.device), self.pool())
            logger.info("captured the layout train step for %s in %.2f s; the pool grew by %.1f MiB",
                        tuple(images.shape), graph.capture_s, graph.pool_added / 2**20)
            return graph

        loss, captured = self.run(train_key(model, images, labels), (next(model.parameters()), opt_state["mu"]),
                                  inputs, make, lambda g: g.outputs[0].clone())
        if captured:
            step_captures += 1
        else:
            step_replays += 1
        return loss


class DetectionGraphs(GraphCache):
    """The captured forwards of one ``LayoutInference`` (see the module's
    docstring). ``budget``: the bytes its keys may hold (None:
    ``cuda_graphs.CACHE_SHARE`` of the card's memory)."""

    def forward(self, body, model, pixels: torch.Tensor, out_hw, compact: bool) -> tuple:
        """``body(pixels on the card) -> tuple of maps`` (the forward of
        ``model`` at ``out_hw`` and ``compact``) through the graph of its
        key; ``pixels`` on the host are copied into its static input. ->
        the maps copied to the host, each after the caller's current stream
        alone."""
        global forward_captures, forward_replays
        device = next(model.parameters()).device
        if device.type != "cuda":
            raise ValueError(f"DetectionGraphs: the graphs run on a CUDA device, the model is on {device}")
        inputs = {"pixels": pixels}

        def make():
            graph = StepGraph(lambda inp: body(inp["pixels"]), inputs, device, side_stream(device, "detection"),
                              self.pool())
            logger.info("captured the layout forward for %s -> %s in %.2f s: %.1f MiB with the pool's growth",
                        tuple(pixels.shape), tuple(out_hw), graph.capture_s, graph.nbytes / 2**20)
            return graph

        maps, captured = self.run(forward_key(model, pixels, out_hw, compact), next(model.parameters()), inputs,
                                  make, lambda g: tuple(t.cpu() for t in g.outputs))
        if captured:
            forward_captures += 1
        else:
            forward_replays += 1
        return maps
