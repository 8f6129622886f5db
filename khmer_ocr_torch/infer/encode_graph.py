"""The encode of a bucket batch as a captured CUDA graph: what
``predict_batch``'s dispatch stage runs on the card.

Eager, one batch's encode (windows, backbone, encoder layers, BiLSTM) is some
hundreds of launches from Python, and a thread making them beside the decode
slows the decode's replays, which wait on the host between chunks: the two
threads share the GIL and the CUDA runtime (PERF.md, section 6). So the
dispatch stage runs the encode of each shape eagerly once, captures it on
its own stream, and from then on replays it: the batch is copied into the
graph's input buffers, the graph replays, and its memory and pad mask are
cloned out, since a later batch of the shape replays into the same buffers
while this one still decodes.

A graph keeps the encode's intermediates in a memory pool of its own,
about 4.4 MB a chunk for the flagship (PERF.md, section 6). So only
shapes of at most ``MAX_CHUNKS`` chunks (rows x chunks a row) are
captured, where the launches weigh most against the encode's device time;
larger ones run eagerly. An owner keeps its encode graphs in a
``cuda_graphs.GraphCache`` of their own, apart from the decode's, each
graph counted by its input buffers and its pool, and freed with it.
"""

from __future__ import annotations

import torch

from ..cuda_graphs import Graph, GraphCache, pool_bytes, switches, tensor_bytes
from ..models import bilstm
from ..profiling import span

# the largest shape whose encode is captured: rows x chunks a row (8 rows of 8 chunks, one row of 64)
MAX_CHUNKS = 64
captures = 0  # encode graphs captured since the last reset_counts()
replays = 0


def reset_counts() -> None:
    global captures, replays
    captures = replays = 0


def encode_key(params: dict, lines: torch.Tensor) -> tuple:
    """The key of an encode: the batch's shape and device, the weights'
    dtype, the recurrence the BiLSTM runs and torch's switches."""
    return tuple(lines.shape), lines.device, params["patch"]["proj"]["w"].dtype, bilstm.lstm_recurrence, switches()


class EncodeGraph:
    """The encode of one shape: ``encode(lines, counts) -> (memory, pad
    mask)`` captured on the current stream into a memory pool of its own,
    with input buffers made like ``lines`` and ``counts``; ``nbytes``: the
    bytes of its input buffers and of its pool (intermediates and
    outputs)."""

    def __init__(self, encode, lines: torch.Tensor, counts: torch.Tensor):
        self.device = lines.device
        self.lines, self.counts = lines.clone(), counts.clone()
        with span("khmer_ocr.encode.capture"):
            self.graph = Graph(lambda: encode(self.lines, self.counts), torch.cuda.current_stream(self.device))
        self.nbytes = tensor_bytes([self.lines, self.counts]) + pool_bytes(self.graph.graph.pool())

    def replay(self, inputs: dict) -> None:
        self.lines.copy_(inputs["lines"])
        self.counts.copy_(inputs["counts"])
        self.graph.replay()


def encode_graphed(cache: GraphCache, params: dict, encode, lines: torch.Tensor, counts: torch.Tensor):
    """``encode(lines, counts)`` on the current stream (not the default
    one, which a capture cannot use) through the graph of this shape in
    ``cache``. A shape not cached yet runs eagerly (the kernels loaded,
    cuDNN's and cuBLAS's workspaces made for this stream outside any
    capture) and is then captured; its first batch keeps the eager result.
    Other params drop every graph made for the old ones."""
    global captures, replays
    eager = []

    def make():
        eager.append(encode(lines, counts))
        return EncodeGraph(encode, lines, counts)

    out, captured = cache.run(encode_key(params, lines), params, {"lines": lines, "counts": counts}, make,
                              lambda g: eager[0] if eager else tuple(t.clone() for t in g.graph.out))
    if captured:
        captures += 1
    else:
        replays += 1
    return out
