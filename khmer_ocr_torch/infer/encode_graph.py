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
``GraphCache`` of their own (decode/graphs.py), apart from the decode's,
each graph counted by its input buffers and its pool, and freed with it. K1's launch in a capture moves to each
replay, as K2's do in the decode's graphs.
"""

from __future__ import annotations

import torch

from ..decode.graphs import GraphCache, precision_key, tensor_bytes
from ..models import bilstm
from ..ops.kernels import lstm
from ..profiling import span

# the largest shape whose encode is captured: rows x chunks a row (8 rows of 8 chunks, one row of 64)
MAX_CHUNKS = 64
captures = 0  # encode graphs captured since the last reset_counts()
replays = 0


def reset_counts() -> None:
    global captures, replays
    captures = replays = 0


def pool_bytes(pool) -> int:
    """The bytes of the segments the caching allocator holds for the graph
    memory pool ``pool``."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


class EncodeGraph:
    """The encode of one shape: ``encode(lines, counts) -> (memory, pad
    mask)`` captured on the current stream into a memory pool of its own,
    with input buffers made like ``lines`` and ``counts``; ``nbytes``: the
    bytes of its input buffers and of its pool (intermediates and
    outputs)."""

    def __init__(self, encode, lines: torch.Tensor, counts: torch.Tensor):
        global captures
        self.device = lines.device
        self.lines, self.counts = lines.clone(), counts.clone()
        k1 = lstm.launches
        self.graph = torch.cuda.CUDAGraph()
        with span("khmer_ocr.encode.capture"), \
                torch.cuda.graph(self.graph, stream=torch.cuda.current_stream(self.device),
                                 capture_error_mode="thread_local"):
            self.memory, self.pad = encode(self.lines, self.counts)
        self.k1 = lstm.launches - k1  # the capture launched nothing: its K1 count moves to each replay
        lstm.launches = k1
        self.nbytes = tensor_bytes([self.lines, self.counts]) + pool_bytes(self.graph.pool())
        captures += 1

    def __call__(self, lines: torch.Tensor, counts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        global replays
        self.lines.copy_(lines)
        self.counts.copy_(counts)
        self.graph.replay()
        lstm.launches += self.k1
        replays += 1
        return self.memory.clone(), self.pad.clone()


def encode_graphed(cache: GraphCache, params: dict, encode, lines: torch.Tensor, counts: torch.Tensor):
    """``encode(lines, counts)`` on the current stream (not the default
    one, which a capture cannot use) through the graph of this shape in
    ``cache``. A shape not cached yet runs eagerly (the kernels loaded,
    cuDNN's and cuBLAS's workspaces made for this stream outside any
    capture) and is then captured; its first batch keeps the eager result.
    Other params drop every graph made for the old ones."""
    key = (tuple(lines.shape), lines.device, params["patch"]["proj"]["w"].dtype, bilstm.lstm_recurrence,
           precision_key(), torch.backends.cudnn.allow_tf32)
    with cache.lock:
        cache.bind(params)
        if key in cache.shapes:
            return cache.get(key, None)(lines, counts)
        out = encode(lines, counts)
        cache.get(key, lambda: EncodeGraph(encode, lines, counts))
        return out
