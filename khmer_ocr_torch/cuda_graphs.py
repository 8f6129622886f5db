"""CUDA graph capture, replay and caching: the one mechanism under the
port's captured decode chunks (decode/graphs.py), encodes
(infer/encode_graph.py), train steps (train/graphs.py) and layout steps and
forwards (detection/graphs.py), the counterparts of the JAX package's jitted
programs. A capture or replay failure raises; nothing falls back to the
eager path.

``capture_lock`` is the one rule across threads: every capture holds it,
and a thread that launches work beside another thread's captures (the
Predictor's dispatch stage) holds it around its launches, so that no other
thread's launch lands inside a capture. A role whose captures may run on
another thread beside the decode's (the detection) takes a side stream of
its own (``side_stream``), since two captures on one stream cannot overlap.
A graph's key ends with torch's switches (``switches``), since a captured
graph replays the kernels they picked.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import torch

from . import precision
from .ops.kernels import build

# The share of the card's memory a GraphCache's entries may hold unless its
# owner sets a budget. One decode shape holds its self caches, 2 layers x 2 x
# rows x lanes x max_len x D x itemsize bytes, and its memory K/V, 2 layers x
# 2 x rows x Tm x D x itemsize. The flagship's default warmup (256 rows,
# chunk buckets 1-4, beam 1 and 3, max_len 256, float32) makes 8 shapes of
# 7598 MiB, and a miss, a shape captured again, costs about 75 ms on an H100
# (PERF.md section 6, chip_smoke.py [decode_graph]): a quarter of an 80 GB
# card holds that warmup 2.7 times and leaves the rest to the encoder and
# other models.
CACHE_SHARE = 0.25

capture_lock = threading.RLock()  # see the module's docstring
_SIDE: dict = {}  # the side stream of each (device, role)


def switches() -> tuple:
    """torch's switches that pick the kernels a captured matmul or
    convolution replays: the precision scope's and the bf16 reduction's."""
    return *precision.switches(), torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction


def side_stream(device: torch.device, role: str = "main"):
    """The stream each device's eager first runs and captures of ``role``
    run on: one, so that the handles and workspaces made for it (cuBLAS
    keeps one a stream) are made once, outside any capture's memory pool.
    The decode and the train steps share the "main" stream."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if (idx, role) not in _SIDE:
        _SIDE[idx, role] = torch.cuda.Stream(idx)
    return _SIDE[idx, role]


def on_stream(stream, fn):
    """``fn()`` on ``stream`` after the current stream's work so far; the
    current stream then waits for it."""
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        out = fn()
    current.wait_stream(stream)
    return out


def tensor_bytes(tree) -> int:
    """The bytes of the tensors in nested dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return tree.nbytes
    if isinstance(tree, dict):
        tree = list(tree.values())
    return sum(tensor_bytes(t) for t in tree) if isinstance(tree, (list, tuple)) else 0


def pool_bytes(pool) -> int:
    """The bytes of the segments the caching allocator holds for the graph
    memory pool ``pool``."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


class Graph:
    """``body()`` captured on ``stream`` into the memory pool ``pool`` (None:
    one of its own); ``out``: what the body returned, the tensors each
    replay writes. ``generator``: the torch.Generator the body draws from,
    registered with the graph so that each replay draws the next numbers
    and advances it as eager runs do (None: the body draws nothing).
    ``launches``: the kernel launches of one replay, added to the registry
    by ``replay``."""

    def __init__(self, body, stream, pool=None, generator=None):
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        with capture_lock, build.capturing(stream.cuda_stream) as self.launches, \
                torch.cuda.graph(self.graph, pool=pool, stream=stream, capture_error_mode="thread_local"):
            self.out = body()

    def replay(self) -> None:
        self.graph.replay()
        build.launches.update(self.launches)


class StepGraph:
    """One key's work, captured: ``body(inputs) -> tuple of tensors`` over
    static buffers on ``device`` made like ``inputs`` (a dict of tensors, on
    the host or the device), run once eagerly on ``stream`` and then
    captured there into ``pool``; ``outputs`` are static tensors outside the
    pool that hold the eager run's results until the first ``replay``, which
    copies other inputs in and replays on the current stream.
    ``generator``: as ``Graph``'s. ``nbytes``: the static buffers and what
    the capture added to ``pool``; ``capture_s``: the seconds of the eager
    run and the capture."""

    def __init__(self, body, inputs: dict, device: torch.device, stream, pool, generator=None):
        self.device = device
        self.inputs = {k: torch.empty(v.shape, dtype=v.dtype, device=device) for k, v in inputs.items()}
        self._fill(inputs)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        current = torch.cuda.current_stream(device)
        start.record(current)
        first = on_stream(stream, lambda: body(self.inputs))
        # made on the caller's stream, outside the pool; the capture's device sync comes before the eager
        # results' memory is used again on the side stream
        self.outputs = tuple(t.detach().clone() for t in first)
        del first
        pool_before = pool_bytes(pool)
        self.graph = Graph(lambda: [out.copy_(t) for out, t in zip(self.outputs, body(self.inputs))], stream, pool,
                           generator)
        end.record(current)
        end.synchronize()
        self.capture_s = start.elapsed_time(end) / 1e3
        self.pool_added = pool_bytes(pool) - pool_before
        self.nbytes = tensor_bytes([self.inputs, self.outputs]) + self.pool_added

    def _fill(self, inputs: dict) -> None:
        for k, v in inputs.items():
            self.inputs[k].copy_(v, non_blocking=True)

    def replay(self, inputs: dict) -> None:
        self._fill(inputs)
        self.graph.replay()


class GraphCache:
    """The graphs of one owner (a Predictor, a ``train()`` call, a
    LayoutInference, ...) by key, and the weights they read: the owner holds
    the cache, so the graphs and their buffers are freed with it.
    ``budget``: the bytes its entries may hold, the least recently used
    evicted beyond it (None: ``CACHE_SHARE`` of the card's memory), each
    counted by its ``nbytes``; an entry larger than the budget is still
    kept, alone. Graphs whose replays run one after another and leave their
    results outside the pool share the cache's one memory pool
    (``pool()``)."""

    def __init__(self, budget: int | None = None):
        self.budget = budget
        self.shapes: OrderedDict = OrderedDict()
        self.lock = threading.Lock()
        self._params = self._shared = self._pool = None

    def __len__(self) -> int:
        return len(self.shapes)

    @property
    def nbytes(self) -> int:
        return sum(s.nbytes for s in self.shapes.values())

    def bind(self, params) -> None:
        """Other params than the last drop every entry made for those.
        ``params``: the weights, or a tuple of the objects the graphs read
        and write (compared item by item)."""
        last = self._params
        same = params is last or (isinstance(params, tuple) and isinstance(last, tuple) and len(params) == len(last)
                                  and all(a is b for a, b in zip(params, last)))
        if not same:
            self.shapes.clear()
            self._params, self._shared = params, None

    def shared(self, params, make):
        """``make(params)``, made once for the entries to share; other
        params drop every entry made for the old ones, and it."""
        self.bind(params)
        if self._shared is None:
            self._shared = make(params)
        return self._shared

    def get(self, key, make):
        """The entry of ``key``, made by ``make()`` the first time."""
        entry = self.shapes.get(key)
        if entry is None:
            entry = make()
            budget = self.budget
            if budget is None:
                budget = int(CACHE_SHARE * torch.cuda.get_device_properties(entry.device).total_memory)
            while self.shapes and self.nbytes + entry.nbytes > budget:
                self.shapes.popitem(last=False)
            self.shapes[key] = entry
        self.shapes.move_to_end(key)
        return entry

    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def run(self, key, params, inputs: dict, make, result):
        """Under the cache's lock, after ``bind(params)``: the entry of
        ``key`` replayed over ``inputs``, or made by ``make()`` (its capture)
        under ``capture_lock`` the first time -> (``result(entry)``, whether
        this call captured it)."""
        with self.lock:
            self.bind(params)
            entry = self.shapes.get(key)
            captured = entry is None
            if captured:
                with capture_lock:
                    entry = self.get(key, make)
            else:
                self.shapes.move_to_end(key)
                entry.replay(inputs)
            return result(entry), captured
