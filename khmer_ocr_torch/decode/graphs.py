"""The decode's step loop as captured CUDA graphs: the counterpart of the JAX
package's ``lax.while_loop`` per cache window.

The JAX package runs each cache window (32, 64, 128, ..., max_len) of a
decode as one ``lax.while_loop`` with ``pos`` a traced carry, so the host
dispatches one program a batch. Here the step body is captured once per
decode shape: one CUDA graph holds ``EXIT_CHECK_EVERY`` steps at one window
(``step_chunks``: a shorter tail graph where a window's positions do not
divide), and the host replays them window by window. The position lives on
the card (a 0-d int32 the body reads and advances, and kernel K2 reads
through its pointer), so one graph serves every position of its window.
Between replays the host tests the provably-safe early exit (a device sync),
as the Python loop did between its chunks; the tokens are the same for any
chunk length (models/ocr_model.py::EXIT_CHECK_EVERY).

A decode shape (``StepGraphs``) holds the static buffers of one (rows,
lanes, Tm, dtype, max_len, head, ...) key: the search state and the decode
state (memory K/V, self caches), shared by the graphs of all its windows.
Its ``run`` runs a chunk's steps from Python, its ``replay`` the chunk's
graph; ``decode`` drives either through ``run_chunks``. The Python loop
(CPU tensors, model groups, or the graphs' oracle) makes a shape for its
batch and runs it; the graphs keep their shapes in a ``GraphCache``, which
its owner (a Predictor) holds, so the buffers and graphs die with it. The
cache evicts the least recently used shapes beyond a budget of bytes
(``CACHE_SHARE`` of the card's memory unless the owner gives one), counted
from each shape's buffers. Capture: a shape's first chunk runs once
eagerly on a side stream (kernels built and loaded, cuBLAS handles made),
every chunk is then captured with the position set to its first step, and
the buffers are filled afresh. A capture or replay failure raises; nothing
falls back to the Python loop.
"""

from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict

import torch

from ..models.ocr_model import EXIT_CHECK_EVERY, decode_windows, memory_kv, pack_decode_params
from ..ops.kernels import beam_step, decode_step
from ..profiling import span

# The share of the card's memory a GraphCache's shapes may hold unless its
# owner sets a budget. One shape holds its self caches, 2 layers x 2 x rows
# x lanes x max_len x D x itemsize bytes, and its memory K/V, 2 layers x 2 x
# rows x Tm x D x itemsize. The flagship's default warmup (256 rows, chunk
# buckets 1-4, beam 1 and 3, max_len 256, float32) makes 8 shapes of 7598
# MiB, and a miss, a shape captured again, costs about 75 ms on an H100
# (PERF.md section 6, chip_smoke.py [decode_graph]): a quarter of an 80 GB
# card holds that warmup 2.7 times and leaves the rest to the encoder and
# other models.
CACHE_SHARE = 0.25

# since the last reset_counts(): graphs captured, graph replays, decode steps
# run by replays, and steps run by the Python loop on CUDA tensors
captures = 0
replays = 0
replayed_steps = 0
eager_steps = 0
_SIDE: dict = {}  # the side stream of each (device, role)


def reset_counts() -> None:
    global captures, replays, replayed_steps, eager_steps
    captures = replays = replayed_steps = eager_steps = 0


def kernel_counts() -> tuple:
    """K2's counts (``decode_step.k2_counts``), then K5's launches."""
    return (*decode_step.k2_counts(), beam_step.launches)


def add_kernel_counts(delta) -> None:
    """Add ``delta`` (as ``kernel_counts``) to K2's and K5's counts."""
    decode_step.add_k2_counts(delta[:-1])
    beam_step.add_launches(delta[-1])


def step_chunks(max_len: int, every: int = EXIT_CHECK_EVERY) -> list[tuple[int, int, int]]:
    """(window, first position, steps) of each chunk of a decode of
    ``max_len`` steps: each cache window's positions in runs of ``every``
    and a shorter tail where they do not divide."""
    chunks, start = [], 0
    for w in decode_windows(max_len):
        end = min(w, max_len)
        while start < end:
            n = min(every, end - start)
            chunks.append((w, start, n))
            start += n
    return chunks


def run_chunks(max_len: int, cache_len: int, finished, run, every: int = EXIT_CHECK_EVERY) -> int:
    """The step loop: before each chunk the exit test ``finished()`` (a
    device sync), then ``run(window, steps)`` from the device position. Every position stays
    below its window and ``cache_len`` (the slots the self caches hold),
    checked here on the host, since the kernels read the position on the
    device. Returns the steps run."""
    pos = 0
    for w, start, n in step_chunks(max_len, every):
        with span("khmer_ocr.decode.exit_test"):
            done = finished()
        if done:
            break
        if start + n > min(w, cache_len):
            raise ValueError(f"decode: position {start + n - 1} outside the window {w} or the caches' {cache_len} "
                             f"slots")
        run(w, n)
        pos = start + n
    return pos


def run_steps(st: dict, n: int, step) -> None:
    """``n`` calls of ``step(state)`` on a copy of the dict ``st``; each
    tensor a step replaced is then copied into ``st``'s own, so that ``st``
    (a graph's static buffers) holds the result."""
    cur = dict(st)
    for _ in range(n):
        step(cur)
    for key, t in st.items():
        if cur[key] is not t:
            t.copy_(cur[key])


def fill_decode_state(state: dict, packed: dict, memory, pad_mask) -> None:
    """``init_decode_state``'s values for this memory, written into the
    buffers of an earlier ``init_decode_state`` of the same shapes."""
    for (mk, mv), (src_k, src_v) in zip(state["mem_kv"], memory_kv(packed, memory)):
        mk.copy_(src_k)
        mv.copy_(src_v)
    for sk, sv in state["self_kv"]:
        sk.zero_()
        sv.zero_()
    state["mem_valid"].copy_(~pad_mask)
    state["mem_valid_f"].copy_(~pad_mask)


def precision_key() -> tuple:
    """torch's switches that pick the kernels a captured matmul replays."""
    m = torch.backends.cuda.matmul
    return m.allow_tf32, m.allow_bf16_reduced_precision_reduction, torch.get_float32_matmul_precision()


def _side_stream(device: torch.device, role: str = "decode"):
    """The stream each device's eager chunks and captures of ``role`` run
    on: one, so that the handles and workspaces made for it (cuBLAS keeps
    one a stream) are made once, outside any capture's memory pool. The
    decode and the train steps share the "decode" stream; a role whose
    captures may run on another thread beside theirs (the detection) takes
    a stream of its own, since two captures on one stream cannot overlap."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if (idx, role) not in _SIDE:
        _SIDE[idx, role] = torch.cuda.Stream(idx)
    return _SIDE[idx, role]


def tensor_bytes(tree) -> int:
    """The bytes of the tensors in nested dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return tree.nbytes
    if isinstance(tree, dict):
        tree = list(tree.values())
    return sum(tensor_bytes(t) for t in tree) if isinstance(tree, (list, tuple)) else 0


class StepGraphs:
    """One decode shape. ``st`` is its search state, whose 0-d int32
    ``st["pos"]`` is the device position, and ``state`` its decode state,
    both made for the batch it was built from; ``run(window, steps)`` runs
    ``steps`` steps on them from that position; ``fill(memory, pad)``
    writes another batch's initial state into them; ``cache_len``: the
    slots of its self caches; ``nbytes``: the bytes of its buffers."""

    def __init__(self, run, fill, st: dict, state: dict):
        self.run, self.fill, self.st = run, fill, st
        self.cache_len = state["self_kv"][0][0].shape[1]
        self.device = st["pos"].device
        self.nbytes = tensor_bytes(st) + tensor_bytes(state)
        self.graphs: dict = {}

    def set_pos(self, pos: int) -> None:
        self.st["pos"].fill_(pos)

    def prepare(self, max_len: int, inputs: tuple, pool, lock=None) -> None:
        """Capture the graph of every chunk shape of a decode of ``max_len``
        steps not captured yet (into the memory pool ``pool``, holding
        ``lock`` meanwhile), then fill the buffers with ``inputs``' initial
        state."""
        todo = [c for c in step_chunks(max_len) if (c[0], c[2]) not in self.graphs]
        if todo:
            with lock or contextlib.nullcontext(), span("khmer_ocr.decode.capture"):
                self._capture(todo, inputs, pool)
        self.fill(*inputs)

    def _capture(self, todo: list, inputs: tuple, pool) -> None:
        global captures
        self.fill(*inputs)  # valid tokens and lineage for the eager chunk
        side = _side_stream(self.device)
        if not self.graphs:  # one eager chunk first: kernels loaded, handles made, outside any capture
            w, start, n = todo[0]
            self.set_pos(start)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self.run(w, n)
            torch.cuda.current_stream(self.device).wait_stream(side)
        for w, start, n in todo:
            if (w, n) in self.graphs:
                continue
            self.set_pos(start)
            before = kernel_counts()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool, stream=side, capture_error_mode="thread_local"):
                self.run(w, n)
            # the capture launched nothing: its K2 and K5 counts move to each replay
            delta = tuple(a - b for a, b in zip(kernel_counts(), before))
            add_kernel_counts(tuple(-d for d in delta))
            self.graphs[(w, n)] = (graph, delta)
            captures += 1

    def replay(self, w: int, n: int) -> None:
        global replays, replayed_steps
        graph, delta = self.graphs[(w, n)]
        graph.replay()
        add_kernel_counts(delta)
        replays += 1
        replayed_steps += n


class GraphCache:
    """The decode shapes of one owner and the weights they read: the owner
    (a Predictor) holds the cache, so its buffers and graphs are freed with
    it. ``budget``: the bytes its shapes' buffers may hold, the least
    recently used shapes evicted beyond it (None: ``CACHE_SHARE`` of the
    card's memory); a shape larger than the budget is still kept, alone.
    The decode's graphs share its one memory pool (``pool()``): replays run
    one after another on one stream and leave their results in their
    shape's buffers, so their intermediates may share memory (the encode
    graphs of infer/encode_graph.py, in a cache of their own, each take a
    pool of their own). ``capture_lock`` is held around every
    capture; a thread that launches work beside the decode (the Predictor's
    dispatch stage) holds it around its launches, so that no other thread's
    call lands inside a capture."""

    def __init__(self, budget: int | None = None):
        self.budget = budget
        self.shapes: OrderedDict = OrderedDict()
        self.lock = threading.Lock()
        self.capture_lock = threading.Lock()
        self._params = self._packed = self._pool = None

    def __len__(self) -> int:
        return len(self.shapes)

    @property
    def nbytes(self) -> int:
        return sum(s.nbytes for s in self.shapes.values())

    def bind(self, params) -> None:
        """Other params than the last drop every shape made for those.
        ``params``: the weights, or a tuple of the objects the graphs read
        and write (compared item by item)."""
        last = self._params
        same = params is last or (isinstance(params, tuple) and isinstance(last, tuple) and len(params) == len(last)
                                  and all(a is b for a, b in zip(params, last)))
        if not same:
            self.shapes.clear()
            self._params, self._packed = params, None

    def packed(self, params: dict) -> dict:
        """``pack_decode_params(params)``, made once for the shapes to share;
        other params drop every shape made for the old ones."""
        self.bind(params)
        if self._packed is None:
            self._packed = pack_decode_params(params)
        return self._packed

    def get(self, key, make) -> StepGraphs:
        """The shape of ``key``, made by ``make()`` the first time."""
        sg = self.shapes.get(key)
        if sg is None:
            sg = make()
            budget = self.budget
            if budget is None:
                budget = int(CACHE_SHARE * torch.cuda.get_device_properties(sg.device).total_memory)
            while self.shapes and self.nbytes + sg.nbytes > budget:
                self.shapes.popitem(last=False)
            self.shapes[key] = sg
        self.shapes.move_to_end(key)
        return sg

    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool


def decode(cache: GraphCache | None, key, make, inputs: tuple, max_len: int, finished, answer):
    """One batch: ``make()`` builds a ``StepGraphs`` for this batch. With
    ``cache`` None the Python loop runs its chunks; else the shape of
    ``key`` in ``cache`` (made the first time) captures the graphs of every
    chunk of ``max_len`` steps still missing, takes ``inputs``' state and
    replays its chunks. The exit test ``finished(st)`` runs between chunks.
    Returns (``answer(st)``, a new tensor, and the steps run)."""
    global eager_steps
    if cache is None:
        sg = make()
        steps = run_chunks(max_len, sg.cache_len, lambda: finished(sg.st), sg.run)
        if sg.device.type == "cuda":
            eager_steps += steps
        return answer(sg.st), steps
    with cache.lock, torch.inference_mode():
        sg = cache.get(key, make)
        sg.prepare(max_len, inputs, cache.pool(), cache.capture_lock)
        steps = run_chunks(max_len, sg.cache_len, lambda: finished(sg.st), sg.replay)
        return answer(sg.st), steps
