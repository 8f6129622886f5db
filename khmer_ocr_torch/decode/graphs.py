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
batch and runs it; the graphs keep their shapes in a
``cuda_graphs.GraphCache``, which its owner (a Predictor) holds, so the
buffers and graphs die with it, each shape counted by its buffers and its
graphs sharing the cache's one memory pool: replays run one after another on
one stream and leave their results in their shape's buffers. Capture: a
shape's first chunk runs once eagerly on the side stream (kernels built and
loaded, cuBLAS handles made), every chunk is then captured there with the
position set to its first step (``cuda_graphs.Graph``), and the buffers are
filled afresh. A capture or replay failure raises; nothing falls back to the
Python loop.
"""

from __future__ import annotations

import torch

from ..cuda_graphs import Graph, GraphCache, capture_lock, on_stream, side_stream, tensor_bytes
from ..models.ocr_model import EXIT_CHECK_EVERY, decode_windows, memory_kv
from ..profiling import span

# since the last reset_counts(): graphs captured, graph replays, decode steps
# run by replays, and steps run by the Python loop on CUDA tensors
captures = 0
replays = 0
replayed_steps = 0
eager_steps = 0


def reset_counts() -> None:
    global captures, replays, replayed_steps, eager_steps
    captures = replays = replayed_steps = eager_steps = 0


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

    def prepare(self, max_len: int, inputs: tuple, pool) -> None:
        """Capture the graph of every chunk shape of a decode of ``max_len``
        steps not captured yet (into the memory pool ``pool``), then fill the
        buffers with ``inputs``' initial state."""
        todo = [c for c in step_chunks(max_len) if (c[0], c[2]) not in self.graphs]
        if todo:
            with capture_lock, span("khmer_ocr.decode.capture"):
                self._capture(todo, inputs, pool)
        self.fill(*inputs)

    def _capture(self, todo: list, inputs: tuple, pool) -> None:
        global captures
        self.fill(*inputs)  # valid tokens and lineage for the eager chunk
        side = side_stream(self.device)
        if not self.graphs:  # one eager chunk first: kernels loaded, handles made, outside any capture
            w, start, n = todo[0]
            self.set_pos(start)
            on_stream(side, lambda: self.run(w, n))
        for w, start, n in todo:
            if (w, n) in self.graphs:
                continue
            self.set_pos(start)
            self.graphs[(w, n)] = Graph(lambda: self.run(w, n), side, pool)
            captures += 1

    def replay(self, w: int, n: int) -> None:
        global replays, replayed_steps
        self.graphs[(w, n)].replay()
        replays += 1
        replayed_steps += n


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
        sg.prepare(max_len, inputs, cache.pool())
        steps = run_chunks(max_len, sg.cache_len, lambda: finished(sg.st), sg.replay)
        return answer(sg.st), steps
