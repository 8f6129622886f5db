"""End-to-end recognition: uint8 lines -> device -> encode + decode -> text.

Each chunk-bucket batch is padded to its batch bucket (repeating its last
line), shipped to the device as uint8 through pinned memory, normalised and
cut into windows there, encoded, and decoded with beam search (beam_width >
1) or greedy decoding. On the card the BiLSTM recurrence runs kernel K1 and
every decoder layer step runs kernel K2, the steps as captured CUDA graphs
replayed per cache window (decode/graphs.py; ``warmup`` captures those of
the shapes it warms); with ``KHMER_OCR_MEGA_DECODE=1`` (read at each call)
a beam batch inside kernel K3's envelope decodes in one launch of K3
instead.

The device is the caller's choice: ``device=None`` means the CUDA card, and
without one the constructor raises; ``device="cpu"`` runs the plain PyTorch
versions of the kernels (what the tests do).

Data-parallel serving (``process_group``; parallel/mesh.py), the counterpart
of the JAX package's ``Predictor(mesh=)``: every rank holds the weights,
pads each bucket batch to a multiple of the world size, decodes its rows and
gathers every rank's tokens, so each rank returns all the strings.

``infer_batch`` is the device part of one bucket batch, the counterpart of
the JAX package's ``_infer_jit``: ``encode_batch`` then ``decode_batch``;
under a tensor-parallel ``model_group`` it runs on one rank's part of the
params (parallel/mesh.py). ``decode_prepared`` runs it for one batch and
reads the tokens back.

``predict_batch`` keeps batches in flight, as the JAX package's does with
its asynchronous dispatch. A dispatch thread consumes
``Preprocessor.iter_batches``, pads each batch, ships it and launches its
encode on a CUDA stream of its own, and queues it with an event. The
caller's thread decodes the batches in order on its current stream, which
first waits on that event (on the card, not the host), gathers the rows
under a ``process_group``, and starts a copy of the tokens into pinned host
memory. The drain reads a batch's rows back once its copy is done: the
oldest, when the dispatch stage waits for a slot or the next batch is not
ready. So preparation, transfer and encode of later batches overlap the
decode of earlier ones. At most 2 x ``RuntimeConfig.max_inflight_batches``
batches are dispatched and not yet drained (the dispatch stage waits for
a slot); ``Predictor.max_batches_in_flight`` is the high-water mark of the
last call. The JAX package dispatches groups of ``max_inflight_batches``
batches; the port forms no groups and dispatches each batch once it is
prepared. An exception in either stage is raised in the caller once the
dispatch thread has ended. Under a torch.profiler session each stage is a
span (profiling.py::span): on the caller's thread ``khmer_ocr.predict``
around the call, ``khmer_ocr.wait_dispatch``, ``khmer_ocr.decode``,
``khmer_ocr.drain`` and ``khmer_ocr.join``, which do not overlap; on the
dispatch thread ``khmer_ocr.prepare``, ``khmer_ocr.wait_slot`` and
``khmer_ocr.dispatch``, and inside the last ``khmer_ocr.encode.eager``
around the encode of a batch too large for a graph
(``Predictor.eager_encodes`` counts those batches).

The serving speed mode: ``RuntimeConfig.compute_dtype="bfloat16"`` casts the
params to bfloat16 (the BatchNorm statistics stay float32), so activations,
caches and memory follow, and K2 and K3 run on bfloat16 storage;
``matmul_precision`` other than "highest" lets the float32 work that remains
use TF32. The precision holds for each call only (``decode_prepared`` runs
under ``precision.matmul_precision``): torch's switches are as the call
found them once it returns.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
from collections import deque
from pathlib import Path

import numpy as np
import torch

from ..config import DecodeConfig, ModelConfig, OCRConfig
from ..convert.from_jax import load_npz, params_from_jax, params_to_jax
from ..cuda_graphs import GraphCache, capture_lock
from ..decode.beam import beam_decode
from ..decode.greedy import greedy_decode
from ..models.ocr_model import encode
from ..ops.lines import device_chunk, u8_to_unit, unit_normalize
from ..parallel.mesh import data_shard, gather_rows, world_of
from ..precision import check_nesting, check_precision, matmul_precision
from ..profiling import span
from ..preprocess import PreparedBatch, Preprocessor
from ..tokenizer import Tokenizer
from . import encode_graph


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card, raising when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def set_parity_mode() -> None:
    """Full float32 matmuls and convolutions (no TF32), the reference's
    parity mode (float32, "highest"), for the whole process."""
    set_matmul_precision("highest")


def set_matmul_precision(precision: str) -> None:
    """The JAX package's ``matmul_precision`` on torch's switches, for the
    whole process and until changed: "highest" keeps float32 matmuls and
    convolutions in full float32 (TF32 off); "high" and "default" let both
    use TF32. For scripts and tests that compute outside the entry points;
    the entry points scope theirs to each call (``precision.matmul_precision``)."""
    check_precision(precision)
    tf32 = precision != "highest"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("highest" if not tf32 else "high")


def cast_params(params, dtype):
    """The params in ``dtype``, but for the BatchNorm statistics ("mean",
    "var"), which stay float32 (the JAX package casts only its params
    tree, not its batch_stats)."""
    if isinstance(params, dict):
        return {k: v if k in ("mean", "var") else cast_params(v, dtype) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [cast_params(v, dtype) for v in params]
    return params.to(dtype) if params.is_floating_point() else params


def encode_batch(params: dict, lines: torch.Tensor, counts: torch.Tensor, model_cfg: ModelConfig,
                 chunk_geom: tuple[int, int], model_group=None):
    """The encode half of ``infer_batch``: uint8 lines (B, H, Wb) and chunk
    counts (B,) -> (memory (B, T, D), pad mask (B, T)), normalised, cut into
    windows and encoded in the params' dtype."""
    # the compute dtype follows the params (their patch projection's)
    chunks = device_chunk(unit_normalize(u8_to_unit(lines)), chunk_geom).to(params["patch"]["proj"]["w"].dtype)
    return encode(params, chunks, counts, model_cfg, model_group=model_group)


def decode_batch(params: dict, memory, pad_mask, model_cfg: ModelConfig, dec_cfg: DecodeConfig, model_group=None,
                 stats: dict | None = None, eager: bool = False, graph_cache=None):
    """The decode half of ``infer_batch``: beam search when
    ``dec_cfg.beam_width`` > 1, else greedy decoding -> tokens."""
    decode = beam_decode if dec_cfg.beam_width > 1 else greedy_decode
    return decode(params, memory, pad_mask, model_cfg, dec_cfg, stats=stats, model_group=model_group, eager=eager,
                  graph_cache=graph_cache)


@torch.inference_mode()
def infer_batch(params: dict, lines: torch.Tensor, counts: torch.Tensor, model_cfg: ModelConfig,
                dec_cfg: DecodeConfig, chunk_geom: tuple[int, int], model_group=None, stats: dict | None = None,
                eager: bool = False, graph_cache=None, encoded: tuple | None = None):
    """One bucket batch on the params' device: uint8 lines (B, H, Wb) and
    chunk counts (B,) -> tokens (B, steps + 1 or + 2), normalised, cut into
    windows, encoded and decoded (beam when ``dec_cfg.beam_width`` > 1) in
    the params' dtype. ``model_group``: a tensor-parallel group, with
    ``params`` this rank's part. ``stats`` receives the decode's counts.
    ``eager``: the decode's Python step loop on the card too, in place of
    its CUDA graphs (the graphs' oracle); ``graph_cache``: where the graphs
    are kept (cuda_graphs.GraphCache; None: for this call alone).
    ``encoded``: these lines' (memory, pad mask) from ``encode_batch``,
    where the caller encoded them already (``predict_batch``'s dispatch
    stage); only the decode runs then."""
    stats = {} if stats is None else stats
    if encoded is None:
        encoded = encode_batch(params, lines, counts, model_cfg, chunk_geom, model_group)
    return decode_batch(params, *encoded, model_cfg, dec_cfg, model_group, stats, eager, graph_cache)


_DISPATCH_STREAMS: dict = {}


def dispatch_stream(device: torch.device):
    """The dispatch stage's stream on ``device``, where transfers and
    encodes run beside the decodes: one for the process, since torch keeps
    the cuBLAS workspace it makes for a stream (32 MiB on an H100) until
    the process ends."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _DISPATCH_STREAMS:
        _DISPATCH_STREAMS[idx] = torch.cuda.Stream(idx)
    return _DISPATCH_STREAMS[idx]


_DONE = object()  # the dispatch stage's last item when it ran to the end
POLL_S = 0.05  # how often the dispatch stage, waiting for a slot, looks whether the call has stopped


class InFlight:
    """The two stages' shared state in one ``predict_batch`` call: the queue
    of dispatched batches, a slot for each of at most ``bound`` batches
    dispatched and not yet drained, their count and its high-water mark,
    and the stop event that ends the dispatch stage."""

    def __init__(self, bound: int):
        self.bound = bound
        self.ready: queue.Queue = queue.Queue()  # never more than ``bound`` batches and the last item: slots bound it
        self.stop = threading.Event()
        self._slots = threading.Semaphore(bound)
        self._lock = threading.Lock()
        self.now = self.high = 0

    def take_slot(self) -> bool:
        """Wait for a slot; False once the call has stopped."""
        while not self._slots.acquire(timeout=POLL_S):
            if self.stop.is_set():
                return False
        with self._lock:
            self.now += 1
            self.high = max(self.high, self.now)
        return not self.stop.is_set()

    def release(self) -> None:
        with self._lock:
            self.now -= 1
        self._slots.release()

    def full(self) -> bool:
        return self.now >= self.bound


def load_weights(model_path: str | Path, vocab_size: int | None = None):
    """Weights of any kind the port reads -> (params, batch_stats, ModelConfig
    or None) in the JAX package's layout, by the path's kind:

      * ``.pth``/``.pt``/``.safetensors``: a reference checkpoint
        (convert/torch_loader.py; ``vocab_size`` where the file has no
        token embedding);
      * ``.npz``: written by ``convert.from_jax.save_npz``;
      * a directory with ``state.pt``: a checkpoint of the port's trainer
        (train/checkpoint.py);
      * a directory with ``index.json``: a weights index into an Orbax
        checkpoint (convert/orbax_index.py).

    A directory that holds an Orbax ``state/`` and no index raises: its
    b-tree is read by tensorstore, which the port does not use."""
    path = Path(model_path)
    if path.suffix in (".pth", ".pt", ".safetensors"):
        from ..convert.torch_loader import load_and_convert

        return load_and_convert(path, vocab_size=vocab_size)
    if path.suffix == ".npz":
        return load_npz(path)
    if path.is_dir():
        if (path / "state.pt").exists():
            from ..train.checkpoint import load_checkpoint

            params, batch_stats, cfg = load_checkpoint(path)
            return (*params_to_jax(params, batch_stats, cfg), cfg)
        if (path / "index.json").exists():
            from ..convert.orbax_index import load_index

            return load_index(path)
        if (path / "state").is_dir():
            raise RuntimeError(f"{path} is an Orbax checkpoint (OCDBT, read through tensorstore), which the port "
                               "does not read: load it through a weights index (convert/orbax_index.py) or convert "
                               "it to an .npz with convert.from_jax.save_npz")
        raise FileNotFoundError(f"{path} holds no weights the port reads (state.pt or index.json)")
    if not path.exists():
        raise FileNotFoundError(f"Model not found at {path}")
    raise ValueError(f"{path}: unknown weights format (.pth, .pt, .safetensors, .npz or a checkpoint directory)")


def _round_up(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return n


class Predictor:
    """Holds the weights on one device and decodes batches of line images.

    Weights: ``params``/``batch_stats`` in the JAX package's layout (nested
    dicts of numpy arrays), or ``model_path`` to any kind that
    ``load_weights`` reads. ``process_group``: serve data-parallel over the
    group, this rank on ``device``; every rank must call with the same
    lines. ``config.runtime.compute_dtype`` and ``matmul_precision`` pick
    parity or speed mode (module docstring). The decode's CUDA graphs are
    kept in ``graph_cache`` (a cuda_graphs.GraphCache), freed with the
    Predictor; ``graph_cache_bytes`` bounds the bytes of their buffers
    (None: ``cuda_graphs.CACHE_SHARE`` of the card's memory). ``eager_decode``:
    decode with the Python step loop on the card too, not its CUDA graphs
    (the graphs' oracle; no serving path sets it). ``predict_batch``'s
    dispatch stage replays the encode of each shape of at most
    ``encode_graph.MAX_CHUNKS`` chunks as a CUDA graph (infer/encode_graph.py),
    kept in ``encode_cache``, a second cache of that budget."""

    def __init__(self, params=None, batch_stats=None, model_cfg: ModelConfig | None = None, device=None,
                 config: OCRConfig | None = None, vocab_path: str | Path | None = None,
                 model_path: str | Path | None = None, process_group=None, eager_decode: bool = False,
                 graph_cache_bytes: int | None = None):
        self.device = resolve_device(device)
        self.group = process_group
        self._rank, self._world = world_of(process_group)
        self.config = config or OCRConfig()
        rt = self.config.runtime
        if rt.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {rt.compute_dtype!r}: float32 or bfloat16")
        check_precision(rt.matmul_precision)
        self.tokenizer = Tokenizer(vocab_path)
        if model_path is not None:
            params, batch_stats, saved_cfg = load_weights(model_path, vocab_size=len(self.tokenizer))
            model_cfg = model_cfg or saved_cfg
        if params is None:
            raise ValueError("Provide params/batch_stats or model_path")
        self.model_cfg = model_cfg or self.config.model
        self.params = params_from_jax(params, batch_stats if batch_stats is not None else {}, self.model_cfg,
                                      device=self.device)
        if rt.compute_dtype == "bfloat16":
            self.params = cast_params(self.params, torch.bfloat16)
        self.preprocessor = Preprocessor(self.config.preprocess, self.config.runtime)
        pre = self.config.preprocess
        self._chunk_geom = (pre.chunk_width, pre.chunk_stride)
        self.eager_decode = eager_decode
        self.graph_cache = GraphCache(graph_cache_bytes)
        self.encode_cache = GraphCache(graph_cache_bytes)
        self.decode_steps = 0  # decode steps run since construction (all batches; graph replays or the Python loop)
        self.mega_batches = 0  # beam batches decoded by the whole-decode path (one K3 launch each)
        self.head_batches = 0  # beam batches whose decode head ran inside K2's last launch
        # bucket batches of more than encode_graph.MAX_CHUNKS rows x chunks: too large for an encode graph, so the
        # dispatch stage encodes them eagerly (on the CPU every encode is eager; these are counted alone)
        self.eager_encodes = 0
        self.max_batches_in_flight = 0  # in the last predict_batch call, the most batches dispatched and not drained
        self._encode_stream = dispatch_stream(self.device) if self.device.type == "cuda" else None

    def _dec_cfg(self, beam_width: int, max_len: int | None) -> DecodeConfig:
        cap = self.model_cfg.decode_max_len
        return DecodeConfig(
            beam_width=max(beam_width, 1),
            max_len=min(max_len or cap, cap),
            sos_idx=self.tokenizer.sos_idx,
            eos_idx=self.tokenizer.eos_idx,
            pad_idx=self.tokenizer.pad_idx,
            mega_mode=os.environ.get("KHMER_OCR_MEGA_DECODE"),  # snapshots per call
            head_mode=os.environ.get("KHMER_OCR_FUSED_HEAD"),
        )

    def _to_device_batch(self, batch: PreparedBatch):
        """The batch padded to its batch bucket (repeating its last line),
        this rank's rows of it on the device, and the true batch size."""
        b = batch.lines.shape[0]
        padded_b = _round_up(b, self.config.runtime.batch_buckets)
        lines, counts = batch.lines, batch.chunk_counts
        if padded_b != b:
            reps = padded_b - b
            lines = np.concatenate([lines, np.repeat(lines[-1:], reps, axis=0)])
            counts = np.concatenate([counts, np.repeat(counts[-1:], reps, axis=0)])
        if self._world > 1:
            shard = data_shard({"lines": lines, "counts": counts}, self._rank, self._world)
            lines, counts = shard["lines"], shard["counts"]
        lines_t, counts_t = torch.from_numpy(np.ascontiguousarray(lines)), torch.from_numpy(counts)
        if self.device.type == "cuda":
            lines_t = lines_t.pin_memory().to(self.device, non_blocking=True)
            counts_t = counts_t.pin_memory().to(self.device, non_blocking=True)
        return lines_t, counts_t, b

    def _add_stats(self, stats: dict) -> None:
        self.decode_steps += stats["steps"]
        self.mega_batches += stats.get("mega", 0)
        self.head_batches += stats.get("head", 0)

    @torch.inference_mode()
    def decode_prepared(self, batch: PreparedBatch, beam_width: int, max_len: int | None = None) -> np.ndarray:
        """One bucket batch -> tokens (B, steps + 1 or + 2) on the host, under
        the configured matmul precision, nothing in flight."""
        dec_cfg = self._dec_cfg(beam_width, max_len)
        lines, counts, b = self._to_device_batch(batch)
        stats: dict = {}
        with matmul_precision(self.config.runtime.matmul_precision):
            tokens = infer_batch(self.params, lines, counts, self.model_cfg, dec_cfg, self._chunk_geom, stats=stats,
                                 eager=self.eager_decode, graph_cache=self.graph_cache)
        if self._world > 1:
            tokens = gather_rows(tokens, self.group)
        self._add_stats(stats)
        return tokens[:b].cpu().numpy()

    def _dispatch(self, batch: PreparedBatch) -> tuple:
        """One batch through the dispatch stage, on the thread's current
        stream: padded, shipped and encoded (on the card by its shape's CUDA
        graph) -> (batch, true size, lines, counts, memory, pad mask, the
        event after its encode or None on the CPU). ``cuda_graphs.capture_lock``
        is held throughout, so that none of these launches lands inside a
        capture of the decode's, nor one of the decode's in an encode's
        capture."""
        with span("khmer_ocr.dispatch"), matmul_precision(self.config.runtime.matmul_precision), capture_lock:
            lines, counts, b = self._to_device_batch(batch)
            encode = lambda l, c: encode_batch(self.params, l, c, self.model_cfg, self._chunk_geom)  # noqa: E731
            if lines.shape[0] * batch.bucket_n > encode_graph.MAX_CHUNKS:  # too large to capture
                self.eager_encodes += 1
                with span("khmer_ocr.encode.eager"):
                    memory, pad = encode(lines, counts)
            elif self._encode_stream is None:
                memory, pad = encode(lines, counts)
            else:
                memory, pad = encode_graph.encode_graphed(self.encode_cache, self.params, encode, lines, counts)
        event = None
        if self._encode_stream is not None:
            event = torch.cuda.Event()
            event.record(self._encode_stream)
        return batch, b, lines, counts, memory, pad, event

    def _dispatch_stage(self, image_list: list, batch_size: int, flight: InFlight) -> None:
        """The dispatch thread: every bucket batch of ``image_list``
        dispatched in turn, each once it has a slot; then ``_DONE``, or the
        exception that ended it, for the caller to raise."""
        last = _DONE
        try:
            on_stream = torch.cuda.stream(self._encode_stream) if self._encode_stream is not None \
                else contextlib.nullcontext()
            with contextlib.closing(self.preprocessor.iter_batches(image_list, max_batch=batch_size)) as batches, \
                    torch.inference_mode(), on_stream:
                while True:
                    with span("khmer_ocr.prepare"):
                        batch = next(batches, None)
                    if batch is None:
                        break
                    with span("khmer_ocr.wait_slot"):
                        if not flight.take_slot():
                            break
                    flight.ready.put(self._dispatch(batch))
        except BaseException as e:  # raised again in the caller
            last = e
        finally:
            flight.ready.put(last)

    def _decode_dispatched(self, item: tuple, dec_cfg: DecodeConfig) -> tuple:
        """One dispatched batch decoded on the current stream, after its
        encode's event, and the copy of its tokens to the host started ->
        (batch, tokens, the event after the copy or None, the item, held
        until the batch drains, since the decode reads its memory)."""
        batch, b, lines, counts, memory, pad, event = item
        with span("khmer_ocr.decode"):
            if event is not None:
                torch.cuda.current_stream(self.device).wait_event(event)
            stats: dict = {}
            with matmul_precision(self.config.runtime.matmul_precision):
                tokens = infer_batch(self.params, lines, counts, self.model_cfg, dec_cfg, self._chunk_geom,
                                     stats=stats, eager=self.eager_decode, graph_cache=self.graph_cache,
                                     encoded=(memory, pad))
            if self._world > 1:
                tokens = gather_rows(tokens, self.group)
            self._add_stats(stats)
            tokens, done = tokens[:b], None
            if tokens.is_cuda:
                host = torch.empty(tokens.shape, dtype=tokens.dtype, pin_memory=True)
                host.copy_(tokens, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
                tokens = host
        return batch, tokens, done, item

    @staticmethod
    def _drain(entry: tuple, results: list, flight: InFlight) -> None:
        batch, tokens, done, _ = entry
        with span("khmer_ocr.drain"):
            if done is not None:
                done.synchronize()
            for idx, row in zip(batch.indices, tokens.numpy().copy()):
                results[idx] = row
        flight.release()

    def predict_batch_tokens(self, image_list: list, beam_width: int = 1, batch_size: int = 8,
                             max_len: int | None = None) -> list[np.ndarray]:
        """Token rows (with <sos>, <eos> and trailing <pad>) in input order,
        through the in-flight pipeline (module docstring)."""
        with span("khmer_ocr.predict"):
            rt = self.config.runtime
            check_nesting(rt.matmul_precision)  # the dispatch thread's scope would wait for this thread's other one
            dec_cfg = self._dec_cfg(beam_width, max_len)
            flight = InFlight(2 * max(1, rt.max_inflight_batches))
            results: list = [None] * len(image_list)
            decoded: deque = deque()
            worker = threading.Thread(target=self._dispatch_stage, args=(image_list, batch_size, flight),
                                      name="khmer-ocr-dispatch", daemon=True)
            worker.start()
            try:
                with torch.inference_mode():
                    while True:
                        # drain the oldest when the dispatch stage waits for a slot or nothing else is ready
                        if decoded and (flight.full() or flight.ready.empty()):
                            self._drain(decoded.popleft(), results, flight)
                            continue
                        with span("khmer_ocr.wait_dispatch"):
                            item = flight.ready.get()
                        if item is _DONE:
                            break
                        if isinstance(item, BaseException):
                            raise item
                        decoded.append(self._decode_dispatched(item, dec_cfg))
                    while decoded:
                        self._drain(decoded.popleft(), results, flight)
            finally:
                flight.stop.set()
                with span("khmer_ocr.join"):
                    worker.join()
                self.max_batches_in_flight = flight.high
            return results

    def predict_batch(self, image_list: list, beam_width: int = 1, batch_size: int = 8,
                      max_len: int | None = None) -> list[str]:
        if not image_list:
            return []
        rows = self.predict_batch_tokens(image_list, beam_width, batch_size, max_len)
        return [self.tokenizer.decode(r) for r in rows]

    def predict(self, image_input, beam_width: int = 3, max_len: int | None = None) -> str:
        return self.predict_batch([image_input], beam_width=beam_width, max_len=max_len)[0]

    def warmup(self, beam_widths=(1, 3), batch_size: int | None = None,
               chunk_buckets: tuple[int, ...] | None = None, max_len: int | None = None) -> None:
        """Run the serving shapes once before the first request: ``batch_size``
        white lines (default: the largest batch bucket) of each chunk bucket
        (default: the first four, lines up to about 8 chunks) through
        ``predict_batch`` at each beam width and ``max_len`` (default: the
        cap). On the card this builds the kernels on a cold ``_build/`` and
        loads them, lets cuDNN pick its algorithms for those shapes, and
        captures the decode's CUDA graphs of each shape, every cache window
        included (decode/graphs.py), as the JAX package's warmup compiles
        its programs. One pass is enough: the port forms no batch groups,
        where the JAX package runs each workload twice so its group
        programs compile."""
        rt = self.config.runtime
        bsz = batch_size or max(rt.batch_buckets)
        buckets = chunk_buckets or rt.chunk_buckets[:4]
        cw, stride = self._chunk_geom
        h = self.config.preprocess.img_height
        imgs = []
        for nb in buckets:
            imgs += [np.full((h, (nb - 1) * stride + cw), 255, np.uint8)] * bsz
        for bw in beam_widths:
            self.predict_batch(imgs, beam_width=bw, batch_size=bsz, max_len=max_len)
