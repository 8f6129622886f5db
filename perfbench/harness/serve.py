"""A serving cell: the Predictor of ``khmer_ocr_torch`` under a closed loop.

Set-up builds the Predictor with the configuration's weights, warms the
shapes the cell's traffic uses (white lines of every chunk bucket its lines
fall in, at every batch bucket up to the cell's batch size) and sends one
request of the traffic that the window does not count. The window sends the mix's
requests one after the other through ``Predictor.predict_batch_tokens``
(the pipeline of ``predict_batch``) and decodes each row to its string, as
``predict_batch`` does, until ``seconds`` have passed; the request in flight
then completes, and the window ends with it.

The check: a sample of the window's requests drawn from the seed, with the
one that took the most decode steps, judged line by line against the
reference (perfbench/reference/) at float32 with TF32 off, in blocks of
lines (``check.py``).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

from . import check as checks
from .context import Run, Served
from .traffic import RealLines, chunks_of, requests

BATCH_BUCKETS = (1, 8, 32, 128, 256)  # the Predictor's default batch buckets (RuntimeConfig.batch_buckets)


def bucket_of(n: int, buckets) -> int:
    return next((b for b in buckets if n <= b), n)


def traffic_buckets(mix: dict, real: RealLines, chunk_buckets) -> list[int]:
    """The chunk buckets the mix's lines fall in."""
    join = mix["line"].get("join")
    if join:
        lo, hi = join["width_px"]
        counts = range(chunks_of(lo), chunks_of(hi - 1) + 1)
    else:
        counts = {chunks_of(ln.shape[1]) for ln in real.lines}
    return sorted({bucket_of(c, chunk_buckets) for c in counts})


def batch_buckets_upto(batch_size: int) -> list[int]:
    return sorted({bucket_of(n, BATCH_BUCKETS) for n in range(1, batch_size + 1)})


def seeded_weights(spec, config: dict, real: RealLines, seed: int, device):
    """The configuration's seeded weights on ``device`` -> numpy trees
    (params, stats): drawn from the seed (reference/weights.py; the seed the
    configuration states, else the run's), the decoder's cross-attention
    queries scaled, and the BatchNorm statistics calibrated on real lines
    drawn by that seed."""
    import torch

    from ..reference.model import Ref, calibrate_batch_norm, chunk_lines
    from ..reference.weights import seeded, tree_map

    m, w = config["model"], config["weights"]
    seed = w.get("seed", seed)
    params, stats = seeded(m, seed, device, w.get("cross_query_scale", 1.0))
    if w.get("calibrate_batch_norm"):
        rng = np.random.default_rng([seed, 6])
        lines = [real.lines[int(i)] for i in rng.integers(len(real.lines), size=w["calibrate_batch_norm"])]
        chunks, _ = chunk_lines(lines, device)
        with torch.no_grad():
            calibrate_batch_norm(Ref(params, stats, m), chunks.reshape(-1, 48, 100))
    return tree_map(lambda t: t.cpu().numpy().copy(), params), tree_map(lambda t: t.cpu().numpy().copy(), stats)


def model_config(m: dict):
    """The program's ModelConfig of the configuration's "model" dict."""
    from khmer_ocr_torch.config import ModelConfig

    mcfg = ModelConfig(**{k: m[k] for k in ("backbone", "vocab_size", "pad_idx", "emb_dim", "num_heads",
                                            "enc_layers", "dec_layers", "enc_ffn_dim", "dropout",
                                            "max_global_len", "decode_max_len", "patch_max", "use_bilstm")})
    if mcfg.dec_ffn_dim != m["dec_ffn_dim"]:
        raise ValueError(f"the program's decoder FFN is {mcfg.dec_ffn_dim}, "
                         f"the configuration states {m['dec_ffn_dim']}")
    return mcfg


def build_predictor(spec, config: dict, serve: dict, seed: int, device, real: RealLines):
    """-> (Predictor, the weights' trees for the reference as numpy, or None
    where the reference reads them itself)."""
    from khmer_ocr_torch.config import OCRConfig, RuntimeConfig
    from khmer_ocr_torch.infer.predictor import Predictor

    mcfg = model_config(config["model"])
    rt = RuntimeConfig(compute_dtype=serve["compute_dtype"], matmul_precision=serve["matmul_precision"],
                       host_workers=serve["host_workers"])
    cfg = OCRConfig(model=mcfg, runtime=rt)
    w = config["weights"]
    if w["kind"] == "checkpoint":
        return Predictor(model_path=spec.root / w["program_path"], model_cfg=mcfg, config=cfg, device=device), None
    if w["kind"] == "seeded":
        host = seeded_weights(spec, config, real, seed, device)
        return Predictor(params=host[0], batch_stats=host[1], model_cfg=mcfg, config=cfg, device=device), host
    raise ValueError(f"weights kind {w['kind']!r}")


def counts_now() -> dict:
    from khmer_ocr_torch.decode import graphs
    from khmer_ocr_torch.infer import encode_graph

    return {"decode_captures": graphs.captures, "encode_captures": encode_graph.captures,
            "eager_steps": graphs.eager_steps}


def shape_keys(predictor) -> set:
    """The shapes the Predictor's decode and encode graph caches hold, each
    key cut to the leading items that name its sizes."""
    return {("decode",) + tuple(str(x) for x in k[:4]) for k in predictor.graph_cache.shapes} | \
        {("encode",) + tuple(str(x) for x in k[:1]) for k in predictor.encode_cache.shapes}


def run(spec, cell: dict, config: dict, mix: dict, seed: int, seconds: float, traced: bool, device: str,
        t_process: float, control: str | None = None, log=print):
    """-> (Run, the check's numbers {name: (value, limit)}, attempted, failed, memory peak bytes)."""
    import torch

    from . import trace as tracing

    serve = cell["serve"]
    on_card = device != "cpu"
    real = RealLines(spec.dir / "data")
    predictor, host_weights = build_predictor(spec, config, serve, seed, device, real)
    chunk_buckets = predictor.config.runtime.chunk_buckets
    beam, max_len, bsz = serve["beam_width"], serve["max_len"], serve["batch_size"]
    buckets = traffic_buckets(mix, real, chunk_buckets)
    for b in batch_buckets_upto(bsz):
        # white lines of nb x 84 px: nb windows each (Predictor.warmup's lines of (nb - 1) x 84 + 100 px
        # make nb + 1 windows, and so warm the next bucket)
        white = [np.full((48, nb * 84), 255, np.uint8) for nb in buckets for _ in range(b)]
        predictor.predict_batch_tokens(white, beam, b, max_len)
    stream = requests(mix, real, seed)
    predictor.predict_batch_tokens(next(stream).lines, beam, bsz, max_len)
    if on_card:
        torch.cuda.synchronize()
    before, keys = counts_now(), shape_keys(predictor)
    setup_s = time.time() - t_process
    log(f"set-up {setup_s:.3f} s: warmed batch buckets {batch_buckets_upto(bsz)} x chunk buckets {buckets}, "
        f"{before['decode_captures']} decode and {before['encode_captures']} encode graphs captured")

    window = float(cell.get("trace_seconds", seconds)) if traced else seconds
    done, attempted, failed = [], 0, 0
    with tracing.traced() if traced else contextlib.nullcontext() as h:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < window:
            req = next(stream)
            attempted += 1
            t_sub = time.perf_counter()
            try:
                rows = predictor.predict_batch_tokens(req.lines, beam, bsz, max_len)
                strings = [predictor.tokenizer.decode(r) for r in rows]
            except Exception as e:  # a failed request counts, and the loop goes on
                failed += 1
                log(f"request {req.index} failed: {type(e).__name__}: {e}")
                continue
            done.append((req, rows, strings, time.perf_counter() - t_sub))
        t1 = time.perf_counter()
    window_s = t1 - t0
    after = counts_now()
    counters = {k: after[k] - before[k] for k in after}
    if any(counters.values()):
        log(f"WARNING: the window captured or ran eagerly: {counters}; new shapes "
            f"{sorted(shape_keys(predictor) - keys)}")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    served = []
    for req, rows, _, lat in done:
        steps = [checks.row_steps(r, predictor.tokenizer.eos_idx, max_len) for r in rows]
        served.append(Served(len(req.lines), [chunks_of(w) for w in req.widths], steps, lat))
    result = Run(cell, config, setup_s, window_s if not traced else h.trace.window_s, served,
                 trace=h.trace if traced else None,
                 counters={**counters, "chunk_buckets": list(chunk_buckets), "batch_size": bsz, "lanes": beam})
    if traced:
        log(f"trace read in {h.read_s:.1f} s: {len(h.trace.device)} device intervals")
    tok = predictor.tokenizer
    ids = {"sos": tok.sos_idx, "eos": tok.eos_idx, "pad": tok.pad_idx}
    del predictor
    if on_card:
        torch.cuda.empty_cache()
    numbers = checks.check_serve(spec, cell, config, done, ids, seed, device, host_weights, control, log)
    return result, numbers, attempted, failed, peak
