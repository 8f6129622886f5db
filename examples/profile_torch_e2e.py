#!/usr/bin/env python3
"""Where the time of the PyTorch port's beam-3 path goes, on one CUDA card.

    python3 examples/profile_torch_e2e.py [--max-len 64] [--trace trace.json]
    KHMER_OCR_MEGA_DECODE=1 python3 examples/profile_torch_e2e.py   # batches of 1-4 chunks through K3
    python3 examples/profile_torch_e2e.py --train                   # the train step instead

Runs chip_smoke.py's end-to-end workload (flagship widths, seeded weights,
the 18 synthetic lines of khmer_ocr_torch/assets/smoke_golden.json, batch 8,
beam 3) through ``khmer_ocr_torch``'s Predictor and prints:

  * per bucket batch, on the host clock with a device sync at each edge:
    encode ms (transfer, windows, backbone, encoder, BiLSTM) and decode ms;
  * for one whole request under torch.profiler: the device's busy time (the
    union of kernel and memcpy intervals), its idle share against the
    request's unprofiled wall time, device launches per decode step (the
    decode's CUDA graph replays launch them: decode/graphs.py), and device
    time by kernel family (K1, K2, K3, convolution, matmul, other).

With ``--train``, the train step at the flagship widths (seeded weights,
dropout 0.1, device augmentation p 0.8, Adam) on batches of 32 synthetic
lines of the (4-chunk, 64-label) and (16-chunk, 256-label) buckets: steps/s
and lines/s over timed steps on the host clock, peak device memory, and for
three steps under torch.profiler the device's busy time, idle share and
device time by kernel family (K1, K1b, convolution, matmul, ...).

Exits 2 without a CUDA card, 1 if the profiler recorded no device activity.
The last line is one JSON object with the numbers.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

FAMILIES = (  # first match wins
    ("K1 lstm_recurrence", ("lstm_recurrence_kernel", "lstm_cluster_kernel")),
    ("K1b lstm_adjoint", ("lstm_backward_kernel", "lstm_backward_cluster_kernel")),
    ("K2 decoder_layer_step", ("decoder_layer_step_kernel",)),
    ("K3 fused_beam_decode", ("fused_beam_decode_kernel",)),
    ("convolution", ("conv", "cudnn", "implicit_gemm", "xmma_fprop", "winograd")),
    ("matmul", ("gemm", "cutlass", "cublas")),
    ("memcpy/memset", ("memcpy", "memset")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def device_profile(fn, trace: Path | None):
    """Run ``fn`` under torch.profiler: (device busy ms, {family: ms,
    launches}, kernels), or None when no device activity was recorded."""
    from khmer_ocr_torch.profiling import busy_ms, device_events

    dev, _ = device_events(fn, trace)
    if not dev:
        return None
    by_family: dict[str, dict] = {}
    for e in dev:
        f = by_family.setdefault(family(e["name"]), {"ms": 0.0, "launches": 0})
        f["ms"] += float(e["dur"]) / 1e3
        f["launches"] += 1
    return busy_ms(dev), by_family, sum(1 for e in dev if e.get("cat") == "kernel")


def train_profile(torch, smi: str, trace: Path | None) -> int:
    import numpy as np

    from khmer_ocr_torch.config import ModelConfig
    from khmer_ocr_torch.data.synthetic import synthetic_samples
    from khmer_ocr_torch.infer.predictor import set_parity_mode
    from khmer_ocr_torch.ops.kernels import build
    from khmer_ocr_torch.train.data import LineDataset
    from khmer_ocr_torch.train.step import batch_to_device, init_train_state, make_train_step

    build.build(["lstm_recurrence", "lstm_backward"])
    set_parity_mode()
    cfg, out = ModelConfig(), []
    for chunks, labels in ((4, 64), (16, 256)):
        ds = LineDataset(synthetic_samples([chunks] * 32, chunks), device_augment=True)
        host = next(ds.epoch_batches(32, np.random.default_rng(0), max_label_len=labels)).as_dict()
        batch = batch_to_device(host, "cuda")
        state, step = init_train_state(cfg, 0, "cuda"), make_train_step(cfg, augment_prob=0.8)
        gen = torch.Generator(device="cuda").manual_seed(0)

        def steps(n):
            nonlocal state
            for _ in range(n):
                state, _ = step(state, batch, gen, 1e-4)

        steps(2)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n = 5
        t0 = time.perf_counter()
        steps(n)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / n
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        prof = device_profile(lambda: steps(3), trace)
        if prof is None:
            print("the profiler recorded no device activity: device time not measured", file=sys.stderr)
            return 1
        busy_ms, by_family, n_kernels = prof
        busy_ms /= 3
        row = dict(chunks=chunks, labels=int(batch["labels"].shape[1]), batch=32, step_ms=step_ms,
                   steps_per_s=1e3 / step_ms, lines_per_s=32e3 / step_ms, device_busy_ms_per_step=busy_ms,
                   idle_share=1 - busy_ms / step_ms, kernels_per_step=n_kernels / 3, peak_gib=peak,
                   by_family={k: {"ms": v["ms"] / 3, "launches": v["launches"] / 3} for k, v in by_family.items()})
        out.append(row)
        print(f"[train] batch 32 x {chunks} chunks, {row['labels']} labels: {step_ms:.1f} ms a step unprofiled "
              f"({row['steps_per_s']:.2f} steps/s, {row['lines_per_s']:.1f} lines/s); device busy {busy_ms:.1f} ms a "
              f"step ({row['idle_share']:.1%} idle), {n_kernels / 3:.0f} kernels a step; peak memory {peak:.2f} GiB; "
              f"on {smi}")
        for fam, f in sorted(row["by_family"].items(), key=lambda kv: -kv[1]["ms"]):
            print(f"[train]   {fam:22s} {f['ms']:9.2f} ms device a step, {f['launches']:7.1f} launches")
        del state, batch
    print(json.dumps(dict(device=smi, train=out)))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--trace", type=Path, default=None, help="also keep the Chrome trace here")
    ap.add_argument("--train", action="store_true", help="profile the train step instead of recognition")
    args = ap.parse_args()

    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {smi}")
    if args.train:
        return train_profile(torch, smi, args.trace)
    from khmer_ocr_torch.config import ModelConfig
    from khmer_ocr_torch.convert.from_jax import seeded_params
    from khmer_ocr_torch.data.synthetic import synthetic_lines
    from khmer_ocr_torch.decode.beam import beam_decode
    from khmer_ocr_torch.infer.predictor import Predictor
    from khmer_ocr_torch.models.ocr_model import encode
    from khmer_ocr_torch.ops.kernels import build
    from khmer_ocr_torch.ops.lines import device_chunk, u8_to_unit, unit_normalize

    build.build()
    golden = json.loads((ROOT / "khmer_ocr_torch" / "assets" / "smoke_golden.json").read_text())
    cfg = ModelConfig()
    params, stats = seeded_params(cfg, golden["seed"])
    lines = synthetic_lines(golden["chunk_counts"], seed=golden["lines_seed"])
    pred = Predictor(params=params, batch_stats=stats, device="cuda")
    bw, bs, max_len = golden["beam_width"], golden["batch_size"], args.max_len
    batches = list(pred.preprocessor.iter_batches(lines, max_batch=bs))
    dec_cfg = pred._dec_cfg(bw, max_len)

    # per-batch split on the host clock (second pass; the first warms up)
    rows = []
    with torch.inference_mode():
        for rep in range(2):
            for batch in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                u8, counts, b = pred._to_device_batch(batch)
                memory, pad = encode(pred.params, device_chunk(unit_normalize(u8_to_unit(u8)), pred._chunk_geom),
                                     counts, cfg)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                st: dict = {}
                beam_decode(pred.params, memory, pad, cfg, dec_cfg, stats=st, graph_cache=pred.graph_cache)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                if rep:
                    rows.append(dict(bucket=batch.bucket_n, lines=b, batch=int(u8.shape[0]), steps=st["steps"],
                                     encode_ms=(t1 - t0) * 1e3, decode_ms=(t2 - t1) * 1e3,
                                     decode_ms_per_step=(t2 - t1) * 1e3 / max(st["steps"], 1)))
    for r in rows:
        print(f"[split] bucket {r['bucket']:3d} ({r['lines']} lines, batch {r['batch']}): encode "
              f"{r['encode_ms']:.2f} ms, decode {r['decode_ms']:.2f} ms over {r['steps']} steps "
              f"({r['decode_ms_per_step']:.3f} ms/step)")

    # one whole request: unprofiled wall time after a warm-up (the Predictor's precision scope is another
    # decode shape for the CUDA graphs than the calls above), then the profiled trace
    pred.predict_batch_tokens(lines, beam_width=bw, batch_size=bs, max_len=max_len)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred.predict_batch_tokens(lines, beam_width=bw, batch_size=bs, max_len=max_len)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    steps0 = pred.decode_steps
    prof = device_profile(lambda: pred.predict_batch_tokens(lines, beam_width=bw, batch_size=bs,
                                                                   max_len=max_len), args.trace)
    steps = pred.decode_steps - steps0
    if prof is None:
        print("the profiler recorded no device activity: device time not measured", file=sys.stderr)
        return 1
    busy_ms, by_family, n_kernels = prof
    print(f"[request] {len(lines)} lines, beam {bw}, max_len {max_len}: wall {wall_ms:.1f} ms unprofiled; "
          f"device busy {busy_ms:.1f} ms ({1 - busy_ms / wall_ms:.1%} idle); {n_kernels} kernels, "
          f"{n_kernels / max(steps, 1):.1f} per decode step over {steps} steps; on {smi}")
    for fam, f in sorted(by_family.items(), key=lambda kv: -kv[1]["ms"]):
        print(f"[request] {fam:22s} {f['ms']:9.2f} ms device, {f['launches']:6d} launches")
    print(json.dumps(dict(device=smi, max_len=max_len, wall_ms=wall_ms, device_busy_ms=busy_ms,
                          idle_share=1 - busy_ms / wall_ms, kernels=n_kernels, steps=steps,
                          by_family=by_family, split=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
