#!/usr/bin/env python3
"""Where the time of the PyTorch port's beam-3 path goes, on one CUDA card.

    python3 examples/profile_torch_e2e.py [--max-len 64] [--trace trace.json]

Runs chip_smoke.py's end-to-end workload (flagship widths, seeded weights,
the 18 synthetic lines of khmer_ocr_torch/assets/smoke_golden.json, batch 8,
beam 3) through ``khmer_ocr_torch``'s Predictor and prints:

  * per bucket batch, on the host clock with a device sync at each edge:
    encode ms (transfer, windows, backbone, encoder, BiLSTM) and decode ms;
  * for one whole request under torch.profiler: the device's busy time (the
    union of kernel and memcpy intervals), its idle share against the
    request's unprofiled wall time, device launches per decode step, and
    device time by kernel family (K1, K2, convolution, matmul, other).

Exits 2 without a CUDA card, 1 if the profiler recorded no device activity.
The last line is one JSON object with the numbers.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

FAMILIES = (  # first match wins
    ("K1 lstm_recurrence", ("lstm_recurrence_kernel",)),
    ("K2 decoder_layer_step", ("decoder_layer_step_kernel",)),
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


def union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if stop <= end:
            continue
        total += stop - max(start, end)
        end = stop
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--trace", type=Path, default=None, help="also keep the Chrome trace here")
    args = ap.parse_args()

    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {smi}")
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
                beam_decode(pred.params, memory, pad, cfg, dec_cfg, stats=st)
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

    # one whole request: unprofiled wall time, then the profiled trace
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred.predict_batch_tokens(lines, beam_width=bw, batch_size=bs, max_len=max_len)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    steps0 = pred.decode_steps
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        pred.predict_batch_tokens(lines, beam_width=bw, batch_size=bs, max_len=max_len)
        torch.cuda.synchronize()
    steps = pred.decode_steps - steps0
    with tempfile.TemporaryDirectory() as tmp:
        path = args.trace or Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(Path(path).read_text())["traceEvents"]
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    if not dev:
        print("the profiler recorded no device activity: device time not measured", file=sys.stderr)
        return 1
    busy_ms = union_us((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev) / 1e3
    by_family: dict[str, dict] = {}
    for e in dev:
        f = by_family.setdefault(family(e["name"]), {"ms": 0.0, "launches": 0})
        f["ms"] += float(e["dur"]) / 1e3
        f["launches"] += 1
    n_kernels = sum(1 for e in dev if e.get("cat") == "kernel")
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
