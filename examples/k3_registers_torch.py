#!/usr/bin/env python3
"""K3 with one CTA's registers per SM against two, on one CUDA card.

    python3 examples/k3_registers_torch.py

Kernel K3 (``csrc/decode_loop.cu``) is compiled with
``__launch_bounds__(NT, 1)``: a CTA may take all of an SM's registers (168 a
thread at 384 threads). This script also builds the same source with
``__launch_bounds__(NT, 2)`` (at most 80 registers a thread, so two CTAs
could share an SM), runs both on the same seeded flagship decoder weights
and random memories (beam 3, Tm=128, max_len 64: 8 images with the self
caches on chip and in global memory, 1 image, 64 images), checks every
image's tokens against the plain version, and times them in turns (one,
two, two, one). It prints each build's registers and spills, the clusters
the card holds at once, one line per case (with how many images equal the
plain version; chip_smoke.py's [K3] phase is the check of record) and a
last line of JSON. The choice of one CTA per SM in ``csrc/decode_loop.cu``
comes from this script.
Exits 2 without a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ONE, TWO = "__launch_bounds__(NT, 1) fused_beam_decode_kernel", "__launch_bounds__(NT, 2) fused_beam_decode_kernel"


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    from khmer_ocr_torch.config import DecodeConfig, ModelConfig
    from khmer_ocr_torch.convert.from_jax import params_from_jax, seeded_params
    from khmer_ocr_torch.infer.predictor import set_parity_mode
    from khmer_ocr_torch.ops.kernels import build, geometry
    from khmer_ocr_torch.ops.kernels import decode_loop as K

    set_parity_mode()
    # the checked-in source, and a copy of csrc/ with two CTAs' registers, built side by side
    build.build(["decode_loop"])
    two_dir = build.BUILD_DIR / "k3_two_ctas_per_sm"
    two_dir.mkdir(parents=True, exist_ok=True)
    for f in build.source_files("decode_loop"):
        text = f.read_text()
        if f.name == build.SOURCES["decode_loop"]:
            if ONE not in text:
                raise RuntimeError(f"{f} has no '{ONE}'")
            text = text.replace(ONE, TWO)
        (two_dir / f.name).write_text(text)
    two_so = two_dir / "decode_loop.so"
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(two_so), str(two_dir / "decode_loop.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    libs = {1: build.load("decode_loop"), 2: ctypes.CDLL(str(two_so))}
    logs = {1: build.BUILD_LOGS.get("decode_loop", ""), 2: proc.stdout + proc.stderr}
    for n, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {n} CTA(s) an SM: {line.strip()}")

    cfg = ModelConfig()
    params = params_from_jax(*seeded_params(cfg, 0), cfg, device="cuda")
    d, heads, f = cfg.emb_dim, cfg.num_heads, cfg.dec_ffn_dim
    vp = geometry.k3_vocab_cols(cfg.vocab_size, heads)
    resident = {}
    for n, lib in libs.items():
        build._LIBS["decode_loop"] = lib  # the wrapper's library for this build
        resident[n] = {r: K.resident_clusters(3, d, heads, f, 64, vp, cfg.dec_layers, r, 128) for r in (True, False)}
        print(f"[K3 registers] {n} CTA(s) an SM: the card holds {resident[n][True]} clusters at once with the self "
              f"caches on chip, {resident[n][False]} with them in global memory")

    gen = torch.Generator(device="cuda").manual_seed(3)
    dec = DecodeConfig(beam_width=3, max_len=64)
    rows = []
    for n_img, on_chip in ((8, True), (8, False), (1, True), (64, True), (64, False)):
        memory = torch.randn(n_img, 128, d, device="cuda", generator=gen) * 0.5
        valid = torch.randint(1, 129, (n_img,), device="cuda", generator=gen)
        pad = torch.arange(128, device="cuda")[None, :] >= valid[:, None]
        with torch.inference_mode():
            ref = K.fused_beam_decode_plain(params, memory, pad, cfg, dec)
            times, same = {1: [], 2: []}, {}
            for n in (1, 2, 2, 1):
                build._LIBS["decode_loop"] = libs[n]
                tok = K.fused_beam_decode_kernel(params, memory, pad, cfg, dec, on_chip=on_chip)
                same[n] = int((tok == ref).all(dim=1).sum())
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(3):
                    K.fused_beam_decode_kernel(params, memory, pad, cfg, dec, on_chip=on_chip)
                end.record()
                end.synchronize()
                times[n].append(start.elapsed_time(end) / 3)
        ms = {n: sum(t) / len(t) for n, t in times.items()}
        route = "on chip" if on_chip else "global"
        rows.append(dict(images=n_img, self_caches=route, ms_one=ms[1], ms_two=ms[2], equal_plain=same))
        print(f"[K3 registers] {n_img}x3 Tm=128 max_len=64, self caches {route}: one CTA an SM {ms[1]:.3f} ms, "
              f"two {ms[2]:.3f} ms ({ms[2] / ms[1]:.2f}x); images equal to plain {same[1]}/{n_img} and "
              f"{same[2]}/{n_img} on {smi}", flush=True)
    build._LIBS["decode_loop"] = libs[1]
    print(json.dumps(dict(device=smi, resident_clusters={n: {str(k): v for k, v in r.items()} for n, r in
                                                         resident.items()}, rows=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
