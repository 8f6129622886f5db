#!/usr/bin/env python3
"""K2 in float32 with one CTA's registers per SM against two, on one CUDA card.

    python3 examples/k2_registers_torch.py

Kernel K2 (``csrc/decoder_layer_step.cu``) and its tensor-parallel blocks
(``csrc/decoder_block.cu``) are compiled with ``__launch_bounds__(NT,
MinBlocks<T>::value)`` (``csrc/decoder_common.cuh``). This script builds both
float32 sources twice from the same files into ``khmer_ocr_torch/_build/
k2_registers/``, with ``-DK2_F32_MIN_BLOCKS=1`` (a CTA may take all of an
SM's registers, 168 a thread at 384 threads) and ``=2`` (at most 80, so two
CTAs could share an SM), and for each build prints:

  * ptxas's registers and spills for the 3-lane instantiation (the main
    path's beam 3) and the worst over all instantiations;
  * the clusters the card holds at once (``cudaOccupancyMaxActiveClusters``)
    at the launches' cluster shapes: K2 with one and two CTAs a head, and
    the blocks of rank 0 of a model group of 2;
  * each case against ``decoder_layer_step_plain`` (the output and the
    written cache slot, max |diff|, tolerance 1e-4; the blocks against
    ``decoder_block_plain``) on seeded flagship-width inputs, whether the two
    builds give the same bits, and the device time from a replayed CUDA
    graph, both builds in turns (one, two, two, one): 1, 8 and 64 images x
    3 lanes at Tm 256 and 8 x 3 at Tm 4096 (w = 64), and rank 0's self,
    cross, FFN and finish blocks at 8 x 3, Tm 256;
  * the trained flagship's tokens for 18 rendered lines at beam 3 through
    each build, against the plain path's on the same card;

and a last line of JSON. The default of ``K2_F32_MIN_BLOCKS`` in
``csrc/decoder_common.cuh`` (1), K2's second float library (2) and the
crossover ``geometry.k2_two_ctas_an_sm`` come from this script. Exits 2
without a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BOUNDS = (1, 2)
CASES = ((1, 256), (8, 256), (64, 256), (8, 4096))  # (images, Tm) at 3 lanes
SOURCES = ("decoder_layer_step", "decoder_block")


def ptxas_rows(log: str) -> list[dict]:
    """One row per compiled kernel of an ``-Xptxas -v`` log: its lanes a
    cluster (the G template argument), registers, spill stores and loads."""
    rows, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            name = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spills = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            g = re.search(r"ILi(\d+)E", name)
            rows.append(dict(lanes=int(g.group(1)) if g else None, registers=int(m.group(1)), spill_stores=spills[0],
                             spill_loads=spills[1]))
            name, spills = None, (0, 0)
    return rows


def build_all(build) -> tuple[dict, dict]:
    """Both float32 sources at both bounds, one nvcc each, all at once ->
    ({(source, bound): library}, {(source, bound): ptxas rows})."""
    out_dir = build.BUILD_DIR / "k2_registers"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in SOURCES:
        for n in BOUNDS:
            so = out_dir / f"{src}_minblocks{n}.so"
            cmd = [build.nvcc_path(), *build.NVCC_FLAGS, f"-DK2_F32_MIN_BLOCKS={n}", "-o", str(so),
                   str(build.CSRC_DIR / build.SOURCES[src])]
            procs[src, n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs, logs = {}, {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {key}: exit {proc.returncode}\n{log}")
        libs[key], logs[key] = ctypes.CDLL(str(so)), ptxas_rows(log)
    return libs, logs


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    from khmer_ocr_torch.config import ModelConfig
    from khmer_ocr_torch.convert.from_jax import params_from_jax, seeded_params
    from khmer_ocr_torch.infer.predictor import Predictor, set_parity_mode
    from khmer_ocr_torch.models.layers import pack_step_params
    from khmer_ocr_torch.ops.kernels import build, geometry
    from khmer_ocr_torch.ops.kernels import decode_step as K2

    set_parity_mode()
    libs, logs = build_all(build)
    cfg = ModelConfig()
    d, heads, f = cfg.emb_dim, cfg.num_heads, cfg.dec_ffn_dim
    hl, da, hd = heads // cs.TP_WORLD, d // cs.TP_WORLD, d // heads

    def use(n):  # the wrappers' float libraries, whichever geometry.k2_two_ctas_an_sm picks, for bound n
        for src in SOURCES:
            build._LIBS[src] = libs[src, n]
        build._LIBS["decoder_layer_step_two_ctas"] = libs["decoder_layer_step", n]

    builds = {}
    for n in BOUNDS:
        fn = libs["decoder_layer_step", n].decoder_layer_step_resident_clusters
        bfn = libs["decoder_block", n].decoder_block_resident_clusters
        rows = {src: logs[src, n] for src in SOURCES}
        builds[n] = dict(
            k2_lanes3=next(r for r in rows["decoder_layer_step"] if r["lanes"] == 3),
            blocks_lanes3=next(r for r in rows["decoder_block"] if r["lanes"] == 3),
            worst={src: max(r, key=lambda r: (r["spill_loads"], r["registers"])) for src, r in rows.items()},
            resident_k2={f"{s} CTA(s) a head": fn(3, d, heads, f, s) for s in (1, 2)},
            resident_blocks=bfn(3, d, da, hd, f // cs.TP_WORLD, 1))
        b = builds[n]
        print(f"[build] MinBlocks<float> {n}: K2 3 lanes {b['k2_lanes3']}; blocks 3 lanes {b['blocks_lanes3']}; worst "
              f"{b['worst']}; clusters resident: K2 {b['resident_k2']}, blocks of rank 0 of 2 {b['resident_blocks']}",
              flush=True)

    layer = params_from_jax(*seeded_params(cfg, 0), cfg, device="cuda")["dec"]["layers"][0]
    weights = K2.layer_weights(pack_step_params(layer))
    parts = [cs.tp_local(torch, weights, m, cs.TP_WORLD, d) for m in range(cs.TP_WORLD)]
    gen = torch.Generator(device="cuda").manual_seed(11)
    cache_len, w, lanes = 256, 64, 3
    pos = w - 1
    at = torch.tensor(pos, dtype=torch.int32, device="cuda")  # K2 reads the position on the card
    rows = []
    for n_img, tm in CASES:
        x, sk, sv, mk, mv, mvf, lin, _ = cs.k2_inputs(torch, gen, n_img, lanes, d, tm, cache_len, w)
        kw = dict(num_heads=heads, window=w, lanes=lanes)
        pk, pv = sk.clone(), sv.clone()
        ref = K2.decoder_layer_step_plain(weights, x, pos, pk, pv, mk, mv, mvf, lin, **kw)
        outs, err, times = {}, {}, {n: [] for n in BOUNDS}
        for n in (1, 2, 2, 1):
            use(n)
            ck, cv = sk.clone(), sv.clone()
            out = K2.decoder_layer_step_kernel(weights, x, at, ck, cv, mk, mv, mvf, lin, route="cluster", **kw)
            torch.cuda.synchronize()
            outs[n] = torch.cat([out, ck[:, pos], cv[:, pos]], dim=1)
            err[n] = (outs[n] - torch.cat([ref, pk[:, pos], pv[:, pos]], dim=1)).abs().max().item()
            times[n].append(cs.graph_ms(torch, lambda: K2.decoder_layer_step_kernel(
                weights, x, at, ck, cv, mk, mv, mvf, lin, route="cluster", **kw)))
        split = geometry.k2_geometry(n_img, lanes, heads, tm)[2] // heads
        rows.append(dict(shape=f"{n_img}x{lanes} w={w} Tm={tm}", ctas_per_head=split,
                         ms={n: sum(t) / len(t) for n, t in times.items()}, runs={n: t for n, t in times.items()},
                         max_abs_err=err, same_bits=bool(torch.equal(outs[1], outs[2]))))
        del x, sk, sv, mk, mv

    # rank 0's four blocks of a model group of 2 at 8 x 3, Tm 256, chained as a layer
    n_img, tm = 8, 256
    x, sk, sv, mk, mv, mvf, lin, _ = cs.k2_inputs(torch, gen, n_img, lanes, d, tm, cache_len, w)
    cache = (sk[..., :da].contiguous(), sv[..., :da].contiguous())
    mem = (mk[..., :da].contiguous(), mv[..., :da].contiguous())
    kinds = (("self", None), ("cross", ("so_b", "ln1_s", "ln1_b")), ("ffn", ("co_b", "ln2_s", "ln2_b")),
             ("finish", ("l2_b", "ln3_s", "ln3_b")))

    def layer_blocks(fn, ck, cv, collect=True):
        xr, part, outs = x, None, []
        for kind, pro in kinds:
            got = fn(kind, parts[0], xr, part, pos, ck, cv, mem[0], mem[1], mvf, lin,
                     prologue=None if pro is None else tuple(weights[k] for k in pro), round_x=kind == "finish",
                     num_heads=hl, window=w, lanes=lanes, dtype=torch.float32)
            xr, part = got[0], got[1] if got[1] is not None else part
            outs += [t for t in got if t is not None]
        if not collect:
            return None
        return torch.cat([t.reshape(-1) for t in outs] + [ck[:, pos].reshape(-1), cv[:, pos].reshape(-1)])

    ref = layer_blocks(K2.decoder_block_plain, cache[0].clone(), cache[1].clone())
    outs, err, times = {}, {}, {n: [] for n in BOUNDS}
    for n in (1, 2, 2, 1):
        use(n)
        ck, cv = cache[0].clone(), cache[1].clone()
        outs[n] = layer_blocks(K2.decoder_block, ck, cv)
        torch.cuda.synchronize()
        err[n] = (outs[n] - ref).abs().max().item()
        times[n].append(cs.graph_ms(torch, lambda: layer_blocks(K2.decoder_block, ck, cv, collect=False)))
    rows.append(dict(shape=f"blocks {n_img}x{lanes} w={w} Tm={tm}, rank 0 of {cs.TP_WORLD}", ctas_per_head=1,
                     ms={n: sum(t) / len(t) for n, t in times.items()}, runs=times, max_abs_err=err,
                     same_bits=bool(torch.equal(outs[1], outs[2]))))
    for r in rows:
        ms = r["ms"]
        print(f"[K2 registers] {r['shape']:40s} {r['ctas_per_head']} CTA(s) a head: one CTA's registers an SM "
              f"{ms[1]:.4f} ms {[round(t, 4) for t in r['runs'][1]]}, two {ms[2]:.4f} ms "
              f"{[round(t, 4) for t in r['runs'][2]]} ({ms[2] / ms[1]:.3f}x); max|kernel - plain| "
              f"{r['max_abs_err'][1]:.2e} and {r['max_abs_err'][2]:.2e}; the builds bit-equal: {r['same_bits']}; "
              f"on {smi}", flush=True)
        if max(r["max_abs_err"].values()) > cs.TOL:
            cs.fail(f"K2 registers {r['shape']}: max|kernel - plain| {r['max_abs_err']} (tol {cs.TOL})")

    # the trained flagship's tokens through each build against the plain path
    lines = [line for line, _ in cs.real_samples(cs.SERVE_LINES)]
    pred = Predictor(model_path=cs.FLAGSHIP)
    with cs.PlainPath():
        plain = [cs.strip(r) for r in pred.predict_batch_tokens(lines, beam_width=3, batch_size=8, max_len=64)]
    tokens = {}
    for n in BOUNDS:
        use(n)
        got = [cs.strip(r) for r in pred.predict_batch_tokens(lines, beam_width=3, batch_size=8, max_len=64)]
        tokens[n] = sum(a == b for a, b in zip(got, plain))
    print(f"[K2 registers] the flagship's 18 rendered lines at beam 3: lines token-equal to the plain path "
          f"{tokens[1]}/{len(lines)} with one CTA's registers an SM, {tokens[2]}/{len(lines)} with two")
    if min(tokens.values()) != len(lines):
        cs.fail(f"K2 registers: tokens differ from the plain path's {tokens}")
    print(json.dumps(dict(device=smi, builds=builds, rows=rows, flagship_tokens_equal=tokens)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
