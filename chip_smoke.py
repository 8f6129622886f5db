#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and hold its kernels to account.

    python3 chip_smoke.py          # from the repository root, on a machine with a CUDA card

Phases, each fatal on failure (exit code != 0, no result line):
  1. device: the card's name and power limit; TF32 off for matmul and cuDNN;
  2. build: every CUDA kernel from khmer_ocr_torch/csrc with nvcc (sm_90a);
  3. K1 (LSTM recurrence) against its plain version at H=192 and
     (B, T) in {(1, 4096), (8, 1024), (256, 256)}, max |diff| <= 1e-4;
  4. K2 (decoder layer step) against its plain version, 64 images x 3
     lanes, windows 32..256 at pos = w - 1, Tm 32..4096, random lineage and
     ragged memory validity: output and written cache slot within 1e-4,
     every other cache slot bit-identical;
  5. end to end: beam-3 recognition of synthetic uint8 lines at the flagship
     configuration (seeded weights) through Predictor.predict_batch_tokens,
     with the launch counts of both kernels, the tokens against the plain
     path on the card and against the golden tokens of the JAX package
     (khmer_ocr_torch/assets/smoke_golden.json), near-ties excepted;
  6. one JSON line with every kernel's numbers;
  7. the last line: {"ok": true, "device": {...}}.

Times come from CUDA events after warm-up. ``bound_ms`` is the larger of the
bytes the function must move over 3.35 TB/s and its operations over the
float32 peak of 67 TFLOP/s (H100 SXM data sheet).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TOL = 1e-4
NEAR_TIE = 1e-4


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def cuda_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def tpu_kernel_site(rel: str, func: str) -> str:
    """'<file>:<line>' of the TPU kernel's function in this checkout (read as
    text; nothing of that package is imported)."""
    for path in sorted(ROOT.glob(f"*/{rel}")):
        if path.parent.parent.parent.name == "khmer_ocr_torch":
            continue
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if line.startswith(f"def {func}("):
                return f"{path.relative_to(ROOT)}:{i}"
    return f"{rel}::{func} (not found)"


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(torch):
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on a machine with an NVIDIA card", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    from khmer_ocr_torch.infer.predictor import set_parity_mode

    set_parity_mode()
    name = torch.cuda.get_device_name(0)
    print(f"[device] {name} x{torch.cuda.device_count()}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    return name, smi[0]


def phase_build():
    from khmer_ocr_torch.ops.kernels import build

    t0 = time.perf_counter()
    secs = build.build()
    print(f"[build] {len(secs)} kernel(s) compiled in parallel in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
    for name, log in build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


def phase_k1(torch):
    from khmer_ocr_torch.ops.kernels import lstm as K

    hid, g = 192, 768
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows, worst = [], 0.0
    for b, t in ((1, 4096), (8, 1024), (256, 256)):
        xg = torch.randn(b, t, g, device="cuda", generator=gen) * 0.5
        w = (torch.rand(hid, g, device="cuda", generator=gen) * 2 - 1) / hid ** 0.5
        got = K.lstm_recurrence(xg, w)
        ref = K.lstm_recurrence_plain(xg, w)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        worst = max(worst, err)
        if not err <= TOL or not torch.isfinite(got).all():
            fail(f"K1 lstm_recurrence B={b} T={t}: max |kernel - plain| = {err:.3e} > {TOL}")
        lib = torch.nn.LSTM(g, hid, batch_first=True).cuda()
        with torch.no_grad():
            lib.weight_ih_l0.copy_(torch.eye(g, device="cuda"))
            lib.weight_hh_l0.copy_(w.t())
            lib.bias_ih_l0.zero_()
            lib.bias_hh_l0.zero_()
            lib_err = (lib(xg)[0] - ref).abs().max().item()
            reps = 3 if b * t >= 4096 else 10
            ms = cuda_ms(torch, lambda: K.lstm_recurrence(xg, w), reps)
            plain_ms = cuda_ms(torch, lambda: K.lstm_recurrence_plain(xg, w), 1)
            library_ms = cuda_ms(torch, lambda: lib(xg), reps)
        nbytes = 4 * (b * t * g + hid * g + b * t * hid)
        ops = 2 * b * t * hid * g + 20 * b * t * hid
        bms, by = bound_ms(nbytes, ops)
        rows.append(dict(shape=f"B={b} T={t}", max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bms, bound_by=by))
        print(f"[K1] B={b:3d} T={t:4d}: max|diff| {err:.2e} (cuDNN LSTM vs plain {lib_err:.2e}); kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms, cuDNN nn.LSTM {library_ms:.3f} ms, bound {bms:.4f} ms "
              f"({by}), {bms / ms:.2%} of roofline")
    return rows, worst


def k2_cost(torch, n_img, lanes, d, f, heads, pos, tm, tm_valid, lineage, weights_numel):
    """Bytes and operations one decoder layer step needs for these inputs:
    each input read once, each output written once, counting only the cache
    rows the lineage reaches and the valid memory rows."""
    b = n_img * lanes
    pairs = 0
    if pos:  # distinct (row, slot) pairs read below slot pos; slot pos is this step's own k, v
        src = lineage[:, :pos].long() + lanes * (torch.arange(b, device=lineage.device)[:, None] // lanes)
        pairs = (src * pos + torch.arange(pos, device=lineage.device)[None, :]).unique().numel()
    nbytes = 4 * (weights_numel + 2 * b * d + 2 * b * d + 2 * pairs * d + 2 * tm_valid * d + n_img * tm + b * pos)
    matvec = 2 * b * (d * 3 * d + 3 * d * d + 2 * d * f)
    attn = 4 * b * (pos + 1) * d + 4 * lanes * tm_valid * d + 6 * heads * (b * (pos + 1) + lanes * tm_valid)
    return nbytes, matvec + attn + 30 * b * d


def phase_k2(torch, weights):
    from khmer_ocr_torch.ops.kernels import decode_step as K

    n_img, lanes, d, heads, cache_len = 64, 3, 384, 8, 256
    b = n_img * lanes
    f = weights["l1_w"].shape[1]
    numel = sum(v.numel() for v in weights.values())
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows, worst = [], 0.0
    for w in (32, 64, 128, 256):
        pos = w - 1
        for tm in (32, 256, 1024, 4096):
            x = torch.randn(b, d, device="cuda", generator=gen) * 0.5
            sk = torch.randn(b, cache_len, d, device="cuda", generator=gen) * 0.3
            sv = torch.randn(b, cache_len, d, device="cuda", generator=gen) * 0.3
            mk = torch.randn(n_img, tm, d, device="cuda", generator=gen) * 0.3
            mv = torch.randn(n_img, tm, d, device="cuda", generator=gen) * 0.3
            valid_len = torch.randint(1, tm + 1, (n_img,), device="cuda", generator=gen)
            mvf = (torch.arange(tm, device="cuda")[None, :] < valid_len[:, None]).float().contiguous()
            lin = torch.randint(0, lanes, (b, w), device="cuda", generator=gen, dtype=torch.int32)
            sk_k, sv_k, sk_p, sv_p = sk.clone(), sv.clone(), sk.clone(), sv.clone()
            out = K.decoder_layer_step(weights, x, pos, sk_k, sv_k, mk, mv, mvf, lin, num_heads=heads,
                                       window=w, lanes=lanes)
            ref = K.decoder_layer_step_plain(weights, x, pos, sk_p, sv_p, mk, mv, mvf, lin, num_heads=heads,
                                             window=w, lanes=lanes)
            torch.cuda.synchronize()
            err = max((out - ref).abs().max().item(), (sk_k[:, pos] - sk_p[:, pos]).abs().max().item(),
                      (sv_k[:, pos] - sv_p[:, pos]).abs().max().item())
            keep = torch.ones(cache_len, dtype=torch.bool, device="cuda")
            keep[pos] = False
            untouched = torch.equal(sk_k[:, keep], sk[:, keep]) and torch.equal(sv_k[:, keep], sv[:, keep])
            worst = max(worst, err)
            if not err <= TOL or not untouched or not torch.isfinite(out).all():
                fail(f"K2 decoder_layer_step w={w} Tm={tm}: max|diff| {err:.3e} (tol {TOL}), "
                     f"untouched slots identical: {untouched}")
            ms = cuda_ms(torch, lambda: K.decoder_layer_step(weights, x, pos, sk_k, sv_k, mk, mv, mvf, lin,
                                                             num_heads=heads, window=w, lanes=lanes), 5)
            plain_ms = cuda_ms(torch, lambda: K.decoder_layer_step_plain(weights, x, pos, sk_p, sv_p, mk, mv, mvf,
                                                                         lin, num_heads=heads, window=w,
                                                                         lanes=lanes), 2)
            nbytes, ops = k2_cost(torch, n_img, lanes, d, f, heads, pos, tm, int(valid_len.sum()), lin, numel)
            bms, by = bound_ms(nbytes, ops)
            rows.append(dict(shape=f"64x3 w={w} Tm={tm}", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=None, bound_ms=bms, bound_by=by))
            print(f"[K2] w={w:3d} pos={pos:3d} Tm={tm:4d}: max|diff| {err:.2e}, untouched slots identical; "
                  f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({by}), "
                  f"{bms / ms:.2%} of roofline")
    return rows, worst


def teacher_forced_score(torch, params, cfg, lines_u8, count, seq):
    """Sum of log-probs of ``seq`` after <sos> over its length, under the
    plain path (the beam's normalisation)."""
    from khmer_ocr_torch.models.layers import dense
    from khmer_ocr_torch.models.ocr_model import encode, init_decode_state, pack_decode_params
    from khmer_ocr_torch.ops.kernels.decode_step import decoder_layer_step_plain
    from khmer_ocr_torch.ops.lines import device_chunk, u8_to_unit, unit_normalize

    with torch.inference_mode(), PlainPath():
        chunks = device_chunk(unit_normalize(u8_to_unit(lines_u8)), (100, 84))
        memory, pad = encode(params, chunks, count, cfg)
        state = init_decode_state(params, memory, pad, cfg, lanes=1, cache_len=len(seq))
        packed = pack_decode_params(params)
        dec = packed["dec"]
        total = torch.zeros((), dtype=torch.float32, device="cuda")
        for pos in range(len(seq) - 1):
            x = dec["tok_emb"][seq[pos:pos + 1]] + dec["pos_emb"][pos]
            for lw, (sk, sv), (mk, mv) in zip(dec["layers_kernel"], state["self_kv"], state["mem_kv"]):
                x = decoder_layer_step_plain(lw, x, pos, sk, sv, mk, mv, state["mem_valid_f"], None,
                                             num_heads=cfg.num_heads, window=len(seq), lanes=1)
            logp = torch.log_softmax(dense(dec["out"], x).float(), dim=-1)
            total = total + logp[0, seq[pos + 1]]
        return (total / len(seq)).item()


class PlainPath:
    """Within this block the model's modules call the plain versions of the
    kernels (the yardstick run on the same card)."""

    def __enter__(self):
        import khmer_ocr_torch.models.bilstm as bl
        import khmer_ocr_torch.models.ocr_model as om
        from khmer_ocr_torch.ops.kernels import decode_step, lstm

        self._saved = (bl.lstm_recurrence, om.decoder_layer_step)
        bl.lstm_recurrence = lstm.lstm_recurrence_plain
        om.decoder_layer_step = decode_step.decoder_layer_step_plain
        return self

    def __exit__(self, *exc):
        import khmer_ocr_torch.models.bilstm as bl
        import khmer_ocr_torch.models.ocr_model as om

        bl.lstm_recurrence, om.decoder_layer_step = self._saved
        return False


def strip(row) -> list[int]:
    out = [int(v) for v in row]
    while out and out[-1] == 0:
        out.pop()
    return out


def check_tokens(torch, pred, lines, golden_rows, got_rows, label: str) -> int:
    """Count lines whose tokens differ, failing unless each is a near-tie."""
    differ = 0
    for i, (ref, got) in enumerate(zip(golden_rows, got_rows)):
        if ref == got:
            continue
        differ += 1
        batch = pred.preprocessor.prepare_one(lines[i])
        u8 = torch.from_numpy(batch[2][None]).cuda()
        cnt = torch.tensor([batch[1]], device="cuda")
        s_ref = teacher_forced_score(torch, pred.params, pred.model_cfg, u8, cnt,
                                     torch.tensor(ref, device="cuda"))
        s_got = teacher_forced_score(torch, pred.params, pred.model_cfg, u8, cnt,
                                     torch.tensor(got, device="cuda"))
        print(f"[e2e] {label}: line {i} differs: {ref} vs {got}; normalised scores {s_ref:.7f} vs {s_got:.7f}")
        if not abs(s_ref - s_got) < NEAR_TIE:
            fail(f"{label}: line {i} differs and is not a near-tie (|{s_ref} - {s_got}| >= {NEAR_TIE})")
    return differ


def phase_e2e(torch, gpu_name, smi):
    import numpy as np

    from khmer_ocr_torch.config import ModelConfig
    from khmer_ocr_torch.convert.from_jax import seeded_params
    from khmer_ocr_torch.data.synthetic import synthetic_lines
    from khmer_ocr_torch.infer.predictor import Predictor
    from khmer_ocr_torch.models.ocr_model import encode
    from khmer_ocr_torch.ops.kernels import decode_step, lstm
    from khmer_ocr_torch.ops.lines import device_chunk, u8_to_unit, unit_normalize

    golden = json.loads((ROOT / "khmer_ocr_torch" / "assets" / "smoke_golden.json").read_text())
    cfg = ModelConfig()
    params, stats = seeded_params(cfg, golden["seed"])
    lines = synthetic_lines(golden["chunk_counts"], seed=golden["lines_seed"])
    pred = Predictor(params=params, batch_stats=stats)  # no device given: the CUDA card
    if pred.device.type != "cuda":
        fail(f"Predictor picked {pred.device}, not the card")
    bw, bs = golden["beam_width"], golden["batch_size"]
    n_batches = len(list(pred.preprocessor.iter_batches(lines, max_batch=bs)))

    # memory: kernel path against the plain path, the 8-chunk batch and the longest line
    counts = golden["chunk_counts"]
    for idx in ([i for i, c in enumerate(counts) if 6 < c <= 8], [counts.index(max(counts))]):
        batch = next(pred.preprocessor.iter_batches([lines[i] for i in idx], max_batch=bs))
        with torch.inference_mode():
            u8 = torch.from_numpy(batch.lines).cuda()
            cnt = torch.from_numpy(batch.chunk_counts).cuda()
            chunks = device_chunk(unit_normalize(u8_to_unit(u8)), (100, 84))
            mem_k, pad = encode(pred.params, chunks, cnt, cfg)
            with PlainPath():
                mem_p, _ = encode(pred.params, chunks, cnt, cfg)
        err = (mem_k - mem_p)[~pad].abs().max().item()
        print(f"[e2e] memory of lines {idx} (bucket {batch.bucket_n}): max|kernel path - plain path| {err:.2e}")
        if not err <= TOL:
            fail(f"memory differs by {err:.3e} > {TOL}")

    results = {}
    for max_len in (golden["max_len"], cfg.decode_max_len):
        pred.predict_batch_tokens(lines, beam_width=bw, batch_size=bs, max_len=max_len)  # warm-up
        torch.cuda.synchronize()
        lstm.reset_launches()
        decode_step.reset_launches()
        steps0 = pred.decode_steps
        t0 = time.perf_counter()
        rows = pred.predict_batch_tokens(lines, beam_width=bw, batch_size=bs, max_len=max_len)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1, k2 = lstm.launches, decode_step.launches
        steps = pred.decode_steps - steps0
        want_k1, want_k2 = 2 * n_batches, cfg.dec_layers * steps
        print(f"[e2e] beam {bw}, max_len {max_len}: {len(lines)} lines in {n_batches} batches, {wall * 1e3:.1f} ms "
              f"({len(lines) / wall:.1f} lines/s, {wall * 1e3 / n_batches:.1f} ms/batch) on {smi}; "
              f"{steps} decode steps; launches K1 {k1} (expected {want_k1}), K2 {k2} (expected {want_k2})")
        if k1 != want_k1 or k2 != want_k2 or k1 == 0 or k2 == 0:
            fail(f"launch counts K1 {k1} / K2 {k2}, expected {want_k1} / {want_k2}")
        got = [strip(r) for r in rows]
        for r in rows:
            if not (np.all(r >= 0) and np.all(r < cfg.vocab_size)):
                fail("tokens out of the vocabulary")
        with PlainPath():
            plain_rows = [strip(r) for r in
                          pred.predict_batch_tokens(lines, beam_width=bw, batch_size=bs, max_len=max_len)]
        n_diff = check_tokens(torch, pred, lines, plain_rows, got, f"max_len {max_len} vs plain path")
        print(f"[e2e] max_len {max_len}: {len(lines) - n_diff}/{len(lines)} lines token-identical to the plain "
              f"path; strings: {[pred.tokenizer.decode(r) for r in got[:2]]} ...")
        if max_len == golden["max_len"]:
            n_gold = check_tokens(torch, pred, lines, golden["tokens"], got, "vs golden")
            print(f"[e2e] {len(lines) - n_gold}/{len(lines)} lines token-identical to the golden tokens")
        results[max_len] = dict(ms=wall * 1e3, lines_per_s=len(lines) / wall, k1=k1, k2=k2, steps=steps)
    return results


def main() -> int:
    if not (ROOT / "khmer_ocr_torch" / "__init__.py").exists():
        print("khmer_ocr_torch not found next to chip_smoke.py: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    gpu_name, smi = phase_device(torch)
    phase_build()
    k1_rows, k1_err = phase_k1(torch)

    from khmer_ocr_torch.config import ModelConfig
    from khmer_ocr_torch.convert.from_jax import params_from_jax, seeded_params
    from khmer_ocr_torch.models.layers import pack_step_params
    from khmer_ocr_torch.ops.kernels.decode_step import layer_weights

    p, s = seeded_params(ModelConfig(), 0)
    state = params_from_jax(p, s, ModelConfig(), device="cuda")
    weights = layer_weights(pack_step_params(state["dec"]["layers"][0]))
    k2_rows, k2_err = phase_k2(torch, weights)
    e2e = phase_e2e(torch, gpu_name, smi)

    main_len = min(e2e)
    k1_main = next(r for r in k1_rows if r["shape"] == "B=8 T=1024")
    k2_main = next(r for r in k2_rows if r["shape"] == "64x3 w=64 Tm=256")
    kernels = [
        dict(name="lstm_recurrence", route="cuda", source="khmer_ocr_torch/csrc/lstm_recurrence.cu",
             replaces=tpu_kernel_site("ops/pallas/lstm.py", "lstm_recurrence"), launches=e2e[main_len]["k1"],
             max_abs_err=k1_err, ms=k1_main["ms"], plain_ms=k1_main["plain_ms"], bound_ms=k1_main["bound_ms"],
             bound_by=k1_main["bound_by"], library_ms=k1_main["library_ms"], shape=k1_main["shape"],
             shapes=k1_rows),
        dict(name="decoder_layer_step", route="cuda", source="khmer_ocr_torch/csrc/decoder_layer_step.cu",
             replaces=tpu_kernel_site("ops/pallas/decode_step.py", "fused_decoder_layer_step"),
             launches=e2e[main_len]["k2"], max_abs_err=k2_err, ms=k2_main["ms"], plain_ms=k2_main["plain_ms"],
             bound_ms=k2_main["bound_ms"], bound_by=k2_main["bound_by"], library_ms=None, shape=k2_main["shape"],
             shapes=k2_rows),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": gpu_name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
