#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and hold its kernels to account.

    python3 chip_smoke.py          # from the repository root, on a machine with a CUDA card

Phases, each fatal on failure (exit code != 0, no result line):
  1. device: the card's name and power limit; TF32 off for matmul and cuDNN;
     whether Pillow, OpenCV and safetensors import there (nothing needs them);
  2. build: the CUDA kernels from khmer_ocr_torch/csrc with nvcc (sm_90a),
     one nvcc each, all at once (K2, its tensor-parallel blocks and K3 once
     per storage type, float32 and bf16, K2's second float32 library,
     bounded for two CTAs an SM, and K5);
  3. K1 (LSTM recurrence) against its plain version and cuDNN's nn.LSTM at
     H=192, one direction and two stacked directions, (B, T) in {(1, 4096),
     (8, 1024), (256, 256)}: both routes (thread-block clusters, one CTA per
     batch tile) at each shape, the one geometry.k1_route picks timed as the
     kernel, max |diff| <= 1e-4;
  4. K2 (decoder layer step, reading the position from a device int32)
     against its plain version, by both routes: the card route
     (decoder_layer_card.cu, seven launches over the whole card) at its
     greedy shapes, at the window's first, middle and last slot, and the
     cluster route; the serving cells' 1, 8 and 64 images x 3 lanes at
     w=64, Tm 256, 384, 1024 and 4096, greedy 32 x 1 at w 64 and 160, Tm
     256 and 384, at w 64, Tm 128 and at w 160, Tm 4096; 64 images x 3
     lanes, windows 32..256 at pos = w - 1, Tm 32..4096; then 1, 2, 4 and 5
     lanes at w=64, Tm=256, and greedy at 1 image x Tm=4096, 8 x Tm=256 and
     11 x Tm=384; random lineage and ragged memory validity: output and
     written cache slot within 1e-4, every other cache slot bit-identical, the cluster
     route with one and (where the launch fits the SMs) two CTAs a head,
     and from both float32 libraries (registers bounded for one CTA an SM
     and for two; geometry.k2_two_ctas_an_sm picks one per launch); timed
     as device time (a CUDA graph of launches) and as a call from Python;
     geometry.k2_route's pick timed as the kernel. Then the card route's
     replays beside a second stream's convolutions: they end, bit-equal;
  5. K3 (whole beam decode, one cluster of one CTA per head for each
     image) against its plain version on seeded flagship decoder weights:
     8 images at Tm 32..128, beam 2-4, max_len 16 and 64; 64 images at
     Tm=128; an <eos>-biased and an exact-ties head; one image (a single
     line's latency). The self caches stay on chip where geometry.k3_geometry
     says (beam 2-3 at the flagship) and go to global memory otherwise; the
     beam-3, Tm=128, max_len 64 cases of 8 and 64 images run both routes.
     Tokens equal (near-ties excepted), scores within 1e-4 x max(1, |ref|);
     timed beside the step loop (K2, replayed as CUDA graphs) on the same inputs;
  5b. K5 (the beam search's step, one CTA of a warp a lane for each image)
     against its plain version (log_softmax + beam_advance) at 8 and 64
     images x 3 lanes, V 124, at positions 0, 31 and 63 of a search on
     random logits: on log-probs every output bit-equal, on logits the
     tokens, lineage and best tokens equal and the scores' gap reported;
     timed from a replayed CUDA graph beside the plain version; the 64-step
     decode of K3's 8 x 3 and 64 x 3 rows by the step loop's graphs with K5
     and with the plain search, in turns; the flagship's 64 real lines
     served with each, K5 launched once a replayed step;
  6. K4 (dynamic shared memory probe): the probe's answer equals the device
     attribute within 1 KB, the next size is refused, row 0 equals the plain
     version; one empty launch and synchronise is timed as its floor;
  7. end to end through Predictor.predict_batch_tokens at the flagship
     configuration (seeded weights), each request with every launch count set
     to 0 just before it and read just after (K2's launched by the decode's
     CUDA graph replays, no decode step by the Python loop): beam 3 at max_len 64 and 256
     (K1, K2), tokens against the plain path on the card and against the
     golden tokens of the JAX package (khmer_ocr_torch/assets/smoke_golden.json),
     near-ties excepted; the same request with KHMER_OCR_MEGA_DECODE=1 (K3
     takes the three batches of 1-4 chunks, K2 the rest); beam 5; the vgg and
     resnet backbones (no BiLSTM) on the 12 short lines through K3, memory and
     tokens against the plain path;
  8. the flagship's real weights (checkpoints/se_vgg_flagship through the
     weights index khmer_ocr_torch/assets/flagship, loaded by
     Predictor(model_path=...)) on the 64 rendered lines of
     khmer_ocr_torch/assets/real_lines.npz, beam 3, max_len 64, batch 8:
     memory against the plain path for each bucket batch; the step loop (K1,
     K2) and then KHMER_OCR_MEGA_DECODE=1 (K3 takes the batches inside its
     envelope), each request's strings equal to the JAX package's stored
     with the lines, near-ties excepted, with launch counts; the strings
     scored by the port's metrics (levenshtein_batch built with g++ there and
     held equal to the numpy DP on every pair), mean CER and exact match
     equal to the stored JAX values;
  8b. the decode's step loop as CUDA graphs (decode/graphs.py) against the
     Python loop (Predictor(eager_decode=True)), in one process, in turns:
     the 18 lines at beam 3 (max_len 64 and 256), beam 5, greedy and beam 3
     with KHMER_OCR_FUSED_HEAD=1, float32 and bf16, and the flagship's 64
     real lines, float32 and bf16: tokens equal, the golden tokens, JAX's
     strings and CER; walls, idle shares (torch.profiler), lines/s,
     captures, replays and K2 launches a replay, K2's kernels in each
     profiled request's trace equal to its counted launches; the decode
     shapes each Predictor cached and their bytes; warmup's captures; the
     graph cache's cost (the flagship's default warmup: its shapes, bytes
     and memory, all of it freed with the Predictor; a budget that keeps
     one shape, so every batch captures again, against the cache and the
     Python loop);
  8c. predict_batch's in-flight pipeline (infer/predictor.py: a dispatch
     thread prepares, ships and encodes each batch on its own stream, the
     encode of shapes up to encode_graph.MAX_CHUNKS chunks replayed as a
     CUDA graph; the caller decodes in order and drains) against the loop
     of decode_prepared, the path before it, on the trained flagship at
     beam 3, max_len 64: the 18 seeded lines and the 64 real lines at
     batch 8, those four times over at batch 8 and 64; the loop, the
     pipeline with the encode launched eagerly and the pipeline at
     max_inflight_batches 1 and 4, in turns, counted: tokens equal, JAX's
     strings and CER, the high-water mark within 2 x max_inflight_batches
     and reaching it at 1; walls, lines/s, idle shares, the decode
     stage's host ms, peak memory; the encode graphs' memory against the
     eager encode's; the exit test's read waiting on its own stream alone;
  9. the page path (document): 4 A4 pages of the 64 rendered lines
     (data/pages.py) written as PNG, the seeded SegFormer written as an HF
     checkpoint directory, loaded by KhmerOCRPipeline(engine="custom") with
     the flagship recognizer: the packed maps of one group of 4 against the
     JAX package's (khmer_ocr_torch/assets/document_golden.*), class ids
     equal off near-tied pixels and heatmaps within 1 step, the per-page
     path against the batched one; the detector's forwards as captured
     CUDA graphs (detection/graphs.py) against the eager forward bit for
     bit: the group of 4, 3 pages padded to 4 (a replay, no capture), each
     page's per-page bucket; forward + copy eager against the graph, the
     cache's keys, bytes and pool, captures and replays counted; the
     post-process on this machine's
     OpenCV giving the golden elements from the golden maps and from the
     pages' known layout; the known layout's 64 crops at beam 3 (K1, K2)
     against the JAX strings, near-ties excepted, with CER; process_pages
     on 4 and 16 pages with launch counts, its detection and recognition
     spans and both measured apart (the recognition by the decode's graphs
     and by the Python loop), against the JAX page texts; the
     searchable PDF's text layer through minipdf;
 10. training at the flagship configuration (seeded weights): K1 with its
     cell-state output and K1b (the LSTM's adjoint, by both its routes:
     clusters with W_hh in registers, one CTA per batch tile; the one
     geometry.k1b_route picks timed as the kernel) against their plain
     versions at (directions, B, T) = (2, 32, 512), (2, 8, 128), (1, 1,
     4096), h, c, dz and dW_hh within 1e-4 (K1b beside cuDNN's nn.LSTM
     backward); one step of batch 32 x 16 chunks, 256 labels, by the kernel
     path against the plain LSTM path on the card (loss 1e-5 relative,
     gradients 1e-4 x max(1, |ref|)), one K1 and one K1b launch a step;
     three steps against the JAX package's golden losses and gradient norms
     (khmer_ocr_torch/assets/train_golden.json, 1e-4 relative); 50 steps
     on 4 samples overfit; the steps as captured CUDA graphs
     (train/graphs.py): 8 steps of the one-step graph and two groups of 8
     against the eager steps from one state, batch and generator seed,
     losses within 1e-5 relative and params within 1e-5, with dropout 0
     (the one-step graph also with dropout 0.1 and augmentation p 0.8), K1
     and K1b counted once a step by each replay; ms a step, idle share, K1
     and K1b launches a step, peak memory, the graphs' pool and capture time
     for the eager step, the one-step graph and the group of 8 (the first
     two also at matmul precision "default"); two epochs of train() (the JAX
     package's batch order, dispatch groups of 8, every step through the
     graphs) on 256 synthetic lines of mixed widths with device
     augmentation and dropout, checkpoints and a resume, and on 512 lines of
     16 chunks (one shape): lines/s, captures, replays, the pool;
 11. layout training (detection/train.py) at MiT-b0 widths, each step
     a replayed CUDA graph (detection/graphs.py): three steps against the
     JAX package's golden losses (khmer_ocr_torch/assets/
     layout_train_golden.json, 1e-4 relative; a capture, then two
     replays); 8 graphed steps against 8 eager steps at batch 4 x 512 px
     from one state, losses, parameters, both Adam moments and the
     BatchNorm running pair bit for bit; the step eager and graphed in
     turns (ms, pages/s, peak memory, busy ms and idle share, the pool,
     the capture); 30 steps of finetune() from random init (1 capture, 29
     replays) with the loss falling below 0.7 of its first, the .npz round
     trip in the JAX package's layout;
 12. host augmentation (train/augment.py): one epoch of 16 rendered lines
     against the JAX package's digest (khmer_ocr_torch/assets/
     host_augment_golden.json), then two epochs of train() on the 64 lines
     augmented on the host (device augmentation off), the batch on the card
     equal to the host's build, one K1 and one K1b launch a step;
 13. data parallelism (parallel/mesh.py): a group of one rank over NCCL
     gives the step without a group bit for bit; two ranks sharing the card
     over gloo, each running K1 and K1b on its half of 8 lines, match the
     one-process step; the two ranks serve 18 rendered lines at beam 3 with
     the flagship's weights, tokens equal to one process's (each rank's K1
     and K2 launches counted);
 14. bf16 serving: K2 in bf16 against its plain bf16 version (the same
     rounding points) at 1, 8 and 64 images x 3 lanes, Tm 256 and 4096,
     within two bf16 steps, timed beside float32; K3 in bf16 at 8 and 64
     images x 3 against its plain version (near-ties excepted) and against
     float32; the flagship on the 64 rendered lines with
     compute_dtype="bfloat16": strings against the JAX package's bf16
     strings stored with the lines, mean CER at most theirs + 0.005,
     lines/s beside float32's by the step loop and with
     KHMER_OCR_MEGA_DECODE=1, launches counted;
 15. matmul precision scoped to each call: a bf16 Predictor at "default"
     beside a LayoutInference leaves torch's TF32 switches as it found them;
     an f32 matmul's error at float32 level outside a scope and at TF32
     level inside "default"; the detector at "highest" waits for another
     thread's "default" scope and gives bit-equal maps;
 16. the fused decode head: K2 with ``head`` against its plain version in
     float32 and bf16, timed with and without; 18 flagship lines at beam 3
     with KHMER_OCR_FUSED_HEAD=1, tokens equal to those without it, one head
     launch a decode step;
 17. the tensor-parallel model axis: K2's blocks (csrc/decoder_block.cu)
     against their plain versions and, both ranks' parts chained in one
     process, against the unsplit K2 step; then two rank processes sharing
     the card over gloo (``--tp-rank``), each with its half of the flagship's
     weights: forward_train logits within 2e-4 / 1e-3 of one process's, 18
     lines at beam 3 through infer_batch token-equal to one process's, K2
     block launches per rank;
 18. the host input path: whether the native loader (native/imageio.cpp)
     builds on this machine and, if so, its pixels against PIL's; the
     Preprocessor's lines/s on 256 PNG files at host_workers 1 and 8;
     Predictor.warmup's seconds and the first request after it;
 19. one JSON line with every kernel's numbers (K2's bf16, head and block
     variants and K3's bf16 as entries of their own);
 20. the last line: {"ok": true, "device": {...}}.

Times come from CUDA events after warm-up (K2's device time from a
replayed CUDA graph of launches). ``bound_ms`` is the larger of the
bytes the function must move over 3.35 TB/s and its operations over the
float32 peak of 67 TFLOP/s (H100 SXM data sheet).
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12  # the tensor cores' dense bf16 x bf16 -> f32 rate
TOL = 1e-4
NEAR_TIE = 1e-4
DOC_RUNS, DOC_RUNS_16 = 5, 3  # process_pages runs on the known layout: 4 pages, 16 pages


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def bound_ms(nbytes: float, ops: float, itemsize: int = 4) -> tuple[float, str]:
    """The least time for these bytes and operations: the operations at the
    card's peak rate for the storage type (float32 outside the tensor cores
    for 4-byte operands, bf16 for 2-byte ones)."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / (F32_OPS_PER_S if itemsize == 4 else BF16_OPS_PER_S) * 1e3
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


def graph_ms(torch, fn, reps: int = 20, replays: int = 3) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in a CUDA
    graph, replayed ``replays`` times between CUDA events (the host's cost
    of a call, which cuda_ms includes once it exceeds the device's, is left
    out)."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


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
    probe = ("import importlib\n"
             "for m in ('PIL', 'cv2', 'safetensors'):\n"
             "    try:\n"
             "        importlib.import_module(m)\n"
             "        print(m, 'imports')\n"
             "    except Exception as e:\n"
             "        print(m, 'does not import:', type(e).__name__)\n")
    found = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, timeout=120).stdout
    print(f"[device] host packages the run needs none of: {'; '.join(found.splitlines())}")
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


def library_lstm(torch, xg, w):
    """cuDNN's nn.LSTM set up to compute lstm_recurrence(xg, w) (identity
    input weights, zero biases); two stacked directions as one
    bidirectional LSTM whose reverse half reads the second direction's gates
    reversed in time. Returns (module, its input, a function of its output
    that gives the kernel's layout)."""
    ndir, g, hid = (xg.shape[0] if xg.dim() == 4 else 1), xg.shape[-1], w.shape[-2]
    lib = torch.nn.LSTM(ndir * g, hid, batch_first=True, bidirectional=ndir == 2).cuda()
    eye = torch.eye(g, device="cuda")
    with torch.no_grad():
        for prm in lib.parameters():
            prm.zero_()
        if ndir == 1:
            lib.weight_ih_l0.copy_(eye)
            lib.weight_hh_l0.copy_(w.t())
            return lib, xg, lambda y: y
        lib.weight_ih_l0[:, :g].copy_(eye)
        lib.weight_ih_l0_reverse[:, g:].copy_(eye)
        lib.weight_hh_l0.copy_(w[0].t())
        lib.weight_hh_l0_reverse.copy_(w[1].t())
    x = torch.cat([xg[0], torch.flip(xg[1], dims=(1,))], dim=-1).contiguous()
    return lib, x, lambda y: torch.stack([y[..., :hid], torch.flip(y[..., hid:], dims=(1,))])


def phase_k1(torch):
    """Both routes of K1 at each shape (the one geometry.k1_route picks is
    the kernel's time, the other is printed beside it), single and stacked
    two-direction inputs, against the plain version and cuDNN."""
    from khmer_ocr_torch.ops.kernels import geometry
    from khmer_ocr_torch.ops.kernels import lstm as K

    hid, g = 192, 768
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows, worst = [], 0.0
    # (directions, B, T): the main path's stacked calls (the 128-chunk line; a batch of 8 long lines),
    # the same shapes one direction at a time, and a batch that takes the tile route
    for ndir, b, t in ((1, 1, 4096), (2, 1, 4096), (1, 8, 1024), (2, 8, 1024), (1, 256, 256), (2, 256, 256)):
        lead = (ndir,) if ndir == 2 else ()
        xg = torch.randn(*lead, b, t, g, device="cuda", generator=gen) * 0.5
        w = (torch.rand(*lead, hid, g, device="cuda", generator=gen) * 2 - 1) / hid ** 0.5
        chosen = geometry.k1_route(b, hid, ndir)
        cluster = chosen if chosen[0] else geometry.k1_route(min(b, geometry.TILE_FROM_BATCH[ndir] - 1), hid, ndir)
        routes = {"cluster": cluster, "tile": (0, geometry.tile_rows(b))}
        ref = K.lstm_recurrence_plain(xg, w)
        lib, lib_x, lib_layout = library_lstm(torch, xg, w)
        shape = f"{ndir}x B={b} T={t}" if ndir == 2 else f"B={b} T={t}"
        reps = 3 if b * t >= 4096 else 10
        times, err = {}, 0.0
        with torch.no_grad():
            for name, route in routes.items():
                got = K.lstm_recurrence_route(xg, w, route)
                torch.cuda.synchronize()
                e = (got - ref).abs().max().item()
                if not e <= TOL or not torch.isfinite(got).all():
                    fail(f"K1 lstm_recurrence {shape} {name} route {route}: max |kernel - plain| = {e:.3e} > {TOL}")
                err = max(err, e)
                times[name] = cuda_ms(torch, lambda: K.lstm_recurrence_route(xg, w, route), reps)
            lib_err = (lib_layout(lib(lib_x)[0]) - ref).abs().max().item()
            plain_ms = cuda_ms(torch, lambda: K.lstm_recurrence_plain(xg, w), 1)
            library_ms = cuda_ms(torch, lambda: lib(lib_x), reps)
        worst = max(worst, err)
        name = "cluster" if chosen[0] else "tile"
        other = "tile" if chosen[0] else "cluster"
        ms = times[name]
        nbytes = 4 * ndir * (b * t * g + hid * g + b * t * hid)
        ops = ndir * (2 * b * t * hid * g + 20 * b * t * hid)
        bms, by = bound_ms(nbytes, ops)
        rows.append(dict(shape=shape, route=name, rows=chosen[1], max_abs_err=err, ms=ms,
                         other_route_ms=times[other], plain_ms=plain_ms, library_ms=library_ms, bound_ms=bms,
                         bound_by=by))
        print(f"[K1] {shape:18s}: max|diff| {err:.2e} (cuDNN LSTM vs plain {lib_err:.2e}); kernel, {name} route "
              f"{chosen}: {ms:.3f} ms ({other} route {routes[other]}: {times[other]:.3f} ms), plain {plain_ms:.3f} "
              f"ms, cuDNN nn.LSTM {library_ms:.3f} ms, bound {bms:.4f} ms ({by}), {bms / ms:.2%} of roofline")
    return rows, worst


# (directions, B, T) of the training path's recurrences: the train step's 16-chunk bucket at batch 32, a
# 4-chunk bucket at batch 8, and the longest line one direction at a time
TRAIN_LSTM_SHAPES = ((2, 32, 512), (2, 8, 128), (1, 1, 4096))


def lstm_inputs(torch, gen, ndir, b, t, hid=192):
    lead = (ndir,) if ndir == 2 else ()
    xg = torch.randn(*lead, b, t, 4 * hid, device="cuda", generator=gen) * 0.5
    w = (torch.rand(*lead, hid, 4 * hid, device="cuda", generator=gen) * 2 - 1) / hid ** 0.5
    return xg, w


def phase_k1_cells(torch):
    """K1 with its cell-state output (the training forward) against the
    plain version at the training path's shapes, by the route
    geometry.k1_route picks; timed with and without the cells."""
    from khmer_ocr_torch.ops.kernels import geometry
    from khmer_ocr_torch.ops.kernels import lstm as K

    gen = torch.Generator(device="cuda").manual_seed(4)
    rows, worst = [], 0.0
    for ndir, b, t in TRAIN_LSTM_SHAPES:
        xg, w = lstm_inputs(torch, gen, ndir, b, t)
        shape = f"{ndir}x B={b} T={t}" if ndir == 2 else f"B={b} T={t}"
        with torch.no_grad():
            h_ref, c_ref = K.lstm_recurrence_plain(xg, w, with_cell=True)
            h, c = K.lstm_recurrence(xg, w, with_cell=True)
            torch.cuda.synchronize()
            err = max((h - h_ref).abs().max().item(), (c - c_ref).abs().max().item())
            if not err <= TOL or not (torch.isfinite(h).all() and torch.isfinite(c).all()):
                fail(f"K1 with cells {shape}: max |kernel - plain| over h and c = {err:.3e} > {TOL}")
            if not torch.equal(h, K.lstm_recurrence(xg, w)):
                fail(f"K1 {shape}: h with cells differs from h without")
            reps = 3 if b * t >= 4096 else 10
            ms_cells = cuda_ms(torch, lambda: K.lstm_recurrence(xg, w, with_cell=True), reps)
            ms = cuda_ms(torch, lambda: K.lstm_recurrence(xg, w), reps)
        worst = max(worst, err)
        g = 4 * 192
        nbytes = 4 * ndir * (b * t * g + 192 * g + 2 * b * t * 192)
        ops = ndir * (2 * b * t * 192 * g + 20 * b * t * 192)
        bms, by = bound_ms(nbytes, ops)
        route = geometry.k1_route(b, 192, ndir)
        rows.append(dict(shape=f"{shape}, with cells", route=route, max_abs_err=err, ms=ms_cells, no_cells_ms=ms,
                         bound_ms=bms, bound_by=by))
        print(f"[K1] {shape:18s} with cells: max|diff| h, c {err:.2e}; route {route}: {ms_cells:.3f} ms with cells, "
              f"{ms:.3f} ms without; bound {bms:.4f} ms ({by}), {bms / ms_cells:.2%} of roofline")
    return rows, worst


def library_lstm_backward_ms(torch, xg, w, dh, reps):
    """cuDNN's backward: out.backward(g) of the bidirectional (or single)
    nn.LSTM of library_lstm after its forward, input weights and biases
    frozen, timed with CUDA events around the backward alone."""
    lib, x, layout = library_lstm(torch, xg, w)
    for name, prm in lib.named_parameters():
        prm.requires_grad_(name.startswith("weight_hh"))
    x = x.detach().requires_grad_(True)
    g = torch.cat([dh[0], torch.flip(dh[1], dims=(1,))], dim=-1) if xg.dim() == 4 else dh
    total = 0.0
    for i in range(reps + 1):
        out = lib(x)[0]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out.backward(g)
        end.record()
        end.synchronize()
        total += start.elapsed_time(end) if i else 0.0  # the first is warm-up
    return total / reps


def phase_k1b(torch):
    """K1b (the LSTM's adjoint) against the plain backward at the training
    path's shapes, by both routes (clusters with W_hh in registers, one CTA
    per batch tile): dz, and the dW_hh LSTMRecurrence makes of it; the route
    geometry.k1b_route picks is the kernel's time, the other is printed
    beside it, with the plain version, the whole backward and cuDNN's."""
    from khmer_ocr_torch.ops.kernels import geometry
    from khmer_ocr_torch.ops.kernels import lstm as K
    from khmer_ocr_torch.ops.kernels import lstm_backward as KB

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows, worst = [], 0.0
    for ndir, b, t in TRAIN_LSTM_SHAPES:
        xg, w = lstm_inputs(torch, gen, ndir, b, t)
        dh = torch.randn(*xg.shape[:-1], 192, device="cuda", generator=gen)
        shape = f"{ndir}x B={b} T={t}" if ndir == 2 else f"B={b} T={t}"
        chosen = geometry.k1b_route(b, 192, ndir)
        routes = {"cluster": (geometry.CLUSTER_CTAS, geometry.cluster_rows(b, ndir)),
                  "tile": (0, geometry.k1b_rows(b, ndir))}
        reps = 3 if b * t >= 4096 else 10
        times, err = {}, 0.0
        with torch.no_grad():
            h, c = K.lstm_recurrence(xg, w, with_cell=True)
            hp = torch.cat([torch.zeros_like(h[..., :1, :]), h[..., :-1, :]], dim=-2).reshape(*h.shape[:-3], -1, 192)
            gates = (xg.reshape(*hp.shape[:-1], -1) + hp @ w).reshape(xg.shape)
            dz_ref = KB.lstm_adjoint_plain(gates, c, dh, w)
            dw_ref = hp.transpose(-1, -2) @ dz_ref.reshape(*hp.shape[:-1], -1)
            for name, route in routes.items():
                dz = KB.lstm_adjoint_kernel(gates, c, dh, w, route)
                torch.cuda.synchronize()
                dw = hp.transpose(-1, -2) @ dz.reshape(*hp.shape[:-1], -1)
                for what, got, ref in (("dz = dxg", dz, dz_ref), ("dW_hh", dw, dw_ref)):
                    e = (got - ref).abs().max().item()
                    if not e <= TOL * max(1.0, ref.abs().max().item()) or not torch.isfinite(got).all():
                        fail(f"K1b {shape} {name} route {route}: {what} max |kernel - plain| = {e:.3e} > {TOL} x "
                             f"max(1, |ref|)")
                    err = max(err, e)
                times[name] = cuda_ms(torch, lambda: KB.lstm_adjoint_kernel(gates, c, dh, w, route), reps)
            plain_ms = cuda_ms(torch, lambda: KB.lstm_adjoint_plain(gates, c, dh, w), 1, warmup=0)
        xr, wr = xg.clone().requires_grad_(True), w.clone().requires_grad_(True)
        out = K.LSTMRecurrence.apply(xr, wr)
        backward_ms = cuda_ms(torch, lambda: torch.autograd.grad(out, (xr, wr), dh, retain_graph=True), reps)
        library_ms = library_lstm_backward_ms(torch, xg, w, dh, reps)
        worst = max(worst, err)
        name = "cluster" if chosen[0] else "tile"
        other = "tile" if chosen[0] else "cluster"
        ms = times[name]
        g = 4 * 192
        nbytes = 4 * ndir * (b * t * (g + 2 * 192 + g) + 192 * g)
        ops = ndir * (2 * b * t * g * 192 + 30 * b * t * 192)
        bms, by = bound_ms(nbytes, ops)
        rows.append(dict(shape=shape, route=name, rows=chosen[1], max_abs_err=err, ms=ms, cluster_ms=times["cluster"],
                         tile_ms=times["tile"], plain_ms=plain_ms, backward_ms=backward_ms, library_ms=library_ms,
                         bound_ms=bms, bound_by=by))
        print(f"[K1b] {shape:18s}: max|diff| dz, dW_hh {err:.2e} (both routes); kernel, {name} route {chosen}: "
              f"{ms:.3f} ms ({other} route {routes[other]}: {times[other]:.3f} ms), plain {plain_ms:.3f} ms; whole "
              f"backward (gates, K1b, dW_hh) {backward_ms:.3f} ms; cuDNN nn.LSTM backward {library_ms:.3f} ms; bound "
              f"{bms:.4f} ms ({by}), {bms / ms:.2%} of roofline")
    return rows, worst


def k2_cost(torch, n_img, lanes, d, f, heads, pos, tm, tm_valid, lineage, weights_numel):
    """Bytes and operations one decoder layer step needs for these inputs:
    each input read once, each output written once, counting only the cache
    rows the lineage reaches and the valid memory rows."""
    b = n_img * lanes
    pairs = b * pos  # greedy: each row reads its own slots below pos
    if pos and lineage is not None:  # distinct (row, slot) pairs read below slot pos; slot pos is this step's own
        src = lineage[:, :pos].long() + lanes * (torch.arange(b, device=lineage.device)[:, None] // lanes)
        pairs = (src * pos + torch.arange(pos, device=lineage.device)[None, :]).unique().numel()
    lin_ints = 0 if lineage is None else b * pos
    nbytes = 4 * (weights_numel + 2 * b * d + 2 * b * d + 2 * pairs * d + 2 * tm_valid * d + n_img * tm + lin_ints)
    matvec = 2 * b * (d * 3 * d + 3 * d * d + 2 * d * f)
    attn = 4 * b * (pos + 1) * d + 4 * lanes * tm_valid * d + 6 * heads * (b * (pos + 1) + lanes * tm_valid)
    return nbytes, matvec + attn + 30 * b * d


def phase_k2(torch, weights, cases=None):
    """K2 against its plain version by both routes (the card route at the
    greedy shapes of at most ``geometry.CARD_MAX_ROWS`` rows it takes, and
    the cluster route with its variants), at ``cases`` ((images, lanes,
    window, Tm, greedy), by default those below); ``ms`` is the device time
    of a launch of the route ``geometry.k2_route`` picks (graph_ms),
    ``call_ms`` that of a call from Python (cuda_ms, the wrapper's host time
    included)."""
    from khmer_ocr_torch.ops.kernels import decode_step as K
    from khmer_ocr_torch.ops.kernels import geometry

    d, heads, cache_len = 384, 8, 256
    f = weights["l1_w"].shape[1]
    numel = sum(v.numel() for v in weights.values())
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows, worst = [], 0.0
    # the serving cells' shapes first (1 and 8 images x 3 lanes with lineage; 32 x 1 greedy over memories of 256
    # and 384 rows, and of 128 rows, the greedy batch of 32 in [e2e] and [decode_graph]), with 64 x 3 and memories
    # of 4096; the 64-image grid at 3 lanes; every other lane count the beam widths 1-5 give, and greedy tails
    if cases is None:
        cases = [(n, 3, 64, tm, False) for n in (1, 8, 64) for tm in (256, 384, 1024, 4096)]
        cases += [(32, 1, w, tm, True) for w in (64, 160) for tm in (256, 384)]
        cases += [(32, 1, 64, 128, True), (32, 1, 160, 4096, True)]
        cases += [(64, 3, w, tm, False) for w in (32, 128, 256) for tm in (32, 256, 1024, 4096)]
        cases += [(64, lanes, 64, 256, False) for lanes in (1, 2, 4, 5)]
        cases += [(1, 1, 64, 4096, True), (8, 1, 64, 256, True), (11, 1, 160, 384, True)]
    for n_img, lanes, w, tm, greedy in cases:
        x, sk, sv, mk, mv, mvf, lin, tm_valid = k2_inputs(torch, gen, n_img, lanes, d, tm, cache_len, w)
        lin = None if greedy else lin
        err, untouched = 0.0, True
        # the card route (where it takes the shape) at the window's first, middle and last slot, then every
        # variant at the last
        _, clusters, ctas = geometry.k2_geometry(n_img, lanes, heads, tm)
        split = ctas // heads
        built = 2 if geometry.k2_two_ctas_an_sm(clusters, ctas) else 1  # CTAs an SM the cluster library is bounded for
        other = 3 - split if clusters * 2 * heads <= geometry.SMS else None
        card = greedy and lanes == 1 and n_img <= geometry.CARD_MAX_ROWS
        variants = {"card": dict(route="card")} if card else {}
        variants["cluster"] = dict(route="cluster")
        if other is not None:
            variants["cluster_other_split"] = dict(route="cluster", split=other)
        variants["cluster_other_library"] = dict(route="cluster", ctas_an_sm=3 - built)
        caches = {}
        for name, extra in variants.items():
            for pos in ((0, w // 2, w - 1) if name == "card" else (w - 1,)):
                at = torch.tensor(pos, dtype=torch.int32, device="cuda")  # K2 reads the position on the card
                sk_o, sv_o, sk_p, sv_p = sk.clone(), sv.clone(), sk.clone(), sv.clone()
                out = K.decoder_layer_step_kernel(weights, x, at, sk_o, sv_o, mk, mv, mvf, lin, num_heads=heads,
                                                  window=w, lanes=lanes, **extra)
                ref = K.decoder_layer_step_plain(weights, x, pos, sk_p, sv_p, mk, mv, mvf, lin, num_heads=heads,
                                                 window=w, lanes=lanes)
                torch.cuda.synchronize()
                e = max((out - ref).abs().max().item(), (sk_o[:, pos] - sk_p[:, pos]).abs().max().item(),
                        (sv_o[:, pos] - sv_p[:, pos]).abs().max().item())
                keep = torch.ones(cache_len, dtype=torch.bool, device="cuda")
                keep[pos] = False
                same = torch.equal(sk_o[:, keep], sk[:, keep]) and torch.equal(sv_o[:, keep], sv[:, keep])
                if not e <= TOL or not same or not torch.isfinite(out).all():
                    fail(f"K2 decoder_layer_step {name} {n_img}x{lanes} w={w} Tm={tm} pos={pos}: max|diff| {e:.3e} "
                         f"(tol {TOL}), untouched slots identical: {same}")
                err, untouched = max(err, e), untouched and same
            caches[name] = (at, sk_o, sv_o)
        worst = max(worst, err)
        route = geometry.k2_route(n_img, lanes, tm, 4, False, d, heads, f)
        shape = f"{'greedy ' if greedy else ''}{n_img}x{lanes} w={w} Tm={tm}"
        at = caches["cluster"][0]  # the window's last slot
        step = lambda: K.decoder_layer_step(weights, x, at, sk, sv, mk, mv, mvf, lin, num_heads=heads,
                                            window=w, lanes=lanes)
        ms = graph_ms(torch, step)
        call_ms = cuda_ms(torch, step, 20)
        times = {name: graph_ms(torch, lambda: K.decoder_layer_step_kernel(
            weights, x, c[0], c[1], c[2], mk, mv, mvf, lin, num_heads=heads, window=w, lanes=lanes,
            **variants[name])) for name, c in caches.items()}
        plain_ms = cuda_ms(torch, lambda: K.decoder_layer_step_plain(weights, x, w - 1, sk, sv, mk, mv, mvf,
                                                                     lin, num_heads=heads, window=w,
                                                                     lanes=lanes), 2)
        nbytes, ops = k2_cost(torch, n_img, lanes, d, f, heads, w - 1, tm, tm_valid, lin, numel)
        bms, by = bound_ms(nbytes, ops)
        rows.append(dict(shape=shape, route=route, ctas_per_head=split, ctas_an_sm=built, max_abs_err=err, ms=ms,
                         call_ms=call_ms, card_ms=times.get("card"), cluster_ms=times["cluster"],
                         other_split_ms=times.get("cluster_other_split"),
                         other_library_ms=times["cluster_other_library"], plain_ms=plain_ms, library_ms=None,
                         bound_ms=bms, bound_by=by))
        also = "" if other is None else f", {other} CTA(s) a head {times['cluster_other_split']:.4f}"
        card_says = (f"card {times['card']:.4f} ms (checked at pos 0, {w // 2}, {w - 1}); " if card else
                     "card route: not for this shape; ")
        print(f"[K2] {shape:22s}: max|diff| {err:.2e} (every variant at pos {w - 1}), untouched slots identical; "
              f"{route} route picked: {ms:.4f} ms (a call from Python {call_ms:.4f} ms); {card_says}cluster, "
              f"{split} CTA(s) a head, {built} CTA(s) an SM: {times['cluster']:.4f} ms (the library for {3 - built} "
              f"CTA(s) an SM {times['cluster_other_library']:.4f}{also}); plain {plain_ms:.3f} ms, bound {bms:.4f} ms "
              f"({by}), {bms / ms:.2%} of roofline")
    beside = k2_beside_convolutions(torch, weights, gen)
    return rows, worst, beside


def k2_beside_convolutions(torch, weights, gen, steps: int = 400):
    """The card route's layer steps (replayed CUDA graphs, 32 x 1 greedy at Tm
    384) while a second stream runs a ResNet block's float32 3x3
    convolutions at the same time, as the dispatch stage's encode runs beside
    the decode: it must end, and its outputs and cache slots must equal those
    of the same replays alone, bit for bit."""
    from khmer_ocr_torch.ops.kernels import decode_step as K

    n_img, lanes, w, tm, heads = 32, 1, 160, 384, 8
    x, sk, sv, mk, mv, mvf, _, _ = k2_inputs(torch, gen, n_img, lanes, 384, tm, 256, w)
    lin = None  # greedy
    at = torch.tensor(w - 1, dtype=torch.int32, device="cuda")
    outs = []
    step = lambda: outs.append(K.decoder_layer_step(weights, x, at, sk, sv, mk, mv, mvf, lin, num_heads=heads,
                                                    window=w, lanes=lanes))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    outs.clear()
    with torch.cuda.graph(graph):
        step()
    out = outs[0]
    conv_in = torch.randn(32, 256, 12, 100, device="cuda", generator=gen)
    conv_w = torch.randn(256, 256, 3, 3, device="cuda", generator=gen) * 0.02

    def replays():
        for _ in range(steps):
            graph.replay()

    replays()
    torch.cuda.synchronize()
    alone = (out.clone(), sk[:, w - 1].clone(), sv[:, w - 1].clone())
    conv_stream = torch.cuda.Stream()
    t0 = time.perf_counter()
    with torch.cuda.stream(conv_stream):
        y = conv_in
        for _ in range(60):
            y = torch.nn.functional.conv2d(y, conv_w, padding=1).relu_()
    replays()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    equal = (torch.equal(out, alone[0]) and torch.equal(sk[:, w - 1], alone[1])
             and torch.equal(sv[:, w - 1], alone[2]))
    if not equal:
        fail("K2's card route beside convolutions on another stream: outputs differ from its replays alone")
    print(f"[K2] card route beside a second stream's 60 convolutions (32 x 256 x 12 x 100, 3x3, f32): {steps} "
          f"replays of 32x1 Tm=384 ended, outputs and cache slots bit-equal to the replays alone; {seconds:.3f} s")
    return dict(steps=steps, seconds=seconds, equal=equal)


def teacher_forced_score(torch, params, cfg, lines_u8, count, seq):
    """Sum of log-probs of ``seq`` after <sos> over its length, under the
    plain path (the beam's normalisation), for one uint8 line."""
    from khmer_ocr_torch.models.ocr_model import encode
    from khmer_ocr_torch.ops.lines import device_chunk, u8_to_unit, unit_normalize

    with torch.inference_mode(), PlainPath():
        chunks = device_chunk(unit_normalize(u8_to_unit(lines_u8)), (100, 84))
        memory, pad = encode(params, chunks, count, cfg)
    return memory_score(torch, params, cfg, memory, pad, seq)


def memory_score(torch, params, cfg, memory, pad, seq):
    """``teacher_forced_score`` for one image's memory (1, Tm, D)."""
    from khmer_ocr_torch.models.layers import dense
    from khmer_ocr_torch.models.ocr_model import init_decode_state, pack_decode_params
    from khmer_ocr_torch.ops.kernels.decode_step import decoder_layer_step_plain

    with torch.inference_mode():
        state = init_decode_state(params, memory, pad, cfg, lanes=1, cache_len=len(seq))
        dec = pack_decode_params(params)["dec"]
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
        import khmer_ocr_torch.decode.beam as bm
        import khmer_ocr_torch.models.bilstm as bl
        import khmer_ocr_torch.models.ocr_model as om
        from khmer_ocr_torch.ops.kernels import beam_step, decode_loop, decode_step, lstm

        self._saved = (bl.lstm_recurrence, om.decoder_layer_step, bm.fused_beam_decode, bm.search_step)
        bl.lstm_recurrence = lstm.lstm_recurrence_plain
        om.decoder_layer_step = decode_step.decoder_layer_step_plain
        bm.fused_beam_decode = decode_loop.fused_beam_decode_plain
        bm.search_step = beam_step.search_step_plain
        return self

    def __exit__(self, *exc):
        import khmer_ocr_torch.decode.beam as bm
        import khmer_ocr_torch.models.bilstm as bl
        import khmer_ocr_torch.models.ocr_model as om

        bl.lstm_recurrence, om.decoder_layer_step, bm.fused_beam_decode, bm.search_step = self._saved
        return False


class PlainSearch:
    """Within this block the beam search's bookkeeping runs as the plain
    version's torch ops (log_softmax, beam_advance) on the card instead of
    kernel K5; the decode's graphs key on it, so each path keeps its own."""

    def __enter__(self):
        import khmer_ocr_torch.decode.beam as bm
        from khmer_ocr_torch.ops.kernels import beam_step

        self._saved = bm.search_step
        bm.search_step = beam_step.search_step_plain
        return self

    def __exit__(self, *exc):
        import khmer_ocr_torch.decode.beam as bm

        bm.search_step = self._saved
        return False


def k3_cost(n_img, k, d, f, heads, max_len, tm, tm_valid, n_layers, vocab, layer_mat, layer_vec, itemsize=4):
    """Bytes and operations of the whole beam decode for these inputs: every
    layer's weights, the head and the embeddings read once, the valid memory
    K/V rows once, the tokens and scores written once; per step and lane the
    operations of k2_cost for every layer, plus the head's 2 D V. The weight
    matrices, embeddings, head weight and memory K/V are ``itemsize`` bytes
    an element (the storage type), the vectors, head bias, mask, tokens and
    scores 4."""
    b = n_img * k
    nbytes = (itemsize * (n_layers * layer_mat + 2 * d * vocab + max_len * d + 2 * n_layers * tm_valid * d)
              + 4 * (n_layers * layer_vec + vocab + n_img * tm + n_img * (max_len + 2) + n_img * (k + 1)))
    pos_sum = max_len * (max_len + 1) // 2  # attended self positions, summed over the steps
    per_layer = (2 * b * (d * 3 * d + 3 * d * d + 2 * d * f) * max_len + 4 * b * pos_sum * d
                 + 4 * k * tm_valid * d * max_len + 6 * heads * (b * pos_sum + k * tm_valid * max_len)
                 + 30 * b * d * max_len)
    return nbytes, n_layers * per_layer + max_len * b * 2 * d * vocab


def layer_numels(lw: dict) -> tuple[int, int]:
    """(elements of a packed layer's weight matrices, of its vectors)."""
    from khmer_ocr_torch.ops.kernels.decode_step import MATRIX_FIELDS

    return (sum(v.numel() for k, v in lw.items() if k in MATRIX_FIELDS),
            sum(v.numel() for k, v in lw.items() if k not in MATRIX_FIELDS))


def timed(torch, fn):
    """(fn(), its device time in ms) for one call."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def k3_agree(torch, shape, prm, cfg, memory, pad, got, ref):
    """K3's tokens and scores against the plain version's, image by image:
    (max score difference where the tokens are equal, images that differ);
    fails unless each differing image is a near-tie."""
    (tok, sc), (tok_p, sc_p) = got, ref
    err, n_diff = 0.0, 0
    for i in range(memory.shape[0]):
        if torch.equal(tok[i], tok_p[i]):
            e = (sc[i] - sc_p[i]).abs().max().item()
            if not e <= TOL * max(1.0, sc_p[i].abs().max().item()):
                fail(f"K3 {shape}: image {i} scores differ by {e:.3e}")
            err = max(err, e)
            continue
        n_diff += 1
        a, b = strip(tok_p[i].tolist()), strip(tok[i].tolist())
        s_ref, s_got = (memory_score(torch, prm, cfg, memory[i:i + 1], pad[i:i + 1], torch.tensor(t, device="cuda"))
                        for t in (a, b))
        print(f"[K3] {shape}: image {i} differs: {a} vs {b}; normalised scores {s_ref:.7f} vs {s_got:.7f}")
        if not abs(s_ref - s_got) < NEAR_TIE:
            fail(f"K3 {shape}: image {i} differs and is not a near-tie")
    return err, n_diff


def phase_k3(torch, params, cfg):
    """K3 against its plain version on seeded flagship decoder weights and
    random memories with ragged validity, by the route geometry.k3_geometry
    picks and, for the K = 3 cases at Tm = 128 and max_len 64, also with the
    self caches forced to global memory; the step loop (K2, its CUDA graphs) is timed on
    the same inputs as the yardstick."""
    import dataclasses

    from khmer_ocr_torch.config import DecodeConfig
    from khmer_ocr_torch.decode.beam import beam_decode
    from khmer_ocr_torch.cuda_graphs import GraphCache
    from khmer_ocr_torch.models.ocr_model import pack_decode_params
    from khmer_ocr_torch.ops.kernels import decode_loop as K
    from khmer_ocr_torch.ops.kernels import geometry

    d, f, heads, n_layers, vocab = cfg.emb_dim, cfg.dec_ffn_dim, cfg.num_heads, cfg.dec_layers, cfg.vocab_size
    layer_numel = layer_numels(pack_decode_params(params)["dec"]["layers_kernel"][0])
    eos_params = {**params, "dec": {**params["dec"], "out": dict(params["dec"]["out"])}}
    eos_params["dec"]["out"]["b"] = params["dec"]["out"]["b"].clone()
    eos_params["dec"]["out"]["b"][3] += 4.0  # <eos>: completions retire early
    tie_params = {**params, "dec": {**params["dec"], "out": dict(params["dec"]["out"])}}
    w, bias = params["dec"]["out"]["w"].clone(), params["dec"]["out"]["b"].clone()
    w[:, 11], w[:, 21], bias[11], bias[21] = w[:, 10], w[:, 20], bias[10], bias[20]
    tie_params["dec"]["out"].update(w=w, b=bias)  # exact ties every step

    cases = [("", params, 8, tm, k, ml) for ml in (16, 64) for k in (2, 3, 4) for tm in (32, 64, 96, 128)]
    cases += [("", params, 64, 128, 3, 64), ("eos ", eos_params, 8, 64, 3, 64), ("ties ", tie_params, 8, 64, 3, 64),
              ("", params, 1, 128, 3, 64)]
    vp = geometry.k3_vocab_cols(vocab, heads)
    resident = {route: K.resident_clusters(3, d, heads, f, 64, vp, n_layers, route, 128) for route in (True, False)}
    print(f"[K3] clusters of {heads} CTAs the card holds at once (beam 3, Tm=128, max_len 64): {resident[True]} "
          f"with the self caches on chip, {resident[False]} with them in global memory; more images run in waves")
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows, worst = [], 0.0
    cache = GraphCache()  # the step loop's graphs, captured at each shape's first call
    for tag, prm, n_img, tm, k, ml in cases:
        memory = torch.randn(n_img, tm, d, device="cuda", generator=gen) * 0.5
        valid_len = torch.randint(1, tm + 1, (n_img,), device="cuda", generator=gen)
        pad = torch.arange(tm, device="cuda")[None, :] >= valid_len[:, None]
        dec = DecodeConfig(beam_width=k, max_len=ml)
        shape = f"{tag}{n_img}x{k} Tm={tm} max_len={ml}"
        ctas, on_chip, tc = geometry.k3_geometry(k, d, heads, f, ml, vocab, n_layers, tm)
        # the K = 3 cases at the gate's largest sizes also on the global route
        forced = (True, False) if (tag, k, tm, ml) == ("", 3, 128, 64) and n_img > 1 else (on_chip,)
        with torch.inference_mode():
            ref, plain_ms = timed(torch, lambda: K.fused_beam_decode_plain(prm, memory, pad, cfg, dec,
                                                                           return_scores=True))
            err, n_diff, route_ms = 0.0, 0, {}
            for route in forced:
                got = K.fused_beam_decode_kernel(prm, memory, pad, cfg, dec, return_scores=True, on_chip=route)
                e, n = k3_agree(torch, f"{shape} {'on chip' if route else 'global'}", prm, cfg, memory, pad, got,
                                ref)
                err, n_diff = max(err, e), max(n_diff, n)
                route_ms[route] = cuda_ms(torch, lambda: K.fused_beam_decode_kernel(prm, memory, pad, cfg, dec,
                                                                                    on_chip=route), 3)
            worst = max(worst, err)
            ms = route_ms[on_chip]
            host_ms = cuda_ms(torch, lambda: beam_decode(prm, memory, pad, cfg, dataclasses.replace(dec, mega_mode="0"),
                                                         graph_cache=cache), 2)
        nbytes, ops = k3_cost(n_img, k, d, f, heads, ml, tm, int(valid_len.sum()), n_layers, vocab, *layer_numel)
        bms, by = bound_ms(nbytes, ops)
        route = "on chip" if on_chip else "global"
        rows.append(dict(shape=shape, route=route, ctas_per_cluster=ctas, chunk=tc, max_abs_err=err, ms=ms,
                         global_ms=route_ms.get(False), on_chip_ms=route_ms.get(True), plain_ms=plain_ms,
                         step_loop_ms=host_ms, library_ms=None, bound_ms=bms, bound_by=by, images_differing=n_diff))
        also = "" if len(route_ms) == 1 else f" (self caches forced global: {route_ms[False]:.3f} ms)"
        print(f"[K3] {shape:27s}: {n_img} cluster(s) of {ctas} CTAs, self caches {route}; tokens equal plain "
              f"({n_diff} near-ties), scores max|diff| {err:.2e}; kernel {ms:.3f} ms{also}, plain {plain_ms:.3f} ms, "
              f"step loop (K2 graphs) {host_ms:.3f} ms, bound {bms:.4f} ms ({by}), {bms / ms:.2%} of roofline")
    return rows, worst, resident[True]


def k5_cost(n_img, k, v, lp, c) -> tuple[int, int]:
    """Bytes and operations of one K5 launch: the logits read, the tokens and
    lineage read and written, the running scores read and written, the best
    score read, the position and a length denominator; per logit the
    log-softmax's max, subtract, exp and add and one compare a top-K pass,
    per candidate the add and compare of each next-beam pass."""
    nbytes = 4 * n_img * k * v + 2 * 8 * n_img * k * lp + 2 * 4 * n_img * k * c + 4 * (2 * n_img * k + n_img + 2)
    return nbytes, n_img * k * v * (4 + k) + n_img * k * k * (2 * k + 2)


def k5_agree(torch, label, st, x, dec, log_probs) -> dict:
    """K5 and the plain version from copies of one state: tokens, lineage
    (the parents at slot pos among them) and best tokens must be equal;
    returns the scores' and best scores' max |diff| (0 required on
    log-probs: the same f32 adds and divides)."""
    from khmer_ocr_torch.ops.kernels import beam_step

    got, ref = ({key: t.clone() for key, t in st.items()} for _ in range(2))
    beam_step.search_step_kernel(got, x, got["pos"], dec, log_probs=log_probs)
    beam_step.search_step_plain(ref, x, ref["pos"], dec, log_probs=log_probs)
    torch.cuda.synchronize()
    for key in ("tokens", "lineage", "best_done_tokens"):
        if not torch.equal(got[key], ref[key]):
            rows = (got[key] != ref[key]).reshape(got[key].shape[0], -1).any(1).nonzero().flatten().tolist()
            fail(f"K5 {label}: {key} differ from the plain version's in images {rows}")
    err = {key: (got[key] - ref[key]).abs().max().item() for key in ("scores", "best_done_score")}
    if log_probs and any(err.values()):
        fail(f"K5 {label}, on log-probs: scores differ from the plain version's by {err}")
    return err


def phase_beam_step(torch, params, cfg, smi):
    """K5 (the beam search's step, csrc/beam_step.cu) against its plain
    version (log_softmax + beam_advance) at 8 x 3 and 64 x 3 lanes, V 124,
    max_len 64, at positions 0, 31 and 63 of a search driven by random
    logits with a growing <eos> bias: on log-probs (the fused head's input)
    every output bit-equal, on logits the tokens, lineage and best tokens
    equal and the scores' gap reported (at position 0 the new scores are
    lane 0's top-3 log-probs: the log-softmax's gap from torch's). Its
    device time from a replayed CUDA graph beside the plain version's, its
    bound and share; the 64-step decode of phase_k3 (seeded flagship
    decoder, Tm 128) by the step loop's graphs with K5 and with the plain
    search, in turns, tokens equal (near-ties excepted); the flagship's 64
    real lines served with each, K5 launched once a replayed step."""
    import dataclasses

    from khmer_ocr_torch.config import DecodeConfig
    from khmer_ocr_torch.cuda_graphs import GraphCache
    from khmer_ocr_torch.decode.beam import beam_decode, beam_state
    from khmer_ocr_torch.infer.predictor import Predictor
    from khmer_ocr_torch.ops.kernels import beam_step, build

    lib = build.load("beam_step")
    lib.beam_step_smem_bytes.argtypes = [ctypes.c_int] * 3
    if lib.beam_step_smem_bytes(3, 66, 64) != beam_step.smem_bytes(3, 66, 64) \
            or lib.beam_step_max_lanes() != beam_step.MAX_LANES:
        fail("K5: the library's shared memory or lane limit differs from ops/kernels/beam_step.py's")
    k, v, max_len = 3, cfg.vocab_size, 64
    dec = DecodeConfig(beam_width=k, max_len=max_len)
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows, out = [], {"smi": smi}
    with torch.inference_mode():
        for n_img in (8, 64):
            st = beam_state(n_img, k, max_len, dec, "cuda")
            errs = {}
            for pos in range(max_len):
                logits = torch.randn(n_img * k, v, device="cuda", generator=gen) * 3.0
                logits[:, dec.eos_idx] += pos / 16.0  # completions grow likelier along the search
                logp = torch.log_softmax(logits, dim=-1)
                if pos in (0, 31, 63):
                    label = f"{n_img}x{k} V={v} pos={pos}"
                    k5_agree(torch, label, st, logp, dec, True)
                    errs[pos] = k5_agree(torch, label, st, logits, dec, False)
                    print(f"[beam_step] {label}: on log-probs every output bit-equal to the plain version; on logits "
                          f"tokens, lineage and best tokens equal, scores max|diff| {errs[pos]['scores']:.3e}, best "
                          f"scores {errs[pos]['best_done_score']:.3e}"
                          + (" (lane 0's top-3 log-probs against torch.log_softmax's)" if pos == 0 else ""))
                beam_step.search_step_plain(st, logits, st["pos"], dec, log_probs=False)
                st["pos"].add_(1)
            done = int((st["best_done_score"] > -1e29).sum())
            # device time at position 31 (the launch rewrites its own state: the same work every replay)
            st["pos"].fill_(31)
            logits = torch.randn(n_img * k, v, device="cuda", generator=gen) * 3.0
            kst = {key: t.clone() for key, t in st.items()}
            pst = {key: t.clone() for key, t in st.items()}
            ms = graph_ms(torch, lambda: beam_step.search_step_kernel(kst, logits, kst["pos"], dec, log_probs=False))
            plain_ms = graph_ms(torch, lambda: beam_step.search_step_plain(pst, logits, pst["pos"], dec,
                                                                           log_probs=False))
            call_ms = cuda_ms(torch, lambda: beam_step.search_step_kernel(kst, logits, kst["pos"], dec,
                                                                         log_probs=False), 50)
            bms, by = bound_ms(*k5_cost(n_img, k, v, max_len + 2, max_len))
            rows.append(dict(shape=f"{n_img}x{k} V={v} max_len={max_len}", ms=ms, plain_ms=plain_ms, call_ms=call_ms,
                             library_ms=None, bound_ms=bms, bound_by=by, log_prob_gap=errs[0]["scores"],
                             score_gap=max(e["scores"] for e in errs.values()), completed_images=done))
            print(f"[beam_step] {n_img}x{k} V={v} max_len={max_len}: {done}/{n_img} images completed by step 63; K5 "
                  f"{ms:.4f} ms (a replayed graph; {call_ms:.4f} ms a call from Python), plain {plain_ms:.4f} ms, "
                  f"bound {bms:.6f} ms ({by}), {bms / ms:.2%} of roofline, on {smi}")

        # the 64-step decode of phase_k3's 8 x 3 and 64 x 3, Tm 128 rows, by the step loop's graphs
        d = cfg.emb_dim
        cache = GraphCache()
        step_loop = {}
        for n_img in (8, 64):
            memory = torch.randn(n_img, 128, d, device="cuda", generator=gen) * 0.5
            valid_len = torch.randint(1, 129, (n_img,), device="cuda", generator=gen)
            pad = torch.arange(128, device="cuda")[None, :] >= valid_len[:, None]
            ddec = dataclasses.replace(dec, mega_mode="0")
            run = lambda: beam_decode(params, memory, pad, cfg, ddec, graph_cache=cache)
            times, toks = {"k5": [], "plain": []}, {}
            for path in ("k5", "plain", "plain", "k5"):
                with PlainSearch() if path == "plain" else contextlib.nullcontext():
                    toks[path] = run()  # the shape's graphs captured at its first call
                    times[path].append(cuda_ms(torch, run, 2))
            differ = [i for i in range(n_img) if not torch.equal(toks["k5"][i], toks["plain"][i])]
            for i in differ:
                a, b = (strip(toks[pth][i].tolist()) for pth in ("plain", "k5"))
                s_ref, s_got = (memory_score(torch, params, cfg, memory[i:i + 1], pad[i:i + 1],
                                             torch.tensor(t, device="cuda")) for t in (a, b))
                print(f"[beam_step] step loop {n_img}x{k}: image {i} differs: {a} vs {b}; scores {s_ref:.7f} vs "
                      f"{s_got:.7f}")
                if not abs(s_ref - s_got) < NEAR_TIE:
                    fail(f"K5 step loop {n_img}x{k}: image {i} differs from the plain search and is not a near-tie")
            step_loop[f"{n_img}x{k}"] = dict(k5_ms=times["k5"], plain_ms=times["plain"], images_differing=len(differ))
            print(f"[beam_step] 64-step decode {n_img}x{k} Tm=128 by the step loop's graphs: with K5 "
                  f"{fmt_gaps(times['k5'])} ms, with the plain search {fmt_gaps(times['plain'])} ms (in turns); "
                  f"{n_img - len(differ)}/{n_img} images token-equal on {smi}")
        del cache
    out.update(rows=rows, step_loop=step_loop)

    # the flagship's 64 real lines: K5 once a replayed step, strings as JAX's, lines/s with each search
    assets = ROOT / "khmer_ocr_torch" / "assets"
    meta = json.loads((assets / "real_lines.json").read_text())
    lines = [line for line, _ in real_samples(len(meta["texts"]))]
    bw, max_len, bs = (meta["recipe"][key] for key in ("beam_width", "max_len", "batch_size"))
    pred = Predictor(model_path=FLAGSHIP)
    walls = {"k5": [], "plain": []}
    for path in ("k5", "plain", "plain", "k5"):
        with PlainSearch() if path == "plain" else contextlib.nullcontext():
            pred.predict_batch_tokens(lines, beam_width=bw, batch_size=bs, max_len=max_len)  # warm-up
            got, c, wall = counted_run(torch, pred, lines, bw, bs, max_len)
        walls[path].append(wall * 1e3)
        strings = [pred.tokenizer.decode(r) for r in got]
        equal = sum(a == b for a, b in zip(strings, meta["strings"]))
        want_k5 = c["replayed_steps"] if path == "k5" else 0
        if c["k5"] != want_k5 or c["eager_steps"] or c["captures"] or equal != len(lines):
            fail(f"K5 serving, {path} search: K5 launches {c['k5']} against {want_k5} ({c['replayed_steps']} "
                 f"replayed steps), {c['eager_steps']} steps by the Python loop, {c['captures']} captures; "
                 f"{equal}/{len(lines)} strings equal to JAX's")
        out[f"serve_{path}"] = c
    print(f"[beam_step] the flagship's {len(lines)} real lines, beam {bw}, batch {bs}: K5 {fmt_gaps(walls['k5'])} ms, "
          f"the plain search {fmt_gaps(walls['plain'])} ms (in turns); K5 launched {out['serve_k5']['k5']} times in "
          f"{out['serve_k5']['replayed_steps']} replayed steps; strings equal to JAX's on {smi}")
    out["serve_walls_ms"] = walls
    del pred
    return out


def phase_k4(torch):
    """K4's own path: the probe's ladder and bisection, launches counted;
    its answer against the device attribute; row 0 against the plain version."""
    import ctypes

    from khmer_ocr_torch.ops.kernels import build
    from khmer_ocr_torch.ops.kernels import smem_probe as K

    build.reset_launches()
    best, refused = K.probe_max_bytes(log=lambda m: print(f"[K4] {m}"))
    launches = build.launches["k4"]
    attr = K.max_optin_bytes(0)
    above = K.try_bytes(best + K.STEP)
    x = K.probe_input()
    out = K.smem_probe(x, best)
    plain = K.smem_probe_plain(x)
    err = (out - plain).abs().max().item()
    print(f"[K4] largest dynamic shared memory that launches: {best} bytes (refused at {refused}, "
          f"{best + K.STEP} launches: {above}); cudaDevAttrMaxSharedMemoryPerBlockOptin {attr}; "
          f"max|kernel - plain| {err:.1e}; {launches} launches")
    if abs(best - attr) > K.STEP or above or err != 0.0:
        fail(f"K4 probe: {best} bytes vs attribute {attr} (within {K.STEP}), {best + K.STEP} refused: "
             f"{not above}, max|diff| {err}")
    ms = cuda_ms(torch, lambda: K.smem_probe(x, best), 10)
    plain_ms = cuda_ms(torch, lambda: K.smem_probe_plain(x), 10)
    bms, by = bound_ms(2 * x.numel() * 4, 2 * x.shape[1])
    # the floor under a launch-and-synchronise: one empty kernel, timed the same way
    empty = build.load("smem_probe").empty_launch
    empty.argtypes, empty.restype = [ctypes.c_void_p], ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    build.check(empty(stream), "empty_launch")
    empty_ms = cuda_ms(torch, lambda: empty(stream), 10)
    # the launcher alone, on the same pointers and stream: the probe's launch without the wrapper's tensor work
    launcher, xp, op = K._launcher(), x.data_ptr(), out.data_ptr()
    launcher_ms = cuda_ms(torch, lambda: launcher(xp, op, best, stream), 10)
    print(f"[K4] {ms:.4f} ms a probe launch (empty output, launch, synchronise; the attribute set once) = "
          f"{ms / empty_ms:.2f}x one empty launch and synchronise {empty_ms:.4f} ms; the launcher alone "
          f"{launcher_ms:.4f} ms; plain {plain_ms:.4f} ms")
    return dict(shape=f"(8, 128) through {best} B", max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bms, bound_by=by, launches=launches, max_bytes=best, refused_bytes=refused,
                attribute_bytes=attr, empty_launch_ms=empty_ms, launcher_ms=launcher_ms)


class PlainLSTM:
    """Within this block the LSTM's training path (forward with cells and
    the adjoint) runs the plain versions of K1 and K1b on the card."""

    def __enter__(self):
        from khmer_ocr_torch.ops.kernels import lstm, lstm_backward

        self._saved = (lstm.lstm_recurrence, lstm_backward.lstm_adjoint)
        lstm.lstm_recurrence = lstm.lstm_recurrence_plain
        lstm_backward.lstm_adjoint = lstm_backward.lstm_adjoint_plain
        return self

    def __exit__(self, *exc):
        from khmer_ocr_torch.ops.kernels import lstm, lstm_backward

        lstm.lstm_recurrence, lstm_backward.lstm_adjoint = self._saved
        return False


def train_counts():
    """Launch counts of the kernels the train step runs (K1, K1b) and of the others."""
    from khmer_ocr_torch.ops.kernels import build

    return {"k1": build.launches["k1"], "k1b": build.launches["k1b"],
            "other": sum(build.launches[k] for k in ("k2", "k3", "k4"))}


def reset_counts():
    import torch

    from khmer_ocr_torch.ops.kernels import build

    torch.cuda.synchronize()
    build.reset_launches()


def padded_lines_batch(chunk_counts, seed: int, labels) -> dict:
    """synthetic_samples' lines, white-padded to the widest line's chunk
    bucket, with the given labels (the golden file's batch)."""
    import numpy as np

    from khmer_ocr_torch.config import PreprocessConfig
    from khmer_ocr_torch.data.synthetic import synthetic_lines

    pre = PreprocessConfig()
    wb = (max(chunk_counts) - 1) * pre.chunk_stride + pre.chunk_width
    lines = synthetic_lines(chunk_counts, seed)
    out = np.full((len(lines), pre.img_height, wb), 255, np.uint8)
    widths = np.array([min(l.shape[1], wb) for l in lines], np.int32)
    for i, (line, w) in enumerate(zip(lines, widths)):
        out[i, :, :w] = line[:, :w]
    counts = np.array([pre.num_chunks(int(w)) for w in widths], np.int32)
    return {"lines": out, "widths": widths, "chunk_counts": counts, "labels": np.asarray(labels, np.int32)}


def bucket_batch(chunks: int, batch: int, max_label: int, seed: int):
    """One batch of ``batch`` synthetic lines of ``chunks`` chunks through the
    port's LineDataset ("lines" layout), labels cut to ``max_label``."""
    import numpy as np

    from khmer_ocr_torch.data.synthetic import synthetic_samples
    from khmer_ocr_torch.train.data import LineDataset

    ds = LineDataset(synthetic_samples([chunks] * batch, seed), device_augment=True)
    return next(ds.epoch_batches(batch, np.random.default_rng(seed), max_label_len=max_label))


GRAPH_STEPS = 8  # steps of each eager-against-graph run (the group's run takes two groups of them)
GRAPH_TOL = 1e-5  # losses (relative) and params (absolute) of the graphed steps against the eager steps


def train_steps_by(torch, cfg, batch, aug: float, mode: str, steps: int, seed: int = 0):
    """``steps`` train steps from the seeded state on ``batch`` (lr 1e-4,
    the device generator seeded by ``seed``) by ``mode``: "eager" (the step
    maker without graphs), "graph" (the one-step graph, captured at the
    first step) or "group" (groups of GRAPH_STEPS steps as one graph) ->
    (losses, params, the launch counts, the TrainGraphs or None)."""
    from khmer_ocr_torch.train.graphs import TrainGraphs
    from khmer_ocr_torch.train.step import init_train_state, make_train_multi_step, make_train_step, tree_leaves

    graphs = None if mode == "eager" else TrainGraphs()
    state = init_train_state(cfg, 0, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    reset_counts()
    losses = []
    if mode == "group":
        multi = make_train_multi_step(cfg, (100, 84), aug, graphs=graphs)
        stacked = {k: torch.stack([v] * GRAPH_STEPS) for k, v in batch.items()}
        for _ in range(steps // GRAPH_STEPS):
            state, m = multi(state, stacked, gen, [1e-4] * GRAPH_STEPS)
            losses += list(m["loss"])
    else:
        step = make_train_step(cfg, (100, 84), aug, graphs=graphs)
        for _ in range(steps):
            state, m = step(state, batch, gen, 1e-4)
            losses.append(m["loss"])
    torch.cuda.synchronize()
    return torch.stack(losses).tolist(), [t.detach().clone() for t in tree_leaves(state.params)], train_counts(), graphs


def train_graphs_agree(torch, cfg, batch, aug: float, label: str, modes=("graph", "group")) -> dict:
    """The one-step graph over GRAPH_STEPS steps and the group over two
    groups (``modes``) against the eager steps from the same state, batch
    and generator seed (cuDNN deterministic, so that both take the same
    sums): losses within GRAPH_TOL relative, params within GRAPH_TOL, K1
    and K1b once a step (the replays' counts moved from each capture)."""
    from khmer_ocr_torch.train import graphs as tgraphs

    torch.backends.cudnn.deterministic = True
    try:
        out = {}
        for mode in modes:
            steps = GRAPH_STEPS if mode == "graph" else 2 * GRAPH_STEPS
            el, ep, _, _ = train_steps_by(torch, cfg, batch, aug, "eager", steps)
            tgraphs.reset_counts()
            gl, gp, counts, graphs = train_steps_by(torch, cfg, batch, aug, mode, steps)
            (entry,) = graphs.shapes.values()
            loss_rel = max(abs(a - b) / abs(b) for a, b in zip(gl, el))
            param_err = max((a - b).abs().max().item() for a, b in zip(gp, ep))
            k = 1 if mode == "graph" else GRAPH_STEPS
            a_replay = dict(+entry.graph.launches)
            row = dict(steps=steps, loss_rel=loss_rel, param_err=param_err, k1=counts["k1"], k1b=counts["k1b"],
                       replays=tgraphs.replays, replayed_steps=tgraphs.replayed_steps, counts_a_replay=a_replay,
                       first_losses=[round(v, 6) for v in gl[:3]])
            print(f"[train] {label}, {mode} against eager, {steps} steps: losses rel {loss_rel:.1e}, params "
                  f"|diff| {param_err:.1e}; launches K1 {counts['k1']}, K1b {counts['k1b']} ({a_replay} a replay, "
                  f"{tgraphs.replays} replays of {tgraphs.replayed_steps} steps); losses {row['first_losses']} ...")
            if not (loss_rel <= GRAPH_TOL and param_err <= GRAPH_TOL):
                fail(f"train graphs ({label}, {mode}): losses rel {loss_rel:.2e}, params {param_err:.2e} "
                     f"against the eager steps")
            if (counts["k1"], counts["k1b"], counts["other"]) != (steps, steps, 0) or a_replay != {"k1": k, "k1b": k} \
                    or tgraphs.replayed_steps != steps - k:
                fail(f"train graphs ({label}, {mode}): launches {counts}, {a_replay} a replay, "
                     f"{tgraphs.replayed_steps} replayed steps")
            out[mode] = row
            del graphs, entry
            torch.cuda.empty_cache()
        return out
    finally:
        torch.backends.cudnn.deterministic = False


def train_step_times(torch, cfg, batch, smi) -> dict:
    """ms a step at the parity batch three ways, each after its warm-up (a
    capture for the graphs), GRAPH_STEPS steps timed with no host read
    between them: the eager step, the one-step graph replayed back to back
    and the group of GRAPH_STEPS as one graph; the idle share of one more
    group, or half as many single steps, under torch.profiler; K1 and K1b
    launches a step;
    peak memory; the graphs' pool and capture time. At matmul precision
    "highest" (train()'s default), and the first two at "default" (TF32
    products and convolutions)."""
    from khmer_ocr_torch.cuda_graphs import pool_bytes
    from khmer_ocr_torch.train import graphs as tgraphs
    from khmer_ocr_torch.train.graphs import TrainGraphs
    from khmer_ocr_torch.train.step import init_train_state, make_train_multi_step, make_train_step

    out = {}
    stacked = {k: torch.stack([v] * GRAPH_STEPS) for k, v in batch.items()}
    for precision, mode in [("highest", "eager"), ("highest", "graph"), ("highest", "group"), ("default", "eager"),
                            ("default", "graph")]:
        graphs = None if mode == "eager" else TrainGraphs()
        state = init_train_state(cfg, 0, "cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        if mode == "group":
            multi = make_train_multi_step(cfg, (100, 84), 0.0, graphs=graphs, precision=precision)
            steps = lambda n: [multi(state, stacked, gen, [1e-4] * GRAPH_STEPS) for _ in range(n // GRAPH_STEPS)]
        else:
            one = make_train_step(cfg, (100, 84), 0.0, graphs=graphs, precision=precision)
            steps = lambda n: [one(state, batch, gen, 1e-4) for _ in range(n)]
        label = f"{mode}, {precision}"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps(GRAPH_STEPS if mode == "group" else 1)  # warm-up; the graphs capture here
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        tgraphs.reset_counts()
        t0 = time.perf_counter()
        steps(GRAPH_STEPS)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / GRAPH_STEPS
        c = train_counts()
        if graphs and (tgraphs.captures, tgraphs.replayed_steps) != (0, GRAPH_STEPS):
            fail(f"train step times ({label}): {tgraphs.captures} captures and {tgraphs.replayed_steps} replayed "
                 f"steps in the timed window")
        peak = torch.cuda.max_memory_allocated() / MIB
        prof = device_profile(lambda: steps(GRAPH_STEPS if mode == "group" else GRAPH_STEPS // 2))
        idle = None if prof is None else 1.0 - prof[0] / prof[1]
        entry = next(iter(graphs.shapes.values())) if graphs else None
        out[label] = dict(ms=ms, idle=idle, k1_a_step=c["k1"] / GRAPH_STEPS, k1b_a_step=c["k1b"] / GRAPH_STEPS,
                          peak_mib=peak, warmup_s=warm_s, pool_mib=pool_bytes(graphs.pool()) / MIB if graphs else None,
                          capture_s=entry.capture_s if entry else None,
                          top=[(k, round(v, 2)) for k, v in prof[2][:3]] if prof else None)
        print(f"[train] {label}: {ms:.2f} ms a step ({32e3 / ms:.1f} lines/s), idle "
              f"{'not measured' if idle is None else f'{idle:.1%}'}, K1 {out[label]['k1_a_step']:.2f} and K1b "
              f"{out[label]['k1b_a_step']:.2f} launches a step, peak allocated {peak:.1f} MiB"
              + (f", the pool {out[label]['pool_mib']:.1f} MiB, capture {entry.capture_s:.2f} s (the first batch's "
                 f"eager steps with it)" if entry else "") + f"; {smi}")
        if (c["k1"], c["k1b"], c["other"]) != (GRAPH_STEPS, GRAPH_STEPS, 0):
            fail(f"train step times ({label}): launches {c} over {GRAPH_STEPS} steps")
        del graphs, state, entry
        torch.cuda.empty_cache()
    return out


def phase_train(torch, smi):
    """The training path at the flagship widths (seeded params): (1) one
    step's loss and gradients by the kernel path against the plain LSTM path
    on the card, batch 32 of 16-chunk lines with 256-long labels, dropout 0,
    with exactly one K1 and one K1b launch a step; (2) three steps against
    the JAX package's golden losses and gradient norms; (3) 50 steps on 4
    samples overfit (dropout 0); (4) the steps as captured CUDA graphs
    (train/graphs.py): the one-step graph and the group of 8 against the
    eager steps (dropout 0; the one-step graph also at dropout 0.1 with
    augmentation p 0.8 from one generator seed), K1 and K1b counted once a
    step by each replay, and the three timed with their idle shares; (5)
    two epochs of train() on
    256 synthetic lines of mixed widths, device augmentation and dropout
    0.1, checkpoint and resume, then on 512 lines of 16 chunks (one shape:
    two groups of 8 an epoch). Returns a train step's K1 and K1b launches
    and the numbers of (4) and (5)."""
    import contextlib
    import logging
    import tempfile

    from khmer_ocr_torch.config import ModelConfig, OCRConfig, TrainConfig
    from khmer_ocr_torch.data.synthetic import synthetic_dataset
    from khmer_ocr_torch.train.loop import train
    from khmer_ocr_torch.train.step import batch_to_device, init_train_state, loss_fn, make_train_step, tree_leaves

    cfg0 = ModelConfig(dropout=0.0)
    batch = batch_to_device(bucket_batch(16, 32, 256, 0).as_dict(), "cuda")
    print(f"[train] parity batch: lines {tuple(batch['lines'].shape)}, labels {tuple(batch['labels'].shape)}, "
          f"chunk counts {batch['chunk_counts'].unique().tolist()}")
    torch.backends.cudnn.deterministic = True  # the two paths' backbones must take the same sums
    runs = {}
    for name, ctx in (("kernel", contextlib.nullcontext()), ("plain", PlainLSTM())):
        state = init_train_state(cfg0, 0, "cuda")
        leaves = tree_leaves(state.params)
        with ctx:
            reset_counts()
            loss, _ = loss_fn(state.params, state.batch_stats, batch, cfg0)
            grads = torch.autograd.grad(loss, leaves)
            torch.cuda.synchronize()
            runs[name] = (loss.item(), grads, train_counts())
    torch.backends.cudnn.deterministic = False
    (lk, gk, ck), (lp, gp, cp) = runs["kernel"], runs["plain"]
    loss_err = abs(lk - lp) / abs(lp)
    grad_err = max(((a - b).abs().max() / max(1.0, b.abs().max().item())).item() for a, b in zip(gk, gp))
    print(f"[train] one step, kernel path vs plain LSTM path: loss {lk:.6f} vs {lp:.6f} (rel {loss_err:.1e}), "
          f"worst gradient leaf |diff| / max(1, |ref|) {grad_err:.1e}; launches K1 {ck['k1']}, K1b {ck['k1b']} "
          f"(plain path: {cp['k1']}, {cp['k1b']})")
    if not (loss_err <= 1e-5 and grad_err <= TOL) or not all(torch.isfinite(g).all() for g in gk):
        fail(f"train step: kernel path vs plain path loss rel {loss_err:.2e}, gradients {grad_err:.2e}")
    if (ck["k1"], ck["k1b"], ck["other"], cp["k1"], cp["k1b"]) != (1, 1, 0, 0, 0):
        fail(f"train step: launches {ck} (plain path {cp}), expected one K1 and one K1b")
    del runs, gk, gp

    # a whole train step (forward, backward, Adam) with counts around it, timed after a warm-up
    state, step = init_train_state(cfg0, 0, "cuda"), make_train_step(cfg0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    state, _ = step(state, batch, gen, 1e-4)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    n_steps = 3
    for _ in range(n_steps):
        state, m = step(state, batch, gen, 1e-4)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n_steps
    c = train_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[train] train_step, batch 32 x 16 chunks, 256 labels: {step_s * 1e3:.1f} ms a step "
          f"({32 / step_s:.1f} lines/s), launches over {n_steps} steps: K1 {c['k1']}, K1b {c['k1b']}; "
          f"peak memory {peak:.2f} GiB; loss {m['loss'].item():.4f} on {smi}")
    if (c["k1"], c["k1b"], c["other"]) != (n_steps, n_steps, 0):
        fail(f"train_step: launches {c} over {n_steps} steps, expected one K1 and one K1b a step")
    launches = {"k1_launches": c["k1"] // n_steps, "k1b_launches": c["k1b"] // n_steps}
    del state

    # the steps as captured CUDA graphs (train/graphs.py): against the eager steps, then timed three ways
    dcfg = ModelConfig(dropout=0.1)
    t0 = time.perf_counter()
    graphs = {"agree": train_graphs_agree(torch, cfg0, batch, 0.0, "dropout 0, no augmentation"),
              "agree_random": train_graphs_agree(torch, dcfg, batch, 0.8, "dropout 0.1, augmentation p 0.8",
                                                 ("graph",))}
    graphs["agree_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    graphs["times"] = train_step_times(torch, cfg0, batch, smi)
    graphs["times_s"] = time.perf_counter() - t0
    print(f"[train] the graphs against the eager steps took {graphs['agree_s']:.1f} s, the step times "
          f"{graphs['times_s']:.1f} s")
    launches["graphs"] = graphs
    del batch

    # golden: the JAX package's three steps (CPU) from the same seeded params and batch
    golden = json.loads((ROOT / "khmer_ocr_torch" / "assets" / "train_golden.json").read_text())
    gcfg = ModelConfig(dropout=0.0)
    gbatch = batch_to_device(padded_lines_batch(golden["chunk_counts"], golden["lines_seed"], golden["labels"]), "cuda")
    state, step = init_train_state(gcfg, golden["seed"], "cuda"), make_train_step(gcfg)
    got = {"losses": [], "grad_norms": []}
    for lr in golden["lrs"]:
        state, m = step(state, gbatch, torch.Generator(device="cuda").manual_seed(0), lr)
        got["losses"].append(m["loss"].item())
        got["grad_norms"].append(m["grad_norm"].item())
    err = max(abs(a - b) / abs(b) for k in got for a, b in zip(got[k], golden[k]))
    print(f"[train] golden: losses {[round(v, 6) for v in got['losses']]} vs {[round(v, 6) for v in golden['losses']]}, "
          f"grad norms {[round(v, 5) for v in got['grad_norms']]} vs {[round(v, 5) for v in golden['grad_norms']]}; "
          f"worst rel {err:.1e}")
    if not err <= 1e-4:
        fail(f"train golden: worst relative difference {err:.2e} > 1e-4")

    # overfit: 50 steps on 4 samples at lr 1e-3; dropout 0, whose masks made the last loss swing between 3%
    # and 8% of the first across runs
    obatch = batch_to_device(bucket_batch(2, 4, 64, 7).as_dict(), "cuda")
    state, step = init_train_state(cfg0, 0, "cuda"), make_train_step(cfg0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    losses = []
    for _ in range(50):
        state, m = step(state, obatch, gen, 1e-3)
        losses.append(m["loss"])
    losses = torch.stack(losses).tolist()
    print(f"[train] overfit, 4 samples, 50 steps at lr 1e-3: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({losses[-1] / losses[0]:.1%} of the first)")
    if not losses[-1] < 0.1 * losses[0]:
        fail(f"train overfit: {losses[0]:.4f} -> {losses[-1]:.4f}, not below 10%")
    del state

    # two epochs of the port's train() on 256 synthetic lines of mixed widths (groups of 8 rarely fill: the
    # partial groups flush singly), then a resume from the first checkpoint; then 512 lines of 16 chunks (one
    # shape: two full groups of 8 an epoch)
    from khmer_ocr_torch.data.synthetic import synthetic_samples
    from khmer_ocr_torch.train import graphs as tgraphs
    from khmer_ocr_torch.train.data import LineDataset

    ocfg = OCRConfig(train=TrainConfig(batch_size=32, checkpoint_every_epochs=1))
    logged = []
    handler = logging.Handler()
    handler.emit = lambda r: logged.append(r.getMessage())
    for name in ("khmer_ocr_torch.train.loop", "khmer_ocr_torch.train.graphs"):
        logging.getLogger(name).addHandler(handler)
        logging.getLogger(name).setLevel(logging.INFO)

    def run_train(dataset, label, out, **kw):
        logged.clear()
        reset_counts()
        tgraphs.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics = out.parent / f"{out.name}.jsonl"
        state = train(dataset, ocfg, out, num_epochs=2, log_every=4, eye_test_every=8, metrics_path=metrics, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = train_counts()
        epochs = [json.loads(line) for line in metrics.read_text().splitlines()]
        eye_tests = sum(m.startswith("eye test") for m in logged)  # each an inference encode: one K1 launch
        growth = [float(m.split("the pool grew by ")[1].split()[0]) for m in logged if "the pool grew by" in m]
        pool = sum(growth)
        row = dict(steps=state.step, seconds=wall, lines_per_s=state.step * 32 / wall,
                   epoch_lines_per_s=[e["lines_per_sec"] for e in epochs], mean_loss=[e["mean_loss"] for e in epochs],
                   captures=tgraphs.captures, captured_steps=tgraphs.captured_steps, replays=tgraphs.replays,
                   replayed_steps=tgraphs.replayed_steps, pool_mib=pool, pool_growth_mib=growth, k1=c["k1"],
                   k1b=c["k1b"], eye_tests=eye_tests,
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        print(f"[train] train(): {label}, 2 epochs, batch 32, device augment p 0.8, dropout 0.1: {state.step} steps "
              f"in {wall:.1f} s ({row['lines_per_s']:.1f} lines/s with padding repeats; per epoch "
              f"{[round(v, 1) for v in row['epoch_lines_per_s']]}), mean loss {[round(v, 4) for v in row['mean_loss']]}"
              f"; {row['captures']} captures ({row['captured_steps']} steps eager, their first batches), "
              f"{row['replays']} replays ({row['replayed_steps']} steps), the pool grew by {pool:.1f} MiB "
              f"(capture by capture {growth}); launches "
              f"K1 {c['k1']}, K1b {c['k1b']}, {eye_tests} eye tests; peak memory {row['peak_gib']:.2f} GiB")
        if (c["k1"], c["k1b"], c["other"]) != (state.step + eye_tests, state.step, 0):
            fail(f"train(): launches {c} for {state.step} steps and {eye_tests} eye tests")
        if row["captured_steps"] + row["replayed_steps"] != state.step or not row["replays"]:
            fail(f"train(): {row['captured_steps']} steps by captures and {row['replayed_steps']} by replays of "
                 f"{state.step}: a step ran outside the graphs")
        return state, epochs, row

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        state, epochs, mixed = run_train(synthetic_dataset(256, 0, ocfg.train), "256 lines of 1-16 chunks",
                                         tmp / "run")
        if not all((tmp / "run" / f"epoch{e:03d}" / "state.pt").exists() for e in (1, 2)):
            fail("train(): checkpoints missing")
        resumed = train(synthetic_dataset(256, 0, ocfg.train), ocfg, tmp / "resumed", num_epochs=2,
                        resume_from=tmp / "run" / "epoch001", metrics_path=tmp / "resumed.jsonl")
        # the JAX package's start epoch: the checkpoint's step over steps_per_epoch (256 // 32). Bucket tails make
        # epoch 1 longer than 8 steps; from 16 on, the start passes epoch 2 and the resumed run takes no step
        start = epochs[0]["step"] // (256 // 32) + 1
        again = [json.loads(line) for line in (tmp / "resumed.jsonl").read_text().splitlines()] \
            if (tmp / "resumed.jsonl").exists() else []
        said = [m for m in logged if m.startswith("resumed from")]
        want_step = state.step if start == 2 else epochs[0]["step"]
        print(f"[train] resume from epoch001 at step {epochs[0]['step']}: start epoch {start} (the log: "
              f"{said[-1].rsplit('(', 1)[-1].rstrip(')') if said else 'none'}), epochs {[e['epoch'] for e in again]}, "
              f"to step {resumed.step} (expected {want_step}; uninterrupted run {state.step})")
        if (resumed.step != want_step or [e["epoch"] for e in again] != list(range(start, 3))
                or not said or not said[-1].endswith(f"(epoch {start})")):
            fail(f"train(): resume from step {epochs[0]['step']} reached step {resumed.step} over epochs "
                 f"{[e['epoch'] for e in again]} (expected {want_step} over {list(range(start, 3))}), log {said}")
        if start == 2:  # the rest of the uninterrupted run, in its sample order
            loss_rel = abs(again[0]["mean_loss"] - epochs[1]["mean_loss"]) / epochs[1]["mean_loss"]
            print(f"[train] resumed epoch 2's mean loss {again[0]['mean_loss']:.5f} vs {epochs[1]['mean_loss']:.5f} "
                  f"(rel {loss_rel:.1e}; cuDNN's backward sums in a run-dependent order)")
            if not loss_rel <= 1e-3:
                fail(f"train(): the resumed epoch 2's mean loss is off by {loss_rel:.2e} relative")
        one = LineDataset(synthetic_samples([16] * 512, 1), train_cfg=ocfg.train, device_augment=True)
        _, _, wide = run_train(one, "512 lines of 16 chunks", tmp / "wide")
        if wide["steps"] != 32 or wide["captures"] != 1 or wide["replayed_steps"] != 24:
            fail(f"train() on one shape: {wide['steps']} steps, {wide['captures']} captures, "
                 f"{wide['replayed_steps']} replayed steps (expected 32, 1 group graph, 24)")
    for name in ("khmer_ocr_torch.train.loop", "khmer_ocr_torch.train.graphs"):
        logging.getLogger(name).removeHandler(handler)
    launches["train_mixed"], launches["train_wide"] = mixed, wide
    return launches


def device_profile(fn):
    """Run ``fn`` under torch.profiler -> (the card's busy ms; the wall ms of
    ``fn`` to its last synchronise; [(kernel, ms)] of the five longest
    kernels by total time), or None when the profiler recorded no device
    activity."""
    from khmer_ocr_torch.profiling import busy_ms, device_events

    dev, wall = device_events(fn)
    if not dev:
        return None
    by_name: dict = {}
    for e in dev:
        by_name[e["name"][:60]] = by_name.get(e["name"][:60], 0.0) + float(e["dur"]) / 1e3
    return busy_ms(dev), wall, sorted(by_name.items(), key=lambda kv: -kv[1])[:5]


LAYOUT_GRAPH_STEPS = 8  # steps of the layout step's graph-against-eager run, and of each timed row


def layout_steps_by(torch, graphed: bool, x, y, steps: int) -> tuple:
    """``steps`` layout train steps from segformer_init(0) at lr 6e-5 on one
    batch, eagerly or through a LayoutTrainGraphs (captured at the first
    step) -> (losses, {name: tensor} of every parameter, both Adam moments
    and the BatchNorm running pair, the cache or None)."""
    from khmer_ocr_torch.detection.graphs import LayoutTrainGraphs
    from khmer_ocr_torch.detection.segformer import SegFormerConfig
    from khmer_ocr_torch.detection.train import make_train_step, segformer_init

    model = segformer_init(0, SegFormerConfig(), "cuda")
    graphs = LayoutTrainGraphs() if graphed else None
    step = make_train_step(model, 6e-5, graphs=graphs)
    losses = torch.stack([step(x, y) for _ in range(steps)]).tolist()
    torch.cuda.synchronize()
    names = [n for n, _ in model.named_parameters()]
    state = {**{f"param/{n}": t.detach().clone() for n, t in model.named_parameters()},
             **{f"mu/{n}": t.clone() for n, t in zip(names, step.opt_state["mu"])},
             **{f"nu/{n}": t.clone() for n, t in zip(names, step.opt_state["nu"])},
             **{f"buffer/{n}": t.clone() for n, t in model.named_buffers()}}
    return losses, state, graphs


def layout_step_times(torch, x, y, smi) -> dict:
    """ms a layout train step at batch 4 x 512 px, eager and through the
    graphs, in turns (eager, graph, graph, eager), each after its warm-up
    (the graph's capture in it): LAYOUT_GRAPH_STEPS steps timed by CUDA
    events with no host read between them, peak memory, the card's busy
    time and idle share of 3 more steps under torch.profiler, the pool and
    the capture's seconds."""
    import numpy as np

    from khmer_ocr_torch.detection import graphs as dgraphs
    from khmer_ocr_torch.detection.segformer import SegFormerConfig
    from khmer_ocr_torch.detection.train import make_train_step, segformer_init
    from khmer_ocr_torch.cuda_graphs import pool_bytes
    from khmer_ocr_torch.precision import matmul_precision

    rows: dict = {"eager": [], "graph": []}
    for mode in ("eager", "graph", "graph", "eager"):
        model = segformer_init(0, SegFormerConfig(), "cuda")
        graphs = dgraphs.LayoutTrainGraphs() if mode == "graph" else None
        step = make_train_step(model, 6e-5, graphs=graphs)
        with matmul_precision("highest"):  # finetune's precision (detector.PRECISION)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2):
                step(x, y)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
            dgraphs.reset_counts()
            ms = cuda_ms(torch, lambda: step(x, y), LAYOUT_GRAPH_STEPS, warmup=0)
            peak = torch.cuda.max_memory_allocated() / MIB
            replays = dgraphs.step_replays
            prof = device_profile(lambda: [step(x, y) for _ in range(3)])
            loss = step(x, y).item()
        if prof is None:
            fail("layout train: the profiler recorded no device activity")
        busy, wall, top = prof
        entry = next(iter(graphs.shapes.values())) if graphs else None
        if graphs and (dgraphs.step_captures, replays) != (0, LAYOUT_GRAPH_STEPS):
            fail(f"layout train step times ({mode}): {dgraphs.step_captures} captures, {replays} replays in the "
                 f"timed window")
        row = dict(ms=ms, pages_per_s=4e3 / ms, peak_mib=peak, busy_ms=busy / 3, idle_share=1 - busy / 3 / ms,
                   profiled_idle_share=1 - busy / wall, warmup_s=warm_s, loss=loss,
                   pool_mib=pool_bytes(graphs.pool()) / MIB if graphs else None,
                   capture_s=entry.capture_s if entry else None, nbytes=graphs.nbytes if graphs else None,
                   top=[(k, round(v, 2)) for k, v in top[:3]])
        rows[mode].append(row)
        print(f"[layout_train] {mode} step, batch 4 x 3 x 512 x 512: {ms:.2f} ms a step ({4e3 / ms:.1f} pages/s), "
              f"peak allocated {peak:.1f} MiB; the card busy {busy / 3:.2f} ms a step, {row['idle_share']:.1%} idle "
              f"against the step's {ms:.2f} ms ({row['profiled_idle_share']:.1%} within the profiled window, the "
              f"profiler's host cost included)"
              + (f"; the pool {row['pool_mib']:.1f} MiB, the cache {graphs.nbytes / MIB:.1f} MiB, capture "
                 f"{entry.capture_s:.2f} s (the first batch's eager step with it)" if entry else "")
              + f"; loss {loss:.4f} on {smi}")
        if not np.isfinite(loss):
            fail(f"layout train step ({mode}): loss {loss}")
        del model, step, graphs, entry
        torch.cuda.empty_cache()
    print(f"[layout_train] the longest kernels over 3 graphed steps (ms): {rows['graph'][-1]['top']}")
    return rows


def phase_layout_train(torch, smi):
    """SegFormer layout training (detection/train.py) at MiT-b0 widths, 12
    labels, on the card, each step through the layout train graphs
    (detection/graphs.py) unless said otherwise: (1) three steps from
    seeded_segformer_state(0) on two 128 px synthetic pages at lr 6e-5 (a
    capture, its batch run eagerly, then two replays) against the JAX
    package's golden losses (khmer_ocr_torch/assets/layout_train_golden.json,
    1e-4 relative); (2) LAYOUT_GRAPH_STEPS steps through the graphs against
    the eager steps from one state on one batch of 4 x 512 px, losses,
    parameters, both Adam moments and the BatchNorm running pair equal bit
    for bit (cuDNN deterministic); (3) the step at batch 4 x 512 px eager
    and graphed in turns: ms, pages/s, peak memory, busy time and idle
    share, the pool and the capture; (4) 30 steps of finetune() from random
    init on synthetic pages, one capture and 29 replays, the loss below 0.7
    of its first; (5) the .npz round trip in the JAX package's layout. No
    kernel of the port lies on this path: every launch count stays 0."""
    import statistics
    import tempfile

    import numpy as np

    from khmer_ocr_torch.convert.from_jax import seeded_segformer_state
    from khmer_ocr_torch.detection import graphs as dgraphs
    from khmer_ocr_torch.detection.segformer import SegFormer, SegFormerConfig, build_model
    from khmer_ocr_torch.detection.train import (finetune, flatten_params, make_train_step, synth_layout_batch,
                                                 unflatten_params)

    cfg = SegFormerConfig()
    golden = json.loads((ROOT / "khmer_ocr_torch" / "assets" / "layout_train_golden.json").read_text())
    reset_counts()
    dgraphs.reset_counts()
    model = build_model(seeded_segformer_state(cfg, golden["seed"]), cfg, "cuda")
    step = make_train_step(model, golden["lr"], graphs=dgraphs.LayoutTrainGraphs())
    x, y = (torch.from_numpy(a).cuda() for a in synth_layout_batch(np.random.RandomState(golden["pages_seed"]),
                                                                    golden["batch"], golden["size"]))
    losses = [step(x, y).item() for _ in range(golden["steps"])]
    err = max(abs(a - b) / abs(b) for a, b in zip(losses, golden["losses"]))
    print(f"[layout_train] golden through the graphs ({dgraphs.step_captures} capture, {dgraphs.step_replays} "
          f"replays): losses {[round(v, 6) for v in losses]} vs {[round(v, 6) for v in golden['losses']]} (worst rel "
          f"{err:.1e}) on {smi}")
    if not err <= 1e-4:
        fail(f"layout train golden: worst relative difference {err:.2e} > 1e-4")
    if (dgraphs.step_captures, dgraphs.step_replays) != (1, golden["steps"] - 1):
        fail(f"layout train golden: {dgraphs.step_captures} captures, {dgraphs.step_replays} replays")
    del model, step

    # the graphed steps against the eager steps, bit for bit
    x, y = (torch.from_numpy(a).cuda() for a in synth_layout_batch(np.random.RandomState(1), 4, 512))
    torch.backends.cudnn.deterministic = True
    try:
        el, es, _ = layout_steps_by(torch, False, x, y, LAYOUT_GRAPH_STEPS)
        dgraphs.reset_counts()
        gl, gs, graphs = layout_steps_by(torch, True, x, y, LAYOUT_GRAPH_STEPS)
    finally:
        torch.backends.cudnn.deterministic = False
    loss_diff = max(abs(a - b) for a, b in zip(gl, el))
    diffs = {k: (gs[k] - es[k]).abs().max().item() for k in es}
    worst = {kind: max(v for k, v in diffs.items() if k.startswith(kind)) for kind in ("param", "mu", "nu", "buffer")}
    counts = (dgraphs.step_captures, dgraphs.step_replays)
    print(f"[layout_train] {LAYOUT_GRAPH_STEPS} steps through the graphs against the eager steps, batch 4 x 512 px: "
          f"losses |diff| {loss_diff:.1e}, parameters {worst['param']:.1e}, Adam's mu {worst['mu']:.1e} and nu "
          f"{worst['nu']:.1e}, the BatchNorm running pair {worst['buffer']:.1e} ({len(diffs)} tensors); captures "
          f"{counts[0]}, replays {counts[1]}; losses {[round(v, 6) for v in gl[:3]]} ... on {smi}")
    if loss_diff or any(worst.values()):
        bad = sorted((k for k, v in diffs.items() if v), key=lambda k: -diffs[k])[:5]
        fail(f"layout train graphs: not bit-equal to the eager steps (losses {loss_diff:.2e}, {worst}; {bad})")
    if counts != (1, LAYOUT_GRAPH_STEPS - 1):
        fail(f"layout train graphs: {counts[0]} captures, {counts[1]} replays over {LAYOUT_GRAPH_STEPS} steps")
    agree = dict(steps=LAYOUT_GRAPH_STEPS, loss_diff=loss_diff, **{f"{k}_diff": v for k, v in worst.items()})
    del graphs, es, gs

    # the step at batch 4 x 512 px, eager and graphed
    times = layout_step_times(torch, x, y, smi)
    del x, y

    # 30 steps of finetune() from random init on synthetic pages, through the graphs
    dgraphs.reset_counts()
    t0 = time.perf_counter()
    model, losses = finetune(steps=30, batch_size=4, image_size=512, lr=3e-4, seed=0, log_every=100)
    torch.cuda.synchronize()
    ft_s = time.perf_counter() - t0
    ft_counts = (dgraphs.step_captures, dgraphs.step_replays)
    print(f"[layout_train] finetune(): 30 steps at batch 4 x 512 px, lr 3e-4, from random init: loss {losses[0]:.4f}"
          f" -> {losses[-1]:.4f} ({losses[-1] / losses[0]:.1%} of the first) in {ft_s:.1f} s (the host's synthetic "
          f"pages included); {ft_counts[0]} capture, {ft_counts[1]} replays; {smi}")
    if not (np.isfinite(losses).all() and losses[-1] < 0.7 * losses[0]):
        fail(f"layout finetune: {losses[0]:.4f} -> {losses[-1]:.4f}, not below 70%")
    if ft_counts != (1, 29):
        fail(f"layout finetune: {ft_counts[0]} captures and {ft_counts[1]} replays, not 1 and 29")

    # the .npz round trip in the JAX package's layout
    flat = flatten_params(model)
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(Path(tmp) / "layout.npz", **flat)
        with np.load(Path(tmp) / "layout.npz") as z:
            back = SegFormer(cfg)
            back.load_state_dict(unflatten_params(dict(z), cfg))
    again = flatten_params(back)
    same = sorted(again) == sorted(flat) and all(np.array_equal(again[k], v) for k, v in flat.items())
    print(f"[layout_train] .npz round trip: {len(flat)} arrays equal: {same}")
    if not same:
        fail("layout train: the .npz round trip changed the weights")
    c = train_counts()
    if c["k1"] or c["k1b"] or c["other"]:
        fail(f"layout train: a kernel was launched ({c}); none lies on this path")
    med = lambda mode, k: statistics.median(r[k] for r in times[mode])  # noqa: E731
    return dict(golden_err=err, agree=agree, times=times, step_ms=med("graph", "ms"), eager_ms=med("eager", "ms"),
                pages_per_s=4e3 / med("graph", "ms"), idle_share=med("graph", "idle_share"),
                eager_idle_share=med("eager", "idle_share"), finetune_first=losses[0], finetune_last=losses[-1],
                finetune_s=ft_s, finetune_counts=ft_counts)


def epoch_digest(batches) -> str:
    """sha256 over every batch's chunks, chunk counts and labels, in order
    (tests/test_torch_host_augment.py::epoch_digest)."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for b in batches:
        for a in (b.chunks, b.chunk_counts, b.labels):
            h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def real_samples(n: int) -> list:
    import numpy as np

    assets = ROOT / "khmer_ocr_torch" / "assets"
    texts = json.loads((assets / "real_lines.json").read_text())["texts"]
    with np.load(assets / "real_lines.npz") as z:
        return [(z[f"line_{i}"], texts[i]) for i in range(n)]


def phase_host_augment(torch, smi):
    """The host Augmenter (train/augment.py, OpenCV) on this machine: one
    epoch of LineDataset(augment=True) on the first 16 rendered lines
    against the JAX package's digest (khmer_ocr_torch/assets/
    host_augment_golden.json); then train() for two epochs on the 64
    rendered lines with --host-augment semantics (augmented on the host,
    device augmentation off), every batch that reached the card byte-equal
    to the same epoch built again on the host, the loss finite, K1 and K1b
    launched once a step."""
    import cv2
    import numpy as np

    from khmer_ocr_torch.config import OCRConfig, TrainConfig
    from khmer_ocr_torch.train import loop
    from khmer_ocr_torch.train.data import LineDataset

    golden = json.loads((ROOT / "khmer_ocr_torch" / "assets" / "host_augment_golden.json").read_text())
    ds = LineDataset(real_samples(golden["lines"]), augment=True)
    digest = epoch_digest(ds.epoch_batches(golden["batch"], np.random.default_rng(golden["seed"])))
    print(f"[host_augment] one epoch of {golden['lines']} lines, batch {golden['batch']}, OpenCV {cv2.__version__}: "
          f"digest equal to the JAX package's: {digest == golden['digest']}")
    if digest != golden["digest"]:
        fail(f"host augment: the epoch's digest {digest} differs from the JAX package's {golden['digest']}")

    ocfg = OCRConfig(train=TrainConfig(batch_size=16, checkpoint_every_epochs=100))
    dataset = LineDataset(real_samples(64), train_cfg=ocfg.train, augment=True)
    seen, real_step = [], loop.make_train_step

    def recording_step(*args, precision="highest", **kw):
        step = real_step(*args, precision=precision, **kw)
        seen.append(args[2])  # the device step's augmentation probability
        seen.append(precision)  # the step's matmul precision: the config's

        def run(state, batch, generator, lr):
            if len(seen) == 2:
                seen.append({k: v.cpu().numpy() for k, v in batch.items()})
            return step(state, batch, generator, lr)

        return run

    loop.make_train_step = recording_step
    try:
        with tempfile_dir() as tmp:
            reset_counts()
            t0 = time.perf_counter()
            state = loop.train(dataset, ocfg, tmp / "run", num_epochs=2, log_every=1000, eye_test_every=10 ** 6,
                               metrics_path=tmp / "metrics.jsonl")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            epochs = [json.loads(line) for line in (tmp / "metrics.jsonl").read_text().splitlines()]
    finally:
        loop.make_train_step = real_step
    c = train_counts()
    first = seen[2]
    # the first batch dispatched is the epoch's first: its partial group is the first flushed (no group of 8 fills)
    host = next(dataset.epoch_batches(16, np.random.default_rng(ocfg.train.seed), sample_size=64,
                                      max_label_len=ocfg.model.decode_max_len + 1))
    same = all(np.array_equal(first[k], v) for k, v in host.as_dict().items())
    print(f"[host_augment] train(): 2 epochs of 64 lines, batch 16, host augment p {ocfg.train.augment_prob} "
          f"(device step's augmentation probability {seen[0]}): {state.step} steps in {wall:.1f} s, mean loss "
          f"{[round(e['mean_loss'], 4) for e in epochs]}; launches K1 {c['k1']}, K1b {c['k1b']}; the first batch on "
          f"the card byte-equal to the host's build: {same}")
    if seen[0] != 0.0 or "lines" in first:
        fail(f"host augment: the device step augments too (probability {seen[0]}, layout {sorted(first)})")
    if seen[1] != ocfg.runtime.matmul_precision:
        fail(f"host augment: train() built its step at precision {seen[1]!r}, not the config's")
    if not same:
        fail("host augment: the batch on the card differs from the host's build of it")
    if not all(np.isfinite(e["mean_loss"]) for e in epochs):
        fail(f"host augment: loss {epochs}")
    if (c["k1"], c["k1b"], c["other"]) != (state.step, state.step, 0):
        fail(f"host augment: launches {c} for {state.step} steps")
    return dict(steps=state.step, k1=c["k1"], k1b=c["k1b"], seconds=wall)


@contextlib.contextmanager
def tempfile_dir():
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        yield Path(tmp)


PAR_WORLD = 2
PAR_LR = 1e-4
PAR_WARMUP, PAR_TIMED = 3, 20
SERVE_LINES = 18


def step_with_grads(torch, step, state, batch, lr):
    """One train step -> (state, {"loss", "grads"}): the gradients Adam
    received (summed over the group when the step has one)."""
    seen, real_grad = [], torch.autograd.grad

    def spy(*args, **kw):
        seen.append(real_grad(*args, **kw))
        return seen[-1]

    torch.autograd.grad = spy
    try:
        state, m = step(state, batch, torch.Generator(device="cuda").manual_seed(0), lr)
    finally:
        torch.autograd.grad = real_grad
    return state, {"loss": m["loss"], "grads": list(seen[0])}


def parallel_batch() -> dict:
    """8 synthetic lines of 4 chunks with labels of their own lengths, the
    "lines" layout (the shards hold different numbers of targets)."""
    return bucket_batch(4, 8, 64, 3).as_dict()


def flat_state(state, extra: dict) -> dict:
    import numpy as np

    from khmer_ocr_torch.train.step import tree_leaves

    copy = lambda t: t.detach().cpu().numpy().copy()  # noqa: E731
    out = {f"param{i}": copy(t) for i, t in enumerate(tree_leaves(state.params))}
    out.update({f"stat{i}": copy(t) for i, t in enumerate(tree_leaves(state.batch_stats))})
    out.update({f"grad{i}": copy(g) for i, g in enumerate(extra["grads"])})
    out["loss"] = np.asarray(extra["loss"].item())
    return out


def parallel_rank(rank: int, world: int, tmp: Path) -> int:
    """A rank of phase_parallel's group (gloo, CUDA tensors, the one card):
    (ii) one train step at the flagship widths on its rows of
    parallel_batch(), (iii) its part of the data-parallel beam-3 request on
    the rendered lines. Writes rank{rank}.npz / .json to ``tmp``."""
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    import torch.distributed as dist

    from khmer_ocr_torch.config import ModelConfig
    from khmer_ocr_torch.infer.predictor import Predictor, set_parity_mode
    from khmer_ocr_torch.parallel.mesh import data_shard
    from khmer_ocr_torch.train.step import batch_to_device, init_train_state, make_train_step

    set_parity_mode()
    torch.backends.cudnn.deterministic = True
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp / "store"), world), rank=rank, world_size=world)
    group = dist.group.WORLD
    cfg = ModelConfig(dropout=0.0)
    batch = batch_to_device(data_shard(parallel_batch(), rank, world), "cuda")
    step = make_train_step(cfg, group=group)
    meta = {"targets": int((batch["labels"][:, 1:] != cfg.pad_idx).sum())}
    reset_counts()
    state, extra = step_with_grads(torch, step, init_train_state(cfg, 0, "cuda"), batch, PAR_LR)
    torch.cuda.synchronize()
    meta["train_counts"] = train_counts()
    np.savez(tmp / f"rank{rank}.npz", **flat_state(state, extra))
    walls = []
    for _ in range(3):
        dist.barrier()
        t0 = time.perf_counter()
        state, _ = step(state, batch, torch.Generator(device="cuda").manual_seed(0), PAR_LR)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    meta["step_ms"] = sorted(walls)[1] * 1e3
    del state, extra

    lines = [line for line, _ in real_samples(SERVE_LINES)]
    pred = Predictor(model_path=ROOT / "khmer_ocr_torch" / "assets" / "flagship", process_group=group)
    pred.predict_batch_tokens(lines, beam_width=3, batch_size=8, max_len=64)  # warm-up
    dist.barrier()
    rows, counts, wall = counted_run(torch, pred, lines, 3, 8, 64)
    meta.update(serve_tokens=[strip(r) for r in rows], serve_counts=counts, serve_ms=wall * 1e3,
                serve_strings=[pred.tokenizer.decode(r) for r in rows])
    (tmp / f"rank{rank}.json").write_text(json.dumps(meta))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_parallel(torch, smi):
    """Data parallelism over torch.distributed on the one card: (i) a group
    of one rank over NCCL: one train step at the flagship widths equals the
    step without a group bit for bit (loss, gradients, params, statistics);
    (ii) two ranks sharing the card over gloo on CUDA tensors, each running
    K1 and K1b on its half of 8 lines: the loss within 1e-5 relative, the
    summed gradients within 1e-4 x max(1, |ref|), the statistics within
    1e-5 and the params within 1e-6 of the one-process step on the whole
    batch, but for values where either gradient lies within the measured
    gradient difference of 0 (Adam's first step turns such a gradient into
    about +-lr: see tests/test_torch_parallel.py), every rank's params
    equal; (iii) the two
    ranks serving the first 18 rendered lines at beam 3 with the flagship's
    weights: every rank's tokens equal to one process's, with each rank's
    K1 and K2 launches."""
    import numpy as np
    import torch.distributed as dist

    from khmer_ocr_torch.config import ModelConfig
    from khmer_ocr_torch.infer.predictor import Predictor
    from khmer_ocr_torch.train.step import batch_to_device, init_train_state, make_train_step

    cfg = ModelConfig(dropout=0.0)
    # bit-equal steps need the same sums: cuDNN's convolutions, the token embedding's gradient (an
    # accumulating index_put, whose default kernel adds in a run-dependent order)
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    batch = batch_to_device(parallel_batch(), "cuda")
    with tempfile_dir() as tmp:
        # (i) NCCL, a group of one rank
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", store=dist.FileStore(str(tmp / "nccl"), 1), rank=0, world_size=1)
        runs = {}
        for name, group in (("alone", None), ("group", dist.group.WORLD)):
            step = make_train_step(cfg, group=group)
            state, extra = step_with_grads(torch, step, init_train_state(cfg, 0, "cuda"), batch, PAR_LR)
            runs[name] = (flat_state(state, extra), step, state)
            del extra
        # the step's wall with and without the group: PAR_TIMED steps between CUDA events after PAR_WARMUP, in the
        # order alone, group, group, alone
        walls = {"alone": [], "group": []}
        for name in ("alone", "group", "group", "alone"):
            _, step, state = runs[name]
            gen = torch.Generator(device="cuda").manual_seed(0)
            walls[name].append(cuda_ms(torch, lambda: step(state, batch, gen, PAR_LR), PAR_TIMED, PAR_WARMUP))
        dist.destroy_process_group()
        torch.use_deterministic_algorithms(False)
        a, b = runs["alone"][0], runs["group"][0]
        a_ms, b_ms = (sum(walls[k]) / 2 for k in ("alone", "group"))
        del runs
        equal = sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
        print(f"[parallel] (i) NCCL, one rank: the step under the group equal to the step without one bit for bit "
              f"({len(a)} arrays: loss, gradients, params, statistics): {equal}; a step {b_ms:.2f} ms under the "
              f"group ({' and '.join(f'{v:.2f}' for v in walls['group'])}), {a_ms:.2f} ms without "
              f"({' and '.join(f'{v:.2f}' for v in walls['alone'])}): means of {PAR_TIMED} steps between CUDA events "
              f"after {PAR_WARMUP} of warm-up, twice each in the order alone, group, group, alone, batch 8 x 4 "
              f"chunks, deterministic algorithms on; {b_ms / a_ms - 1:+.1%} under the group, on {smi}")
        if not equal:
            bad = [k for k in a if not np.array_equal(a[k], b[k])]
            fail(f"parallel (i): {len(bad)} arrays differ under a group of one ({bad[:6]})")
        ref = a

        # the one-process references for (iii)
        lines = [line for line, _ in real_samples(SERVE_LINES)]
        pred = Predictor(model_path=ROOT / "khmer_ocr_torch" / "assets" / "flagship")
        pred.predict_batch_tokens(lines, beam_width=3, batch_size=8, max_len=64)
        one_rows, one_counts, one_wall = counted_run(torch, pred, lines, 3, 8, 64)
        one_tokens = [strip(r) for r in one_rows]
        del pred
        torch.cuda.empty_cache()

        # (ii) and (iii): two ranks sharing the card over gloo
        logs = [tmp / f"rank{r}.log" for r in range(PAR_WORLD)]
        t0 = time.perf_counter()
        procs = []
        for r, log in enumerate(logs):
            with open(log, "w") as fh:
                procs.append(subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--parallel-rank", str(r),
                                               str(PAR_WORLD), str(tmp)], stdout=fh, stderr=subprocess.STDOUT,
                                              cwd=ROOT))
        try:
            rcs = [p.wait(timeout=300) for p in procs]
        finally:
            for p in procs:
                p.kill()
        ranks_s = time.perf_counter() - t0
        if rcs != [0] * PAR_WORLD:
            for log in logs:
                print(log.read_text()[-3000:])
            fail(f"parallel: the ranks exited {rcs}")
        outs = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(PAR_WORLD)]
        metas = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(PAR_WORLD)]
    torch.backends.cudnn.deterministic = False

    loss_rel = abs(float(outs[0]["loss"]) - float(ref["loss"])) / abs(float(ref["loss"]))
    grad_err = max(np.abs(outs[0][k] - ref[k]).max() / max(1.0, np.abs(ref[k]).max()) for k in ref if
                   k.startswith("grad"))
    stat_err = max(np.abs(outs[0][k] - ref[k]).max() for k in ref if k.startswith("stat"))
    # Adam's first step moves a value by lr g / (|g| + eps), about lr sign(g): where either gradient lies within the
    # measured gradient difference of 0 (every sign flip among them), the two steps may part by up to 2 lr. Those
    # values are exempt from the 1e-6 on params; every other value must meet it.
    grad_diff = max(np.abs(outs[0][f"grad{k[5:]}"] - ref[f"grad{k[5:]}"]).max() for k in ref if k.startswith("param"))
    past = exempt = unexplained = 0
    param_err = 0.0
    for k in (k for k in ref if k.startswith("param")):
        g, g_ref = outs[0][f"grad{k[5:]}"], ref[f"grad{k[5:]}"]
        off = np.abs(outs[0][k] - ref[k]) > 1e-6
        free = np.minimum(np.abs(g), np.abs(g_ref)) <= grad_diff
        past += int(off.sum())
        exempt += int((off & free).sum())
        unexplained += int((off & ~free).sum())
        kept = np.abs(outs[0][k] - ref[k])[~free]
        param_err = max(param_err, float(kept.max()) if kept.size else 0.0)
    n_params = sum(ref[k].size for k in ref if k.startswith("param"))
    replicated = all(np.array_equal(o[k], outs[0][k]) for o in outs[1:] for k in outs[0] if k.startswith("param"))
    counts = [m["train_counts"] for m in metas]
    print(f"[parallel] (ii) {PAR_WORLD} ranks over gloo on CUDA tensors, one card, targets {[m['targets'] for m in metas]}:"
          f" loss {float(outs[0]['loss']):.6f} vs {float(ref['loss']):.6f} one-process (rel {loss_rel:.1e}); "
          f"summed gradients worst |diff| / max(1, |ref|) {grad_err:.1e} (|diff| {grad_diff:.1e}); statistics "
          f"{stat_err:.1e}; params: {past} of {n_params} values past 1e-6, {exempt} of them exempt (a gradient "
          f"within {grad_diff:.1e} of 0), {unexplained} not; the rest within {param_err:.1e}; params equal on every "
          f"rank: {replicated}; launches per rank K1 {[c['k1'] for c in counts]}, K1b {[c['k1b'] for c in counts]}; "
          f"a step {[round(m['step_ms'], 1) for m in metas]} ms per rank (two processes time-sharing one card over "
          f"loopback gloo: a numerics check, not a scaling figure) against {a_ms:.2f} ms for one process on the "
          f"whole batch, on {smi}")
    if not (loss_rel <= 1e-5 and grad_err <= TOL and stat_err <= 1e-5 and unexplained == 0
            and replicated):
        fail(f"parallel (ii): loss rel {loss_rel:.2e}, gradients {grad_err:.2e}, statistics {stat_err:.2e}, "
             f"{unexplained} params past 1e-6 with both gradients off 0, replicated {replicated}")
    if any((c["k1"], c["k1b"], c["other"]) != (1, 1, 0) for c in counts):
        fail(f"parallel (ii): launches {counts}, expected one K1 and one K1b on every rank")

    same = [m["serve_tokens"] == one_tokens for m in metas]
    sc = [m["serve_counts"] for m in metas]
    print(f"[parallel] (iii) {PAR_WORLD} ranks serving {SERVE_LINES} lines, beam 3, max_len 64, batch 8: tokens equal "
          f"to one process's on every rank: {same}; launches per rank K1 {[c['k1'] for c in sc]}, K2 "
          f"{[c['k2'] for c in sc]} (one process: K1 {one_counts['k1']}, K2 {one_counts['k2']}); "
          f"{[round(m['serve_ms'], 1) for m in metas]} ms per rank, {one_wall * 1e3:.1f} ms for one process; the "
          f"ranks' processes {ranks_s:.1f} s in all")
    if not all(same):
        fail("parallel (iii): a rank's tokens differ from one process's")
    if any(c["k1"] == 0 or c["k2"] == 0 or c["k3"] or c["k4"] for c in sc):
        fail(f"parallel (iii): launches {sc}")
    return dict(nccl_one_rank_equal=equal, loss_rel=loss_rel, grad_err=float(grad_err), param_err=param_err,
                params_past=past, params_exempt=exempt,
                k1_train=[c["k1"] for c in counts], k1b_train=[c["k1b"] for c in counts],
                k1_serve=[c["k1"] for c in sc], k2_serve=[c["k2"] for c in sc],
                step_ms=[m["step_ms"] for m in metas], one_step_ms=a_ms, group_one_step_ms=b_ms)


def strip(row) -> list[int]:
    out = [int(v) for v in row]
    while out and out[-1] == 0:
        out.pop()
    return out


def check_tokens(torch, pred, lines, golden_rows, got_rows, label: str, tag: str = "e2e") -> int:
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
        print(f"[{tag}] {label}: line {i} differs: {ref} vs {got}; normalised scores {s_ref:.7f} vs {s_got:.7f}")
        if not abs(s_ref - s_got) < NEAR_TIE:
            fail(f"{label}: line {i} differs and is not a near-tie (|{s_ref} - {s_got}| >= {NEAR_TIE})")
    return differ


class MegaDecode:
    """Within this block the Predictor takes the whole-decode path (K3)
    inside its envelope: KHMER_OCR_MEGA_DECODE=1, read at each call."""

    def __enter__(self):
        self._saved = os.environ.get("KHMER_OCR_MEGA_DECODE")
        os.environ["KHMER_OCR_MEGA_DECODE"] = "1"
        return self

    def __exit__(self, *exc):
        if self._saved is None:
            os.environ.pop("KHMER_OCR_MEGA_DECODE", None)
        else:
            os.environ["KHMER_OCR_MEGA_DECODE"] = self._saved
        return False


def counted_run(torch, pred, lines, bw, bs, max_len):
    """One request with every kernel's launch count set to 0 just before it
    and read just after: (token rows, counts, seconds). K2's count inside
    the decode's CUDA graphs is that of each replay's launches
    (cuda_graphs.py), ``k2_card`` those of them on K2's card route; the
    counts also hold the decode's graph captures and replays and the steps
    the Python loop ran on the card."""
    from khmer_ocr_torch.decode import graphs
    from khmer_ocr_torch.ops.kernels import build

    torch.cuda.synchronize()
    build.reset_launches()
    graphs.reset_counts()
    steps0, mega0 = pred.decode_steps, pred.mega_batches
    t0 = time.perf_counter()
    rows = pred.predict_batch_tokens(lines, beam_width=bw, batch_size=bs, max_len=max_len)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: build.launches[k] for k in ("k1", "k2", "k3", "k4", "k5", "k2_card")}
    counts.update(steps=pred.decode_steps - steps0,
                  mega=pred.mega_batches - mega0, captures=graphs.captures, replays=graphs.replays,
                  replayed_steps=graphs.replayed_steps, eager_steps=graphs.eager_steps)
    return rows, counts, wall


def check_run(cfg, rows, counts, want: dict, label: str, tag: str = "e2e") -> list:
    """Launch counts as expected (and non-zero where expected), every
    decode step outside K3 run by the decode's CUDA graphs (none by the
    Python loop, unless ``want`` says otherwise), tokens in the vocabulary;
    the stripped rows."""
    import numpy as np

    want = {"eager_steps": 0, "replayed_steps": counts["steps"], **want}
    print(f"[{tag}] {label}: launches K1 {counts['k1']}, K2 {counts['k2']} ({counts['k2_card']} on the card route), "
          f"K3 {counts['k3']}, K5 {counts['k5']} (expected {want['k1']}, {want['k2']} ({want.get('k2_card', 'any')}), "
          f"{want['k3']}, {want.get('k5', 'any')}); {counts['steps']} decode steps "
          f"({counts['replays']} graph replays, {counts['eager_steps']} steps by the Python loop), "
          f"{counts['mega']} whole-decode batches")
    if any(counts[k] != v for k, v in want.items()) or counts["k4"]:
        fail(f"{label}: launch counts {counts}, expected {want}")
    for r in rows:
        if not (np.all(r >= 0) and np.all(r < cfg.vocab_size)):
            fail(f"{label}: tokens out of the vocabulary")
    return [strip(r) for r in rows]


def check_memory(torch, pred, lines, bs, label: str, tag: str = "e2e") -> float:
    """Memory of the kernel path against the plain path for each bucket batch
    of ``lines``: the worst difference over valid positions."""
    from khmer_ocr_torch.models.ocr_model import encode
    from khmer_ocr_torch.ops.lines import device_chunk, u8_to_unit, unit_normalize

    worst = 0.0
    for batch in pred.preprocessor.iter_batches(lines, max_batch=bs):
        with torch.inference_mode():
            u8 = torch.from_numpy(batch.lines).cuda()
            cnt = torch.from_numpy(batch.chunk_counts).cuda()
            chunks = device_chunk(unit_normalize(u8_to_unit(u8)), (100, 84))
            mem_k, pad = encode(pred.params, chunks, cnt, pred.model_cfg)
            with PlainPath():
                mem_p, _ = encode(pred.params, chunks, cnt, pred.model_cfg)
        err = (mem_k - mem_p)[~pad].abs().max().item()
        finite = bool(torch.isfinite(mem_k).all())
        print(f"[{tag}] {label}: memory of lines {batch.indices} (bucket {batch.bucket_n}): max|kernel path - plain "
              f"path| {err:.2e}")
        if not err <= TOL or not finite:
            fail(f"{label}: memory differs by {err:.3e} > {TOL} (finite: {finite})")
        worst = max(worst, err)
    return worst


def card_route_lines():
    """32 seeded synthetic lines of 4 chunks each: one bucket, so a greedy
    batch of 32 is one launch shape that K2's card route takes."""
    from khmer_ocr_torch.data.synthetic import synthetic_lines

    return synthetic_lines([4] * 32, seed=23)


def phase_e2e(torch, gpu_name, smi):
    from khmer_ocr_torch.config import ModelConfig
    from khmer_ocr_torch.convert.from_jax import seeded_params
    from khmer_ocr_torch.data.synthetic import synthetic_lines
    from khmer_ocr_torch.infer.predictor import Predictor

    golden = json.loads((ROOT / "khmer_ocr_torch" / "assets" / "smoke_golden.json").read_text())
    cfg = ModelConfig()
    params, stats = seeded_params(cfg, golden["seed"])
    lines = synthetic_lines(golden["chunk_counts"], seed=golden["lines_seed"])
    pred = Predictor(params=params, batch_stats=stats)  # no device given: the CUDA card
    if pred.device.type != "cuda":
        fail(f"Predictor picked {pred.device}, not the card")
    bw, bs = golden["beam_width"], golden["batch_size"]
    batches = list(pred.preprocessor.iter_batches(lines, max_batch=bs))
    n_batches = len(batches)
    # K3's envelope at beam 3, max_len 64: Tm = 32 x bucket <= 128
    n_mega = sum(1 for b in batches if 32 * b.bucket_n <= 128)

    # memory: kernel path against the plain path, the 8-chunk batch and the longest line
    counts = golden["chunk_counts"]
    for idx in ([i for i, c in enumerate(counts) if 6 < c <= 8], [counts.index(max(counts))]):
        check_memory(torch, pred, [lines[i] for i in idx], bs, f"lines {idx}")

    results, plain_rows = {}, {}
    for max_len in (golden["max_len"], cfg.decode_max_len):
        pred.predict_batch_tokens(lines, beam_width=bw, batch_size=bs, max_len=max_len)  # warm-up
        rows, c, wall = counted_run(torch, pred, lines, bw, bs, max_len)
        label = f"beam {bw}, max_len {max_len}"
        print(f"[e2e] {label}: {len(lines)} lines in {n_batches} batches, {wall * 1e3:.1f} ms "
              f"({len(lines) / wall:.1f} lines/s, {wall * 1e3 / n_batches:.1f} ms/batch) on {smi}")
        # beam 3 at batch 8: K2's cluster route (geometry.k2_route)
        want = dict(k1=n_batches, k2=cfg.dec_layers * c["steps"], k2_card=0, k3=0, k5=c["steps"])
        got = check_run(cfg, rows, c, want, label)
        if c["k2"] == 0:
            fail(f"{label}: K2 never launched")
        with PlainPath():
            plain_rows[max_len] = [strip(r) for r in
                                   pred.predict_batch_tokens(lines, beam_width=bw, batch_size=bs, max_len=max_len)]
        n_diff = check_tokens(torch, pred, lines, plain_rows[max_len], got, f"max_len {max_len} vs plain path")
        print(f"[e2e] max_len {max_len}: {len(lines) - n_diff}/{len(lines)} lines token-identical to the plain "
              f"path; strings: {[pred.tokenizer.decode(r) for r in got[:2]]} ...")
        if max_len == golden["max_len"]:
            n_gold = check_tokens(torch, pred, lines, golden["tokens"], got, "vs golden")
            print(f"[e2e] {len(lines) - n_gold}/{len(lines)} lines token-identical to the golden tokens")
        results[max_len] = dict(ms=wall * 1e3, lines_per_s=len(lines) / wall, **c)

    # the whole-decode path: K3 takes the batches inside its envelope, K2 the rest
    max_len = golden["max_len"]
    with MegaDecode():
        pred.predict_batch_tokens(lines, beam_width=bw, batch_size=bs, max_len=max_len)  # warm-up
        rows, c, wall = counted_run(torch, pred, lines, bw, bs, max_len)
    label = f"KHMER_OCR_MEGA_DECODE=1, beam {bw}, max_len {max_len}"
    print(f"[e2e] {label}: {len(lines)} lines in {wall * 1e3:.1f} ms ({len(lines) / wall:.1f} lines/s) on {smi}")
    got = check_run(cfg, rows, c, dict(k1=n_batches, k2=cfg.dec_layers * c["steps"], k2_card=0, k3=n_mega,
                                       mega=n_mega, k5=c["steps"]), label)
    if n_mega != 3 or c["k3"] == 0:
        fail(f"{label}: {n_mega} batches inside K3's envelope, {c['k3']} launches (expected 3)")
    n_diff = check_tokens(torch, pred, lines, plain_rows[max_len], got, f"{label} vs plain path")
    n_gold = check_tokens(torch, pred, lines, golden["tokens"], got, f"{label} vs golden")
    print(f"[e2e] {label}: {len(lines) - n_diff}/{len(lines)} lines token-identical to the plain path, "
          f"{len(lines) - n_gold}/{len(lines)} to the golden tokens")
    results["mega"] = dict(ms=wall * 1e3, lines_per_s=len(lines) / wall, **c)

    # beam 5: K2 in lane groups (mega off)
    pred.predict_batch_tokens(lines, beam_width=5, batch_size=bs, max_len=max_len)  # warm-up: the graphs captured
    rows, c, wall = counted_run(torch, pred, lines, 5, bs, max_len)
    label = f"beam 5, max_len {max_len}"
    want = dict(k1=n_batches, k2=cfg.dec_layers * c["steps"], k3=0, k5=c["steps"])
    got = check_run(cfg, rows, c, want, label)
    with PlainPath():
        ref = [strip(r) for r in pred.predict_batch_tokens(lines, beam_width=5, batch_size=bs, max_len=max_len)]
    n_diff = check_tokens(torch, pred, lines, ref, got, f"{label} vs plain path")
    print(f"[e2e] {label}: {len(lines)} lines in {wall * 1e3:.1f} ms; {len(lines) - n_diff}/{len(lines)} lines "
          f"token-identical to the plain path")
    results["beam5"] = dict(ms=wall * 1e3, lines_per_s=len(lines) / wall, **c)

    # greedy at batch 32 on 32 lines of one bucket: every K2 launch on the card route
    wide = card_route_lines()
    pred.predict_batch_tokens(wide, beam_width=1, batch_size=32, max_len=max_len)  # warm-up: the graphs captured
    rows, c, wall = counted_run(torch, pred, wide, 1, 32, max_len)
    label = f"greedy, batch 32 (K2's card route), max_len {max_len}"
    layers_steps = cfg.dec_layers * c["steps"]
    got = check_run(cfg, rows, c, dict(k1=1, k2=layers_steps, k2_card=layers_steps, k3=0, k5=0), label)
    if c["k2_card"] == 0:
        fail(f"{label}: the card route never launched")
    with PlainPath():
        ref = [strip(r) for r in pred.predict_batch_tokens(wide, beam_width=1, batch_size=32, max_len=max_len)]
    n_diff = check_tokens(torch, pred, wide, ref, got, f"{label} vs plain path")
    print(f"[e2e] {label}: {len(wide)} lines in {wall * 1e3:.1f} ms; {len(wide) - n_diff}/{len(wide)} lines "
          f"token-identical to the plain path")
    results["greedy32"] = dict(ms=wall * 1e3, lines_per_s=len(wide) / wall, **c)

    # the baseline backbones without the BiLSTM, the 12 short lines through the whole-decode path
    short = [line for line, n in zip(lines, counts) if n <= 4]
    for name in ("vgg", "resnet"):
        bcfg = ModelConfig(backbone=name, use_bilstm=False)
        bparams, bstats = seeded_params(bcfg, 0)
        bpred = Predictor(params=bparams, batch_stats=bstats, model_cfg=bcfg)
        check_memory(torch, bpred, short, bs, name)
        with MegaDecode():
            bpred.predict_batch_tokens(short, beam_width=bw, batch_size=bs, max_len=max_len)  # warm-up
            rows, c, wall = counted_run(torch, bpred, short, bw, bs, max_len)
            label = f"{name}, KHMER_OCR_MEGA_DECODE=1, beam {bw}, max_len {max_len}"
            got = check_run(bcfg, rows, c, dict(k1=0, k2=0, k3=3, mega=3, steps=0, k5=0), label)
            with PlainPath():
                ref = [strip(r) for r in bpred.predict_batch_tokens(short, beam_width=bw, batch_size=bs,
                                                                    max_len=max_len)]
        n_diff = check_tokens(torch, bpred, short, ref, got, f"{label} vs plain path")
        print(f"[e2e] {label}: {len(short)} lines in {wall * 1e3:.1f} ms; {len(short) - n_diff}/{len(short)} "
              f"lines token-identical to the plain path; strings: {[bpred.tokenizer.decode(r) for r in got[:2]]}")
        results[name] = dict(ms=wall * 1e3, lines_per_s=len(short) / wall, **c)
    return results


def phase_real(torch, smi):
    """The flagship's real weights on the card: the weights directory
    (khmer_ocr_torch/assets/flagship, an index into
    checkpoints/se_vgg_flagship) loaded by Predictor(model_path=...), the 64
    rendered lines of khmer_ocr_torch/assets/real_lines.npz decoded at beam 3
    by the step loop (K1, K2) and with KHMER_OCR_MEGA_DECODE=1 (K3 inside its
    envelope), each against the JAX package's strings stored with the lines,
    near-ties excepted; memory against the plain path for each bucket batch;
    CER and exact match by the port's scoring against the stored JAX values."""
    import numpy as np

    from khmer_ocr_torch.infer.predictor import Predictor
    from khmer_ocr_torch.metrics import levenshtein, score
    from khmer_ocr_torch.native import levenshtein_batch, load_native_library
    from khmer_ocr_torch.train.step import tree_leaves

    assets = ROOT / "khmer_ocr_torch" / "assets"
    meta = json.loads((assets / "real_lines.json").read_text())
    with np.load(assets / "real_lines.npz") as z:
        lines = [z[f"line_{i}"] for i in range(len(z.files))]
    bw, max_len, bs = (meta["recipe"][k] for k in ("beam_width", "max_len", "batch_size"))
    weights = assets / "flagship"
    index = json.loads((weights / "index.json").read_text())
    chunk_bytes = sum(e.get("length", 0) for e in index["leaves"])
    dir_bytes = sum(f.stat().st_size for f in weights.iterdir())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred = Predictor(model_path=weights)  # no device given: the CUDA card
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    n_params = sum(v.numel() for v in tree_leaves(pred.params))
    print(f"[real] Predictor(model_path={weights.relative_to(ROOT)}) on {pred.device}: {load_s:.2f} s; the directory "
          f"{dir_bytes} B, the checkpoint chunks it reads {chunk_bytes} B ({len(index['leaves'])} leaves); "
          f"{n_params} values on the card (BatchNorm statistics included)")
    if pred.device.type != "cuda":
        fail(f"real: Predictor picked {pred.device}, not the card")
    cfg = pred.model_cfg

    check_memory(torch, pred, lines, bs, "flagship", tag="real")
    batches = list(pred.preprocessor.iter_batches(lines, max_batch=bs))
    n_batches = len(batches)
    n_mega = sum(1 for b in batches if 32 * b.bucket_n <= 128)  # K3's envelope at beam 3, max_len 64
    jax_rows = [pred.tokenizer.encode(t) for t in meta["strings"]]
    out = {}
    for mode in ("k2", "k3"):
        with MegaDecode() if mode == "k3" else contextlib.nullcontext():
            pred.predict_batch_tokens(lines, beam_width=bw, batch_size=bs, max_len=max_len)  # warm-up
            rows, c, wall = counted_run(torch, pred, lines, bw, bs, max_len)
        label = f"beam {bw}, max_len {max_len}" + (", KHMER_OCR_MEGA_DECODE=1" if mode == "k3" else "")
        want = dict(k1=n_batches, k2=cfg.dec_layers * c["steps"], k2_card=0, k3=n_mega if mode == "k3" else 0,
                    k5=c["steps"])
        if mode == "k3":
            want["mega"] = n_mega
        got = check_run(cfg, rows, c, want, label, tag="real")
        if c[mode] == 0 or (mode == "k3" and n_mega == 0):
            fail(f"real {label}: {mode.upper()} never launched ({n_mega} batches inside K3's envelope)")
        strings = [pred.tokenizer.decode(r) for r in got]
        differ = [i for i, (a, b) in enumerate(zip(strings, meta["strings"])) if a != b]
        n_diff = check_tokens(torch, pred, [lines[i] for i in differ], [jax_rows[i] for i in differ],
                              [got[i] for i in differ], f"{label} vs the JAX package (lines {differ})", tag="real")
        print(f"[real] {label}: {len(lines)} lines in {n_batches} batches, {wall * 1e3:.1f} ms "
              f"({len(lines) / wall:.1f} lines/s) on {smi}; {len(lines) - n_diff}/{len(lines)} strings equal to "
              f"the JAX package's")
        out[mode] = dict(strings=strings, n_diff=n_diff, ms=wall * 1e3, lines_per_s=len(lines) / wall, **c)

    t0 = time.perf_counter()
    load_native_library()
    build_s = time.perf_counter() - t0
    texts, names = meta["texts"], [f"line_{i}" for i in range(len(lines))]
    refs = texts * 3
    hyps = meta["strings"] + out["k2"]["strings"] + out["k3"]["strings"]
    native, plain = levenshtein_batch(refs, hyps).tolist(), [levenshtein(r, h) for r, h in zip(refs, hyps)]
    print(f"[real] levenshtein_batch (g++, {build_s:.2f} s to build and load): {len(refs)} pairs equal to the numpy "
          f"DP: {native == plain}")
    if native != plain:
        fail("real: levenshtein_batch differs from the numpy DP")
    ref = score(names, texts, meta["strings"])
    if (ref.mean_cer, ref.exact_match_accuracy) != (meta["mean_cer"], meta["exact_match"]):
        fail(f"real: the JAX strings score {ref.summary()} here, against {meta['mean_cer']}, {meta['exact_match']} "
             "stored")
    for mode in ("k2", "k3"):
        res = score(names, texts, out[mode]["strings"])
        same = (res.mean_cer, res.exact_match_accuracy) == (meta["mean_cer"], meta["exact_match"])
        print(f"[real] {mode.upper()} request: mean CER {res.mean_cer:.6f}, exact match {res.exact_match_accuracy:.4f} "
              f"(JAX: {meta['mean_cer']:.6f}, {meta['exact_match']:.4f}; equal: {same}), "
              f"{out[mode]['lines_per_s']:.1f} lines/s on {smi}")
        if not same and out[mode]["n_diff"] == 0:
            fail(f"real {mode}: the same strings score differently")
        out[mode].update(mean_cer=res.mean_cer, exact_match=res.exact_match_accuracy)
    return dict(load_s=load_s, n_params=n_params, chunk_bytes=chunk_bytes, **{
        k: {kk: v for kk, v in d.items() if kk != "strings"} for k, d in out.items()})


GRAPH_REPEATS = 3  # timed requests of each path, in turns
TRACE_ATTEMPTS = 5  # profiled requests of each path until the trace holds every K2 launch counted


def decode_paths(torch, pred, lines, bw, bs, max_len, label, tag="decode_graph", card=False):
    """The request through the decode's CUDA graphs and through the Python
    step loop (``Predictor.eager_decode``), each warmed up, then timed
    GRAPH_REPEATS times in turns, each run counted and held: the graphs' runs
    replay every step (no capture, no Python step, K2 launched layers x
    steps times, by the replays), the loop's run every step itself; tokens
    of every run equal. Then one request of each under torch.profiler,
    counted too: the card's busy ms, the idle share against the timed walls,
    and the K2 kernels the trace holds, equal to layers x the request's
    steps and to its K2 count (on the graph path that count is derived from
    the replays; a trace short of it, the profiler's loss, is taken again,
    up to TRACE_ATTEMPTS times), its tokens equal too. ``card``: every K2
    launch on the card route (CARD_KERNELS kernels each), else none. Returns (the
    graphs' token rows, a dict of the numbers)."""
    from khmer_ocr_torch.decode import graphs
    from khmer_ocr_torch.profiling import busy_ms, device_events

    from khmer_ocr_torch.ops.kernels import decode_step

    layers = pred.model_cfg.dec_layers
    out = {}
    try:
        for eager in (False, True):
            pred.eager_decode = eager
            pred.predict_batch_tokens(lines, beam_width=bw, batch_size=bs, max_len=max_len)  # warm-up, captures
        walls = {False: [], True: []}
        ref = None
        for _ in range(GRAPH_REPEATS):
            for eager in (False, True):
                pred.eager_decode = eager
                rows, c, wall = counted_run(torch, pred, lines, bw, bs, max_len)
                rows = [strip(r) for r in rows]
                walls[eager].append(wall * 1e3)
                want = dict(k2=layers * c["steps"], captures=0, eager_steps=c["steps"] if eager else 0,
                            replayed_steps=0 if eager else c["steps"], k5=c["steps"] if bw > 1 else 0)
                want["k2_card"] = layers * c["steps"] if card else 0
                if any(c[k] != v for k, v in want.items()) or (not eager and c["replays"] == 0) or c["k3"]:
                    fail(f"{label}, {'Python loop' if eager else 'graphs'}: counts {c}, expected {want} "
                         f"({'no replay' if eager else 'replays'}, no K3)")
                if ref is None:
                    ref = rows
                if rows != ref:
                    differ = [i for i, (a, b) in enumerate(zip(ref, rows)) if a != b]
                    fail(f"{label}: the {'Python loop' if eager else 'graphs'} give other tokens on lines {differ}")
                out["eager" if eager else "graph"] = c
        prof = {}
        for eager in (False, True):
            pred.eager_decode = eager
            path = "Python loop" if eager else "graphs"
            # K2's count is derived on the graph path (cuda_graphs.py): hold it against the kernels the trace
            # holds. The profiler can lose records in a long request (traces of about 125k device events at max_len
            # 256 have held 2584 and 2343 of 2592 K2 launches, the request's tokens equal), so a trace short of the
            # count is profiled again; one with more kernels, or other tokens, fails at once.
            for attempt in range(TRACE_ATTEMPTS):
                run = []
                dev, _ = device_events(lambda: run.append(counted_run(torch, pred, lines, bw, bs, max_len)))
                rows, c, _ = run[0]
                traced = sum(1 for e in dev if e.get("cat") == "kernel" and "decoder_layer_step_kernel" in e["name"])
                # a card-route launch is CARD_KERNELS kernels, each named decoder_layer_step_kernel*
                kernels = c["k2"] + (decode_step.CARD_KERNELS - 1) * c["k2_card"]
                if [strip(r) for r in rows] != ref or c["k2"] != layers * c["steps"] or traced > kernels:
                    fail(f"{label}, {path}, profiled: tokens equal {[strip(r) for r in rows] == ref}; the trace "
                         f"holds {traced} K2 kernels, the counts {c['k2']} launches ({c['k2_card']} on the card "
                         f"route, {decode_step.CARD_KERNELS} kernels each) of {c['steps']} steps x {layers} layers")
                if traced == kernels:
                    break
                print(f"[{tag}] {label}, {path}, profiled: the trace holds {traced} of the {kernels} K2 kernels "
                      f"counted ({len(dev)} device events); profiling again")
            else:
                fail(f"{label}, {path}: {TRACE_ATTEMPTS} traces each short of the {kernels} K2 kernels counted")
            prof[eager] = busy_ms(dev) if dev else None
            out["eager" if eager else "graph"].update(traced_k2=traced, trace_attempts=attempt + 1)
    finally:
        pred.eager_decode = False
    for eager, name in ((False, "graph"), (True, "eager")):
        mean = sum(walls[eager]) / len(walls[eager])
        busy = prof[eager]
        out[name] = dict(walls_ms=walls[eager], ms=mean, lines_per_s=len(lines) / mean * 1e3, busy_ms=busy,
                         idle=None if busy is None else 1.0 - busy / mean, **out[name])
    g, e = out["graph"], out["eager"]
    idle = lambda r: "not measured" if r["idle"] is None else f"{r['idle']:.1%} idle (busy {r['busy_ms']:.1f} ms)"
    print(f"[{tag}] {label}: graphs {fmt_gaps(g['walls_ms'])} ms, {idle(g)}; Python loop {fmt_gaps(e['walls_ms'])} "
          f"ms, {idle(e)}; {e['ms'] / g['ms']:.2f}x; {g['steps']} steps in {g['replays']} replays "
          f"({layers * g['steps']} K2 launches, {layers * graphs.EXIT_CHECK_EVERY} a full replay; the profiled "
          f"request's trace {g['traced_k2']} K2 kernels, its counts {layers} x its steps); tokens equal")
    return ref, out


def phase_decode_graph(torch, smi):
    """The decode's step loop as CUDA graphs (decode/graphs.py) against the
    Python loop on the card, in one process, in turns (decode_paths): the
    18 lines of [e2e] (seeded flagship widths) at beam 3, max_len 64 and
    256, beam 5 and greedy at max_len 64, and beam 3 with
    KHMER_OCR_FUSED_HEAD=1, in float32 and bf16 ("default" precision), the
    graphs' tokens of every run equal to the loop's, beam 3 max_len 64 in
    float32 also to the golden tokens (near-ties excepted); then the
    trained flagship on the 64 rendered lines, float32 and bf16: the
    graphs' strings equal to the loop's and to the JAX package's, the mean
    CER equal to JAX's. Walls, idle shares, lines/s; the captures and the
    replays; Predictor.warmup capturing a shape's graphs."""
    from khmer_ocr_torch.config import ModelConfig, OCRConfig, RuntimeConfig
    from khmer_ocr_torch.convert.from_jax import seeded_params
    from khmer_ocr_torch.data.synthetic import synthetic_lines
    from khmer_ocr_torch.decode import graphs
    from khmer_ocr_torch.infer.predictor import Predictor
    from khmer_ocr_torch.metrics import score

    golden = json.loads((ROOT / "khmer_ocr_torch" / "assets" / "smoke_golden.json").read_text())
    cfg = ModelConfig()
    params, stats = seeded_params(cfg, golden["seed"])
    lines = synthetic_lines(golden["chunk_counts"], seed=golden["lines_seed"])
    bs = golden["batch_size"]
    bf16 = OCRConfig(runtime=RuntimeConfig(compute_dtype="bfloat16", matmul_precision="default"))
    out = {"smi": smi, "rows": {}}
    saved = os.environ.get("KHMER_OCR_FUSED_HEAD")
    try:
        for dt, config in (("float32", None), ("bfloat16", bf16)):
            pred = Predictor(params=params, batch_stats=stats, config=config)
            for bw, max_len, head in ((3, 64, "0"), (3, 256, "0"), (5, 64, "0"), (1, 64, "0"), (3, 64, "1")):
                os.environ["KHMER_OCR_FUSED_HEAD"] = head
                label = (f"{dt}, {'greedy' if bw == 1 else f'beam {bw}'}, max_len {max_len}"
                         + (", KHMER_OCR_FUSED_HEAD=1" if head == "1" else ""))
                rows, res = decode_paths(torch, pred, lines, bw, bs, max_len, label)
                if dt == "float32" and (bw, max_len, head) == (3, golden["max_len"], "0"):
                    n_gold = check_tokens(torch, pred, lines, golden["tokens"], rows, f"{label}, graphs vs golden",
                                          tag="decode_graph")
                    print(f"[decode_graph] {label}: {len(lines) - n_gold}/{len(lines)} lines token-identical to the "
                          "golden tokens")
                out["rows"][label] = res
            # greedy at batch 32 on one bucket: float32 takes K2's card route, bfloat16 the cluster route
            os.environ["KHMER_OCR_FUSED_HEAD"] = "0"
            label = f"{dt}, greedy, batch 32, max_len 64"
            _, out["rows"][label] = decode_paths(torch, pred, card_route_lines(), 1, 32, 64, label,
                                                 card=dt == "float32")
            print(f"[decode_graph] {dt} Predictor, the 18 lines' rows: {len(pred.graph_cache)} decode shapes cached, "
                  f"their buffers {pred.graph_cache.nbytes / 2**20:.1f} MiB")
            out[f"shapes_{dt}"] = dict(n=len(pred.graph_cache), bytes=pred.graph_cache.nbytes)
            del pred
    finally:
        if saved is None:
            os.environ.pop("KHMER_OCR_FUSED_HEAD", None)
        else:
            os.environ["KHMER_OCR_FUSED_HEAD"] = saved

    assets = ROOT / "khmer_ocr_torch" / "assets"
    meta = json.loads((assets / "real_lines.json").read_text())
    real = [line for line, _ in real_samples(len(meta["texts"]))]
    names = [f"line_{i}" for i in range(len(real))]
    bw, max_len, bs = (meta["recipe"][k] for k in ("beam_width", "max_len", "batch_size"))
    for dt, config in (("float32", None), ("bfloat16", bf16)):
        pred = Predictor(model_path=FLAGSHIP, config=config)
        label = f"flagship {dt}, 64 real lines, beam {bw}, max_len {max_len}"
        rows, res = decode_paths(torch, pred, real, bw, bs, max_len, label)
        strings = [pred.tokenizer.decode(r) for r in rows]
        want = meta["strings"] if dt == "float32" else meta["bf16_strings"]
        cer = score(names, meta["texts"], strings).mean_cer
        want_cer = meta["mean_cer"] if dt == "float32" else meta["bf16_mean_cer"]
        equal = sum(a == b for a, b in zip(strings, want))
        print(f"[decode_graph] {label}: {equal}/{len(real)} strings equal to the JAX package's {dt}, mean CER "
              f"{cer:.6f} (JAX {want_cer:.6f}); graphs {res['graph']['lines_per_s']:.1f} lines/s, Python loop "
              f"{res['eager']['lines_per_s']:.1f} on {smi}")
        if equal != len(real) or cer != want_cer:
            fail(f"decode_graph {label}: {equal}/{len(real)} strings equal to JAX's, CER {cer} against {want_cer}")
        out["rows"][label] = dict(equal_to_jax=equal, mean_cer=cer, shapes=len(pred.graph_cache),
                                  shape_bytes=pred.graph_cache.nbytes, **res)
        print(f"[decode_graph] {label}: {len(pred.graph_cache)} decode shapes, their buffers "
              f"{pred.graph_cache.nbytes / 2**20:.1f} MiB")
        del pred

    # warmup captures the graphs of the shapes it warms: the next request of those shapes captures none
    pred = Predictor(params=params, batch_stats=stats)
    graphs.reset_counts()
    t0 = time.perf_counter()
    pred.warmup(beam_widths=(3,), batch_size=8, chunk_buckets=(4,), max_len=64)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_captures = graphs.captures
    import numpy as np

    cw, stride = pred._chunk_geom
    white = [np.full((pred.config.preprocess.img_height, 3 * stride + cw), 255, np.uint8)] * 8  # warmup's lines
    rows, c, wall = counted_run(torch, pred, white, 3, 8, 64)
    print(f"[decode_graph] Predictor.warmup (beam 3, 8 lines of 4 chunks, max_len 64): {warm_s:.2f} s, {warm_captures} "
          f"graphs captured; the next request of that shape: {c['captures']} captures, {c['replays']} replays, "
          f"{wall * 1e3:.1f} ms on {smi}")
    if warm_captures == 0 or c["captures"] or c["replays"] == 0:
        fail(f"decode_graph: warmup captured {warm_captures} graphs, the request after it {c}")
    out["warmup"] = dict(s=warm_s, warmup_captures=warm_captures, next_ms=wall * 1e3, **c)
    del pred
    out["cache"] = graph_cache_cost(torch, smi, params, stats, lines, bs)
    return out


MIB = 2**20


def settled_memory(torch) -> tuple[int, int]:
    """(allocated, reserved) bytes on the card once every dropped object is
    collected and the allocator's free blocks are released."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()


def graph_cache_cost(torch, smi, params, stats, lines, bs):
    """What the decode's graph cache (cuda_graphs.GraphCache) costs.
    (1) The trained flagship's default ``Predictor.warmup()`` (256 white
    lines of chunk buckets 1-4, beam 1 and 3, max_len 256, float32): its
    wall, the shapes and bytes it caches, the memory it holds; dropping the
    Predictor gives every byte back. (2) Misses: the 18 seeded lines at beam
    3, max_len 256 (6 shapes) by a Predictor whose budget keeps one shape,
    so every batch captures its graphs again, against one whose cache holds
    them all and against the Python loop, GRAPH_REPEATS times in turns,
    tokens equal: each miss's cost, the capture of one shape."""
    from khmer_ocr_torch.cuda_graphs import CACHE_SHARE
    from khmer_ocr_torch.decode import graphs
    from khmer_ocr_torch.infer.predictor import Predictor

    out = {}
    alloc0, res0 = settled_memory(torch)
    pred = Predictor(model_path=FLAGSHIP)
    alloc_w, res_w = settled_memory(torch)
    graphs.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    captures = graphs.captures
    alloc1, res1 = settled_memory(torch)
    n, nbytes, budget = len(pred.graph_cache), pred.graph_cache.nbytes, int(
        CACHE_SHARE * torch.cuda.get_device_properties(0).total_memory)
    del pred
    alloc2, res2 = settled_memory(torch)
    print(f"[decode_graph] the flagship's default warmup(): {warm_s:.2f} s, {n} decode shapes, {captures} graphs; "
          f"their buffers {nbytes / MIB:.1f} MiB (the budget, CACHE_SHARE {CACHE_SHARE} of the card: "
          f"{budget / MIB:.0f} MiB); allocated {alloc0 / MIB:.1f} MiB before the Predictor, {alloc_w / MIB:.1f} with "
          f"its weights, {alloc1 / MIB:.1f} after warmup, {alloc2 / MIB:.1f} after del; reserved {res0 / MIB:.1f} / "
          f"{res_w / MIB:.1f} / {res1 / MIB:.1f} / {res2 / MIB:.1f} MiB, on {smi}")
    if alloc2 - alloc0 > 64 * MIB or res2 - res0 > 256 * MIB or n == 0:
        fail(f"decode_graph: a dropped Predictor kept {(alloc2 - alloc0) / MIB:.1f} MiB allocated, "
             f"{(res2 - res0) / MIB:.1f} MiB reserved ({n} shapes cached)")
    out["warmup"] = dict(s=warm_s, shapes=n, captures=captures, shape_bytes=nbytes, budget=budget,
                         allocated=[alloc0, alloc_w, alloc1, alloc2], reserved=[res0, res_w, res1, res2])

    preds = {"hits": Predictor(params=params, batch_stats=stats),
             "misses": Predictor(params=params, batch_stats=stats, graph_cache_bytes=1),
             "Python loop": Predictor(params=params, batch_stats=stats, eager_decode=True)}
    walls, counts, ref = {k: [] for k in preds}, {}, None
    for p in preds.values():
        p.predict_batch_tokens(lines, beam_width=3, batch_size=bs, max_len=256)  # warm-up
    for _ in range(GRAPH_REPEATS):
        for name, p in preds.items():
            rows, c, wall = counted_run(torch, p, lines, 3, bs, 256)
            rows = [strip(r) for r in rows]
            ref = rows if ref is None else ref
            if rows != ref:
                fail(f"decode_graph: the graph cache's {name} give other tokens")
            walls[name].append(wall * 1e3)
            counts[name] = c
    n_shapes = len(preds["hits"].graph_cache)
    miss = counts["misses"]
    if counts["hits"]["captures"] or miss["captures"] == 0 or len(preds["misses"].graph_cache) != 1:
        fail(f"decode_graph: captures {counts['hits']['captures']} with every shape cached, {miss['captures']} with "
             f"one; {len(preds['misses'].graph_cache)} shapes kept by the budget of 1 byte")
    mean = {k: sum(v) / len(v) for k, v in walls.items()}
    per_shape = (mean["misses"] - mean["hits"]) / n_shapes
    print(f"[decode_graph] 18 lines, beam 3, max_len 256, {n_shapes} shapes: every shape cached "
          f"{fmt_gaps(walls['hits'])} ms, one kept (every batch captures again: {miss['captures']} graphs a request) "
          f"{fmt_gaps(walls['misses'])} ms, the Python loop {fmt_gaps(walls['Python loop'])} ms; a miss costs "
          f"{per_shape:.1f} ms a shape; tokens equal; on {smi}")
    out["misses"] = dict(walls_ms=walls, shapes=n_shapes, captures_a_request=miss["captures"],
                         miss_ms_a_shape=per_shape)
    return out


INFLIGHT_REPEATS = 3  # timed requests of each path, in turns
# the paths: the sequential loop of decode_prepared (the path before the pipeline), the pipeline with the encode
# launched eagerly at max_inflight_batches 4, and the pipeline (encode graphs) at 1 and at 4: (eager encode, bound)
INFLIGHT_PATHS = {"loop": None, "eager encode, 4": (True, 4), "1": (False, 1), "4": (False, 4)}
INFLIGHT_BOUND = "256 real lines, batch 8"  # the request whose pipeline at max_inflight_batches 1 must reach the bound


def sequential_run(torch, pred, lines, bw, bs, max_len):
    """The request by the path before the pipeline: each bucket batch's
    ``decode_prepared`` (prepared, shipped, encoded, decoded, read back)
    before the next is dispatched -> (token rows, counts, seconds), counted
    as counted_run counts."""
    from khmer_ocr_torch.decode import graphs
    from khmer_ocr_torch.ops.kernels import build

    torch.cuda.synchronize()
    build.reset_launches()
    graphs.reset_counts()
    steps0, mega0 = pred.decode_steps, pred.mega_batches
    t0 = time.perf_counter()
    rows = [None] * len(lines)
    for batch in pred.preprocessor.iter_batches(lines, max_batch=bs):
        for i, r in zip(batch.indices, pred.decode_prepared(batch, bw, max_len)):
            rows[i] = r
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: build.launches[k] for k in ("k1", "k2", "k3", "k4", "k5", "k2_card")}
    counts.update(steps=pred.decode_steps - steps0,
                  mega=pred.mega_batches - mega0, captures=graphs.captures, replays=graphs.replays,
                  replayed_steps=graphs.replayed_steps, eager_steps=graphs.eager_steps)
    return rows, counts, wall


def exit_test_waits_on_its_stream(torch) -> dict:
    """The exit test's host read (``bool`` of a device tensor, as
    beam_finished and greedy_finished read it) with about 50 ms of work
    queued on another stream, as an encode of the dispatch stage would be:
    it must return before that work ends, so it waited on its own stream
    alone."""
    side = torch.cuda.Stream()
    flag = torch.zeros(4, device="cuda")
    bool((flag > 0).any())  # its kernels loaded: a lazily loaded module's first launch waits on the whole card
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    cycles = 100_000_000
    with torch.cuda.stream(side):
        torch.cuda._sleep(1000)  # loaded
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
    t0 = time.perf_counter()
    done = bool((flag > 0).any())
    read_ms = (time.perf_counter() - t0) * 1e3
    side_busy = not side.query()
    end.synchronize()
    sleep_ms = start.elapsed_time(end)
    print(f"[inflight] the exit test's read with {sleep_ms:.1f} ms queued on another stream: {read_ms:.3f} ms, the "
          f"other stream still busy after it: {side_busy}")
    if done or not side_busy or not read_ms < sleep_ms / 2:
        fail(f"inflight: the exit test's read took {read_ms:.3f} ms beside {sleep_ms:.1f} ms on another stream "
             f"(still busy: {side_busy}): it waits on more than its stream")
    return dict(read_ms=read_ms, other_stream_ms=sleep_ms)


def encode_graph_agrees(torch, pred, lines, bs) -> float:
    """Each bucket batch's memory and pad mask by its encode graph (the
    dispatch stage's path, infer/encode_graph.py) against the eager encode
    on the same inputs: the worst difference over valid positions."""
    import khmer_ocr_torch.infer.predictor as predictor
    from khmer_ocr_torch.infer import encode_graph

    worst, shapes = 0.0, []
    with torch.inference_mode():
        for batch in pred.preprocessor.iter_batches(lines, max_batch=bs):
            u8, cnt, _ = pred._to_device_batch(batch)
            known = len(pred.encode_cache)
            torch.cuda.synchronize()
            reserved = torch.cuda.memory_reserved()
            encode = lambda l, c: predictor.encode_batch(pred.params, l, c, pred.model_cfg, pred._chunk_geom)  # noqa
            ref, ref_pad = encode(u8, cnt)
            side = pred._encode_stream  # the dispatch stage's stream: a capture cannot run on the default one
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(2):  # the shape's first batch runs eagerly (and captures), the next replays
                    mem, pad = encode_graph.encode_graphed(pred.encode_cache, pred.params, encode, u8, cnt)
            torch.cuda.current_stream().wait_stream(side)
            if len(pred.encode_cache) > known:  # a capture: its pool against what the card reserved meanwhile
                torch.cuda.synchronize()
                g = next(reversed(pred.encode_cache.shapes.values()))
                shapes.append(dict(rows=u8.shape[0], chunks=batch.bucket_n, nbytes=g.nbytes,
                                   reserved=torch.cuda.memory_reserved() - reserved))
                if g.nbytes <= g.lines.nbytes:
                    fail(f"inflight: the encode graph of {tuple(u8.shape)} counts no pool ({g.nbytes} B)")
            if not torch.equal(pad, ref_pad):
                fail(f"inflight: the encode graph's pad mask differs from the eager one (bucket {batch.bucket_n})")
            worst = max(worst, (mem - ref)[~pad].abs().max().item())
    print(f"[inflight] encode graphs against the eager encode, each bucket batch of the 64 real lines at batch {bs}: "
          f"max |diff| {worst:.2e}; each new shape's bytes (its inputs and pool) against what the card reserved "
          "meanwhile, MiB: " + ", ".join(f"{s['rows']}x{s['chunks']} {s['nbytes'] / MIB:.1f} / {s['reserved'] / MIB:.1f}"
                                         for s in shapes))
    if not worst <= TOL:
        fail(f"inflight: the encode graphs' memory differs from the eager encode's by {worst:.3e} > {TOL}")
    return dict(err=worst, shapes=shapes)


def phase_inflight(torch, smi):
    """``predict_batch``'s in-flight pipeline against the sequential loop of
    ``decode_prepared`` (the path before it), on the trained flagship
    (khmer_ocr_torch/assets/flagship), float32, beam 3, max_len 64, one
    Predictor, every shape warmed first: the 18 seeded lines at batch 8,
    the 64 real lines at batch 8, and those lines four times over (256) at
    batch 8 and 64. The paths of INFLIGHT_PATHS, INFLIGHT_REPEATS requests
    each in turns, each counted (K1 a batch, K2 layers x steps, no
    capture of the decode's or the encode's, on the graph paths an encode
    replay for each batch of at most encode_graph.MAX_CHUNKS chunks): the
    wall, lines/s, the peak allocated bytes, the host ms inside the decode
    half (the decode stage's work), the high-water mark of batches in
    flight, and, from one profiled request of each (where its trace is
    small enough), the idle share. Fails unless
    every request's tokens equal the loop's, the real lines read the JAX
    package's strings (mean CER equal to JAX's), the mark stays within
    2 x max_inflight_batches and reaches 2 in the 256 lines at batch 8 with
    max_inflight_batches 1. Also: the exit test's read waits on its stream
    alone (exit_test_waits_on_its_stream), and the encode graphs' memory
    equals the eager encode's within TOL (encode_graph_agrees)."""
    import dataclasses

    import khmer_ocr_torch.infer.predictor as predictor
    from khmer_ocr_torch.data.synthetic import synthetic_lines
    from khmer_ocr_torch.infer import encode_graph
    from khmer_ocr_torch.metrics import score
    from khmer_ocr_torch.profiling import busy_ms, device_events

    out = {"smi": smi, "exit_test": exit_test_waits_on_its_stream(torch), "rows": {}}
    golden = json.loads((ROOT / "khmer_ocr_torch" / "assets" / "smoke_golden.json").read_text())
    meta = json.loads((ROOT / "khmer_ocr_torch" / "assets" / "real_lines.json").read_text())
    real = [line for line, _ in real_samples(len(meta["texts"]))]
    bw, max_len = meta["recipe"]["beam_width"], meta["recipe"]["max_len"]
    pred = predictor.Predictor(model_path=FLAGSHIP)
    out["encode_graph"] = encode_graph_agrees(torch, pred, real, 8)
    layers = pred.model_cfg.dec_layers
    decode_s = [0.0]  # host seconds inside the decode half, the decode stage's work
    real_decode = predictor.decode_batch

    def timed_decode(*a, **kw):
        t0 = time.perf_counter()
        try:
            return real_decode(*a, **kw)
        finally:
            decode_s[0] += time.perf_counter() - t0

    max_chunks = encode_graph.MAX_CHUNKS

    def run(path, lines, bs):
        encode_graph.reset_counts()
        if INFLIGHT_PATHS[path] is None:
            return sequential_run(torch, pred, lines, bw, bs, max_len)
        eager, bound = INFLIGHT_PATHS[path]
        encode_graph.MAX_CHUNKS = 0 if eager else max_chunks  # 0: no shape is captured, every encode runs eagerly
        pred.config = pred.config.replace(runtime=dataclasses.replace(pred.config.runtime, max_inflight_batches=bound))
        try:
            return counted_run(torch, pred, lines, bw, bs, max_len)
        finally:
            encode_graph.MAX_CHUNKS = max_chunks

    # (label, lines, batch size, JAX's strings, profiled): the 256 lines at batch 8 are not profiled, since their
    # trace would hold about 4x the 64 lines' device events and take longer than the rest of the phase
    requests = (("18 seeded lines, batch 8", synthetic_lines(golden["chunk_counts"], seed=golden["lines_seed"]), 8,
                 None, True),
                ("64 real lines, batch 8", real, 8, meta["strings"], True),
                (INFLIGHT_BOUND, real * 4, 8, meta["strings"] * 4, False),
                ("256 real lines, batch 64", real * 4, 64, meta["strings"] * 4, True))
    predictor.decode_batch = timed_decode
    try:
        for label, lines, bs, want, profiled in requests:
            batches = list(pred.preprocessor.iter_batches(lines, max_batch=bs))
            n_batches = len(batches)
            # the batches whose encode the dispatch stage replays as a graph: at most MAX_CHUNKS chunks, padded
            n_graphed = sum(1 for b in batches if predictor._round_up(len(b.indices), pred.config.runtime.batch_buckets)
                            * b.bucket_n <= encode_graph.MAX_CHUNKS)
            for path in INFLIGHT_PATHS:
                run(path, lines, bs)  # warm-up: every shape's graphs captured
            res = {p: dict(walls_ms=[], peak_mib=[], high=[], decode_ms=[]) for p in INFLIGHT_PATHS}
            ref = None
            for _ in range(INFLIGHT_REPEATS):
                for path, how in INFLIGHT_PATHS.items():
                    base = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    decode_s[0] = 0.0
                    rows, c, wall = run(path, lines, bs)
                    r = res[path]
                    r["walls_ms"].append(wall * 1e3)
                    r["peak_mib"].append((torch.cuda.max_memory_allocated() - base) / MIB)
                    r["decode_ms"].append(decode_s[0] * 1e3)
                    graphed = how is not None and not how[0]
                    c.update(encode_captures=encode_graph.captures, encode_replays=encode_graph.replays)
                    want_c = dict(k1=n_batches, k2=layers * c["steps"], k3=0, k4=0, captures=0, eager_steps=0,
                                  replayed_steps=c["steps"], encode_captures=0,
                                  encode_replays=n_graphed if graphed else 0)
                    if any(c[k] != v for k, v in want_c.items()):
                        fail(f"inflight {label}, {path}: counts {c}, expected {want_c}")
                    if how is not None:
                        r["high"].append(pred.max_batches_in_flight)
                        if not 1 <= pred.max_batches_in_flight <= 2 * how[1]:
                            fail(f"inflight {label}: {pred.max_batches_in_flight} batches in flight at "
                                 f"max_inflight_batches {how[1]}")
                    rows = [strip(x) for x in rows]
                    ref = rows if ref is None else ref
                    if rows != ref:
                        differ = [i for i, (a, b) in enumerate(zip(ref, rows)) if a != b]
                        fail(f"inflight {label}, {path}: tokens differ from the loop's on lines {differ}")
                    r["counts"] = c
            for path in INFLIGHT_PATHS:
                r = res[path]
                mean = sum(r["walls_ms"]) / len(r["walls_ms"])
                r.update(ms=mean, lines_per_s=len(lines) / mean * 1e3, busy_ms=None, idle=None)
                if profiled:
                    dev, _ = device_events(lambda: run(path, lines, bs))
                    r.update(busy_ms=busy_ms(dev), events=len(dev))
                    r["idle"] = 1.0 - r["busy_ms"] / mean
            if label == INFLIGHT_BOUND and max(res["1"]["high"]) != 2:
                fail(f"inflight {label}: the high-water mark at max_inflight_batches 1 is {res['1']['high']}, not 2")
            if want is not None:
                strings = [pred.tokenizer.decode(r) for r in ref]
                equal = sum(a == b for a, b in zip(strings, want))
                # the CER of the 64 lines (each copy reads the same strings once all are equal)
                cer = score([f"line_{i}" for i in range(len(real))], meta["texts"], strings[:len(real)]).mean_cer
                print(f"[inflight] {label}: {equal}/{len(lines)} strings equal to the JAX package's, mean CER "
                      f"{cer:.6f} (JAX {meta['mean_cer']:.6f})")
                if equal != len(lines) or cer != meta["mean_cer"]:
                    fail(f"inflight {label}: {equal}/{len(lines)} of JAX's strings, CER {cer} against "
                         f"{meta['mean_cer']}")
                res["jax_strings"], res["mean_cer"] = equal, cer
            for path in INFLIGHT_PATHS:
                r = res[path]
                name = path if path == "loop" else f"inflight {path}"
                idle = ("idle not measured (its trace holds about 4x the 64 lines' events)" if r["idle"] is None
                        else f"{r['idle']:.1%} idle (busy {r['busy_ms']:.1f} ms, {r['events']} events)")
                print(f"[inflight] {label}, {name}: {fmt_gaps(r['walls_ms'])} ms, {r['lines_per_s']:.1f} lines/s, "
                      f"{idle}; decode half {fmt_gaps(r['decode_ms'])} ms on the host; peak "
                      f"{max(r['peak_mib']):.1f} MiB above the Predictor; in flight {r['high'] or '-'}; "
                      f"{n_batches} batches on {smi}")
            print(f"[inflight] {label}: tokens of every request equal to the loop's; the loop's wall over each "
                  f"path's: " + ", ".join(f"{p} {res['loop']['ms'] / res[p]['ms']:.2f}x" for p in INFLIGHT_PATHS
                                          if p != "loop"))
            out["rows"][label] = res
    finally:
        predictor.decode_batch = real_decode
        pred.config = pred.config.replace(runtime=dataclasses.replace(pred.config.runtime, max_inflight_batches=4))
    out["encode_shapes"] = dict(n=len(pred.encode_cache), bytes=pred.encode_cache.nbytes)
    print(f"[inflight] the Predictor's encode graphs: {len(pred.encode_cache)} shapes of at most "
          f"{encode_graph.MAX_CHUNKS} chunks, {pred.encode_cache.nbytes / MIB:.1f} MiB (their inputs and pools)")
    return out


DETECT_REPS = 10  # forward + copy runs of each path, in turns


def detection_graphs_agree(torch, det, images, pixels, smi) -> dict:
    """The detector's forwards through its graphs (detection/graphs.py)
    against the eager forward on the same pixels, bit for bit: the packed
    maps of the group of 4 pages at model resolution, the first 3 pages as
    a short group through predict_maps_batch (padded to 4 with a zero page:
    no second capture, their maps those of the 4-page group), and each
    page's per-page bucket path (logits resized to the 256-rounded page
    size). Then forward + copy to the host eager against the graph, in
    turns, and the cache's keys and bytes. Captures and replays counted."""
    import numpy as np

    from khmer_ocr_torch.detection import graphs as dgraphs
    from khmer_ocr_torch.detection.detector import PRECISION, unpack_maps
    from khmer_ocr_torch.detection.preprocess import prepare_image
    from khmer_ocr_torch.detection.segformer import predict_maps
    from khmer_ocr_torch.cuda_graphs import pool_bytes
    from khmer_ocr_torch.precision import matmul_precision

    def eager(px, out_hw):
        with torch.inference_mode(), matmul_precision(PRECISION):
            return predict_maps(det.model, torch.from_numpy(px).to(det.device), out_hw, compact=True).cpu().numpy()

    det.graphs.shapes.clear()
    dgraphs.reset_counts()
    tile = pixels.shape[2]
    group = det.packed_maps(pixels)  # the capture: its first batch runs eagerly on the side stream
    group_replay = det.packed_maps(pixels)
    want = eager(pixels, (tile, tile))
    out = dict(group_equal=bool(np.array_equal(group, want)), group_replay_equal=bool(np.array_equal(group_replay,
                                                                                                     want)))
    before = (dgraphs.forward_captures, dgraphs.forward_replays)
    short = det.predict_maps_batch(images[:3], group=4)
    padded = np.concatenate([pixels[:3], np.zeros_like(pixels[:1])])
    want_short = eager(padded, (tile, tile))
    out["short_group_captures"] = dgraphs.forward_captures - before[0]
    out["short_group_replays"] = dgraphs.forward_replays - before[1]
    out["short_equal"] = all(np.array_equal(cm, unpack_maps(want_short[i], images[i].size)[0])
                             and np.array_equal(hm, unpack_maps(want_short[i], images[i].size)[1])
                             for i, (_, cm, hm) in enumerate(short))
    out["short_as_in_group"] = bool(np.array_equal(want_short[:3], want[:3]))
    bucket = []
    for img in images:
        _, cm, hm = det.predict_maps(img)
        _, px, (w, h) = prepare_image(img, tile)
        ref = unpack_maps(eager(px, (((h + 255) // 256) * 256, ((w + 255) // 256) * 256))[0], (w, h))
        bucket.append(bool(np.array_equal(cm, ref[0]) and np.array_equal(hm, ref[1])))
    out["bucket_equal"] = bucket
    out["captures"], out["replays"] = dgraphs.forward_captures, dgraphs.forward_replays
    out["keys"] = {f"{k[1]} -> {k[3]}": dict(mib=g.nbytes / MIB, pool_added_mib=g.pool_added / MIB,
                                             capture_s=g.capture_s) for k, g in det.graphs.shapes.items()}
    out["cache_mib"], out["pool_mib"] = det.graphs.nbytes / MIB, pool_bytes(det.graphs.pool()) / MIB
    print(f"[document] the detector's graphs against the eager forward, bit for bit: the group of {len(images)} "
          f"{out['group_equal']} (replayed {out['group_replay_equal']}); 3 pages padded to 4 {out['short_equal']} "
          f"({out['short_group_captures']} captures, {out['short_group_replays']} replay; their maps those of the "
          f"4-page group: {out['short_as_in_group']}); the per-page bucket path {bucket}; {out['captures']} captures, "
          f"{out['replays']} replays; {smi}")
    if not (out["group_equal"] and out["group_replay_equal"] and out["short_equal"] and out["short_as_in_group"]
            and all(bucket)):
        fail(f"document: the detector's graphs differ from the eager forward ({out})")
    if (out["short_group_captures"], out["short_group_replays"]) != (0, 1):
        fail(f"document: the short group took {out['short_group_captures']} captures and "
             f"{out['short_group_replays']} replays, not 0 and 1")
    times: dict = {"eager": [], "graph": []}
    for r in range(DETECT_REPS):
        for mode in (("eager", "graph") if r % 2 == 0 else ("graph", "eager")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eager(pixels, (tile, tile)) if mode == "eager" else det.packed_maps(pixels)
            times[mode].append((time.perf_counter() - t0) * 1e3)
    out["forward_copy_ms"] = {m: sorted(v) for m, v in times.items()}
    med = {m: sorted(v)[len(v) // 2] for m, v in times.items()}
    print(f"[document] forward + copy of the group of {len(images)} at {tile}x{tile}, medians of {DETECT_REPS} in "
          f"turns: eager {med['eager']:.3f} ms ({min(times['eager']):.3f}-{max(times['eager']):.3f}), the graph "
          f"{med['graph']:.3f} ms ({min(times['graph']):.3f}-{max(times['graph']):.3f}); the cache: "
          f"{len(det.graphs)} keys, {out['cache_mib']:.1f} MiB (the pool {out['pool_mib']:.1f} MiB): "
          + ", ".join(f"{k} {v['mib']:.1f} MiB (pool +{v['pool_added_mib']:.1f}, capture {v['capture_s']:.2f} s)"
                      for k, v in out["keys"].items()) + f"; {smi}")
    return out


def phase_document(torch, smi):
    """The page path: the SegFormer layout model (seeded weights, written as
    an HF checkpoint directory), its post-process on the host, and the
    trained flagship reading every detected line through K1 and K2, all
    through KhmerOCRPipeline(engine="custom"); then the searchable PDF.
    Held to the JAX package's golden (khmer_ocr_torch/assets/
    document_golden.{npz,json}, tests/test_torch_document.py assets).

    The seeded model finds one box a page, so process_pages is timed, in
    several runs, on the pages' known layout: the forward, the copy and the
    resize of the maps run as always, and each page's maps are then
    replaced by its known layout, so that the pipeline reads the 64 real
    lines."""
    import itertools
    import statistics
    import tempfile

    import numpy as np
    from PIL import Image

    from khmer_ocr_torch.convert.from_jax import seeded_segformer_state
    from khmer_ocr_torch.data.generator import find_fonts
    from khmer_ocr_torch.data.pages import compose_pages, layout_maps
    from khmer_ocr_torch.detection.detector import unpack_maps
    from khmer_ocr_torch.detection.postprocess import extract_layout_elements
    from khmer_ocr_torch.detection.preprocess import prepare_image
    from khmer_ocr_torch.detection.segformer import SegFormerConfig, predict_maps, save_hf_checkpoint
    from khmer_ocr_torch.infer.api import get_predictor
    from khmer_ocr_torch.metrics import score
    from khmer_ocr_torch.ops.kernels import build
    from khmer_ocr_torch.pipeline.document import run_layout_aware_pipeline
    from khmer_ocr_torch.pipeline.engine import KhmerOCRPipeline
    from khmer_ocr_torch.pipeline.minipdf import extract_pdf_text
    from khmer_ocr_torch.pipeline.pdf import generate_searchable_pdf

    assets = ROOT / "khmer_ocr_torch" / "assets"
    weights = assets / "flagship"
    meta = json.loads((assets / "document_golden.json").read_text())
    recipe = meta["recipe"]
    with np.load(assets / "document_golden.npz") as z:
        gold_maps = z["maps"]
        exempt = [z[f"exempt_{i}"] for i in range(gold_maps.shape[0])]
    with np.load(assets / "real_lines.npz") as z:
        lines = [z[f"line_{i}"] for i in range(len(z.files))]
    pages, boxes = compose_pages(lines, meta["pages"])
    images = [Image.fromarray(p).convert("RGB") for p in pages]
    bw, bs, pad, tile = recipe["beam_width"], recipe["batch_size"], recipe["padding"], recipe["tile"]
    out = {}

    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        layout_dir = save_hf_checkpoint(tmp / "layout", seeded_segformer_state(SegFormerConfig(), recipe["seed"]))
        paths = []
        for i, page in enumerate(pages):
            paths.append(tmp / f"page{i}.png")
            Image.fromarray(page).save(paths[-1])
        pipe = KhmerOCRPipeline(engine="custom", layout_model_dir=str(layout_dir), recognizer_model_path=str(weights))
        det = pipe.detector
        print(f"[document] KhmerOCRPipeline(engine='custom'): the layout model from {layout_dir.name}/ "
              f"(config.json + pytorch_model.bin, seed {recipe['seed']}) on {det.device}; "
              f"{len(pages)} pages of {pages[0].shape[1]}x{pages[0].shape[0]}, {len(lines)} lines")
        if det.device.type != "cuda":
            fail(f"document: the layout model is on {det.device}, not the card")

        # 1. maps: one group of 4 at model resolution against the JAX package's
        pixels = np.concatenate([prepare_image(img, tile)[1] for img in images])
        packed = det.packed_maps(pixels)
        x = torch.from_numpy(pixels).to(det.device)
        with torch.inference_mode():
            seg_ms = cuda_ms(torch, lambda: predict_maps(det.model, x, x.shape[2:], compact=True), reps=5)
        n_exempt = n_exempt_differ = 0
        for i, (got, want, ex) in enumerate(zip(packed, gold_maps, exempt)):
            cls_differ = got[0] != want[0]
            on_exempt = np.zeros(cls_differ.size, bool)
            on_exempt[ex] = True
            bad = int((cls_differ.ravel() & ~on_exempt).sum())
            heat = int(np.abs(got[1].astype(int) - want[1].astype(int)).max())
            n_exempt += ex.size
            n_exempt_differ += int((cls_differ.ravel() & on_exempt).sum())
            print(f"[document] page {i} maps at {tile}x{tile}: {bad} class ids differ off the {ex.size} near-tied "
                  f"pixels ({int((cls_differ.ravel() & on_exempt).sum())} on them), heatmap within {heat}")
            if bad or heat > 1:
                fail(f"document: page {i}'s maps differ from the JAX package's ({bad} class ids off near-ties, "
                     f"heatmap step {heat})")
        print(f"[document] SegFormer forward + resize + softmax + pack, a group of {len(pages)} at {tile}x{tile}: "
              f"{seg_ms:.3f} ms on {smi}")
        out["graphs"] = detection_graphs_agree(torch, det, images, pixels, smi)
        for i, img in enumerate(images):
            _, cm_pp, hm_pp = det.predict_maps(img)
            cm_b, hm_b = unpack_maps(packed[i], img.size)
            agree, dheat = float((cm_b == cm_pp).mean()), abs(float(hm_b.mean()) - float(hm_pp.mean()))
            print(f"[document] page {i}: the per-page path (logits to a 256-rounded bucket, then the page size) "
                  f"against the batched one: class agreement {agree:.4f}, mean heat {dheat:.4f} apart")
            if cm_pp.shape != (img.height, img.width) or agree <= 0.95 or dheat >= 0.05:
                fail(f"document: page {i}'s per-page maps diverge from the batched ones ({agree}, {dheat})")

        # 2. the post-process on this machine: the golden maps -> the golden elements
        import cv2

        ipp = next((ln.strip() for ln in cv2.getBuildInformation().splitlines() if "IPP" in ln), "no IPP line")
        known_maps = [layout_maps(p.shape, b) for p, b in zip(pages, boxes)]
        post_ms = []
        for name, maps_of in (("golden maps", lambda i: unpack_maps(gold_maps[i], images[i].size)),
                              ("known layout", lambda i: known_maps[i])):
            want_all = meta["elements"] if name == "golden maps" else meta["known_elements"]
            for i, img in enumerate(images):
                t0 = time.perf_counter()
                _, el = extract_layout_elements(img, *maps_of(i))
                post_ms.append((time.perf_counter() - t0) * 1e3)
                got = [[[int(v) for v in box], int(cls)] for box, cls in el]
                if got != want_all[i]:
                    print(f"[document] page {i}, {name}: elements {got} against the JAX package's {want_all[i]}; "
                          f"OpenCV {cv2.__version__}, {ipp}")
                    fail(f"document: the post-process gives other elements on page {i} ({name})")
        print(f"[document] post-process (OpenCV {cv2.__version__}, {ipp}): the golden elements on all "
              f"{len(images)} pages from the golden maps and from the known layout; {np.mean(post_ms):.1f} ms a page "
              f"on the host")

        # 3. recognition of the known layout's crops through K1 and K2
        page_known = [pipe._crops_from_elements(img, [(box, cls) for box, cls in el], pad)
                      for img, el in zip(images, meta["known_elements"])]
        crops = [cr for cs in page_known for cr in cs]
        pred = get_predictor(str(weights), None)  # the Predictor the pipeline recognises with
        if pred.device.type != "cuda":
            fail(f"document: the recognizer is on {pred.device}, not the card")
        check_memory(torch, pred, crops, bs, "known layout", tag="document")
        pred.predict_batch(crops, beam_width=bw, batch_size=bs)  # warm-up
        rows, c, wall = counted_run(torch, pred, crops, bw, bs, None)
        got = [strip(r) for r in rows]
        strings = [pred.tokenizer.decode(r) for r in got]
        differ = [i for i, (a, b) in enumerate(zip(strings, meta["crop_strings"])) if a != b]
        n_diff = check_tokens(torch, pred, [crops[i] for i in differ],
                              [pred.tokenizer.encode(meta["crop_strings"][i]) for i in differ],
                              [got[i] for i in differ], f"known-layout crops {differ}", tag="document")
        names = [f"crop_{i}" for i in range(len(crops))]
        res = score(names, meta["crop_texts"], strings)
        print(f"[document] known layout: {len(crops)} crops, beam {bw}, in {wall * 1e3:.1f} ms "
              f"({len(crops) / wall:.1f} lines/s) on {smi}; launches K1 {c['k1']}, K2 {c['k2']}, K3 {c['k3']}; "
              f"{len(crops) - n_diff}/{len(crops)} strings equal to the JAX package's; mean CER {res.mean_cer:.6f}, "
              f"exact match {res.exact_match_accuracy:.4f} (JAX: {meta['crop_mean_cer']:.6f}, "
              f"{meta['crop_exact_match']:.4f})")
        if c["k1"] == 0 or c["k2"] == 0:
            fail(f"document: K1 or K2 never launched on the known layout's crops ({c})")
        out["crops"] = dict(n=len(crops), ms=wall * 1e3, mean_cer=res.mean_cer, exact_match=res.exact_match_accuracy,
                            n_diff=n_diff, **c)

        # 4. the page path end to end: process_pages on the PNG pages
        spans = []

        def timed(name, fn):
            def run(*a, **k):
                t = time.perf_counter()
                r = fn(*a, **k)
                spans.append((name, t, time.perf_counter()))
                return r
            return run

        def counted_pages(page_paths, **kw):
            """process_pages with every count set to 0 just before it and read
            just after, its detection groups and recognition flushes kept as
            spans: (texts, wall s, counts, spans in ms from the call)."""
            spans.clear()
            pipe._detect_crops_batch = timed("detect", type(pipe)._detect_crops_batch.__get__(pipe))
            pipe._recognize = timed("recognise", type(pipe)._recognize.__get__(pipe))
            try:
                reset_counts()
                t0 = time.perf_counter()
                got = pipe.process_pages(page_paths, beam_width=bw, batch_size=bs, pages_per_batch=recipe["group"],
                                         **kw)
                torch.cuda.synchronize()
                took = time.perf_counter() - t0
            finally:
                del pipe._detect_crops_batch, pipe._recognize
            return (got, took, {k: build.launches[k] for k in ("k1", "k2", "k3")},
                    [(name, (a - t0) * 1e3, (b - t0) * 1e3) for name, a, b in spans])

        def show(spans_ms) -> str:
            return ", ".join(f"{name} {a:.0f}-{b:.0f}" for name, a, b in spans_ms)

        def apart(crops_of_pages, page_paths):
            """Detection of ``page_paths`` and recognition of ``crops_of_pages``,
            each timed on its own, the recognition also by the decode's Python
            step loop: (detection s, recognition s, by the loop s)."""
            t0 = time.perf_counter()
            pipe._detect_crops_batch([str(p) for p in page_paths], pad)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            pred.predict_batch(crops_of_pages, beam_width=bw, batch_size=bs)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            pred.eager_decode = True
            try:
                pred.predict_batch(crops_of_pages, beam_width=bw, batch_size=bs)
                torch.cuda.synchronize()
            finally:
                pred.eager_decode = False
            return t1 - t0, t2 - t1, time.perf_counter() - t2

        # 4a. with the seeded layout model: the texts against the JAX package's
        pipe.process_pages(paths, beam_width=bw, batch_size=bs, pages_per_batch=recipe["group"])  # warm-up
        texts, wall, counts, spans_ms = counted_pages(paths)
        seeded_crops = [cr for cs in pipe._detect_crops_batch([str(p) for p in paths], pad) for cr in cs]
        check_memory(torch, pred, seeded_crops, bs, "the seeded layout's crops", tag="document")
        print(f"[document] process_pages, the seeded layout model: {len(paths)} pages, {len(seeded_crops)} lines, "
              f"{wall * 1e3:.1f} ms; launches K1 {counts['k1']}, K2 {counts['k2']}, K3 {counts['k3']}; spans (ms from "
              f"the call): {show(spans_ms)}")
        if counts["k1"] == 0 or counts["k2"] == 0:
            fail(f"document: process_pages launched K1 {counts['k1']}, K2 {counts['k2']} times")
        for i, (got_t, want_t) in enumerate(zip(texts, meta["page_texts"])):
            if got_t == want_t:
                continue
            _, el = det.run(str(paths[i]))
            print(f"[document] page {i}: text {got_t!r} against the JAX package's {want_t!r}; its boxes here "
                  f"{[[[int(v) for v in box], int(cls)] for box, cls in el]}, the JAX package's {meta['elements'][i]}")
            if not n_exempt_differ:
                fail(f"document: page {i}'s text differs from the JAX package's, and no near-tied pixel took the "
                     "other class")
        print(f"[document] page texts equal to the JAX package's: {texts == meta['page_texts']} "
              f"({n_exempt} near-tied pixels, {n_exempt_differ} of them took the other class)")
        out["seeded"] = dict(lines=len(seeded_crops), ms=wall * 1e3, **counts)

        # 4b. on the known layout, timed in several runs: the 64 real lines
        offsets = np.cumsum([0] + [len(cs) for cs in page_known])
        want_texts = ["\n".join(strings[a:b]) for a, b in zip(offsets, offsets[1:])]
        batched, order = det.predict_maps_batch, itertools.cycle(range(len(pages)))  # the worker goes page by page
        det.predict_maps_batch = lambda srcs, group=4: [(im, *known_maps[next(order)])
                                                        for im, _, _ in batched(srcs, group=group)]
        try:
            pipe.process_pages(paths, beam_width=bw, batch_size=bs, pages_per_batch=recipe["group"])  # warm-up
            runs = []
            for r in range(DOC_RUNS):
                texts_k, wall_k, counts_k, spans_ms = counted_pages(paths)
                det_s, rec_s, rec_eager_s = apart(crops, paths)
                if texts_k != want_texts:
                    fail(f"document: run {r} of process_pages on the known layout reads {texts_k}, not the crops' "
                         f"strings {want_texts}")
                if counts_k["k1"] == 0 or counts_k["k2"] == 0:
                    fail(f"document: process_pages on the known layout launched K1 {counts_k['k1']}, K2 "
                         f"{counts_k['k2']} times")
                runs.append(dict(ms=wall_k * 1e3, detect_ms=det_s * 1e3, recognise_ms=rec_s * 1e3,
                                 recognise_eager_ms=rec_eager_s * 1e3, **counts_k))
                print(f"[document] process_pages, known layout, run {r}: {len(paths)} pages, {len(crops)} lines in "
                      f"{wall_k * 1e3:.1f} ms ({len(paths) / wall_k:.2f} pages/s); apart: detection {det_s * 1e3:.1f} "
                      f"ms + recognition {rec_s * 1e3:.1f} ms (by the Python step loop {rec_eager_s * 1e3:.1f} ms) = "
                      f"{(det_s + rec_s) * 1e3:.1f} ms (wall / sum "
                      f"{wall_k / (det_s + rec_s):.3f}); launches K1 {counts_k['k1']}, K2 {counts_k['k2']}, K3 "
                      f"{counts_k['k3']}; spans: {show(spans_ms)}")
            if any({k: u[k] for k in ("k1", "k2", "k3")} != {k: runs[0][k] for k in ("k1", "k2", "k3")}
                   for u in runs):
                fail(f"document: the runs launched the kernels unequally: {runs}")
            # the detection of the 4 pages step by step, as _detect_crops_batch does it
            steps, stamps = ("read PNG", "prepare", "forward + copy", "maps to page size", "post-process",
                             "crops"), [time.perf_counter()]
            imgs = [Image.open(p).convert("RGB") for p in paths]
            stamps.append(time.perf_counter())
            px = np.concatenate([prepare_image(im, tile)[1] for im in imgs])
            stamps.append(time.perf_counter())
            packed4 = det.packed_maps(px)
            stamps.append(time.perf_counter())
            [unpack_maps(m, im.size) for m, im in zip(packed4, imgs)]
            stamps.append(time.perf_counter())
            els = [extract_layout_elements(im, *m, det.cfg)[1] for im, m in zip(imgs, known_maps)]
            stamps.append(time.perf_counter())
            [pipe._crops_from_elements(im, el, pad) for im, el in zip(imgs, els)]
            stamps.append(time.perf_counter())
            split = {k: (b - a) * 1e3 for k, a, b in zip(steps, stamps, stamps[1:])}
            print(f"[document] detection of the {len(paths)} pages on the known layout, step by step (ms): "
                  + ", ".join(f"{k} {v:.1f}" for k, v in split.items()))
            # four times the pages, a flush after each group's lines: recognition beside the next group's detection
            many, runs_many = paths * 4, []
            for r in range(DOC_RUNS_16):
                texts_m, wall_m, counts_m, spans_ms = counted_pages(many, flush_lines=len(crops))
                if texts_m != want_texts * 4:
                    fail(f"document: run {r} of process_pages on 16 pages reads otherwise than on 4")
                runs_many.append(dict(ms=wall_m * 1e3, **counts_m))
                print(f"[document] process_pages, known layout, {len(many)} pages, flush_lines {len(crops)}, run {r}: "
                      f"{wall_m * 1e3:.1f} ms ({len(many) / wall_m:.2f} pages/s); launches K1 {counts_m['k1']}, K2 "
                      f"{counts_m['k2']}; spans: {show(spans_ms)}")
        finally:
            del det.predict_maps_batch

        def med(rs, key):
            return statistics.median(u[key] for u in rs)

        sums = [u["detect_ms"] + u["recognise_ms"] for u in runs]
        print(f"[document] process_pages on the known layout, medians of {DOC_RUNS} runs on {smi}: {len(paths)} "
              f"pages {med(runs, 'ms'):.1f} ms ({len(paths) / med(runs, 'ms') * 1e3:.2f} pages/s; runs "
              f"{min(u['ms'] for u in runs):.1f}-{max(u['ms'] for u in runs):.1f}), detection apart "
              f"{med(runs, 'detect_ms'):.1f} ms, recognition apart {med(runs, 'recognise_ms'):.1f} ms (by the Python "
              f"step loop {med(runs, 'recognise_eager_ms'):.1f} ms), their sum "
              f"{statistics.median(sums):.1f}; {len(many)} pages {med(runs_many, 'ms'):.1f} ms "
              f"({len(many) / med(runs_many, 'ms') * 1e3:.2f} pages/s; runs {min(u['ms'] for u in runs_many):.1f}-"
              f"{max(u['ms'] for u in runs_many):.1f}) against {4 * statistics.median(sums):.1f} ms for 4 x "
              f"(detection + recognition) apart")
        out["pages"] = dict(n=len(paths), lines=len(crops), ms=med(runs, "ms"),
                            pages_per_s=len(paths) / med(runs, "ms") * 1e3, detect_ms=med(runs, "detect_ms"),
                            recognise_ms=med(runs, "recognise_ms"), recognise_eager_ms=med(runs, "recognise_eager_ms"),
                            runs_ms=[u["ms"] for u in runs],
                            sums_ms=sums, detect_split_ms=split, **{k: runs[0][k] for k in ("k1", "k2", "k3")})
        out["pages_16"] = dict(ms=med(runs_many, "ms"), pages_per_s=len(many) / med(runs_many, "ms") * 1e3,
                               runs_ms=[u["ms"] for u in runs_many],
                               **{k: runs_many[0][k] for k in ("k1", "k2", "k3")})
        print(f"[document] the recognizer's graph cache: {len(pred.graph_cache)} decode shapes, their buffers "
              f"{pred.graph_cache.nbytes / 2**20:.1f} MiB")
        out["graph_cache"] = dict(shapes=len(pred.graph_cache), bytes=pred.graph_cache.nbytes)

        # the searchable PDF: the layout-aware pipeline's lines, then the known layout's strings of page 0
        font = next(f for f in find_fonts(None) if f.name == "NotoSansKhmer-Regular.ttf")
        results = run_layout_aware_pipeline(str(paths[0]), model_path=str(weights), beam_width=bw, engine="custom",
                                            layout_model_dir=str(layout_dir))
        known = [{"text": t, "bbox": box} for t, (box, _) in  # page 0's crops come first, top to bottom
                 zip(strings, sorted(meta["known_elements"][0], key=lambda e: e[0][1]))]
        pdf_bytes = []
        for name, items in (("layout-aware pipeline", results), ("known layout", known)):
            pdf = generate_searchable_pdf(paths[0], items, tmp / "page0.pdf", font)
            data = pdf.read_bytes()
            layer, want_layer = extract_pdf_text(pdf), [r["text"] for r in items if r["text"]]
            print(f"[document] searchable PDF of page 0, {name} ({font.name}): {len(data)} B, {len(items)} lines, "
                  f"the text layer {'equal to' if layer == want_layer else 'NOT equal to'} the recognised strings: "
                  f"{layer[:3]}{' ...' if len(layer) > 3 else ''}")
            if not data.startswith(b"%PDF-") or layer != want_layer:
                fail(f"document: the PDF's text layer {layer} is not the recognised {want_layer}")
            pdf_bytes.append(len(data))
        out.update(segformer_ms=seg_ms, post_ms=float(np.mean(post_ms)), pdf_bytes=pdf_bytes,
                   exempt=n_exempt, exempt_differ=n_exempt_differ)
    return out


# ---------------------------------------------------------------------------
# the tenth slice: bf16 serving, the fused head, the tensor-parallel blocks, the host input path
# ---------------------------------------------------------------------------

BF16_STEP = 2.0 ** -7  # one bf16 step of a value in [1, 2)
# K3's bf16 decode against its plain bf16 version on seeded weights (the vocabulary projection scaled by
# SHARPEN) and random memory: a differing answer is exempt as a near-tie when its normalised score is within
# BF16_NEAR_TIE of the plain answer's. Correct builds read gaps of 0.0005-0.032 there, a build that kept K3's
# layer outputs in float32 read 0.018-0.063 (PERF.md section 6): the first-step check below is what tells the two
# apart, this one holds the search over 64 steps.
BF16_NEAR_TIE = 0.05
SHARPEN = 8.0
# K3's first step in bf16 (max_len 1: the K lane scores are the top-K log-probs of one position, continuous in
# the inputs, so near-ties cannot part them): the median over images of the largest lane-score difference from
# the plain bf16 version. The same float32 values rounded at the same points agree but where a last bit flips
# (correct builds: median under 1e-5); a kernel that rounds elsewhere moves every image (the float32-output build:
# median 1e-3).
K3_FIRST_STEP_MEDIAN = 1e-4
FLAGSHIP = ROOT / "khmer_ocr_torch" / "assets" / "flagship"
TP_WORLD = 2


def bf16_tol(ref) -> float:
    """Two bf16 steps at the largest magnitude of ``ref``: the kernel and its
    plain version round the same float32 values to bf16, whose last bit a
    difference of summation order can flip."""
    return 2 * BF16_STEP * max(1.0, float(ref.float().abs().max()))


def k2_typed_cost(torch, n_img, lanes, d, f, heads, pos, tm, tm_valid, lineage, weights, itemsize, head=None):
    """k2_cost with the storage type's bytes: x, the caches, the memory K/V
    and the weight matrices ``itemsize`` bytes an element, the vectors,
    mem_valid and the lineage 4; with ``head`` its (D, Vp) weight, f32 bias
    and (B, Vp) f32 log-probs, and 2 D Vp operations a row."""
    from khmer_ocr_torch.ops.kernels.decode_step import MATRIX_FIELDS

    mat = sum(v.numel() for k, v in weights.items() if k in MATRIX_FIELDS)
    vec = sum(v.numel() for k, v in weights.items() if k not in MATRIX_FIELDS)
    nb0, ops = k2_cost(torch, n_img, lanes, d, f, heads, pos, tm, tm_valid, lineage, 0)
    b = n_img * lanes
    four = n_img * tm + (0 if lineage is None else b * pos)
    nbytes = itemsize * (nb0 // 4 - four + mat) + 4 * (vec + four)
    if head is not None:
        vp = head[0].shape[1]
        nbytes += itemsize * d * vp + 4 * vp + 4 * b * vp
        ops += 2 * b * d * vp
    return nbytes, ops


def k2_inputs(torch, gen, n_img, lanes, d, tm, cache_len, w, dtype=None):
    """Random inputs of one decode step: x, caches, memory K/V (in ``dtype``
    when given), ragged validity (float32), image-local lineage."""
    b = n_img * lanes
    cast = (lambda t: t.to(dtype)) if dtype is not None else (lambda t: t)
    x = cast(torch.randn(b, d, device="cuda", generator=gen) * 0.5)
    sk = cast(torch.randn(b, cache_len, d, device="cuda", generator=gen) * 0.3)
    sv = cast(torch.randn(b, cache_len, d, device="cuda", generator=gen) * 0.3)
    mk = cast(torch.randn(n_img, tm, d, device="cuda", generator=gen) * 0.3)
    mv = cast(torch.randn(n_img, tm, d, device="cuda", generator=gen) * 0.3)
    valid_len = torch.randint(1, tm + 1, (n_img,), device="cuda", generator=gen)
    mvf = (torch.arange(tm, device="cuda")[None, :] < valid_len[:, None]).float().contiguous()
    lin = torch.randint(0, lanes, (b, w), device="cuda", generator=gen, dtype=torch.int32)
    return x, sk, sv, mk, mv, mvf, lin, int(valid_len.sum())


def fmt_gaps(gaps) -> str:
    return "[" + ", ".join(f"{g:.5f}" for g in gaps) + "]"


def k3_bf16_agree(torch, label, params, cfg, memory, pad, got, ref, n_img, limit, score_tol):
    """K3 in bf16 against its plain bf16 version on the first ``n_img``
    images: (the largest difference of the answer's normalised score where
    the tokens are equal, images whose tokens differ, the normalised-score
    gap of each). Fails unless each such difference is under ``score_tol``
    and each gap under ``limit`` (0: no image may differ)."""
    (tok, sc), (tok_p, sc_p) = got, ref
    k, ml = sc.shape[1] - 1, tok.shape[1] - 2
    err, gaps = 0.0, []
    for i in range(n_img):
        if torch.equal(tok[i], tok_p[i]):
            # the answer's normalised score (the best completion's, or lane 0's running score over the
            # length); the other running lanes may part at near-ties without changing the answer
            done = sc_p[i, k].item() > -1e29
            e = abs(sc[i, k].item() - sc_p[i, k].item()) if done else \
                abs(sc[i, 0].item() - sc_p[i, 0].item()) / (ml + 1)
            if not e < score_tol:
                fail(f"bf16 K3 {label}: image {i} answer scores differ by {e:.3e} (tol {score_tol})")
            err = max(err, e)
            continue
        a, b = strip(tok_p[i].tolist()), strip(tok[i].tolist())
        s_ref, s_got = (memory_score(torch, params, cfg, memory[i:i + 1], pad[i:i + 1], torch.tensor(t, device="cuda"))
                        for t in (a, b))
        gaps.append(abs(s_ref - s_got))
        print(f"[bf16] K3 {label}: image {i} differs from the plain bf16 version: {a} vs {b}; normalised scores "
              f"{s_ref:.5f} vs {s_got:.5f}")
        if not abs(s_ref - s_got) < limit:
            fail(f"bf16 K3 {label}: image {i} differs" + (" and is not a near-tie" if limit else ""))
    return err, len(gaps), gaps


def k3_bf16_first_step(torch, params, cfg, n_img=64, tm=128, k=3):
    """K3's first step in bf16 against its plain bf16 version (max_len 1,
    seeded weights, random memory): per image the largest difference of
    the sorted lane scores (the top-K log-probs) and of the best completion;
    their median within K3_FIRST_STEP_MEDIAN, each within two bf16 steps of
    the largest |score|."""
    from khmer_ocr_torch.config import DecodeConfig
    from khmer_ocr_torch.ops.kernels import decode_loop as K3

    gen = torch.Generator(device="cuda").manual_seed(9)
    d = cfg.emb_dim
    memory = (torch.randn(n_img, tm, d, device="cuda", generator=gen) * 0.5).to(torch.bfloat16)
    valid_len = torch.randint(1, tm + 1, (n_img,), device="cuda", generator=gen)
    pad = torch.arange(tm, device="cuda")[None, :] >= valid_len[:, None]
    dec = DecodeConfig(beam_width=k, max_len=1)
    with torch.inference_mode():
        _, sc = K3.fused_beam_decode_kernel(params, memory, pad, cfg, dec, return_scores=True)
        _, sc_p = K3.fused_beam_decode_plain(params, memory, pad, cfg, dec, return_scores=True)
    lanes = (sc[:, :k].sort(dim=1).values - sc_p[:, :k].sort(dim=1).values).abs().max(dim=1).values
    done, done_p = sc[:, k] > -1e29, sc_p[:, k] > -1e29
    best = torch.where(done & done_p, (sc[:, k] - sc_p[:, k]).abs(), torch.zeros_like(lanes))
    per_image = torch.maximum(lanes, best).masked_fill(done != done_p, float("inf"))
    median, worst = per_image.median().item(), per_image.max().item()
    tol = 2 * BF16_STEP * max(1.0, sc_p[:, :k].abs().max().item())
    over = int((per_image > K3_FIRST_STEP_MEDIAN).sum())
    print(f"[bf16] K3's first step, {n_img}x{k} Tm={tm}, against its plain bf16 version: lane scores differ by "
          f"median {median:.2e} (limit {K3_FIRST_STEP_MEDIAN:g}), max {worst:.2e} (tol {tol:.2e}); {over}/{n_img} "
          f"images over {K3_FIRST_STEP_MEDIAN:g}")
    if not (median <= K3_FIRST_STEP_MEDIAN and worst <= tol):
        fail(f"bf16 K3 first step: lane scores differ by median {median:.3e} (limit {K3_FIRST_STEP_MEDIAN}), max "
             f"{worst:.3e} (tol {tol:.3e})")
    return dict(median=median, max=worst, images_over=over, images=n_img)


def k3_bf16_real(torch, pred, lines, bw, bs, max_len):
    """K3 in bf16 against its plain bf16 version on the trained flagship's
    encoder memory of the rendered lines (bf16 Predictor ``pred``), every
    batch inside K3's envelope: a trained head on real memory, whose
    choices are not near-ties, so every line's tokens must be equal and its
    answer's normalised score within TOL."""
    from khmer_ocr_torch.models.ocr_model import encode
    from khmer_ocr_torch.ops.kernels import decode_loop as K3
    from khmer_ocr_torch.ops.lines import device_chunk, u8_to_unit, unit_normalize

    cfg, dec = pred.model_cfg, pred._dec_cfg(bw, max_len)
    err, gaps, n_lines, n_batches = 0.0, [], 0, 0
    with torch.inference_mode():
        for batch in pred.preprocessor.iter_batches(lines, max_batch=bs):
            lt, ct, b = pred._to_device_batch(batch)
            chunks = device_chunk(unit_normalize(u8_to_unit(lt)), pred._chunk_geom).to(torch.bfloat16)
            memory, pad = encode(pred.params, chunks, ct, cfg)
            if not K3.should_use_megakernel(bw, dec.max_len, memory.shape[1], cfg.vocab_size, mode="1"):
                continue
            got = K3.fused_beam_decode_kernel(pred.params, memory, pad, cfg, dec, return_scores=True)
            ref = K3.fused_beam_decode_plain(pred.params, memory, pad, cfg, dec, return_scores=True)
            e, _, g = k3_bf16_agree(torch, f"flagship Tm={memory.shape[1]}", pred.params, cfg, memory, pad, got, ref, b,
                                    0.0, TOL)
            err, gaps, n_lines, n_batches = max(err, e), gaps + g, n_lines + b, n_batches + 1
    print(f"[bf16] K3 on the flagship's bf16 memory of {n_lines} rendered lines ({n_batches} batches inside its "
          f"envelope), beam {bw}, max_len {dec.max_len}: tokens equal the plain bf16 version but {len(gaps)} near-ties "
          f"(gaps {fmt_gaps(gaps)}), answer scores max|diff| {err:.2e}")
    if not n_lines:
        fail("bf16 K3: no batch of the rendered lines inside K3's envelope")
    return dict(lines=n_lines, batches=n_batches, images_differing=len(gaps), exempt_gaps=gaps, max_abs_err=err)


def phase_bf16(torch, state, cfg, smi):
    """bf16 serving on the card. (i) K2 in bf16 against its plain bf16
    version (the same rounding points) at 1, 8 and 64 images x 3 lanes, Tm
    256 and 4096, w=64 at pos 63: the output and the written cache slot
    within two bf16 steps of their largest value, every other slot
    untouched; its device time beside the float32 kernel's on the same
    inputs (CUDA graphs), with the bound at 2 bytes an element and the
    bf16 operation rate. (ii) K3 in bf16 against its plain bf16 version:
    its first step (k3_bf16_first_step); then at 8 and 64 images x 3, Tm
    128, max_len 64 on the seeded weights with
    the vocabulary projection scaled by SHARPEN and random memory, then on
    the trained flagship's bf16 memory of the rendered lines (the batches
    inside K3's envelope): tokens equal but for near-ties (normalised
    scores within BF16_NEAR_TIE; each exempt gap printed and returned), the
    answer's normalised score within BF16_NEAR_TIE where they are equal;
    the images whose tokens equal the float32 kernel's counted; times
    beside float32. (iii) The trained
    flagship on the 64 rendered lines with compute_dtype="bfloat16",
    matmul precision "default": the strings against the JAX package's bf16
    strings stored with the lines, the mean CER at most theirs + 0.005;
    lines/s beside float32's, by the step loop and with
    KHMER_OCR_MEGA_DECODE=1, each request's launches counted."""
    import dataclasses

    import numpy as np

    from khmer_ocr_torch.config import DecodeConfig, OCRConfig, RuntimeConfig
    from khmer_ocr_torch.decode.beam import beam_decode
    from khmer_ocr_torch.cuda_graphs import GraphCache
    from khmer_ocr_torch.infer.predictor import Predictor, cast_params
    from khmer_ocr_torch.metrics import score
    from khmer_ocr_torch.models.layers import pack_step_params
    from khmer_ocr_torch.models.ocr_model import pack_decode_params
    from khmer_ocr_torch.ops.kernels import decode_loop as K3
    from khmer_ocr_torch.ops.kernels import build
    from khmer_ocr_torch.ops.kernels import decode_step as K2
    from khmer_ocr_torch.ops.kernels import geometry

    bf = torch.bfloat16
    d, heads, f, n_layers, vocab = cfg.emb_dim, cfg.num_heads, cfg.dec_ffn_dim, cfg.dec_layers, cfg.vocab_size
    w32 = K2.layer_weights(pack_step_params(state["dec"]["layers"][0]))
    w16 = K2.layer_weights(pack_step_params(cast_params(state["dec"]["layers"][0], bf)))
    gen = torch.Generator(device="cuda").manual_seed(5)
    k2_rows, k2_worst, cache_len, w, lanes = [], 0.0, 256, 64, 3
    for n_img, tm in ((1, 256), (8, 256), (64, 256), (1, 4096), (8, 4096), (64, 4096)):
        pos = w - 1
        at = torch.tensor(pos, dtype=torch.int32, device="cuda")
        x, sk, sv, mk, mv, mvf, lin, tm_valid = k2_inputs(torch, gen, n_img, lanes, d, tm, cache_len, w)
        x16, sk16, sv16, mk16, mv16 = (t.to(bf) for t in (x, sk, sv, mk, mv))
        a_k, a_v, p_k, p_v = sk16.clone(), sv16.clone(), sk16.clone(), sv16.clone()
        kw = dict(num_heads=heads, window=w, lanes=lanes)
        out = K2.decoder_layer_step(w16, x16, at, a_k, a_v, mk16, mv16, mvf, lin, **kw)
        ref = K2.decoder_layer_step_plain(w16, x16, pos, p_k, p_v, mk16, mv16, mvf, lin, **kw)
        torch.cuda.synchronize()
        err = max((out.float() - ref.float()).abs().max().item(),
                  (a_k[:, pos].float() - p_k[:, pos].float()).abs().max().item(),
                  (a_v[:, pos].float() - p_v[:, pos].float()).abs().max().item())
        tol = max(bf16_tol(ref), bf16_tol(p_k[:, pos]), bf16_tol(p_v[:, pos]))
        keep = torch.ones(cache_len, dtype=torch.bool, device="cuda")
        keep[pos] = False
        untouched = torch.equal(a_k[:, keep], sk16[:, keep]) and torch.equal(a_v[:, keep], sv16[:, keep])
        shape = f"{n_img}x{lanes} w={w} Tm={tm}"
        if not (err <= tol and untouched and bool(torch.isfinite(out.float()).all())):
            fail(f"bf16 K2 {shape}: max|diff| {err:.3e} (tol {tol:.3e}), untouched slots identical: {untouched}")
        k2_worst = max(k2_worst, err)
        ms16 = graph_ms(torch, lambda: K2.decoder_layer_step(w16, x16, at, a_k, a_v, mk16, mv16, mvf, lin, **kw))
        f_k, f_v = sk.clone(), sv.clone()
        ms32 = graph_ms(torch, lambda: K2.decoder_layer_step(w32, x, at, f_k, f_v, mk, mv, mvf, lin, **kw))
        plain_ms = cuda_ms(torch, lambda: K2.decoder_layer_step_plain(w16, x16, pos, p_k, p_v, mk16, mv16, mvf, lin,
                                                                      **kw), 2)
        bms, by = bound_ms(*k2_typed_cost(torch, n_img, lanes, d, f, heads, pos, tm, tm_valid, lin, w16, 2), 2)
        b32, _ = bound_ms(*k2_typed_cost(torch, n_img, lanes, d, f, heads, pos, tm, tm_valid, lin, w32, 4))
        k2_rows.append(dict(shape=shape, max_abs_err=err, tol=tol, ms=ms16, f32_ms=ms32, plain_ms=plain_ms,
                            library_ms=None, bound_ms=bms, bound_by=by, f32_bound_ms=b32))
        print(f"[bf16] K2 {shape:20s}: max|kernel - plain bf16| {err:.2e} (tol {tol:.2e}), untouched slots "
              f"identical; bf16 {ms16:.4f} ms against float32 {ms32:.4f} ms on the same inputs "
              f"({ms32 / ms16:.2f}x), plain bf16 {plain_ms:.3f} ms; bound {bms:.4f} ms ({by}; float32's {b32:.4f}), "
              f"{bms / ms16:.2%} of roofline")
        del x, sk, sv, mk, mv, x16, sk16, sv16, mk16, mv16, a_k, a_v, p_k, p_v, f_k, f_v

    layer_numel = layer_numels(pack_decode_params(state)["dec"]["layers_kernel"][0])
    resident = {}
    for k in (3, 4):  # in bf16 the self caches of beam 4 fit on chip too (geometry.k3_smem_bytes)
        vp = geometry.k3_vocab_cols(vocab, heads, 8)
        _, on_chip, tc = geometry.k3_geometry(k, d, heads, f, 64, vocab, n_layers, 128, 2)
        resident[k] = (on_chip, K3.resident_clusters(k, d, heads, f, 64, vp, n_layers, on_chip, tc, bf))
    print("[bf16] K3's clusters the card holds at once in bf16 (Tm=128, max_len 64): " + "; ".join(
        f"beam {k}: {n} with the self caches {'on chip' if oc else 'in global memory'}" for k, (oc, n) in
        resident.items()))
    first_step = k3_bf16_first_step(torch, cast_params(state, bf), cfg)
    k3_rows, k3_worst, k3_gaps = [], 0.0, []
    gen = torch.Generator(device="cuda").manual_seed(7)
    sharp32 = {**state, "dec": {**state["dec"], "out": {**state["dec"]["out"],
                                                         "w": state["dec"]["out"]["w"] * SHARPEN}}}
    sharp = cast_params(sharp32, bf)
    cache = GraphCache()  # the step loop's graphs, captured at each shape's first call
    for n_img in (8, 64):
        tm, k, ml = 128, 3, 64
        memory = torch.randn(n_img, tm, d, device="cuda", generator=gen) * 0.5
        valid_len = torch.randint(1, tm + 1, (n_img,), device="cuda", generator=gen)
        pad = torch.arange(tm, device="cuda")[None, :] >= valid_len[:, None]
        m16 = memory.to(bf)
        dec = DecodeConfig(beam_width=k, max_len=ml)
        shape = f"{n_img}x{k} Tm={tm} max_len={ml}"
        with torch.inference_mode():
            ref, plain_ms = timed(torch, lambda: K3.fused_beam_decode_plain(sharp, m16, pad, cfg, dec,
                                                                            return_scores=True))
            got = K3.fused_beam_decode_kernel(sharp, m16, pad, cfg, dec, return_scores=True)
            err, n_diff, gaps = k3_bf16_agree(torch, f"seeded, head x{SHARPEN:g}, {shape}", sharp, cfg, m16, pad, got,
                                              ref, n_img, BF16_NEAR_TIE, BF16_NEAR_TIE)
            tok32, _ = K3.fused_beam_decode_kernel(sharp32, memory, pad, cfg, dec, return_scores=True)
            same32 = sum(bool(torch.equal(got[0][i], tok32[i])) for i in range(n_img))
            ms16 = cuda_ms(torch, lambda: K3.fused_beam_decode_kernel(sharp, m16, pad, cfg, dec), 3)
            ms32 = cuda_ms(torch, lambda: K3.fused_beam_decode_kernel(sharp32, memory, pad, cfg, dec), 3)
            host16 = cuda_ms(torch, lambda: beam_decode(sharp, m16, pad, cfg, dataclasses.replace(dec, mega_mode="0"),
                                                        graph_cache=cache), 2)
        k3_worst, k3_gaps = max(k3_worst, err), k3_gaps + gaps
        _, on_chip, _ = geometry.k3_geometry(k, d, heads, f, ml, vocab, n_layers, tm, 2)
        nbytes, ops = k3_cost(n_img, k, d, f, heads, ml, tm, int(valid_len.sum()), n_layers, vocab, *layer_numel, 2)
        bms, by = bound_ms(nbytes, ops, 2)
        k3_rows.append(dict(shape=shape, route="on chip" if on_chip else "global", max_abs_err=err, ms=ms16,
                            f32_ms=ms32, plain_ms=plain_ms, step_loop_ms=host16, library_ms=None, bound_ms=bms,
                            bound_by=by, images_differing=n_diff, exempt_gaps=gaps, images_equal_f32=same32))
        print(f"[bf16] K3 {shape}: self caches {'on chip' if on_chip else 'global'}; with the head x{SHARPEN:g}, "
              f"tokens equal the plain bf16 version but {n_diff} near-ties (gaps {fmt_gaps(gaps)}), answer scores "
              f"max|diff| {err:.2e}; {same32}/{n_img} images token-equal to the float32 kernel's; bf16 {ms16:.3f} ms "
              f"against float32 {ms32:.3f} ms, plain {plain_ms:.1f} ms, step loop bf16 {host16:.1f} ms; bound {bms:.4f} ms ({by}), {bms / ms16:.2%} of roofline")

    assets = ROOT / "khmer_ocr_torch" / "assets"
    meta = json.loads((assets / "real_lines.json").read_text())
    lines = [line for line, _ in real_samples(len(meta["texts"]))]
    bw, max_len, bs = (meta["recipe"][k] for k in ("beam_width", "max_len", "batch_size"))
    names = [f"line_{i}" for i in range(len(lines))]
    preds = {"float32": Predictor(model_path=FLAGSHIP),
             "bfloat16": Predictor(model_path=FLAGSHIP, config=OCRConfig(
                 runtime=RuntimeConfig(compute_dtype="bfloat16", matmul_precision="default")))}
    real_k3 = k3_bf16_real(torch, preds["bfloat16"], lines, bw, bs, max_len)
    k3_worst, k3_gaps = max(k3_worst, real_k3["max_abs_err"]), k3_gaps + real_k3["exempt_gaps"]
    real, launches = {}, {}
    for mode in ("k2", "k3"):
        for dt, pred in preds.items():
            with MegaDecode() if mode == "k3" else contextlib.nullcontext():
                pred.predict_batch_tokens(lines, beam_width=bw, batch_size=bs, max_len=max_len)  # warm-up
                rows, c, wall = counted_run(torch, pred, lines, bw, bs, max_len)
            c.update(k2_bf16=build.launches["k2_bf16"])
            strings = [pred.tokenizer.decode(r) for r in rows]
            res = score(names, meta["texts"], strings)
            ref = meta["strings"] if dt == "float32" else meta["bf16_strings"]
            equal = sum(a == b for a, b in zip(strings, ref))
            real[f"{dt}_{mode}"] = dict(lines_per_s=len(lines) / wall, ms=wall * 1e3, mean_cer=res.mean_cer,
                                        exact_match=res.exact_match_accuracy, equal_to_jax=equal, **c)
            print(f"[bf16] flagship {dt}, {'KHMER_OCR_MEGA_DECODE=1' if mode == 'k3' else 'step loop'}: "
                  f"{len(lines)} lines in {wall * 1e3:.1f} ms ({len(lines) / wall:.1f} lines/s) on {smi}; "
                  f"{equal}/{len(lines)} strings equal to the JAX package's {dt}; mean CER {res.mean_cer:.6f} "
                  f"(JAX {dt}: {meta['mean_cer' if dt == 'float32' else 'bf16_mean_cer']:.6f}); launches K1 "
                  f"{c['k1']}, K2 {c['k2']} (bf16 {c['k2_bf16']}), K3 {c['k3']}")
            if dt == "bfloat16":
                launches[mode] = c
                if not res.mean_cer <= meta["bf16_mean_cer"] + 0.005:
                    fail(f"bf16 flagship {mode}: mean CER {res.mean_cer:.6f} > the JAX package's bf16 "
                         f"{meta['bf16_mean_cer']:.6f} + 0.005")
                if c["k2_bf16"] != c["k2"] or c[mode] == 0:
                    fail(f"bf16 flagship {mode}: launches {c} (every K2 launch bf16, {mode.upper()} launched)")
    del preds
    torch.cuda.empty_cache()
    print(f"[bf16] K3 against its plain bf16 version: {len(k3_gaps)} image(s) exempt as near-ties in all, gaps "
          f"{fmt_gaps(k3_gaps)} (BF16_NEAR_TIE {BF16_NEAR_TIE})")
    return dict(k2_rows=k2_rows, k2_err=k2_worst, k3_rows=k3_rows, k3_err=k3_worst, real=real, k3_resident=resident,
                k3_real=real_k3, k3_exempt_gaps=k3_gaps, k3_first_step=first_step, k2_launches=launches["k2"]["k2_bf16"],
                k3_launches=launches["k3"]["k3"])


PRECISION_WAIT = 0.5  # seconds the detector must stay blocked behind another precision's scope


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref|."""
    return ((got.double() - ref).abs().max() / ref.abs().max()).item()


def phase_precision(torch, smi):
    """The matmul precision is scoped to each call (khmer_ocr_torch/
    precision.py), as the JAX package scopes default_matmul_precision. (i)
    LayoutInference on the seeded SegFormer, then a Predictor of the trained
    flagship with compute_dtype="bfloat16" and matmul_precision="default"
    on 8 of the 64 rendered lines (beam 3, max_len 64): torch's three
    switches after the call equal those before it, and the strings score
    within 0.005 of the JAX package's bf16 CER on those lines. (ii) One
    float32 384 x 384 x 384 matmul against float64: its max error relative
    to the largest |value| below 1e-5 outside any scope (float32), above
    1e-4 inside matmul_precision("default") (TF32); both timed. (iii) One
    LayoutInference.packed_maps at "highest" while another thread holds a
    "default" scope: it waits until that scope ends, then gives maps
    bit-equal to a run without the thread."""
    import threading

    import numpy as np

    from khmer_ocr_torch.config import OCRConfig, RuntimeConfig
    from khmer_ocr_torch.convert.from_jax import seeded_segformer_state
    from khmer_ocr_torch.data.pages import compose_pages
    from khmer_ocr_torch.detection import detector
    from khmer_ocr_torch.infer.predictor import Predictor
    from khmer_ocr_torch.metrics import score
    from khmer_ocr_torch.precision import matmul_precision, switches

    layout = detector.LayoutInference(None, params=seeded_segformer_state(None, 0))
    meta = json.loads((FLAGSHIP.parent / "real_lines.json").read_text())
    samples = real_samples(8)
    lines = [line for line, _ in samples]
    before = switches()
    pred = Predictor(model_path=FLAGSHIP, config=OCRConfig(runtime=RuntimeConfig(compute_dtype="bfloat16",
                                                                                  matmul_precision="default")))
    rows = pred.predict_batch_tokens(lines, beam_width=3, batch_size=8, max_len=64)
    torch.cuda.synchronize()
    after = switches()
    names = [f"line_{i}" for i in range(len(lines))]
    got = score(names, meta["texts"][:8], [pred.tokenizer.decode(r) for r in rows])
    jax_bf16 = score(names, meta["texts"][:8], meta["bf16_strings"][:8])
    print(f"[precision] switches (cuda.matmul.allow_tf32, cudnn.allow_tf32, float32 matmul precision) before a bf16 "
          f"'default' Predictor {before}, after its 8-line call {after}; mean CER {got.mean_cer:.6f} against the JAX "
          f"package's bf16 {jax_bf16.mean_cer:.6f}")
    if after != before:
        fail(f"precision: a Predictor call left the switches {after}, found {before}")
    if not got.mean_cer <= jax_bf16.mean_cer + 0.005:
        fail(f"precision: the bf16 Predictor's mean CER {got.mean_cer:.6f} > JAX's {jax_bf16.mean_cer:.6f} + 0.005")
    del pred

    gen = torch.Generator(device="cuda").manual_seed(12)
    a, b = (torch.randn(384, 384, device="cuda", generator=gen) for _ in range(2))
    ref = a.double() @ b.double()
    err_out, ms_out = rel_err(a @ b, ref), cuda_ms(torch, lambda: a @ b, 50)
    with matmul_precision("default"):
        err_in, ms_in = rel_err(a @ b, ref), cuda_ms(torch, lambda: a @ b, 50)
    print(f"[precision] float32 384x384x384 matmul against float64: max error / max |value| {err_out:.3e} outside any "
          f"scope ({ms_out:.4f} ms), {err_in:.3e} inside matmul_precision('default') ({ms_in:.4f} ms) on {smi}")
    if not (err_out < 1e-5 and err_in > 1e-4):
        fail(f"precision: matmul errors {err_out:.3e} outside (limit 1e-5), {err_in:.3e} inside 'default' (above 1e-4)")

    page = compose_pages([line for line, _ in real_samples(16)])[0][0]
    from PIL import Image

    pixels = detector.prepare_image(Image.fromarray(page), layout.cfg.image_size)[1]
    alone = layout.packed_maps(pixels)
    held, release, entered = threading.Event(), threading.Event(), {}
    real_run = layout.graphs.forward  # the forward: a replay of the graph the first call captured

    def spy(*args, **kw):  # the forward's own precision, and when it began
        entered.update(t=time.perf_counter(), switches=switches())
        return real_run(*args, **kw)

    def holder():
        with matmul_precision("default"):
            held.set()
            release.wait(30)
            entered["released"] = time.perf_counter()

    out = []
    layout.graphs.forward = spy
    try:
        h = threading.Thread(target=holder)
        h.start()
        if not held.wait(30):
            fail("precision: the holder thread never entered its scope")
        d = threading.Thread(target=lambda: out.append(layout.packed_maps(pixels)))
        d.start()
        d.join(PRECISION_WAIT)
        waited = d.is_alive() and "t" not in entered
        release.set()
        h.join(30)
        d.join(30)
    finally:
        del layout.graphs.forward
    same = bool(out) and np.array_equal(out[0], alone)
    print(f"[precision] packed_maps at 'highest' beside a thread holding 'default': waited {waited} (still out after "
          f"{PRECISION_WAIT} s), began {entered.get('t', 0) - entered.get('released', 0):+.4f} s after the scope "
          f"ended under {entered.get('switches')}; maps {tuple(alone.shape)} bit-equal to a run without the thread: "
          f"{same}")
    if not (waited and not h.is_alive() and not d.is_alive() and entered.get("t", 0) >= entered["released"]):
        fail("precision: the detector did not wait for the other precision's scope to end")
    if entered["switches"] != (False, False, "highest") or not same:
        fail(f"precision: the detector ran under {entered['switches']}, maps bit-equal {same}")
    return dict(switches_before=before, switches_after=after, mean_cer=got.mean_cer, jax_bf16_mean_cer=jax_bf16.mean_cer,
                matmul_rel_err=err_out, tf32_matmul_rel_err=err_in, matmul_ms=ms_out, tf32_matmul_ms=ms_in,
                detector_waited=waited, maps_bit_equal=same)

def phase_head(torch, state, cfg, smi):
    """The decode head fused into K2's last launch. (i) The kernel with
    ``head`` against its plain version, float32 and bf16, 1 and 8 images x 3
    lanes, Tm 256: the layer output as K2 (1e-4; two bf16 steps), the
    log-probs within 1e-4 x max(1, |ref|) in float32 and two bf16 steps of the
    largest |log-prob| in bf16 (a flipped last bit of a rounded logit), the
    padded columns NEG_INF; device time with and without the head. (ii) The
    flagship's first 18 rendered lines at beam 3 with KHMER_OCR_FUSED_HEAD=1:
    tokens equal to those without it, near-ties excepted, launches counted."""
    from khmer_ocr_torch.infer.predictor import Predictor, cast_params
    from khmer_ocr_torch.models.layers import pack_step_params
    from khmer_ocr_torch.ops.kernels import build
    from khmer_ocr_torch.ops.kernels import decode_step as K2

    d, heads, f = cfg.emb_dim, cfg.num_heads, cfg.dec_ffn_dim
    gen = torch.Generator(device="cuda").manual_seed(6)
    rows, worst, cache_len, w, lanes = [], 0.0, 256, 64, 3
    for dt in ("float32", "bfloat16"):
        cdt = getattr(torch, dt)
        layer = state["dec"]["layers"][0] if dt == "float32" else cast_params(state["dec"]["layers"][0], cdt)
        wt = K2.layer_weights(pack_step_params(layer))
        head = K2.head_weights({k: v.to(cdt) for k, v in state["dec"]["out"].items()})
        for n_img, tm in ((1, 256), (8, 256)):
            pos = w - 1
            at = torch.tensor(pos, dtype=torch.int32, device="cuda")
            x, sk, sv, mk, mv, mvf, lin, tm_valid = k2_inputs(torch, gen, n_img, lanes, d, tm, cache_len, w, cdt)
            kw = dict(num_heads=heads, window=w, lanes=lanes)
            a_k, a_v, p_k, p_v = sk.clone(), sv.clone(), sk.clone(), sv.clone()
            out, logp = K2.decoder_layer_step(wt, x, at, a_k, a_v, mk, mv, mvf, lin, head=head, **kw)
            ref, ref_lp = K2.decoder_layer_step_plain(wt, x, pos, p_k, p_v, mk, mv, mvf, lin, head=head, **kw)
            torch.cuda.synchronize()
            v = head[2]
            x_err = (out.float() - ref.float()).abs().max().item()
            lp_err = (logp[:, :v] - ref_lp[:, :v]).abs().max().item()
            if dt == "float32":
                x_tol, lp_tol = TOL, TOL * max(1.0, ref_lp[:, :v].abs().max().item())
            else:
                x_tol, lp_tol = bf16_tol(ref), bf16_tol(ref_lp[:, :v])
            shape = f"{dt} {n_img}x{lanes} w={w} Tm={tm}"
            padded = bool((logp[:, v:] == -1e30).all())
            if not (x_err <= x_tol and lp_err <= lp_tol and padded and bool(torch.isfinite(logp[:, :v]).all())):
                fail(f"head K2 {shape}: layer max|diff| {x_err:.3e} (tol {x_tol:.3e}), log-probs {lp_err:.3e} "
                     f"(tol {lp_tol:.3e}), padded columns NEG_INF: {padded}")
            worst = max(worst, x_err if dt == "float32" else 0.0, lp_err if dt == "float32" else 0.0)
            ms = graph_ms(torch, lambda: K2.decoder_layer_step(wt, x, at, a_k, a_v, mk, mv, mvf, lin, head=head,
                                                               **kw))
            ms_no = graph_ms(torch, lambda: K2.decoder_layer_step(wt, x, at, a_k, a_v, mk, mv, mvf, lin, **kw))
            plain_ms = cuda_ms(torch, lambda: K2.decoder_layer_step_plain(wt, x, pos, p_k, p_v, mk, mv, mvf, lin,
                                                                          head=head, **kw), 2)
            bms, by = bound_ms(*k2_typed_cost(torch, n_img, lanes, d, f, heads, pos, tm, tm_valid, lin, wt,
                                              cdt.itemsize, head), cdt.itemsize)
            rows.append(dict(shape=shape, max_abs_err=max(x_err, lp_err), logp_err=lp_err, ms=ms, no_head_ms=ms_no,
                             plain_ms=plain_ms, library_ms=None, bound_ms=bms, bound_by=by))
            print(f"[head] K2 {shape:26s}: layer max|diff| {x_err:.2e}, log-probs {lp_err:.2e} (tol {lp_tol:.2e}), "
                  f"padded columns NEG_INF; with the head {ms:.4f} ms, without {ms_no:.4f} ms, plain {plain_ms:.3f} "
                  f"ms; bound {bms:.4f} ms ({by}), {bms / ms:.2%} of roofline")

    lines = [line for line, _ in real_samples(SERVE_LINES)]
    pred = Predictor(model_path=FLAGSHIP)
    saved = os.environ.get("KHMER_OCR_FUSED_HEAD")
    runs = {}
    try:
        for mode in ("0", "1"):
            os.environ["KHMER_OCR_FUSED_HEAD"] = mode
            pred.predict_batch_tokens(lines, beam_width=3, batch_size=8, max_len=64)  # warm-up
            h0 = pred.head_batches
            rows_, c, wall = counted_run(torch, pred, lines, 3, 8, 64)
            c.update(head=build.launches["k2_head"], head_batches=pred.head_batches - h0)
            runs[mode] = ([strip(r) for r in rows_], c, wall)
    finally:
        if saved is None:
            os.environ.pop("KHMER_OCR_FUSED_HEAD", None)
        else:
            os.environ["KHMER_OCR_FUSED_HEAD"] = saved
    (off, c0, w0), (on, c1, w1) = runs["0"], runs["1"]
    n_diff = check_tokens(torch, pred, lines, off, on, "KHMER_OCR_FUSED_HEAD=1 vs without", tag="head")
    print(f"[head] {SERVE_LINES} flagship lines, beam 3, max_len 64: with the head {w1 * 1e3:.1f} ms (K2 {c1['k2']} "
          f"launches, {c1['head']} with the head, {c1['head_batches']} batches), without {w0 * 1e3:.1f} ms (K2 "
          f"{c0['k2']}, {c0['head']} with the head); {SERVE_LINES - n_diff}/{SERVE_LINES} lines token-equal on {smi}")
    if c1["head"] == 0 or c0["head"] or c1["head"] != c1["steps"]:
        fail(f"head: launches {c1} with the head, {c0} without (one head launch a decode step expected)")
    return dict(rows=rows, err=worst, launches=c1["head"], on_ms=w1 * 1e3, off_ms=w0 * 1e3, n_diff=n_diff)


def tp_local(torch, lw: dict, m: int, n_model: int, d: int) -> dict:
    """Model rank m's part of a layer's kernel operands (parallel/placement.py's
    cut: q, k, v and cross q columns, the out-projections' rows, lin1's
    columns and lin2's rows, with the biases of the split columns)."""
    da, fl = d // n_model, lw["l1_w"].shape[1] // n_model
    cols = lambda t, n: t[..., m * n:(m + 1) * n]  # noqa: E731
    qkv = lambda t: torch.cat([cols(t[..., j * d:(j + 1) * d], da) for j in range(3)], dim=-1)  # noqa: E731
    out = dict(lw)
    out.update(qkv_w=qkv(lw["qkv_w"]), qkv_b=qkv(lw["qkv_b"]), so_w=lw["so_w"][m * da:(m + 1) * da],
               cq_w=cols(lw["cq_w"], da), cq_b=cols(lw["cq_b"], da), co_w=lw["co_w"][m * da:(m + 1) * da],
               l1_w=cols(lw["l1_w"], fl), l1_b=cols(lw["l1_b"], fl), l2_w=lw["l2_w"][m * fl:(m + 1) * fl])
    return {k: v.contiguous() for k, v in out.items()}


def tp_block_cost(torch, n_img, lanes, d, f, heads, pos, tm, tm_valid, lineage, local, itemsize):
    """Bytes and operations of one rank's four block launches of a layer
    under a model group of TP_WORLD: its weights, its heads' columns of the
    cache rows the lineage reaches and of the valid memory rows, the cache
    slot written (``itemsize`` bytes an element); the vectors, the (B, D)
    float32 residual read and written by each launch, the partial sums read
    by three and written by three, mem_valid and the lineage (4 bytes);
    one TP_WORLD-th of K2's operations."""
    from khmer_ocr_torch.ops.kernels.decode_step import MATRIX_FIELDS

    b, da = n_img * lanes, d // TP_WORLD
    pairs = b * pos
    if pos and lineage is not None:
        src = lineage[:, :pos].long() + lanes * (torch.arange(b, device=lineage.device)[:, None] // lanes)
        pairs = (src * pos + torch.arange(pos, device=lineage.device)[None, :]).unique().numel()
    mat = sum(v.numel() for k, v in local.items() if k in MATRIX_FIELDS)
    vec = sum(v.numel() for k, v in local.items() if k not in MATRIX_FIELDS)
    nbytes = itemsize * (mat + 2 * pairs * da + 2 * tm_valid * da + 2 * b * da) + 4 * (
        vec + 4 * 2 * b * d + 6 * b * d + n_img * tm + (0 if lineage is None else b * pos))
    _, ops = k2_cost(torch, n_img, lanes, d, f, heads, pos, tm, tm_valid, lineage, 0)
    return nbytes, ops / TP_WORLD


def phase_tp_blocks(torch, state, cfg):
    """K2's tensor-parallel blocks on one card, both ranks' parts in this
    process: each block kernel against its plain version (the residual, the
    partial sum and the written cache slot within 1e-4, two bf16 steps in
    bf16), and the self, cross and FFN blocks of the two parts chained, each
    pair of partial sums added, into the unsplit K2 step (1e-4; two bf16
    steps). 8 images x 3 lanes for a rank of a model group of 2 (4 heads,
    F/2 = 768), Tm 256 and 4096: at 4096 the cross block runs two CTAs a
    head (k2_split) and is also checked and timed with one. Device times
    of rank 0's launches from CUDA graphs."""
    from khmer_ocr_torch.infer.predictor import cast_params
    from khmer_ocr_torch.models.layers import pack_step_params
    from khmer_ocr_torch.ops.kernels import decode_step as K2
    from khmer_ocr_torch.ops.kernels import geometry

    d, heads = cfg.emb_dim, cfg.num_heads
    hl, da = heads // TP_WORLD, d // TP_WORLD
    gen = torch.Generator(device="cuda").manual_seed(8)
    rows, worst, cache_len, w, lanes, n_img = {}, 0.0, 256, 64, 3, 8
    pos = w - 1
    kinds = (("self", None), ("cross", ("so_b", "ln1_s", "ln1_b")), ("ffn", ("co_b", "ln2_s", "ln2_b")),
             ("finish", ("l2_b", "ln3_s", "ln3_b")))
    for dt in ("float32", "bfloat16"):
        cdt = getattr(torch, dt)
        layer = state["dec"]["layers"][0] if dt == "float32" else cast_params(state["dec"]["layers"][0], cdt)
        full = K2.layer_weights(pack_step_params(layer))
        parts = [tp_local(torch, full, m, TP_WORLD, d) for m in range(TP_WORLD)]
        for tm in (256, 4096):
            x, sk, sv, mk, mv, mvf, lin, tm_valid = k2_inputs(torch, gen, n_img, lanes, d, tm, cache_len, w, cdt)
            ref_k, ref_v = sk.clone(), sv.clone()
            ref = K2.decoder_layer_step(full, x, torch.tensor(pos, dtype=torch.int32, device="cuda"), ref_k, ref_v, mk,
                                        mv, mvf, lin, num_heads=heads, window=w,
                                        lanes=lanes)
            cols = [slice(m * da, (m + 1) * da) for m in range(TP_WORLD)]
            caches = [(sk[..., c].contiguous(), sv[..., c].contiguous()) for c in cols]
            mems = [(mk[..., c].contiguous(), mv[..., c].contiguous()) for c in cols]
            plain_caches = [(a.clone(), b.clone()) for a, b in caches]
            kw = dict(num_heads=hl, window=w, lanes=lanes, dtype=cdt)
            split = geometry.k2_geometry(n_img, lanes, hl, tm)[2] // hl
            err, times, plain_times, other = 0.0, {}, {}, {}
            xr, part = x.float(), None
            for kind, pro in kinds:
                prologue = None if pro is None else tuple(full[k] for k in pro)
                outs = []
                for m in range(TP_WORLD):
                    def call(fn, cache=caches[m], m=m, **extra):
                        return fn(kind, parts[m], xr, part, pos, cache[0], cache[1], mems[m][0], mems[m][1], mvf,
                                  lin, prologue=prologue, round_x=kind == "finish", **kw, **extra)

                    got = call(K2.decoder_block)
                    want = call(K2.decoder_block_plain, plain_caches[m])
                    checks = [got]
                    if kind == "cross" and split == 2:  # the cross block with one CTA a head too
                        checks.append(call(K2.decoder_block_kernel, split=1))
                    torch.cuda.synchronize()
                    for g in checks:
                        tol = TOL if dt == "float32" else bf16_tol(want[0])
                        e = (g[0] - want[0]).abs().max().item()
                        if g[1] is not None:
                            tol = max(tol, TOL * max(1.0, want[1].abs().max().item()) if dt == "float32"
                                      else bf16_tol(want[1]))
                            e = max(e, (g[1] - want[1]).abs().max().item())
                        if kind == "self":  # the local heads' columns of cache slot pos
                            cc, pc = caches[m], plain_caches[m]
                            e = max(e, (cc[0][:, pos].float() - pc[0][:, pos].float()).abs().max().item(),
                                    (cc[1][:, pos].float() - pc[1][:, pos].float()).abs().max().item())
                        if not e <= tol:
                            fail(f"tensor_parallel K2 block {kind} {dt} Tm={tm} rank {m}: max|kernel - plain| "
                                 f"{e:.3e} (tol {tol:.3e})")
                        err = max(err, e)
                    if m == 0:
                        times[kind] = graph_ms(torch, lambda: call(K2.decoder_block))
                        plain_times[kind] = cuda_ms(torch, lambda: call(K2.decoder_block_plain, plain_caches[0]), 2)
                        if len(checks) > 1:
                            other[kind] = graph_ms(torch, lambda: call(K2.decoder_block_kernel, split=1))
                    outs.append(got)
                xr = outs[0][0]
                if kind != "finish":  # the all-reduce of the ranks' partial sums, in rank order
                    part = outs[0][1].clone()
                    for o in outs[1:]:
                        part += o[1]
            chain = xr.to(cdt)
            tol = TOL if dt == "float32" else bf16_tol(ref)
            c_err = (chain.float() - ref.float()).abs().max().item()
            k_err = max((torch.cat([c[0][:, pos] for c in caches], -1).float() - ref_k[:, pos].float()).abs().max()
                        .item(), (torch.cat([c[1][:, pos] for c in caches], -1).float() - ref_v[:, pos].float()).abs()
                        .max().item())
            if not (c_err <= tol and k_err <= tol):
                fail(f"tensor_parallel {dt} Tm={tm}: the chained blocks of {TP_WORLD} parts against the unsplit K2 "
                     f"step: layer {c_err:.3e}, cache slot {k_err:.3e} (tol {tol:.3e})")
            if dt == "float32":
                worst = max(worst, err, c_err)
            bms, by = bound_ms(*tp_block_cost(torch, n_img, lanes, d, cfg.dec_ffn_dim, heads, pos, tm, tm_valid, lin,
                                              parts[0], cdt.itemsize), cdt.itemsize)
            ms, plain_ms = sum(times.values()), sum(plain_times.values())
            shape = f"{dt} {n_img}x{lanes} w={w} Tm={tm}, rank 0 of {TP_WORLD}"
            rows[shape] = dict(shape=shape, max_abs_err=max(err, c_err), chain_err=c_err, ms=ms, block_ms=times,
                               cross_ctas_per_head=split, cross_other_split_ms=other.get("cross"), plain_ms=plain_ms,
                               library_ms=None, bound_ms=bms, bound_by=by)
            also = "" if not other else f" (the cross block with one CTA a head {other['cross']:.4f} ms)"
            print(f"[tensor_parallel] K2 blocks {shape}, {hl} heads a rank, cross block {split} CTA(s) a head: each "
                  f"block within {err:.2e} of its plain version; the two ranks' blocks chained against the unsplit K2 "
                  f"step: layer {c_err:.2e}, cache slot {k_err:.2e}; rank 0's launches "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
                  + f"{also} ({ms:.4f} ms a layer without the all-reduces), plain {plain_ms:.3f} ms; bound "
                  f"{bms:.4f} ms ({by}), {bms / ms:.2%} of roofline")
            del x, sk, sv, mk, mv, caches, mems, plain_caches
    return rows, worst


def tp_rank(rank: int, world: int, tmp: Path) -> int:
    """A rank of phase_tensor_parallel's model group (gloo, CUDA tensors, the
    one card): its part of the flagship's weights, forward_train's logits of
    the 8 lines of parallel_batch(), and the first 18 rendered lines at beam 3
    through infer_batch, its K2 block launches counted."""
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    import torch.distributed as dist

    from khmer_ocr_torch.config import DecodeConfig
    from khmer_ocr_torch.convert.from_jax import params_from_jax
    from khmer_ocr_torch.infer.predictor import infer_batch, load_weights, set_parity_mode
    from khmer_ocr_torch.models.ocr_model import forward_train
    from khmer_ocr_torch.ops.kernels import build
    from khmer_ocr_torch.ops.lines import device_chunk, u8_to_unit, unit_normalize
    from khmer_ocr_torch.parallel.mesh import make_mesh, shard_params
    from khmer_ocr_torch.preprocess import Preprocessor
    from khmer_ocr_torch.tokenizer import Tokenizer

    set_parity_mode()
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp / "store"), world), rank=rank, world_size=world)
    mesh = make_mesh(1, world)
    params, stats, cfg = load_weights(FLAGSHIP)
    state = params_from_jax(shard_params(params, mesh.model_rank, world), stats, cfg, device="cuda",
                            model_group=mesh.model_group)
    batch = parallel_batch()
    with torch.inference_mode():
        chunks = device_chunk(unit_normalize(u8_to_unit(torch.from_numpy(batch["lines"]).cuda())), (100, 84))
        logits, _ = forward_train(state, None, chunks, torch.from_numpy(batch["chunk_counts"]).cuda(),
                                  torch.from_numpy(batch["labels"][:, :-1]).long().cuda(), cfg, train=False,
                                  model_group=mesh.model_group)
    np.save(tmp / f"tp_logits{rank}.npy", logits.float().cpu().numpy())
    tok = Tokenizer()
    dec = DecodeConfig(beam_width=3, max_len=64, sos_idx=tok.sos_idx, eos_idx=tok.eos_idx, pad_idx=tok.pad_idx)
    lines = [line for line, _ in real_samples(SERVE_LINES)]
    batches = list(Preprocessor().iter_batches(lines, max_batch=8))

    def serve():
        rows = [None] * len(lines)
        for b in batches:
            out = infer_batch(state, torch.from_numpy(b.lines).cuda(), torch.from_numpy(b.chunk_counts).cuda(), cfg,
                              dec, (100, 84), model_group=mesh.model_group)
            for i, r in zip(b.indices, out.cpu().numpy()):
                rows[i] = strip(r)
        return rows

    serve()  # warm-up
    dist.barrier()
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    rows = serve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"k1": build.launches["k1"], "k2": build.launches["k2"], "blocks": build.launches["k2_block"],
              "k3": build.launches["k3"]}
    (tmp / f"tp{rank}.json").write_text(json.dumps({"tokens": rows, "counts": counts, "serve_ms": wall * 1e3}))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_tensor_parallel(torch, state, cfg, smi):
    """The model axis on the card: K2's blocks against their plain versions
    and chained into the unsplit step (phase_tp_blocks); then a model group
    of 2 rank processes sharing the card over gloo (NCCL refuses two ranks on
    one device), each holding its part of the flagship's weights (4 heads,
    F/2 = 768): forward_train's logits within 2e-4 / 1e-3 (the JAX package's
    own bound) of one process's, and 18 rendered lines at beam 3 through
    infer_batch, K2's three blocks a layer and an all-reduce after each, the
    tokens equal to one process's on both ranks, near-ties excepted. A
    numerics check, not a scaling figure."""
    import numpy as np

    from khmer_ocr_torch.infer.predictor import Predictor
    from khmer_ocr_torch.models.ocr_model import forward_train
    from khmer_ocr_torch.ops.lines import device_chunk, u8_to_unit, unit_normalize

    rows, worst = phase_tp_blocks(torch, state, cfg)
    pred = Predictor(model_path=FLAGSHIP)
    batch = parallel_batch()
    with torch.inference_mode():
        chunks = device_chunk(unit_normalize(u8_to_unit(torch.from_numpy(batch["lines"]).cuda())), (100, 84))
        ref_logits, _ = forward_train(pred.params, None, chunks, torch.from_numpy(batch["chunk_counts"]).cuda(),
                                      torch.from_numpy(batch["labels"][:, :-1]).long().cuda(), pred.model_cfg,
                                      train=False)
    ref_logits = ref_logits.float().cpu().numpy()
    lines = [line for line, _ in real_samples(SERVE_LINES)]
    pred.predict_batch_tokens(lines, beam_width=3, batch_size=8, max_len=64)  # warm-up
    one_rows, one_counts, one_wall = counted_run(torch, pred, lines, 3, 8, 64)
    one = [strip(r) for r in one_rows]
    with tempfile_dir() as tmp:
        logs = [tmp / f"tp{r}.log" for r in range(TP_WORLD)]
        t0 = time.perf_counter()
        procs = []
        for r, log in enumerate(logs):
            with open(log, "w") as fh:
                procs.append(subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--tp-rank", str(r),
                                               str(TP_WORLD), str(tmp)], stdout=fh, stderr=subprocess.STDOUT, cwd=ROOT))
        try:
            rcs = [p.wait(timeout=300) for p in procs]
        finally:
            for p in procs:
                p.kill()
        ranks_s = time.perf_counter() - t0
        if rcs != [0] * TP_WORLD:
            for log in logs:
                print(log.read_text()[-3000:])
            fail(f"tensor_parallel: the ranks exited {rcs}")
        metas = [json.loads((tmp / f"tp{r}.json").read_text()) for r in range(TP_WORLD)]
        logits = [np.load(tmp / f"tp_logits{r}.npy") for r in range(TP_WORLD)]
    l_err = max(float(np.abs(lg - ref_logits).max()) for lg in logits)
    close = all(np.allclose(lg, ref_logits, atol=2e-4, rtol=1e-3) for lg in logits)
    n_diff = [check_tokens(torch, pred, lines, one, m["tokens"], f"tensor_parallel rank {r} vs one process",
                           tag="tensor_parallel") for r, m in enumerate(metas)]
    counts = [m["counts"] for m in metas]
    print(f"[tensor_parallel] {TP_WORLD} ranks over gloo on one card, the flagship's weights split by heads: "
          f"forward_train logits of 8 lines max|diff| {l_err:.2e} against one process (within 2e-4 / 1e-3: {close}); "
          f"{SERVE_LINES} lines at beam 3: tokens equal to one process's but {n_diff} near-ties; launches per rank "
          f"K2 blocks {[c['blocks'] for c in counts]}, K2 {[c['k2'] for c in counts]}, K1 {[c['k1'] for c in counts]}, "
          f"K3 {[c['k3'] for c in counts]} (one process: K2 {one_counts['k2']}); "
          f"{[round(m['serve_ms'], 1) for m in metas]} ms per rank, {one_wall * 1e3:.1f} ms for one process; the "
          f"ranks' processes {ranks_s:.1f} s in all (a numerics check, not a scaling figure) on {smi}")
    if not close:
        fail(f"tensor_parallel: forward_train logits differ from one process's by {l_err:.3e}")
    if any(c["blocks"] == 0 or c["k2"] or c["k3"] or c["k1"] == 0 for c in counts):
        fail(f"tensor_parallel: launches {counts} (K2's blocks and K1 expected, no whole-layer K2, no K3)")
    del pred
    torch.cuda.empty_cache()
    return dict(block_rows=rows, block_err=worst, logits_err=l_err, n_diff=n_diff,
                block_launches=[c["blocks"] for c in counts], k1=[c["k1"] for c in counts],
                serve_ms=[m["serve_ms"] for m in metas], one_ms=one_wall * 1e3)


def phase_host(torch, smi):
    """The host input path on the card's machine: whether the native loader
    (native/imageio.cpp, g++ with libpng and libjpeg) builds here, and where
    it does, its pixels against PIL's on the 64 rendered lines written as
    PNG; the Preprocessor's lines/s on 256 PNG files at host_workers 1 and
    8 (batches of 64, the better of two passes); Predictor.warmup's seconds
    on the flagship, and the first request (8 lines, beam 3) after it against
    a fresh Predictor's first request."""
    import numpy as np
    from PIL import Image

    from khmer_ocr_torch.config import RuntimeConfig
    from khmer_ocr_torch.infer.predictor import Predictor
    from khmer_ocr_torch.native import imageio as native
    from khmer_ocr_torch.preprocess import Preprocessor

    t0 = time.perf_counter()
    lib = native.load_imageio_library()
    build_s = time.perf_counter() - t0
    route = "the native loader" if lib is not None else "PIL (the native loader did not build)"
    print(f"[host] native loader: {'built and loaded' if lib is not None else 'unavailable'} in {build_s:.2f} s"
          + ("" if lib is not None else f": {(native.unavailable_reason() or '')[:400]}"))
    samples = real_samples(64)
    out = {"native": lib is not None}
    with tempfile_dir() as tmp:
        paths = []
        for i, (line, _) in enumerate(samples):
            p = tmp / f"line{i}.png"
            Image.fromarray(line).save(p)
            paths.append(p)
        if lib is not None:
            bad = [i for i, p in enumerate(paths) if not np.array_equal(
                native.load_resize_gray(p, as_uint8=True),
                np.asarray(Image.open(p).convert("L").resize(
                    (max(50, int(48 * Image.open(p).width / Image.open(p).height)), 48), Image.Resampling.BILINEAR)))]
            print(f"[host] native pixels equal to PIL's on {len(paths) - len(bad)}/{len(paths)} PNG lines")
            if bad:
                fail(f"host: the native loader's pixels differ from PIL's on lines {bad}")
        files = paths * 4
        for workers in (1, 8):
            pre = Preprocessor(runtime=RuntimeConfig(host_workers=workers))
            best = float("inf")
            for _ in range(2):
                t0 = time.perf_counter()
                n = sum(len(b.indices) for b in pre.iter_batches(files, max_batch=64))
                best = min(best, time.perf_counter() - t0)
            out[f"workers{workers}_lines_per_s"] = n / best
            print(f"[host] Preprocessor, {len(files)} PNG files through {route}, host_workers {workers}: "
                  f"{best * 1e3:.1f} ms ({n / best:.0f} lines/s)")
    lines = [line for line, _ in samples[:8]]
    buckets = tuple(sorted({b.bucket_n for b in Preprocessor().iter_batches(lines, max_batch=8)}))
    fresh = Predictor(model_path=FLAGSHIP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh.predict_batch(lines, beam_width=3, batch_size=8, max_len=64)
    torch.cuda.synchronize()
    fresh_s = time.perf_counter() - t0
    warm = Predictor(model_path=FLAGSHIP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm.warmup(beam_widths=(3,), batch_size=8, chunk_buckets=buckets)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    strings = warm.predict_batch(lines, beam_width=3, batch_size=8, max_len=64)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    same = strings == fresh.predict_batch(lines, beam_width=3, batch_size=8, max_len=64)
    print(f"[host] warmup(beam 3, batch 8, buckets {buckets}): {warmup_s:.2f} s; the first request of 8 lines after "
          f"it {first_s * 1e3:.1f} ms, a fresh Predictor's first request {fresh_s * 1e3:.1f} ms; the same "
          f"strings: {same} on {smi}")
    if not same:
        fail("host: warmup changed the predictions")
    out.update(warmup_s=warmup_s, first_after_warmup_ms=first_s * 1e3, fresh_first_ms=fresh_s * 1e3)
    del fresh, warm
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if sys.argv[1:2] == ["--parallel-rank"]:  # a rank of phase_parallel's group, started by the phase
        return parallel_rank(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
    if sys.argv[1:2] == ["--tp-rank"]:  # a rank of phase_tensor_parallel's model group, started by the phase
        return tp_rank(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
    if not (ROOT / "khmer_ocr_torch" / "__init__.py").exists():
        print("khmer_ocr_torch not found next to chip_smoke.py: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    gpu_name, smi = phase_device(torch)
    phase_build()
    k1_rows, k1_err = phase_k1(torch)
    k1_cell_rows, k1_cell_err = phase_k1_cells(torch)
    k1b_rows, k1b_err = phase_k1b(torch)

    from khmer_ocr_torch.config import ModelConfig
    from khmer_ocr_torch.convert.from_jax import params_from_jax, seeded_params
    from khmer_ocr_torch.models.layers import pack_step_params
    from khmer_ocr_torch.ops.kernels.decode_step import layer_weights

    p, s = seeded_params(ModelConfig(), 0)
    state = params_from_jax(p, s, ModelConfig(), device="cuda")
    weights = layer_weights(pack_step_params(state["dec"]["layers"][0]))
    k2_rows, k2_err, k2_beside = phase_k2(torch, weights)
    k3_rows, k3_err, k3_resident = phase_k3(torch, state, ModelConfig())
    t0 = time.perf_counter()
    k5 = phase_beam_step(torch, state, ModelConfig(), smi)
    print(f"[beam_step] the phase took {time.perf_counter() - t0:.1f} s")
    k4 = phase_k4(torch)
    e2e = phase_e2e(torch, gpu_name, smi)
    real = phase_real(torch, smi)
    print(f"[real] {json.dumps(real)}")
    t0 = time.perf_counter()
    decode_graph = phase_decode_graph(torch, smi)
    print(f"[decode_graph] {json.dumps(decode_graph)}; the phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    inflight = phase_inflight(torch, smi)
    print(f"[inflight] {json.dumps(inflight)}; the phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    document = phase_document(torch, smi)
    print(f"[document] {json.dumps(document)}; the phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tr = phase_train(torch, smi)
    print(f"[train] {json.dumps({k: v for k, v in tr.items() if k != 'graphs'})}; {json.dumps(tr['graphs'])}; "
          f"the phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    layout_train = phase_layout_train(torch, smi)
    print(f"[layout_train] {json.dumps(layout_train)}; the phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    host_augment = phase_host_augment(torch, smi)
    print(f"[host_augment] {json.dumps(host_augment)}; the phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    parallel = phase_parallel(torch, smi)
    print(f"[parallel] {json.dumps(parallel)}; the phase took {time.perf_counter() - t0:.1f} s")
    cfg = ModelConfig()
    t0 = time.perf_counter()
    bf16 = phase_bf16(torch, state, cfg, smi)
    print(f"[bf16] {json.dumps(bf16['real'])}; the phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    precision = phase_precision(torch, smi)
    print(f"[precision] {json.dumps(precision)}; the phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    head = phase_head(torch, state, cfg, smi)
    print(f"[head] the phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tp = phase_tensor_parallel(torch, state, cfg, smi)
    print(f"[tensor_parallel] the phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    host = phase_host(torch, smi)
    print(f"[host] {json.dumps(host)}; the phase took {time.perf_counter() - t0:.1f} s")

    from khmer_ocr_torch.models.ocr_model import EXIT_CHECK_EVERY
    from khmer_ocr_torch.ops.kernels import decode_step

    main_len = min(k for k in e2e if isinstance(k, int))
    k1_main = next(r for r in k1_rows if r["shape"] == "2x B=8 T=1024")
    k1b_main = next(r for r in k1b_rows if r["shape"] == "2x B=32 T=512")
    k2_main = next(r for r in k2_rows if r["shape"] == "8x3 w=64 Tm=256")
    k2_card_main = next(r for r in k2_rows if r["shape"] == "greedy 32x1 w=160 Tm=384")
    k3_main = next(r for r in k3_rows if r["shape"] == "8x3 Tm=128 max_len=64")
    inflight_main = inflight["rows"]["64 real lines, batch 8"]["4"]["counts"]  # the pipeline's request

    def entry(name, source, replaces, launches, err, main_row, rows, **extra):
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
        return dict(name=name, route="cuda", source=f"khmer_ocr_torch/csrc/{source}", replaces=replaces,
                    launches=launches, max_abs_err=err, **{k: main_row[k] for k in keys}, **extra, shapes=rows)

    kernels = [
        # launches: the beam-3 request (inference); the train step launches it once too (train_launches)
        entry("lstm_recurrence", "lstm_recurrence.cu", tpu_kernel_site("ops/pallas/lstm.py", "lstm_recurrence"),
              e2e[main_len]["k1"], max(k1_err, k1_cell_err), k1_main, k1_rows + k1_cell_rows,
              train_launches=tr["k1_launches"], document_launches=document["pages"]["k1"],
              host_augment_train_launches=host_augment["k1"], parallel_train_launches=parallel["k1_train"],
              parallel_serve_launches=parallel["k1_serve"], inflight_launches=inflight_main["k1"],
              encode_graph_replays=inflight_main["encode_replays"]),
        # launches: one train step's (the training path)
        entry("lstm_adjoint", "lstm_backward.cu", tpu_kernel_site("ops/pallas/lstm.py", "_vjp_bwd"),
              tr["k1b_launches"], k1b_err, k1b_main, k1b_rows, backward_ms=k1b_main["backward_ms"],
              graph_launches_a_replay={m: tr["graphs"]["agree"][m]["counts_a_replay"] for m in ("graph", "group")},
              train_loop_launches={"mixed": tr["train_mixed"]["k1b"], "wide": tr["train_wide"]["k1b"]},
              host_augment_train_launches=host_augment["k1b"], parallel_train_launches=parallel["k1b_train"],
              kernel_route=f"{k1b_main['route']}, {k1b_main['rows']} rows", cluster_ms=k1b_main["cluster_ms"],
              tile_ms=k1b_main["tile_ms"]),
        entry("decoder_layer_step", "decoder_layer_step.cu",
              tpu_kernel_site("ops/pallas/decode_step.py", "fused_decoder_layer_step"), e2e[main_len]["k2"],
              k2_err, k2_main, k2_rows, document_launches=document["pages"]["k2"],
              inflight_launches=inflight_main["k2"],
              parallel_serve_launches=parallel["k2_serve"], graph_replays=e2e[main_len]["replays"],
              launches_a_replay=cfg.dec_layers * EXIT_CHECK_EVERY,
              traced_launches=decode_graph["rows"]["float32, beam 3, max_len 64"]["graph"]["traced_k2"],
              pos="device int32 (one launch serves every position of a captured graph)"),
        # launches: the greedy batch of 32 one-bucket lines ([e2e]), every K2 launch of it on the card route; ms: the
        # card route's at 32 x 1, w 160, Tm 384
        entry("decoder_layer_card", "decoder_layer_card.cu",
              tpu_kernel_site("ops/pallas/decode_step.py", "fused_decoder_layer_step"), e2e["greedy32"]["k2_card"],
              k2_err, dict(k2_card_main, ms=k2_card_main["card_ms"]), [r for r in k2_rows if r["card_ms"] is not None],
              kernels_a_launch=decode_step.CARD_KERNELS, cluster_ms=k2_card_main["cluster_ms"],
              decode_graph_launches=decode_graph["rows"]["float32, greedy, batch 32, max_len 64"]["graph"]["k2_card"],
              traced_kernels=decode_graph["rows"]["float32, greedy, batch 32, max_len 64"]["graph"]["traced_k2"],
              beside_convolutions=k2_beside),
        # launches: the flagship's bf16 request by the step loop ([bf16]); the library built with STORAGE_BF16
        entry("decoder_layer_step_bf16", "decoder_layer_step.cu",
              tpu_kernel_site("ops/pallas/decode_step.py", "fused_decoder_layer_step"), bf16["k2_launches"],
              bf16["k2_err"], next(r for r in bf16["k2_rows"] if r["shape"] == "8x3 w=64 Tm=256"), bf16["k2_rows"],
              storage="bfloat16", f32_ms=next(r for r in bf16["k2_rows"] if r["shape"] == "8x3 w=64 Tm=256")["f32_ms"],
              mega_request_launches=bf16["real"]["bfloat16_k3"]["k2_bf16"]),
        # launches: the 18-line request with KHMER_OCR_FUSED_HEAD=1 ([head])
        entry("decoder_layer_step_head", "decoder_layer_step.cu",
              tpu_kernel_site("ops/pallas/decode_step.py", "fused_decoder_layer_step"), head["launches"],
              head["err"], next(r for r in head["rows"] if r["shape"] == "float32 8x3 w=64 Tm=256"), head["rows"],
              no_head_ms=next(r for r in head["rows"] if r["shape"] == "float32 8x3 w=64 Tm=256")["no_head_ms"]),
        # launches: rank 0's in the two-rank model group's 18-line request ([tensor_parallel]); ms: rank 0's self,
        # cross, FFN and finish launches of one layer at 8 x 3
        entry("decoder_block", "decoder_block.cu",
              tpu_kernel_site("ops/pallas/decode_step.py", "fused_decoder_layer_step"), tp["block_launches"][0],
              tp["block_err"], tp["block_rows"]["float32 8x3 w=64 Tm=256, rank 0 of 2"], list(tp["block_rows"].values()),
              rank_launches=tp["block_launches"]),

        # launches: the KHMER_OCR_MEGA_DECODE=1 request, K3's path
        entry("fused_beam_decode", "decode_loop.cu", tpu_kernel_site("ops/pallas/decode_loop.py", "fused_beam_decode"),
              e2e["mega"]["k3"], k3_err, k3_main, k3_rows, step_loop_ms=k3_main["step_loop_ms"],
              ctas_per_cluster=k3_main["ctas_per_cluster"], self_caches=k3_main["route"],
              global_ms=k3_main["global_ms"], resident_clusters=k3_resident),
        # launches: the flagship's bf16 request with KHMER_OCR_MEGA_DECODE=1 ([bf16])
        entry("fused_beam_decode_bf16", "decode_loop.cu",
              tpu_kernel_site("ops/pallas/decode_loop.py", "fused_beam_decode"), bf16["k3_launches"], bf16["k3_err"],
              bf16["k3_rows"][0], bf16["k3_rows"], storage="bfloat16", f32_ms=bf16["k3_rows"][0]["f32_ms"],
              step_loop_ms=bf16["k3_rows"][0]["step_loop_ms"], first_step=bf16["k3_first_step"],
              flagship_memory=bf16["k3_real"], resident_clusters={k: n for k, (_, n) in bf16["k3_resident"].items()}),
        # launches: the flagship's 64 real lines served ([beam_step]), one a replayed step
        entry("beam_step", "beam_step.cu", "none (XLA fuses the search into the JAX package's lax.while_loop body)",
              k5["serve_k5"]["k5"], max(r["score_gap"] for r in k5["rows"]), k5["rows"][0], k5["rows"],
              replayed_steps=k5["serve_k5"]["replayed_steps"], step_loop=k5["step_loop"],
              serve_walls_ms=k5["serve_walls_ms"]),
        # launches: the probe's ladder and bisection, K4's path
        entry("smem_probe", "smem_probe.cu", tpu_kernel_site("probe_vmem.py", "try_mb"), k4["launches"],
              k4["max_abs_err"], k4, [], max_bytes=k4["max_bytes"], attribute_bytes=k4["attribute_bytes"],
              empty_launch_ms=k4["empty_launch_ms"], launcher_ms=k4["launcher_ms"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": gpu_name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
