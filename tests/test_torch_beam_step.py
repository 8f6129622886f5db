"""Kernel K5, the beam search's step (khmer_ocr_torch/ops/kernels/beam_step.py,
csrc/beam_step.cu with the routines of csrc/beam_search.cuh), on the CPU.

The kernel runs only on the card. Here a numpy restatement of its order of
work (each warp's lanes scanning their columns, the butterfly that reduces
them with the kernel's comparison, the passes of the top-K with a taken
column reading NEG_INF, the retirement over the lanes, the next beams over
the K x K candidates, the reorder through the parents) is held bit for bit
against the plain version, ``decode/beam.py::beam_advance``, on log-probs:
the running scores, the tokens, the lineage, the best completion and its
score, step after step, on
  * random log-probs at 1, 2, 3 and 5 lanes, and at 32 (the envelope's end);
  * exact ties inside a lane and across lanes;
  * <eos> inside a lane's top-K, and as the overall best;
  * step 0 of ``beam_state`` (lanes 1..K-1 at NEG_INF);
  * the last position of a window (tokens and lineage written at their last
    slots) from a drawn state.
Its log-softmax (per-lane maximum and sum in the warp's order, precise exp
and log) is held to torch.log_softmax within 1e-6 x max(1, |value|): the
sums run in another order. The wrapper's own checks: CPU tensors take the
plain version and launch nothing; K outside 1..32, a wrong dtype, shape or
layout, a vocabulary wider than x, a position of more than one element and
shared memory beyond the card's raise, and a tensor off the CPU that is not
a CUDA tensor raises rather than falling back. A capture
(``cuda_graphs.Graph``) moves K5's launches with K2's to its replays, all
counted in one registry (``ops/kernels/build.py::launches``).

The plain version runs in one torch-only subprocess (this file run as a
script), as the other port tests do; the restatement is numpy in the pytest
process.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
NEG_INF = np.float32(-1e30)
NONE = 1 << 30
EOS, SOS, PAD = 3, 2, 0

# name -> (images, lanes, vocabulary, max_len, steps, kind, seed)
CASES = {
    "random_k1": (3, 1, 124, 8, 6, "random", 1),
    "random_k2": (3, 2, 124, 8, 6, "random", 2),
    "random_k3": (4, 3, 124, 12, 10, "random", 3),
    "random_k5": (2, 5, 124, 8, 6, "random", 4),
    "random_k32": (1, 32, 40, 4, 2, "random", 5),
    "ties_in_and_across_lanes": (4, 3, 124, 10, 8, "ties", 6),
    "ties_k4": (3, 4, 30, 8, 6, "ties", 7),
    "eos_in_topk": (4, 3, 124, 10, 8, "eos_topk", 8),
    "eos_overall_best": (4, 3, 124, 10, 6, "eos_best", 9),
    "step0_only": (5, 3, 124, 6, 1, "random", 10),
    "last_position": (4, 3, 124, 9, 1, "last", 11),
    "last_position_eos": (4, 3, 124, 9, 1, "last_eos", 12),
}
LOGSOFTMAX_ROWS = (12, 124)
CHECKS = ("k_above_envelope", "k_zero", "x_dtype", "tokens_dtype", "lineage_dtype", "x_layout", "x_shape",
          "vocab_wider_than_x", "pos_elements", "shared_memory", "cpu_tensors_on_kernel", "meta_tensors")


def case_inputs(name: str) -> dict:
    """The steps' log-probs (steps, B * K, V) float32 and, for a drawn start,
    the state and its position."""
    b, k, v, max_len, steps, kind, seed = CASES[name]
    rng = np.random.default_rng(seed)
    if kind == "ties":  # few distinct values: exact ties in a row, and equal sums across lanes
        x = -0.5 * rng.integers(0, 5, size=(steps, b * k, v))
    else:
        x = rng.normal(size=(steps, b * k, v)) * 3.0
        x = x - np.log(np.exp(x).sum(-1, keepdims=True))
    x = x.astype(np.float32)
    if kind == "eos_topk":  # <eos> second in its row
        second = np.sort(x, axis=-1)[..., -2]
        x[..., EOS] = second
    if kind in ("eos_best", "last_eos"):  # <eos> above every other column
        x[..., EOS] = x.max(-1) + np.float32(0.25)
    out = {"x": x}
    if kind in ("last", "last_eos"):
        lp = max_len + 2
        out.update(
            pos=np.int32(max_len - 1),
            tokens=rng.integers(4, v, size=(b, k, lp)).astype(np.int64),
            lineage=rng.integers(0, k, size=(b, k, max_len)).astype(np.int32),
            scores=(-rng.random((b, k)) * 20).astype(np.float32),
            best_done_score=np.where(rng.random(b) < 0.5, NEG_INF, -rng.random(b) * 2).astype(np.float32),
            best_done_tokens=rng.integers(4, v, size=(b, lp)).astype(np.int64))
    return out


# ---- the restatement of the kernel's order (numpy, float32) --------------------------------------------------------


def before(v, i, bv, bi) -> bool:
    return i != NONE and (bi == NONE or v > bv or (v == bv and i < bi))


def warp_first(pairs: list) -> tuple:
    """The xor butterfly over 32 lanes' (value, index) pairs: every lane ends
    with the same pair."""
    for o in (16, 8, 4, 2, 1):
        pairs = [pairs[l ^ o] if before(*pairs[l ^ o], *pairs[l]) else pairs[l] for l in range(32)]
    assert len(set(pairs)) == 1
    return pairs[0]


def warp_sum(vals: list) -> np.float32:
    for o in (16, 8, 4, 2, 1):
        vals = [np.float32(vals[l] + vals[l ^ o]) for l in range(32)]
    return vals[0]


def warp_topk(val, n: int, k: int) -> tuple[list, list]:
    top_v, top_i = [], []
    for _ in range(k):
        lanes = []
        for lane in range(32):
            bv, bi = np.float32(0), NONE
            for c in range(lane, n, 32):
                v = NEG_INF if c in top_i else val(c)
                if before(v, c, bv, bi):
                    bv, bi = v, c
            lanes.append((bv, bi))
        v, i = warp_first(lanes)
        top_v.append(v)
        top_i.append(i)
    return top_v, top_i


def lane_log_softmax(row: np.ndarray) -> np.ndarray:
    """The kernel's log-probs of one lane's logits: the warp's maximum, its
    sum of exp(x - max) lane by lane then over the butterfly, (x - m) - lse."""
    m = max(max([row[c] for c in range(lane, len(row), 32)], default=np.float32(-3.4e38)) for lane in range(32))
    parts = []
    for lane in range(32):
        se = np.float32(0)
        for c in range(lane, len(row), 32):
            se = np.float32(se + np.exp(np.float32(row[c] - m)))
        parts.append(se)
    lse = np.log(warp_sum(parts))
    return np.array([np.float32(np.float32(row[c] - m) - lse) for c in range(len(row))], np.float32)


def k5_step(st: dict, logp: np.ndarray, p: int) -> None:
    """One launch on log-probs (B * K, V), image by image; updates ``st``."""
    b, k = st["scores"].shape
    v = logp.shape[1]
    lens = np.arange(st["tokens"].shape[2], dtype=np.float32)
    for img in range(b):
        score = st["scores"][img].copy()
        top_v = np.zeros((k, k), np.float32)
        top_i = np.zeros((k, k), np.int64)
        for l in range(k):
            row = logp[img * k + l]
            tv, ti = warp_topk(lambda c: row[c], v, k)
            top_v[l], top_i[l] = tv, ti
        pairs = []
        for lane in range(32):
            e, idx = NEG_INF, NONE
            if lane < k:
                idx = lane
                for j in range(k):
                    if top_i[lane, j] == EOS:
                        e = max(e, np.float32(np.float32(score[lane] + top_v[lane, j]) / lens[p + 2]))
            pairs.append((e, idx))
        e, best_lane = warp_first(pairs)
        tokens, lineage = st["tokens"][img].copy(), st["lineage"][img].copy()
        if e > st["best_done_score"][img]:
            st["best_done_score"][img] = e
            st["best_done_tokens"][img] = tokens[best_lane]
            st["best_done_tokens"][img, p + 1] = EOS
        nv, ni = warp_topk(lambda c: NEG_INF if top_i.flat[c] == EOS else np.float32(score[c // k] + top_v.flat[c]),
                           k * k, k)
        parent = np.array([c // k for c in ni])
        st["scores"][img] = nv
        st["tokens"][img] = tokens[parent]
        st["tokens"][img, :, p + 1] = [top_i.flat[c] for c in ni]
        st["lineage"][img] = lineage[parent]
        st["lineage"][img, :, p] = parent


def start_state(name: str, inputs: dict) -> tuple[dict, int]:
    """``beam_state``'s values (or the drawn state) in numpy, and the position."""
    b, k, _, max_len, _, _, _ = CASES[name]
    if "pos" in inputs:
        keys = ("tokens", "lineage", "scores", "best_done_score", "best_done_tokens")
        return {key: inputs[key].copy() for key in keys}, int(inputs["pos"])
    tokens = np.full((b, k, max_len + 2), PAD, np.int64)
    tokens[:, :, 0] = SOS
    scores = np.full((b, k), NEG_INF, np.float32)
    scores[:, 0] = 0.0
    return {"tokens": tokens, "scores": scores, "best_done_score": np.full(b, NEG_INF, np.float32),
            "best_done_tokens": np.full((b, max_len + 2), PAD, np.int64),
            "lineage": np.broadcast_to(np.arange(k, dtype=np.int32)[None, :, None], (b, k, max_len)).copy()}, 0


STATE_KEYS = ("scores", "tokens", "lineage", "best_done_score", "best_done_tokens")


if __name__ != "__main__":

    @pytest.fixture(scope="module")
    def port(tmp_path_factory):
        tmp = tmp_path_factory.mktemp("torch_beam_step")
        for name in CASES:
            np.savez(tmp / f"in_{name}.npz", **case_inputs(name))
        rng = np.random.default_rng(0)
        for n in LOGSOFTMAX_ROWS:
            np.save(tmp / f"logits_{n}.npy", (rng.normal(size=(6, n)) * 4).astype(np.float32))
        proc = subprocess.run([sys.executable, __file__, str(tmp)], cwd=REPO, capture_output=True, text=True,
                              env={**os.environ, "OMP_NUM_THREADS": "2"}, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        return tmp, json.loads((tmp / "port.json").read_text())

    @pytest.mark.parametrize("name", sorted(CASES))
    def test_restatement_equals_beam_advance_bit_for_bit(port, name):
        tmp, _ = port
        inputs = case_inputs(name)
        got = np.load(tmp / f"out_{name}.npz")
        st, p = start_state(name, inputs)
        for s, logp in enumerate(inputs["x"]):
            k5_step(st, logp, p + s)
            for key in STATE_KEYS:
                want = got[f"{key}_{s}"]
                assert st[key].dtype == want.dtype and np.array_equal(st[key].view(np.uint8), want.view(np.uint8)), \
                    f"{name}: step {s} {key}: {st[key]} vs {want}"

    @pytest.mark.parametrize("name", ["ties_in_and_across_lanes", "eos_in_topk", "eos_overall_best",
                                      "last_position_eos"])
    def test_the_case_meets_what_it_is_for(port, name):
        """The drawn inputs hold what the case name says: equal candidates in
        a row and across lanes, <eos> among a lane's top-K, completions."""
        _, res = port
        assert res["meets"][name], res["meets"]

    @pytest.mark.parametrize("n", LOGSOFTMAX_ROWS)
    def test_log_softmax_restatement_against_torch(port, n):
        tmp, _ = port
        logits = np.load(tmp / f"logits_{n}.npy")
        ref = np.load(tmp / f"log_softmax_{n}.npy")
        got = np.stack([lane_log_softmax(row) for row in logits])
        assert np.all(np.abs(got - ref) <= 1e-6 * np.maximum(1.0, np.abs(ref)))

    def test_cpu_tensors_take_the_plain_version(port):
        _, res = port
        assert res["cpu"] == {"equal": True, "launches": 0, "same_tensors_replaced": True}

    @pytest.mark.parametrize("check", CHECKS)
    def test_wrapper_raises_outside_its_envelope(port, check):
        _, res = port
        assert res["checks"][check] == {
            "k_above_envelope": "ValueError", "k_zero": "ValueError", "x_dtype": "TypeError",
            "tokens_dtype": "TypeError", "lineage_dtype": "TypeError", "x_layout": "ValueError",
            "x_shape": "ValueError", "vocab_wider_than_x": "ValueError", "pos_elements": "ValueError",
            "shared_memory": "ValueError", "cpu_tensors_on_kernel": "RuntimeError",
            "meta_tensors": "RuntimeError"}[check], res["checks"]

    def test_smem_bytes_is_the_kernels_layout(port):
        """8-byte tokens, then 4-byte lineage, candidates and next beams."""
        _, res = port
        assert res["smem_3x66x64"] == 8 * 3 * 66 + 4 * (3 * 64 + 2 * 9 + 12)

    def test_graph_counts_move_k5_with_k2(port):
        _, res = port
        assert res["counts"] == {"after_capture": [0, 0, 0, 0, 0], "after_replay": [5, 1, 2, 3, 7]}


# ---- the torch side (run as a script) ------------------------------------------------------------------------------


def _state_from(st_np: dict, b: int, k: int, max_len: int, pos: int):
    import torch

    from khmer_ocr_torch.config import DecodeConfig
    from khmer_ocr_torch.decode.beam import beam_state

    st = beam_state(b, k, max_len, DecodeConfig(beam_width=k, max_len=max_len), "cpu")
    for key in STATE_KEYS:
        st[key] = torch.from_numpy(st_np[key].copy())
    st["pos"].fill_(pos)
    return st


def _port_main(tmp: Path) -> None:
    sys.path.insert(0, str(REPO))
    import contextlib
    from types import SimpleNamespace

    import torch

    from khmer_ocr_torch import cuda_graphs
    from khmer_ocr_torch.config import DecodeConfig
    from khmer_ocr_torch.decode.beam import beam_advance, beam_state
    from khmer_ocr_torch.ops.kernels import beam_step, build

    res = {"meets": {}, "checks": {}}
    for name in CASES:
        b, k, v, max_len, steps, kind, _ = CASES[name]
        dec = DecodeConfig(beam_width=k, max_len=max_len)
        inputs = dict(np.load(tmp / f"in_{name}.npz"))
        st_np, p = start_state(name, inputs)
        st = _state_from(st_np, b, k, max_len, p)
        out, in_row, across, eos_top, done = {}, False, False, False, False
        off_diagonal = ~torch.eye(k, dtype=torch.bool)
        for s, x in enumerate(inputs["x"]):
            logp = torch.from_numpy(x)
            top = torch.topk(logp, min(k + 1, v), dim=-1).values
            in_row |= bool((top[:, :-1] == top[:, 1:]).any())
            eos_top |= bool((torch.topk(logp, k, dim=-1).indices == dec.eos_idx).any())
            beam_step.search_step(st, logp, st["pos"], dec, log_probs=True)
            st["pos"].add_(1)
            sc = st["scores"]
            across |= bool(((sc[:, :, None] == sc[:, None, :]) & off_diagonal & (sc[:, :, None] > -1e29)).any())
            done |= bool((st["best_done_score"] > -1e29).any())
            for key in STATE_KEYS:
                out[f"{key}_{s}"] = st[key].numpy()
        np.savez(tmp / f"out_{name}.npz", **out)
        res["meets"][name] = {"ties": in_row and across, "eos_topk": eos_top, "eos_best": done,
                              "last_eos": done}.get(kind, True)
    for n in LOGSOFTMAX_ROWS:
        np.save(tmp / f"log_softmax_{n}.npy",
                torch.log_softmax(torch.from_numpy(np.load(tmp / f"logits_{n}.npy")), dim=-1).numpy())

    # CPU tensors: search_step is the plain version (beam_advance after log_softmax), in one call, no launch
    b, k, v, max_len = 2, 3, 20, 6
    dec = DecodeConfig(beam_width=k, max_len=max_len)
    logits = torch.from_numpy((np.random.default_rng(5).normal(size=(b * k, v)) * 2).astype(np.float32))
    a, c = (beam_state(b, k, max_len, dec, "cpu") for _ in range(2))
    before = {key: a[key] for key in STATE_KEYS}
    build.reset_launches()
    beam_step.search_step(a, logits, a["pos"], dec, log_probs=False)
    beam_advance(c, torch.log_softmax(logits, dim=-1).reshape(b, k, v), c["pos"], dec)
    res["cpu"] = {"equal": all(torch.equal(a[key], c[key]) for key in STATE_KEYS), "launches": build.launches["k5"],
                  "same_tensors_replaced": all(a[key] is not before[key] for key in STATE_KEYS)}

    # the wrapper's checks, in the kernel's own entry (each raises before any launch)
    def attempt(st, x, pos=None, vocab=None):
        try:
            beam_step.search_step_kernel(st, x, st["pos"] if pos is None else pos, dec, log_probs=False, vocab=vocab)
        except (TypeError, ValueError, RuntimeError) as e:
            return type(e).__name__
        return "ran"

    def fresh(kk=k, ml=max_len, device="cpu"):
        return beam_state(b, kk, ml, DecodeConfig(beam_width=kk, max_len=ml), device)

    x = torch.zeros(b * k, v)
    res["checks"]["k_above_envelope"] = attempt(fresh(33), torch.zeros(b * 33, v))
    st0 = fresh()
    st0["scores"] = torch.zeros(b, 0)
    res["checks"]["k_zero"] = attempt(st0, torch.zeros(0, v))
    res["checks"]["x_dtype"] = attempt(fresh(), x.double())
    st1 = fresh()
    st1["tokens"] = st1["tokens"].int()
    res["checks"]["tokens_dtype"] = attempt(st1, x)
    st2 = fresh()
    st2["lineage"] = st2["lineage"].long()
    res["checks"]["lineage_dtype"] = attempt(st2, x)
    res["checks"]["x_layout"] = attempt(fresh(), torch.zeros(v, b * k).t())
    res["checks"]["x_shape"] = attempt(fresh(), torch.zeros(b * k + 1, v))
    res["checks"]["vocab_wider_than_x"] = attempt(fresh(), x, vocab=v + 1)
    res["checks"]["pos_elements"] = attempt(fresh(), x, pos=torch.zeros(2, dtype=torch.int32))
    res["checks"]["shared_memory"] = attempt(fresh(32, 1000), torch.zeros(b * 32, v))
    res["checks"]["cpu_tensors_on_kernel"] = attempt(fresh(), x)
    res["checks"]["meta_tensors"] = attempt(fresh(device="meta"), torch.zeros(b * k, v, device="meta"))
    res["smem_3x66x64"] = beam_step.smem_bytes(3, 66, 64)

    # a capture of K2's and K5's launches (the capture itself stubbed: it needs the card)
    class FakeGraph:
        def replay(self):
            pass

    names = ("k2", "k2_bf16", "k2_head", "k2_card", "k5")
    saved = torch.cuda.CUDAGraph, torch.cuda.graph
    torch.cuda.CUDAGraph, torch.cuda.graph = FakeGraph, lambda graph, **kw: contextlib.nullcontext()
    try:
        build.reset_launches()
        side = SimpleNamespace(cuda_stream=7)
        graph = cuda_graphs.Graph(lambda: build.count_launch(7, **dict(zip(names, (5, 1, 2, 3, 7)))), side)
        after_capture = [build.launches[n] for n in names]
        graph.replay()
    finally:
        torch.cuda.CUDAGraph, torch.cuda.graph = saved
    res["counts"] = {"after_capture": after_capture, "after_replay": [build.launches[n] for n in names]}
    (tmp / "port.json").write_text(json.dumps(res))


if __name__ == "__main__":
    _port_main(Path(sys.argv[1]))
