"""The in-flight pipeline of the port's ``Predictor.predict_batch``, on the CPU, against the JAX package's.

The JAX package's ``predict_batch`` keeps up to 2 x ``max_inflight_batches``
bucket batches dispatched and not yet read back while the host prepares the
next. The port's does the same with a dispatch thread (preparation,
transfer, encode) beside the caller's decodes (khmer_ocr_torch/infer/
predictor.py). On CPU tensors the stages, the queue, the slots and the
drain run as on the card, without streams. Checked:

  * 10 real lines of 3-6 chunks (chunk buckets 3, 4 and 6) at
    ``max_inflight_batches`` 1, 2 and 4, ``batch_size`` 1 and 3, greedy and
    beam 3: the strings equal the JAX package's ``Predictor.predict_batch``
    on the same weights, and the tokens are bit-equal to a loop of
    ``decode_prepared`` over the same batches; the high-water mark of
    batches in flight is never above 2 x ``max_inflight_batches``;
  * with the first batch's decode half held, the dispatch stage runs
    ahead to 2 x ``max_inflight_batches`` batches and stops there; the
    high-water mark reaches the bound, tokens unchanged;
  * a missing file (preparation), an encode half and a decode half that
    raise at the second batch: each raises in the caller, and no thread of
    the call is left within 5 s; a caller inside a scope of another matmul
    precision gets ValueError at once;
  * ``flush_deadline_ms`` > 0: JAX's strings; bf16 (``compute_dtype``) and
    the whole-decode path (``KHMER_OCR_MEGA_DECODE=1``; kernel K3's plain
    version here): tokens bit-equal to the loop's; an empty list gives an
    empty list;
  * the dispatch thread's encodes run at the config's precision
    ("default": TF32 switches on) and the decodes too, and torch's switches
    are as the call found them afterwards;
  * on the card the dispatch stage replays each shape's encode as a CUDA
    graph (infer/encode_graph.py): its cache, with the capture stubbed,
    runs a shape's first batch eagerly, replays the later ones and drops
    every shape for other params; the adaptive pool's matrices are made on
    the device once, outside inference mode.

Model: se_vgg with the BiLSTM at D 32 (1 + 1 layers, 4 heads, vocab 124),
weights made with numpy from a seed (convert/from_jax.py::seeded_params, the
JAX package's layout), the BiLSTM's input weights scaled by 10 and the
vocabulary projection by 8, so that the strings differ from line to line
(at PyTorch's initial scales the memory barely depends on the line). The
port runs in one torch-only subprocess (this file run as a script) while
the JAX side runs here.
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
MODEL = dict(emb_dim=32, num_heads=4, enc_layers=1, dec_layers=1, enc_ffn_dim=64, decode_max_len=24)
SEED, N_LINES, BUCKETS = 3, 10, (1, 3)
CASES = [(m, bs, beam) for m in (1, 2, 4) for bs in (1, 3) for beam in (1, 3)]
ERRORS = {"prepare": "FileNotFoundError", "encode": "RuntimeError", "decode": "RuntimeError"}
ALL_OFF = (False, False, "highest")
INSIDE_DEFAULT = (True, True, "high")


def model_params():
    """The seeded weights in the JAX package's layout (numpy), sharpened."""
    from khmer_ocr_torch.config import ModelConfig
    from khmer_ocr_torch.convert.from_jax import seeded_params

    params, stats = seeded_params(ModelConfig(**MODEL), SEED)
    for d in ("fw", "bw"):
        params["bilstm"][d]["w_ih"] = params["bilstm"][d]["w_ih"] * np.float32(10)
    params["dec"]["out"]["w"] = params["dec"]["out"]["w"] * np.float32(8)
    return params, stats


def real_lines() -> list:
    with np.load(REPO / "khmer_ocr_torch" / "assets" / "real_lines.npz") as z:
        return [z[f"line_{i}"] for i in range(N_LINES)]


if __name__ != "__main__":

    @pytest.fixture(scope="module")
    def runs(tmp_path_factory):
        import jax

        from khmer_ocr_tpu.config import ModelConfig, OCRConfig, RuntimeConfig
        from khmer_ocr_tpu.infer.predictor import Predictor

        tmp = tmp_path_factory.mktemp("torch_inflight")
        proc = subprocess.Popen([sys.executable, __file__, str(tmp)], cwd=REPO, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env={**os.environ, "OMP_NUM_THREADS": "2"})
        try:
            params, stats = model_params()
            pred = Predictor(params=jax.tree.map(np.asarray, params), batch_stats=stats,
                             model_cfg=ModelConfig(**MODEL),
                             config=OCRConfig(runtime=RuntimeConfig(batch_buckets=BUCKETS, max_inflight_batches=1)))
            with jax.default_matmul_precision("highest"):
                ref = {beam: pred.predict_batch(real_lines(), beam_width=beam, batch_size=3) for beam in (1, 3)}
            _, err = proc.communicate(timeout=600)
        finally:
            proc.kill()
        assert proc.returncode == 0, err[-3000:]
        with np.load(tmp / "tokens.npz") as z:
            tokens = {k: z[k] for k in z.files}
        return {"jax": ref, "meta": json.loads((tmp / "port.json").read_text()), "tokens": tokens}

    def _rows(runs, key):
        return [runs["tokens"][f"{key}/{i}"] for i in range(N_LINES)]

    @pytest.mark.parametrize("m,bs,beam", CASES, ids=[f"inflight{m}-batch{bs}-beam{k}" for m, bs, k in CASES])
    def test_pipeline_equals_jax_strings_and_the_sequential_loop(runs, m, bs, beam):
        key = f"{m}_{bs}_{beam}"
        got = runs["meta"]["cases"][key]
        assert got["strings"] == runs["jax"][beam]
        assert len(set(got["strings"])) >= 5  # rows that differ: a misplaced row would show
        for row, ref in zip(_rows(runs, key), _rows(runs, f"loop_{bs}_{beam}")):
            assert row.dtype == ref.dtype == np.int64
            np.testing.assert_array_equal(row, ref)
        assert 1 <= got["high"] <= 2 * m, got

    @pytest.mark.parametrize("m", [1, 2, 4])
    def test_dispatch_runs_ahead_to_the_bound(runs, m):
        """The first batch's decode half held until 2 x max_inflight_batches
        batches are encoded, then 0.2 s more: the dispatch stage fills every
        slot and stops there; the high-water mark is the bound."""
        got = runs["meta"]["slow"][str(m)]
        assert got["encoded_during_the_first_decode"] == 2 * m, got
        assert got["high"] == 2 * m, got
        assert got["batches"] == N_LINES
        for row, ref in zip(_rows(runs, f"slow_{m}"), _rows(runs, "loop_1_3")):
            np.testing.assert_array_equal(row, ref)

    @pytest.mark.parametrize("stage", sorted(ERRORS))
    def test_an_error_in_a_stage_raises_in_the_caller_and_leaves_no_thread(runs, stage):
        got = runs["meta"]["errors"][stage]
        assert got["raised"].startswith(ERRORS[stage]), got
        if stage != "prepare":
            assert "at the second batch" in got["raised"], got
        assert got["threads_left"] == [], got

    def test_a_scope_of_another_precision_raises_at_once(runs):
        got = runs["meta"]["nested"]
        assert got["raised"].startswith("ValueError") and "'default'" in got["raised"], got
        assert got["threads_left"] == [], got

    @pytest.mark.parametrize("case", ["deadline", "bfloat16", "mega"])
    def test_options_keep_the_tokens(runs, case):
        """``flush_deadline_ms`` 1 ms: JAX's strings (the batches it flushes
        depend on timing, so no loop runs the same ones); bf16 params and
        ``KHMER_OCR_MEGA_DECODE=1`` (the batches inside kernel K3's envelope
        through the whole-decode path): the tokens of the loop over the same
        batches, in input order."""
        got = runs["meta"]["options"][case]
        assert got["rows"] == N_LINES, got
        if case == "deadline":
            assert got["strings"] == runs["jax"][3]
        else:
            assert got["equal"], got
        if case == "mega":
            assert got["mega_batches"] > 0, got

    def test_empty_list(runs):
        assert runs["meta"]["empty"] == {"strings": [], "tokens": 0, "threads_left": []}

    def test_encode_graph_cache_captures_each_shape_once(runs):
        """``encode_graphed`` (the card's encode, capture stubbed here): a
        shape's first batch runs eagerly and keeps that result while the
        shape is captured; later batches of the shape replay; a new shape
        captures; other params drop every shape."""
        assert runs["meta"]["encode_graph"] == [
            ["eager", "capture"], ["replay"], ["replay"], ["eager", "capture"], ["replay"], ["eager", "capture"]]
        assert runs["meta"]["encode_graph_results"] == ["eager", "replay", "replay", "eager", "replay", "eager"]

    def test_pool_matrices_made_once_outside_inference_mode(runs):
        """The adaptive pool's averaging matrices on the device (no copy from
        the host at each call): one tensor a shape, made outside inference
        mode even when first asked for inside it, so training can use it."""
        assert runs["meta"]["pool_matrix"] == {"same": True, "inference": False, "grad": True}

    def test_dispatch_thread_runs_at_the_config_precision(runs):
        """A Predictor at "default" called with the switches all off: its
        encodes run on the dispatch thread with TF32 on, its decodes on the
        caller's, and the switches are all off again after the call."""
        got = runs["meta"]["precision"]
        assert tuple(got["before"]) == tuple(got["after"]) == ALL_OFF
        assert got["encode"] and {(t, tuple(s)) for t, s in got["encode"]} == {("khmer-ocr-dispatch",
                                                                                INSIDE_DEFAULT)}
        assert got["decode"] and {(t, tuple(s)) for t, s in got["decode"]} == {("MainThread", INSIDE_DEFAULT)}


def _port_main(tmp: Path) -> None:
    sys.path.insert(0, str(REPO))
    import threading
    import time

    import torch

    import khmer_ocr_torch.infer.predictor as predictor
    from khmer_ocr_torch.config import ModelConfig, OCRConfig, RuntimeConfig
    from khmer_ocr_torch.precision import matmul_precision, switches

    torch.set_num_threads(2)
    cfg = ModelConfig(**MODEL)
    params, stats = model_params()
    lines = real_lines()
    meta: dict = {"cases": {}, "slow": {}, "errors": {}, "options": {}}
    tokens: dict = {}
    base = threading.enumerate()

    def make(**runtime):
        rt = RuntimeConfig(**{"batch_buckets": BUCKETS, **runtime})
        return predictor.Predictor(params=params, batch_stats=stats, model_cfg=cfg, device="cpu",
                                   config=OCRConfig(runtime=rt))

    def loop(pred, bs, beam):
        """The sequential loop of ``decode_prepared`` over the same batches."""
        rows = [None] * len(lines)
        for batch in pred.preprocessor.iter_batches(lines, max_batch=bs):
            for i, r in zip(batch.indices, pred.decode_prepared(batch, beam)):
                rows[i] = r
        return rows

    def keep(key, rows):
        tokens.update({f"{key}/{i}": r for i, r in enumerate(rows)})

    def threads_left(deadline=5.0):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < deadline:
            left = [t.name for t in threading.enumerate() if t not in base]
            if not left:
                return []
            time.sleep(0.01)
        return left

    def wrap(name, fn):
        real = getattr(predictor, name)
        setattr(predictor, name, lambda *a, **kw: fn(real, *a, **kw))
        return real

    plain = make()
    for bs in (1, 3):
        for beam in (1, 3):
            keep(f"loop_{bs}_{beam}", loop(plain, bs, beam))
    for m, bs, beam in CASES:
        pred = make(max_inflight_batches=m)
        rows = pred.predict_batch_tokens(lines, beam_width=beam, batch_size=bs)
        keep(f"{m}_{bs}_{beam}", rows)
        meta["cases"][f"{m}_{bs}_{beam}"] = {"strings": [pred.tokenizer.decode(r) for r in rows],
                                             "high": pred.max_batches_in_flight}

    # the first decode held until the dispatch stage has encoded 2 x max_inflight_batches batches, and 0.2 s more:
    # the dispatch stage runs ahead until every slot is taken, and no further
    for m in (1, 2, 4):
        pred = make(max_inflight_batches=m)
        encoded, held = [0], []

        def count_encode(real, *a, **kw):
            encoded[0] += 1
            return real(*a, **kw)

        def hold_first_decode(real, *a, m=m, **kw):
            if not held:
                t0 = time.perf_counter()
                while encoded[0] < 2 * m and time.perf_counter() - t0 < 60:
                    time.sleep(0.005)
                time.sleep(0.2)
                held.append(encoded[0])
            return real(*a, **kw)

        real_encode, real_decode = wrap("encode_batch", count_encode), wrap("decode_batch", hold_first_decode)
        keep(f"slow_{m}", pred.predict_batch_tokens(lines, beam_width=3, batch_size=1))
        predictor.encode_batch, predictor.decode_batch = real_encode, real_decode
        meta["slow"][str(m)] = {"high": pred.max_batches_in_flight, "batches": encoded[0],
                                "encoded_during_the_first_decode": held[0]}

    # an error in each stage
    def fail_second(real, *a, **kw):
        fail_second.calls += 1
        if fail_second.calls == 2:
            raise RuntimeError("failed at the second batch")
        return real(*a, **kw)

    for stage in sorted(ERRORS):
        pred, src, saved = make(max_inflight_batches=1), list(lines), None
        if stage == "prepare":
            src[5] = str(tmp / "missing.png")
        else:
            fail_second.calls = 0
            name = f"{stage}_batch"
            saved = wrap(name, fail_second)
        try:
            pred.predict_batch_tokens(src, beam_width=3, batch_size=1)
            raised = "returned"
        except Exception as e:  # recorded and asserted on by the test
            raised = f"{type(e).__name__}: {e}"
        if saved is not None:
            setattr(predictor, name, saved)
        meta["errors"][stage] = {"raised": raised, "threads_left": threads_left()}

    # a caller inside another precision's scope
    with matmul_precision("highest"):
        try:
            make(matmul_precision="default").predict_batch(lines, beam_width=1)
            raised = "returned"
        except Exception as e:  # recorded and asserted on by the test
            raised = f"{type(e).__name__}: {e}"
    meta["nested"] = {"raised": raised, "threads_left": threads_left()}

    # options: the flush deadline, bf16, the whole-decode path
    for case, runtime in (("deadline", {"flush_deadline_ms": 1.0}), ("bfloat16", {"compute_dtype": "bfloat16"}),
                          ("mega", {})):
        pred = make(max_inflight_batches=1, **runtime)
        os.environ["KHMER_OCR_MEGA_DECODE"] = "1" if case == "mega" else "0"
        rows = pred.predict_batch_tokens(lines, beam_width=3, batch_size=3)
        got = {"rows": len(rows), "strings": [pred.tokenizer.decode(r) for r in rows]}
        if case != "deadline":
            got["equal"] = all(np.array_equal(a, b) for a, b in zip(rows, loop(pred, 3, 3)))
        got["mega_batches"] = pred.mega_batches
        os.environ.pop("KHMER_OCR_MEGA_DECODE")
        meta["options"][case] = got

    pred = make()
    empty = pred.predict_batch([], beam_width=3)
    meta["empty"] = {"strings": empty, "tokens": len(pred.predict_batch_tokens([], beam_width=3)),
                     "threads_left": threads_left()}

    # the precision inside each stage
    seen: dict = {"encode": [], "decode": []}
    for half in ("encode", "decode"):
        wrap(f"{half}_batch", lambda real, *a, half=half, **kw: seen[half].append(
            (threading.current_thread().name, switches())) or real(*a, **kw))
    predictor.set_parity_mode()
    before = switches()
    make(matmul_precision="default", max_inflight_batches=2).predict_batch(lines, beam_width=1, batch_size=3)
    meta["precision"] = {"before": before, "after": switches(), **seen}

    # the encode graphs' cache, with the capture stubbed (CUDA graphs need the card)
    from types import SimpleNamespace

    from khmer_ocr_torch.cuda_graphs import GraphCache
    from khmer_ocr_torch.infer import encode_graph

    events: list = []

    class FakeGraph:
        def __init__(self, encode, lines, counts):
            self.device, self.nbytes = lines.device, 1
            self.graph = SimpleNamespace(out=[SimpleNamespace(clone=lambda: "replay")])
            events[-1].append("capture")

        def replay(self, inputs):
            events.append(["replay"])

    def eager(lines, counts):
        events.append(["eager"])
        return "eager"

    real_graph, encode_graph.EncodeGraph = encode_graph.EncodeGraph, FakeGraph
    cache, other = GraphCache(10**9), make().params
    shape_a, shape_b = torch.zeros(2, 48, 184, dtype=torch.uint8), torch.zeros(3, 48, 184, dtype=torch.uint8)
    counts = torch.ones(2, dtype=torch.int32)
    got = ["".join(encode_graph.encode_graphed(cache, prm, eager, lines_t, counts))
           for prm, lines_t in ((plain.params, shape_a), (plain.params, shape_a), (plain.params, shape_a),
                                (plain.params, shape_b), (plain.params, shape_b), (other, shape_a))]
    encode_graph.EncodeGraph = real_graph
    meta["encode_graph"], meta["encode_graph_results"] = events, got

    # the adaptive pool's matrices: made once, outside inference mode
    from khmer_ocr_torch.ops.adaptive_pool import pool_matrix_on

    pool_matrix_on.cache_clear()
    with torch.inference_mode():
        first = pool_matrix_on(3, 2, torch.device("cpu"), torch.float32)
    x = torch.ones(3, 4, requires_grad=True)
    torch.einsum("oh,hc->oc", pool_matrix_on(3, 2, torch.device("cpu"), torch.float32), x).sum().backward()
    meta["pool_matrix"] = {"same": pool_matrix_on(3, 2, torch.device("cpu"), torch.float32) is first,
                           "inference": first.is_inference(), "grad": x.grad is not None}

    np.savez(tmp / "tokens.npz", **tokens)
    (tmp / "port.json").write_text(json.dumps(meta, ensure_ascii=False))


if __name__ == "__main__":
    _port_main(Path(sys.argv[1]))
