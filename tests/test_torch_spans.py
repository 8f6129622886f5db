"""The port's spans (khmer_ocr_torch/profiling.py::span), on the CPU.

Each layer boundary of the serving and training paths is a torch.profiler
range named ``khmer_ocr.*`` while a profiler runs, and one shared no-op
otherwise. Checked:

  * with no profiler, ``predict_batch_tokens``, a single and a multi train
    step and ``train.loop._prefetched`` never enter ``record_function``
    (patched to raise), and ``span`` hands out one shared object;
  * under ``torch.profiler.profile()`` one ``predict_batch_tokens`` call
    records one ``khmer_ocr.predict`` and one ``khmer_ocr.join`` on the
    caller's thread, ``khmer_ocr.decode`` and ``khmer_ocr.drain`` once per
    bucket batch, ``khmer_ocr.wait_dispatch`` once per batch and once for
    the end, every ``khmer_ocr.decode.exit_test`` inside a decode; the
    caller's spans lie inside ``khmer_ocr.predict`` and do not overlap; the
    tokens equal an unprofiled call's;
  * ``utils.profile_trace`` records every thread: its chrome trace holds
    ``khmer_ocr.prepare``, ``khmer_ocr.wait_slot`` and ``khmer_ocr.dispatch``
    on the dispatch thread, not the caller's;
  * ``_prefetched`` yields the same items with and without a profiler, and
    records one ``khmer_ocr.train.wait_batch`` per item and one for the end
    on the consumer's thread, one ``khmer_ocr.train.assemble`` per pull on
    the prefetch thread;
  * ``khmer_ocr.train.step``: one per call of a single and of a multi step;
  * a span's interval holds the aten ops launched inside it, on the
    profiler's clock, on its thread;
  * ``khmer_ocr.decode.capture`` wraps a decode shape's capture (stubbed:
    CUDA graphs need the card) and nothing else.

The capture spans of the encode and train graphs, and the device's side of a
span (a user annotation, no busy time), need the card: perfbench's traced
runs read them there. The port runs in one torch-only subprocess (this file
run as a script), as the other port tests do.
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
SERVE_MODEL = dict(emb_dim=32, num_heads=4, enc_layers=1, dec_layers=1, enc_ffn_dim=64, decode_max_len=24)
TRAIN_MODEL = dict(vocab_size=124, emb_dim=64, num_heads=4, enc_layers=1, dec_layers=1, enc_ffn_dim=128,
                   max_global_len=256, decode_max_len=16, backbone="vgg", use_bilstm=False, dropout=0.1)
SEED, N_LINES, BATCH = 3, 10, 3
CALLER = ("khmer_ocr.wait_dispatch", "khmer_ocr.decode", "khmer_ocr.drain", "khmer_ocr.join")
OFF_PATHS = ("predict", "single", "multi", "prefetched")


if __name__ != "__main__":

    @pytest.fixture(scope="module")
    def port(tmp_path_factory):
        tmp = tmp_path_factory.mktemp("torch_spans")
        proc = subprocess.run([sys.executable, __file__, str(tmp)], cwd=REPO, capture_output=True, text=True,
                              env={**os.environ, "OMP_NUM_THREADS": "2"}, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        return json.loads((tmp / "spans.json").read_text())

    def named(spans, name, thread=None):
        return [s for s in spans if s[0] == name and (thread is None or s[3] == thread)]

    @pytest.mark.parametrize("path", OFF_PATHS)
    def test_no_profiler_never_enters_record_function(port, path):
        assert port["off"][path] == "ran", port["off"]

    def test_a_span_off_is_one_shared_no_op(port):
        assert port["shared_off"] == {"same": True, "on": "record_function"}

    @pytest.mark.parametrize("name", ["khmer_ocr.predict", "khmer_ocr.join"])
    def test_one_span_a_call(port, name):
        p = port["predict"]
        assert len(named(p["spans"], name, p["caller"])) == 1

    @pytest.mark.parametrize("name", ["khmer_ocr.decode", "khmer_ocr.drain"])
    def test_once_per_bucket_batch(port, name):
        p = port["predict"]
        assert p["batches"] >= 3
        assert len(named(p["spans"], name, p["caller"])) == p["batches"]

    def test_wait_dispatch_per_batch_and_the_end(port):
        p = port["predict"]
        assert len(named(p["spans"], "khmer_ocr.wait_dispatch", p["caller"])) == p["batches"] + 1

    def test_exit_tests_lie_inside_decodes(port):
        p = port["predict"]
        decodes = named(p["spans"], "khmer_ocr.decode", p["caller"])
        tests = named(p["spans"], "khmer_ocr.decode.exit_test", p["caller"])
        assert len(tests) >= len(decodes)
        for _, s, e, _ in tests:
            assert any(ds <= s and e <= de for _, ds, de, _ in decodes), (s, e)
        for _, ds, de, _ in decodes:
            assert any(ds <= s and e <= de for _, s, e, _ in tests)

    def test_caller_spans_inside_predict_and_disjoint(port):
        p = port["predict"]
        (_, ps, pe, _), = named(p["spans"], "khmer_ocr.predict", p["caller"])
        caller = sorted((s, e) for n, s, e, th in p["spans"] if n in CALLER and th == p["caller"])
        assert caller and all(ps <= s <= e <= pe for s, e in caller)
        assert all(e0 <= s1 for (_, e0), (s1, _) in zip(caller, caller[1:]))
        assert not [s for s in p["spans"] if s[3] != p["caller"]]  # a default profiler records the caller alone

    def test_profiled_tokens_equal_unprofiled(port):
        assert port["predict"]["tokens_equal"] is True

    @pytest.mark.parametrize("name", ["khmer_ocr.prepare", "khmer_ocr.wait_slot", "khmer_ocr.dispatch"])
    def test_profile_trace_shows_the_dispatch_thread(port, name):
        t = port["trace"]
        caller = {tid for n, tid in t["spans"] if n == "khmer_ocr.predict"}
        tids = {tid for n, tid in t["spans"] if n == name}
        assert len(caller) == 1 and tids and not tids & caller, t
        count = sum(n == name for n, _ in t["spans"])
        assert count == t["batches"] + (name == "khmer_ocr.prepare"), t  # the last pull finds none

    def test_prefetched_yields_the_same_items(port):
        f = port["prefetched"]
        assert f["plain"] == f["profiled"] == f["all_threads"] == [[i, i * i] for i in range(f["items"])]

    def test_prefetched_waits_once_per_item_and_the_end(port):
        f = port["prefetched"]
        assert f["wait_batch"] == {str(f["main"]): f["items"] + 1}

    def test_prefetch_thread_assembles_each_item(port):
        f = port["prefetched"]
        (tid, count), = f["assemble"].items()
        assert int(tid) != f["main"] and count == f["items"] + 1  # the last pull finds none
        assert f["all_threads_wait_batch"] == f["items"] + 1

    @pytest.mark.parametrize("kind", ["single", "multi"])
    def test_train_step_span(port, kind):
        assert port["train_step"][kind] == 1

    def test_span_holds_its_aten_ops(port):
        a = port["aten"]
        assert a["ops"] >= 2, a
        assert a["inside"] == a["ops"], a

    def test_decode_capture_span_wraps_a_capture_alone(port):
        assert port["capture"] == {"first": [1, 1], "again": [0, 0]}


def _port_main(tmp: Path) -> None:
    sys.path.insert(0, str(REPO))
    import threading
    import time

    import torch
    import torch.autograd.profiler as autograd_profiler
    from torch.profiler import profile

    from khmer_ocr_torch import profiling
    from khmer_ocr_torch.config import ModelConfig, OCRConfig, RuntimeConfig, TrainConfig
    from khmer_ocr_torch.convert.from_jax import seeded_params
    from khmer_ocr_torch.decode import graphs
    from khmer_ocr_torch.infer.predictor import Predictor
    from khmer_ocr_torch.train.data import LineDataset
    from khmer_ocr_torch.train.loop import _prefetched
    from khmer_ocr_torch.train.step import batch_to_device, init_train_state, make_train_multi_step, make_train_step
    from khmer_ocr_torch.utils import profile_trace

    torch.set_num_threads(2)
    out: dict = {}

    def spans_of(prof, prefix="khmer_ocr."):
        return [(e.name(), e.start_ns(), e.end_ns(), e.device_resource_id())
                for e in prof.profiler.kineto_results.events() if e.name().startswith(prefix)]

    # the serving path
    cfg = ModelConfig(**SERVE_MODEL)
    params, stats = seeded_params(cfg, SEED)
    pred = Predictor(params=params, batch_stats=stats, model_cfg=cfg, device="cpu",
                     config=OCRConfig(runtime=RuntimeConfig(batch_buckets=(1, 3), max_inflight_batches=1)))
    with np.load(REPO / "khmer_ocr_torch" / "assets" / "real_lines.npz") as z:
        lines = [z[f"line_{i}"] for i in range(N_LINES)]
    batches = sum(1 for _ in pred.preprocessor.iter_batches(lines, max_batch=BATCH))

    # the training path: a single and a multi step, dropout and augmentation on
    tcfg = ModelConfig(**TRAIN_MODEL)
    rs = np.random.RandomState(5)
    samples = [(rs.randint(0, 256, (48, 60)).astype(np.uint8), "ក" + "០១២៣"[i % 4]) for i in range(6)]
    ds = LineDataset(samples, train_cfg=TrainConfig(batch_size=2, augment_prob=0.8), device_augment=True)
    steps = [batch_to_device(b.as_dict(), "cpu")
             for b in ds.epoch_batches(2, np.random.default_rng(0), max_label_len=tcfg.decode_max_len + 1)]
    stacked = {k: torch.stack([b[k] for b in steps]) for k in steps[0]}
    single = make_train_step(tcfg, (100, 84), 0.8)
    multi = make_train_multi_step(tcfg, (100, 84), 0.8)
    state = init_train_state(tcfg, 1)
    gen = torch.Generator().manual_seed(7)

    def produce(n, delay=0.0):
        for i in range(n):
            time.sleep(delay)
            yield [i, i * i]

    # no profiler: record_function patched to raise on every path
    def refuse(*a, **kw):
        raise RuntimeError("record_function entered with no profiler")

    runs = {"predict": lambda: pred.predict_batch_tokens(lines, 3, BATCH),
            "single": lambda: single(state, steps[0], gen, 1e-3),
            "multi": lambda: multi(state, stacked, gen, [1e-3] * len(steps)),
            "prefetched": lambda: list(_prefetched(produce(5)))}
    saved = autograd_profiler.record_function, torch.profiler.record_function
    autograd_profiler.record_function = torch.profiler.record_function = refuse
    out["off"] = {}
    for name, fn in runs.items():
        try:
            fn()
            out["off"][name] = "ran"
        except RuntimeError as e:
            out["off"][name] = f"raised: {e}"
    autograd_profiler.record_function, torch.profiler.record_function = saved
    with profile():
        on = profiling.span("khmer_ocr.probe")
    out["shared_off"] = {"same": profiling.span("khmer_ocr.a") is profiling.span("khmer_ocr.b"),
                         "on": type(on).__name__}

    # predict_batch_tokens under a default profiler
    plain = pred.predict_batch_tokens(lines, 3, BATCH)
    with profile() as prof:
        rows = pred.predict_batch_tokens(lines, 3, BATCH)
    out["predict"] = {"spans": spans_of(prof), "caller": threading.get_native_id(), "batches": batches,
                      "tokens_equal": len(rows) == len(plain) and all(np.array_equal(a, b)
                                                                      for a, b in zip(rows, plain))}

    # profile_trace: every thread
    with profile_trace(tmp / "trace") as path:
        pred.predict_batch_tokens(lines, 3, BATCH)
    events = json.loads(path.read_text())["traceEvents"]
    out["trace"] = {"spans": [(e["name"], e["tid"]) for e in events
                              if str(e.get("name", "")).startswith("khmer_ocr.") and e.get("ph") == "X"],
                    "batches": batches}

    # _prefetched: items and spans, the producer slower than the consumer
    main = threading.get_native_id()
    f = {"items": 5, "main": main, "plain": list(_prefetched(produce(5, 0.01)))}
    with profile() as prof:
        f["profiled"] = list(_prefetched(produce(5, 0.01)))
    waits: dict = {}
    for n, _, _, th in spans_of(prof, "khmer_ocr.train.wait_batch"):
        waits[str(th)] = waits.get(str(th), 0) + 1
    f["wait_batch"] = waits
    with profiling.profiler() as prof:
        f["all_threads"] = list(_prefetched(produce(5, 0.01)))
    assemble: dict = {}
    for n, _, _, th in spans_of(prof, "khmer_ocr.train.assemble"):
        assemble[str(th)] = assemble.get(str(th), 0) + 1
    f["assemble"] = assemble
    f["all_threads_wait_batch"] = len(spans_of(prof, "khmer_ocr.train.wait_batch"))
    out["prefetched"] = f

    # the train step's span
    out["train_step"] = {}
    for kind, fn in (("single", runs["single"]), ("multi", runs["multi"])):
        with profile() as prof:
            fn()
        out["train_step"][kind] = len(spans_of(prof, "khmer_ocr.train.step"))

    # a span holds its aten ops on the profiler's clock
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    with profile() as prof:
        with profiling.span("khmer_ocr.probe"):
            torch.relu(torch.mm(a, b))
    events = prof.profiler.kineto_results.events()
    (probe,) = [e for e in events if e.name() == "khmer_ocr.probe"]
    ops = [e for e in events if e.name() in ("aten::mm", "aten::relu")]
    out["aten"] = {"ops": len(ops), "inside": sum(
        probe.start_ns() <= e.start_ns() <= e.end_ns() <= probe.end_ns()
        and e.device_resource_id() == probe.device_resource_id() for e in ops)}

    # khmer_ocr.decode.capture around a shape's capture: the capture stubbed, one chunk to capture at max_len 4
    sg = graphs.StepGraphs(lambda w, n: None, lambda *inputs: None, {"pos": torch.zeros((), dtype=torch.int32)},
                           {"self_kv": [(torch.zeros(1, 32, 8), torch.zeros(1, 32, 8))]})
    seen: list = []

    def fake_capture(todo, inputs, pool):
        seen.append(len(todo))
        sg.graphs.update({(w, n): None for w, _, n in todo})

    sg._capture = fake_capture
    capture = {}
    for key in ("first", "again"):
        seen.clear()
        with profile() as prof:
            sg.prepare(4, (), None)
        capture[key] = [len(spans_of(prof, "khmer_ocr.decode.capture")), len(seen)]
    out["capture"] = capture

    (tmp / "spans.json").write_text(json.dumps(out))


if __name__ == "__main__":
    _port_main(Path(sys.argv[1]))
