"""The ResNet-Transformer baseline through the port's greedy serving path, on
the CPU, held to the benchmark's plain reference (perfbench/reference/).

The model is ``perfbench/configs/resnet_seeded.json``'s at its published
widths (the ResNet backbone, no BiLSTM, D 384, 8 heads, 2 + 2 layers),
weights seeded as that configuration makes them (the cross-attention
queries x4, BatchNorm statistics set from real lines: here 4 of them).
Five lines joined from the rendered real lines, in two chunk buckets (2 and
3 chunks), go through ``Predictor.predict_batch_tokens`` at beam 1. Checked:

  * the memory each served bucket batch was decoded from (recorded where the
    dispatch stage encodes it), its real rows against the reference's
    float32 encode of the same pixels;
  * every served greedy token's reference log-prob within ``GAP_TOL`` of
    the reference's best at its prefix (``token_gaps``), ``MAX_LEN`` steps;
  * the real rows' tokens equal with batches padded to 4 rows (the last
    line repeated) and with no padding rows;
  * the dispatch stage's eager encode: with ``encode_graph.MAX_CHUNKS`` cut
    to 10, the batch of 4 rows x 3 chunks is encoded eagerly, counted once
    in ``Predictor.eager_encodes`` and marked by one
    ``khmer_ocr.encode.eager`` span inside ``khmer_ocr.dispatch`` on the
    dispatch thread, in ``utils.profile_trace``'s trace;
  * the tolerances are tight enough: the reference with every matmul and
    convolution operand rounded to TF32 (``Ref(..., "tf32")``) misses the
    memory tolerance.

The port runs in one torch-only subprocess (this file run as a script), as
the other port tests do; nothing here imports JAX or the JAX package.
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
CONFIG = REPO / "perfbench" / "configs" / "resnet_seeded.json"
SEED = 5
MAX_LEN = 12
# (real-line parts, width px) of each line: three of 2 chunks, two of 3
LINES = [([3, 17], 140), ([40, 8], 160), ([21, 55], 165), ([12, 33], 220), ([60, 2], 250)]
CALIBRATE_LINES = 4
# The port's float32 memory departs from the reference's by rounding alone: other convolution and matmul
# algorithms (oneDNN's against torch's plain calls) through 17 convolutions, the patch projection and two
# encoder layers. The memory's entries are of order 1 (LayerNorm, then the global positions); float32 rounding
# leaves them within 1e-5 of the reference's here, TF32's 10-bit operands move them by about 6e-3.
MEMORY_TOL = 1e-4
# A served token's reference log-prob below the reference's best at its prefix: 0 where the port took the
# reference's argmax; float32 rounding can flip only a near-tie, of the size of the logits' rounding (about 1e-6).
GAP_TOL = 1e-4
EAGER_MAX_CHUNKS = 10  # below the padded batch of 4 x 3 chunks (12), above 4 x 2 (8)


if __name__ != "__main__":

    @pytest.fixture(scope="module")
    def port(tmp_path_factory):
        tmp = tmp_path_factory.mktemp("torch_resnet_greedy")
        proc = subprocess.run([sys.executable, __file__, str(tmp)], cwd=REPO, capture_output=True, text=True,
                              env={**os.environ, "OMP_NUM_THREADS": "2"}, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        return json.loads((tmp / "resnet.json").read_text())

    def test_the_model_is_the_configurations(port):
        cfg = json.loads(CONFIG.read_text())["model"]
        assert port["model"] == {k: cfg[k] for k in port["model"]}
        assert cfg["backbone"] == "resnet" and cfg["use_bilstm"] is False

    def test_lines_fall_in_two_chunk_buckets(port):
        assert port["chunks"] == [2, 2, 2, 3, 3]
        assert sorted(port["buckets"]) == [2, 3]

    @pytest.mark.parametrize("line", range(len(LINES)))
    def test_memory_matches_the_reference(port, line):
        assert port["memory_gap"][line] <= MEMORY_TOL, port["memory_gap"]

    @pytest.mark.parametrize("line", range(len(LINES)))
    def test_served_tokens_are_the_references_best(port, line):
        assert port["steps"][line] >= 1
        assert port["token_gap"][line] <= GAP_TOL, port["token_gap"]

    def test_padding_rows_leave_the_real_rows_unchanged(port):
        assert port["padded_rows"] == [4, 4] and port["unpadded_rows"] == [3, 2]
        assert port["rows_equal"] is True

    def test_eager_encode_is_counted_and_marked(port):
        e = port["eager"]
        assert e["counted"] == 1 and e["unpadded_counted"] == 0
        assert e["spans"] == 1 and e["inside_dispatch"] is True and e["on_caller_thread"] is False

    def test_tf32_misses_the_memory_tolerance(port):
        assert max(port["tf32_memory_gap"]) > MEMORY_TOL, port["tf32_memory_gap"]

    def test_no_jax_in_the_port_process(port):
        assert port["jax_loaded"] == []


def _port_main(tmp: Path) -> None:
    sys.path.insert(0, str(REPO))
    import torch

    from khmer_ocr_torch.config import OCRConfig, RuntimeConfig
    from khmer_ocr_torch.infer import encode_graph
    from khmer_ocr_torch.infer import predictor as predictor_mod
    from khmer_ocr_torch.utils import profile_trace
    from perfbench.harness.serve import model_config
    from perfbench.harness.traffic import RealLines, chunks_of, join_line
    from perfbench.reference.model import Ref, calibrate_batch_norm, chunk_lines
    from perfbench.reference.search import token_gaps
    from perfbench.reference.weights import seeded, tree_map

    torch.set_num_threads(2)
    out: dict = {}
    config = json.loads(CONFIG.read_text())
    m, w = config["model"], config["weights"]
    mcfg = model_config(m)
    out["model"] = {k: getattr(mcfg, k) for k in ("backbone", "emb_dim", "num_heads", "enc_layers", "dec_layers",
                                                  "enc_ffn_dim", "dec_ffn_dim", "use_bilstm", "vocab_size")}
    real = RealLines(REPO / "perfbench" / "data")
    lines = [join_line(real, parts, 16, width) for parts, width in LINES]
    out["chunks"] = [chunks_of(ln.shape[1]) for ln in lines]

    # seeded weights as the configuration makes them, BatchNorm set from a few real lines
    params, stats = seeded(m, SEED, "cpu", w["cross_query_scale"])
    cal, _ = chunk_lines(real.lines[:CALIBRATE_LINES], "cpu")
    with torch.no_grad():
        calibrate_batch_norm(Ref(params, stats, m), cal.reshape(-1, 48, 100))
    host = tree_map(lambda t: t.numpy().copy(), params), tree_map(lambda t: t.numpy().copy(), stats)

    def predictor(buckets):
        rt = RuntimeConfig(batch_buckets=buckets, host_workers=1)
        return predictor_mod.Predictor(params=host[0], batch_stats=host[1], model_cfg=mcfg, device="cpu",
                                       config=OCRConfig(model=mcfg, runtime=rt))

    # the memory of each bucket batch, where the dispatch stage encodes it
    encoded = []
    original = predictor_mod.encode_batch

    def recording(params, lines_t, counts, *args, **kwargs):
        memory, pad = original(params, lines_t, counts, *args, **kwargs)
        encoded.append((memory.clone(), pad.clone()))
        return memory, pad

    padded = predictor((1, 4))
    batches = list(padded.preprocessor.iter_batches(lines, max_batch=4))
    out["buckets"] = [b.bucket_n for b in batches]
    out["padded_rows"] = [predictor_mod._round_up(b.lines.shape[0], (1, 4)) for b in batches]
    predictor_mod.encode_batch = recording
    encode_graph.MAX_CHUNKS, max_chunks = EAGER_MAX_CHUNKS, encode_graph.MAX_CHUNKS
    try:
        with profile_trace(tmp / "trace") as path:
            rows = padded.predict_batch_tokens(lines, 1, 4, MAX_LEN)
    finally:
        predictor_mod.encode_batch = original
        encode_graph.MAX_CHUNKS = max_chunks
    events = json.loads(Path(path).read_text())["traceEvents"]
    spans = {n: [(e["tid"], e["ts"], e["ts"] + e["dur"]) for e in events if e.get("name") == n and e.get("ph") == "X"]
             for n in ("khmer_ocr.encode.eager", "khmer_ocr.dispatch", "khmer_ocr.predict")}
    eager = spans["khmer_ocr.encode.eager"]
    out["eager"] = {"counted": padded.eager_encodes, "spans": len(eager),
                    "inside_dispatch": all(any(t == dt and ds <= s and e <= de for dt, ds, de in
                                               spans["khmer_ocr.dispatch"]) for t, s, e in eager),
                    "on_caller_thread": any(t in {pt for pt, _, _ in spans["khmer_ocr.predict"]} for t, _, _ in eager)}

    unpadded = predictor((1, 2, 3))
    out["unpadded_rows"] = [b.lines.shape[0] for b in unpadded.preprocessor.iter_batches(lines, max_batch=4)]
    plain = unpadded.predict_batch_tokens(lines, 1, 4, MAX_LEN)
    out["eager"]["unpadded_counted"] = unpadded.eager_encodes
    out["rows_equal"] = all(np.array_equal(a, b) for a, b in zip(rows, plain))

    # the reference on the same pixels
    tok = padded.tokenizer
    chunks, counts = chunk_lines(lines, "cpu")
    ref_cfg = {**m, "sos_idx": tok.sos_idx}
    served = np.full((len(lines), MAX_LEN + 2), tok.pad_idx, np.int64)
    for i, r in enumerate(rows):
        served[i, :len(r)] = r
    served_t = torch.from_numpy(served)
    with torch.no_grad():
        ref = Ref(params, stats, ref_cfg, "f32")
        mem, pad = ref.encode(chunks, counts)
        ctl_mem, _ = Ref(params, stats, ref_cfg, "tf32").encode(chunks, counts)
        gaps = token_gaps(ref, mem, pad, served_t, tok.eos_idx, MAX_LEN)
    gen = served[:, 1:MAX_LEN + 1]
    out["steps"] = [int(np.flatnonzero(g == tok.eos_idx)[0]) + 1 if (g == tok.eos_idx).any() else MAX_LEN
                    for g in gen]
    out["token_gap"] = [float(g) for g in gaps]
    port_mem = [None] * len(lines)
    for b, (memory, _) in zip(batches, encoded):
        for row, idx in enumerate(b.indices):
            port_mem[idx] = memory[row]
    valid = [c * 32 for c in out["chunks"]]
    out["memory_gap"] = [float((port_mem[i][:n] - mem[i, :n]).abs().max()) for i, n in enumerate(valid)]
    out["tf32_memory_gap"] = [float((ctl_mem[i, :n] - mem[i, :n]).abs().max()) for i, n in enumerate(valid)]
    out["jax_loaded"] = sorted({k.split(".")[0] for k in sys.modules} & {"jax", "jaxlib", "flax", "khmer_ocr_tpu"})
    (tmp / "resnet.json").write_text(json.dumps(out))


if __name__ == "__main__":
    _port_main(Path(sys.argv[1]))
