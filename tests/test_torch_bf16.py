"""The serving speed mode of the PyTorch port (bfloat16), on the CPU, against the JAX package's bfloat16.

The JAX package's speed mode casts its params to bfloat16 and lets
activations, caches and memory follow (``RuntimeConfig.compute_dtype``); the
port's ``Predictor`` and ``infer_batch`` do the same (infer/predictor.py).
bfloat16 keeps 8 significant bits: one step is 2^-7 of a value in [1, 2),
and two implementations that round at different points (XLA's bf16 dots
and elementwise ops against the port's float32 sums of bf16-rounded
inputs) differ by a few steps. Held here, at toy widths (D=32, 4 heads,
two decoder layers, se_vgg with the BiLSTM) on seeded weights whose
vocabulary projection is scaled by 8 (``toy_params``: seeded weights alone
predict a nearly flat distribution, every choice a near-tie):

  * the encoder memory (after the BiLSTM, run in float32 by both) within 8
    bf16 steps of the largest |memory| (the backbone's 7 convolutions, the
    encoder layer and the projections each round to bf16; measured 2-3
    steps), and the padding mask equal;
  * one decoder layer step (ops/kernels/decode_step.py::
    decoder_layer_step_plain, the kernel's oracle) against JAX's XLA
    ``decoder_layer_step`` in bfloat16, beam lineage and greedy: the output
    and the written cache slot within 4 bf16 steps of the largest value
    (LayerNorm outputs near 3: steps of 2^-6);
  * greedy and beam-3 tokens of 8 lines through ``infer_batch`` against
    JAX's ``_infer_jit`` with bfloat16 params: equal, but for lines whose
    two answers are within the bf16 margin of each other: their
    teacher-forced mean log-probs (the port in float32) differ by less
    than 0.05 nats a token, a few bf16 steps of the logits' scale. The
    exempt lines are counted and at most 2 of 8;
  * ``Predictor(compute_dtype="bfloat16")`` casts every param but the
    BatchNorm statistics, and decodes through the same path;
  * float32 (parity mode) is untouched: the same seeded lines give the
    tokens they gave before bfloat16 existed (the JAX package's float32
    tokens, equal).

The port runs in a torch-only subprocess (this file run as a script).
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
TOY = dict(vocab_size=124, emb_dim=32, num_heads=4, enc_layers=1, dec_layers=2, enc_ffn_dim=64, max_global_len=512,
           decode_max_len=24, dropout=0.0)
SEED = 3
MAX_LEN = 16
COUNTS = [1, 2, 3, 4, 2, 1, 3, 4]
BF16_STEP = 2.0 ** -7  # one step of a bf16 value in [1, 2)
MARGIN = 0.05  # nats
SHARPEN = 8.0


def toy_params():
    """Seeded weights (JAX layout) with the vocabulary projection scaled by
    SHARPEN: seeded weights alone give a nearly flat next-token distribution
    whose every choice is a near-tie; the sharper head makes the decode's
    choices ones that bf16 rounding should not flip."""
    from khmer_ocr_torch.config import ModelConfig
    from khmer_ocr_torch.convert.from_jax import seeded_params

    params, stats = seeded_params(ModelConfig(**TOY), SEED)
    params["dec"]["out"]["w"] = params["dec"]["out"]["w"] * SHARPEN
    return params, stats


def lines_batch() -> dict:
    """8 synthetic block lines white-padded into the 4-chunk bucket."""
    from khmer_ocr_torch.data.synthetic import synthetic_lines

    wb = 3 * 84 + 100
    lines = np.full((len(COUNTS), 48, wb), 255, np.uint8)
    for i, line in enumerate(synthetic_lines(COUNTS, seed=SEED)):
        lines[i, :, :min(wb, line.shape[1])] = line[:, :wb]
    return {"lines": lines, "counts": np.array(COUNTS, np.int32)}


def step_inputs(d: int, lanes: int):
    """Seeded inputs of one decoder layer step (float32; each side casts)."""
    r = np.random.RandomState(20 + lanes)
    n_img, cache_len, tm, w = 3, 16, 40, 16
    b = n_img * lanes
    valid = r.rand(n_img, tm) > 0.25
    valid[:, 0] = True
    return dict(x=r.randn(b, d).astype(np.float32) * 0.5, sk=r.randn(b, cache_len, d).astype(np.float32) * 0.3,
                sv=r.randn(b, cache_len, d).astype(np.float32) * 0.3,
                mk=r.randn(n_img, tm, d).astype(np.float32) * 0.3, mv=r.randn(n_img, tm, d).astype(np.float32) * 0.3,
                valid=valid, lin=r.randint(0, lanes, (b, w)).astype(np.int32) if lanes > 1 else None,
                pos=9, w=w, lanes=lanes)


if __name__ != "__main__":
    import jax
    import jax.numpy as jnp

    @pytest.fixture(scope="module")
    def jax_side():
        from khmer_ocr_tpu.config import DecodeConfig, ModelConfig
        from khmer_ocr_tpu.infer.predictor import _device_chunk, _infer_jit
        from khmer_ocr_tpu.models.layers import Ctx, decoder_layer_step, pack_step_params
        from khmer_ocr_tpu.models.ocr_model import encode

        cfg = ModelConfig(**TOY)
        params, stats = toy_params()
        params32, stats = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats)
        params16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params32)
        b = lines_batch()
        lines, counts = jnp.asarray(b["lines"]), jnp.asarray(b["counts"])
        ctx = Ctx(num_heads=cfg.num_heads, dropout=0.0, deterministic=True)

        @jax.jit
        def enc(p, s, u8, n):
            chunks = _device_chunk((u8.astype(jnp.float32) / 255.0 - 0.5) / 0.5, (100, 84)).astype(jnp.bfloat16)
            return encode(p, s, chunks, n, cfg, ctx, train=False)[:2]

        memory, pad = enc(params16, stats, lines, counts)
        out = {"memory": np.asarray(memory.astype(jnp.float32)), "pad": np.asarray(pad)}
        for dt, p, prec in (("bf16", params16, "default"), ("f32", params32, "highest")):
            for beam in (1, 3):
                dc = DecodeConfig(beam_width=beam, max_len=MAX_LEN)
                out[f"tokens_{dt}_{beam}"] = np.asarray(_infer_jit(p, stats, lines, counts, cfg, dc, beam > 1, prec,
                                                                   (100, 84)))
        lp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), pack_step_params(params32["dec"]["layers"][0]))
        for lanes in (1, 3):
            s = step_inputs(cfg.emb_dim, lanes)
            bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
            idx = None
            if s["lin"] is not None:
                rows = np.arange(s["x"].shape[0])[:, None]
                idx = np.where(np.arange(s["w"])[None, :] == s["pos"], rows, s["lin"] + lanes * (rows // lanes))
                idx = jnp.asarray(idx.astype(np.int32))
            fn = jax.jit(lambda x, sk, sv, mk, mv, valid, idx: decoder_layer_step(
                lp, ctx, x, s["pos"], sk, sv, mk, mv, valid, window=s["w"], lineage_idx=idx))
            x, sk, _ = fn(bf(s["x"]), bf(s["sk"]), bf(s["sv"]), bf(s["mk"]), bf(s["mv"]), jnp.asarray(s["valid"]), idx)
            out[f"step_x_{lanes}"] = np.asarray(x.astype(jnp.float32))
            out[f"step_k_{lanes}"] = np.asarray(sk[:, s["pos"]].astype(jnp.float32))
        return out

    @pytest.fixture(scope="module")
    def port(tmp_path_factory, jax_side):
        tmp = tmp_path_factory.mktemp("torch_bf16")
        np.savez(tmp / "jax_tokens.npz", **{k: v for k, v in jax_side.items() if k.startswith("tokens")})
        subprocess.run([sys.executable, __file__, "port", str(tmp)], cwd=REPO, check=True, timeout=600)
        return dict(np.load(tmp / "port.npz")), json.loads((tmp / "port.json").read_text())

    def test_encoder_memory_within_bf16_steps(port, jax_side):
        got, ref = port[0]["memory"], jax_side["memory"]
        np.testing.assert_array_equal(port[0]["pad"], jax_side["pad"])
        valid = ~jax_side["pad"]
        scale = max(1.0, np.abs(ref[valid]).max())
        assert np.abs(got[valid] - ref[valid]).max() <= 8 * BF16_STEP * scale, np.abs(got[valid] - ref[valid]).max()

    @pytest.mark.parametrize("lanes", [1, 3], ids=["greedy", "beam3"])
    def test_plain_bf16_step_against_jax_xla_step(port, jax_side, lanes):
        for key in (f"step_x_{lanes}", f"step_k_{lanes}"):
            got, ref = port[0][key], jax_side[key]
            scale = max(1.0, np.abs(ref).max())
            assert np.abs(got - ref).max() <= 4 * BF16_STEP * scale, (key, np.abs(got - ref).max())

    @pytest.mark.parametrize("beam", [1, 3], ids=["greedy", "beam3"])
    def test_bf16_tokens_against_jax_but_near_ties(port, jax_side, beam):
        got, ref = port[0][f"tokens_bf16_{beam}"], jax_side[f"tokens_bf16_{beam}"]
        assert got.shape == ref.shape
        differ = [i for i in range(len(got)) if not np.array_equal(got[i], ref[i])]
        gaps = port[1]["gaps"][str(beam)]
        assert sorted(int(i) for i in gaps) == differ
        assert all(g < MARGIN for g in gaps.values()), gaps
        assert len(differ) <= 2, differ

    @pytest.mark.parametrize("beam", [1, 3], ids=["greedy", "beam3"])
    def test_float32_tokens_equal_jax(port, jax_side, beam):
        np.testing.assert_array_equal(port[0][f"tokens_f32_{beam}"], jax_side[f"tokens_f32_{beam}"])

    def test_predictor_casts_all_but_the_statistics(port):
        meta = port[1]["predictor"]
        assert meta["dtypes"] == ["torch.bfloat16"] and meta["stat_dtypes"] == ["torch.float32"]
        assert meta["n_stats"] > 0
        assert meta["tokens_equal_infer_batch"]


def _tf_gap(torch, state, cfg, lines, counts, seq_a, seq_b) -> float:
    """Where two answers part: the difference of their teacher-forced log-probs
    (the float32 model), summed from <sos> through the first token where
    they differ."""
    from khmer_ocr_torch.models.ocr_model import forward_train
    from khmer_ocr_torch.ops.lines import device_chunk, u8_to_unit, unit_normalize

    k = int(np.argmax(np.asarray(seq_a) != np.asarray(seq_b)))  # the first token that differs
    chunks = device_chunk(unit_normalize(u8_to_unit(lines)), (100, 84))
    sums = []
    for seq in (seq_a, seq_b):
        seq = torch.tensor([int(t) for t in seq[:k + 1]])[None]
        with torch.no_grad():
            logits, _ = forward_train(state, None, chunks, counts, seq[:, :-1], cfg, train=False)
        sums.append(float(torch.log_softmax(logits.float(), -1)[0].gather(-1, seq[0, 1:, None]).sum()))
    return abs(sums[0] - sums[1])


def _port_main(tmp: Path) -> None:
    sys.path.insert(0, str(REPO))
    import torch

    from khmer_ocr_torch.config import DecodeConfig, ModelConfig, OCRConfig, RuntimeConfig
    from khmer_ocr_torch.convert.from_jax import params_from_jax
    from khmer_ocr_torch.infer.predictor import Predictor, cast_params, infer_batch
    from khmer_ocr_torch.models.layers import pack_step_params
    from khmer_ocr_torch.models.ocr_model import encode
    from khmer_ocr_torch.ops.kernels import decode_step as K
    from khmer_ocr_torch.ops.lines import device_chunk, u8_to_unit, unit_normalize
    from khmer_ocr_torch.preprocess import PreparedBatch

    torch.set_num_threads(2)
    cfg = ModelConfig(**TOY)
    params, stats = toy_params()
    s32 = params_from_jax(params, stats, cfg)
    s16 = cast_params(s32, torch.bfloat16)
    b = lines_batch()
    lines, counts = torch.from_numpy(b["lines"]), torch.from_numpy(b["counts"])
    out, meta = {}, {}
    with torch.inference_mode():
        chunks = device_chunk(unit_normalize(u8_to_unit(lines)), (100, 84)).to(torch.bfloat16)
        memory, pad = encode(s16, chunks, counts, cfg)
    out["memory"], out["pad"] = memory.float().numpy(), pad.numpy()

    jax_tokens = dict(np.load(tmp / "jax_tokens.npz"))
    meta["gaps"] = {}
    for dt, state in (("bf16", s16), ("f32", s32)):
        for beam in (1, 3):
            dc = DecodeConfig(beam_width=beam, max_len=MAX_LEN)
            got = infer_batch(state, lines, counts, cfg, dc, (100, 84)).numpy()
            out[f"tokens_{dt}_{beam}"] = got
            if dt == "bf16":
                ref = jax_tokens[f"tokens_bf16_{beam}"]
                meta["gaps"][str(beam)] = {
                    str(i): _tf_gap(torch, s32, cfg, lines[i:i + 1], counts[i:i + 1], got[i], ref[i])
                    for i in range(len(got)) if not np.array_equal(got[i], ref[i])}

    wt = K.layer_weights(pack_step_params(cast_params(s32["dec"]["layers"][0], torch.bfloat16)))
    for lanes in (1, 3):
        s = step_inputs(cfg.emb_dim, lanes)
        bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
        sk, sv = bf(s["sk"]), bf(s["sv"])
        lin = None if s["lin"] is None else torch.from_numpy(s["lin"])
        x = K.decoder_layer_step_plain(wt, bf(s["x"]), s["pos"], sk, sv, bf(s["mk"]), bf(s["mv"]),
                                       torch.from_numpy(s["valid"]).float(), lin, num_heads=cfg.num_heads,
                                       window=s["w"], lanes=lanes)
        out[f"step_x_{lanes}"] = x.float().numpy()
        out[f"step_k_{lanes}"] = sk[:, s["pos"]].float().numpy()

    ocfg = OCRConfig(model=cfg, runtime=RuntimeConfig(compute_dtype="bfloat16", batch_buckets=(8,)))
    pred = Predictor(params=params, batch_stats=stats, model_cfg=cfg, device="cpu", config=ocfg)
    flat = []

    def walk(tree, name=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, k)
        elif isinstance(tree, list):
            for v in tree:
                walk(v, name)
        else:
            flat.append((name, tree))

    walk(pred.params)
    rows = pred.decode_prepared(PreparedBatch(b["lines"], b["counts"], list(range(len(COUNTS))), 4), 3, MAX_LEN)
    meta["predictor"] = {
        "dtypes": sorted({str(t.dtype) for n, t in flat if n not in ("mean", "var")}),
        "stat_dtypes": sorted({str(t.dtype) for n, t in flat if n in ("mean", "var")}),
        "n_stats": sum(n in ("mean", "var") for n, _ in flat),
        "tokens_equal_infer_batch": all(np.array_equal(r, t) for r, t in zip(rows, out["tokens_bf16_3"])),
    }
    np.savez(tmp / "port.npz", **out)
    (tmp / "port.json").write_text(json.dumps(meta))


if __name__ == "__main__":
    if sys.argv[1] == "port":
        _port_main(Path(sys.argv[2]))
