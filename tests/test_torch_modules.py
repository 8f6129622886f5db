"""Module parity of the PyTorch port against the JAX package, on the CPU.

The same numpy-seeded inputs go through each JAX function (in this process)
and its port counterpart. The port side runs once per module in a torch-only
subprocess (this file run as a script), because torch compute followed by
jitted JAX in one process can hang (tests/conftest.py). The port's kernels
run here through their plain versions; the JAX side of the two Pallas
kernels runs in interpret mode as well as through its plain reference.

Tolerances:
  * chunking, pad masks, top-k and tokens: exact;
  * one float32 layer (pool, backbone, decoder step, LSTM): 1e-5 x max(1, |ref|),
    the spread of float32 sums taken in another order;
  * memory after the BiLSTM: 1e-4, two encoder layers and a recurrence later.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]

TOY = dict(emb_dim=64, num_heads=4, enc_layers=2, dec_layers=2, enc_ffn_dim=128, max_global_len=512,
           decode_max_len=64)
TIES = dict(vocab_size=8, emb_dim=32, num_heads=4, enc_layers=1, dec_layers=2, enc_ffn_dim=64,
            max_global_len=64, decode_max_len=16, backbone="se_vgg")
STRESS = dict(vocab_size=40, emb_dim=64, num_heads=4, enc_layers=1, dec_layers=2, enc_ffn_dim=128,
              max_global_len=256, decode_max_len=128, use_bilstm=False)
TIE_CASES = {  # decoder output bias per case (tests/test_beam_ties.py)
    "all_tied": [-30, -30, -30, 0.0, 0.0, 0.0, 0.0, 0.0],
    "top2_tied_eos_third": [-30, -30, -30, 0.5, 1.0, 1.0, 0.2, 0.1],
    "eos_tied_with_best": [-30, -30, -30, 1.0, 1.0, 0.3, 0.2, 0.1],
    "distinct": [-30, -30, -30, 0.4, 1.2, 0.8, 0.1, -0.5],
    "pairwise_ties": [-30, -30, -30, 0.7, 0.7, 0.3, 0.3, 0.0],
}
TIE_KS = (2, 3, 5)
TOPK_SHAPES = ((128, 3, 124), (128, 9), (7, 5, 33))
STEP_CASES = [(lin, w, tm) for lin in (False, True) for w in (32, 64) for tm in (32, 256)]
CHUNK_COUNTS = (1, 2, 3, 5, 7, 13, 30)


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), f"max |diff| {err:.3e} > {tol} x max(1, |ref|)"


def _step_inputs(lin: bool, w: int, tm: int):
    r = np.random.RandomState(100 + w + tm + int(lin))
    n_img, lanes, d, cache_len = 2, 3 if lin else 1, 384, 64
    b = n_img * lanes
    valid = r.rand(n_img, tm) > 0.2
    valid[:, 0] = True
    return dict(
        x=r.randn(b, d).astype(np.float32) * 0.5,
        sk=r.randn(b, cache_len, d).astype(np.float32) * 0.3,
        sv=r.randn(b, cache_len, d).astype(np.float32) * 0.3,
        mk=r.randn(n_img, tm, d).astype(np.float32) * 0.3,
        mv=r.randn(n_img, tm, d).astype(np.float32) * 0.3,
        valid=valid.astype(np.float32),
        lin=r.randint(0, lanes, size=(b, w)).astype(np.int32),
        pos=np.int32(w - 1 - (w // 4)),
    )


# ---------------------------------------------------------------------------
# the JAX side and the fixtures (pytest process)
# ---------------------------------------------------------------------------

if __name__ != "__main__":
    import jax
    import jax.numpy as jnp

    from khmer_ocr_torch.convert.from_jax import save_npz, seeded_params
    from khmer_ocr_torch.config import ModelConfig as PortModelConfig
    from khmer_ocr_torch.data.synthetic import synthetic_lines

    @pytest.fixture(scope="module")
    def port(tmp_path_factory):
        """Build every case's inputs, run the port side once, return its outputs."""
        from khmer_ocr_tpu.config import ModelConfig
        from khmer_ocr_tpu.models.ocr_model import init_model

        tmp = tmp_path_factory.mktemp("torch_modules")
        r = np.random.RandomState(0)
        inp = {
            "pool_x": r.randn(2, 3, 25, 16).astype(np.float32),
            "chunks": r.uniform(-1, 1, size=(3, 48, 100, 1)).astype(np.float32),
            "xg": (r.randn(8, 16, 768) * 0.3).astype(np.float32),
            "w_hh": (r.randn(192, 768) * 0.05).astype(np.float32),
            "ties_memory": np.asarray(jax.random.normal(jax.random.PRNGKey(1), (1, 8, 32), jnp.float32)),
        }
        for i, shape in enumerate(TOPK_SHAPES):
            x = np.round(np.random.RandomState(i).randn(*shape), 1).astype(np.float32)
            x[..., : shape[-1] // 3] = x[..., :1]
            inp[f"topk_{i}"] = x
        for lin, w, tm in STEP_CASES:
            for k, v in _step_inputs(lin, w, tm).items():
                inp[f"step_{int(lin)}_{w}_{tm}_{k}"] = v
        rs = np.random.RandomState(11)
        mem = (rs.randn(4, 128, 64) * 0.5).astype(np.float32)
        pad = np.arange(128)[None, :] >= np.array([32, 64, 96, 128])[:, None]
        mem[pad] = 0.0
        inp["stress_memory"], inp["stress_pad"] = mem, pad
        np.savez(tmp / "inputs.npz", **inp)

        toy_p, toy_s = seeded_params(PortModelConfig(**TOY), 3)
        save_npz(tmp / "toy.npz", toy_p, toy_s)
        ties_p, ties_s = init_model(jax.random.PRNGKey(0), ModelConfig(**TIES))
        save_npz(tmp / "ties.npz", jax.tree.map(np.asarray, ties_p), jax.tree.map(np.asarray, ties_s))
        stress_p, stress_s = init_model(jax.random.PRNGKey(0), ModelConfig(**STRESS))
        save_npz(tmp / "stress.npz", jax.tree.map(np.asarray, stress_p), jax.tree.map(np.asarray, stress_s))

        subprocess.run([sys.executable, __file__, str(tmp)], cwd=REPO, check=True, timeout=600)
        with np.load(tmp / "outputs.npz") as z:
            out = {k: z[k] for k in z.files}
        return {"out": out, "inp": inp, "toy": (toy_p, toy_s), "ties": (ties_p, ties_s),
                "stress": (stress_p, stress_s), "meta": json.loads((tmp / "outputs.json").read_text())}

    def test_chunking_bit_exact(port):
        """Bucketing, white padding, the port's host chunker and its on-device
        windows == the JAX package's host chunker."""
        from khmer_ocr_tpu.config import PreprocessConfig
        from khmer_ocr_tpu.preprocess import Preprocessor, chunk_line, normalize

        pre, cfg = Preprocessor(), PreprocessConfig()
        for i, line in enumerate(synthetic_lines(CHUNK_COUNTS, seed=5)):
            bucket, n, padded = pre._prepare_one(line)
            assert port["meta"]["chunk"][i] == [bucket, n]
            np.testing.assert_array_equal(port["out"][f"chunk_padded_{i}"], padded)
            ref = normalize(chunk_line(line.astype(np.float32) / 255.0, cfg, bucket))
            np.testing.assert_array_equal(port["out"][f"chunk_windows_{i}"], ref)
            np.testing.assert_array_equal(port["out"][f"chunk_host_{i}"], ref)
        batches = [(b.bucket_n, b.indices) for b in pre.iter_batches(synthetic_lines(CHUNK_COUNTS, seed=5),
                                                                     max_batch=2)]
        assert [tuple(x) for x in port["meta"]["batches"]] == [(bn, idx) for bn, idx in batches]

    def test_adaptive_pool(port):
        from khmer_ocr_tpu.ops.adaptive_pool import adaptive_avg_pool2d

        ref = adaptive_avg_pool2d(jnp.asarray(port["inp"]["pool_x"]), (2, 32))
        _close(port["out"]["pool"], ref, 1e-5)

    def test_se_vgg_backbone(port):
        from khmer_ocr_tpu.models.backbones import se_vgg_apply

        p, s = port["toy"]
        with jax.default_matmul_precision("highest"):
            ref, _ = jax.jit(lambda p, s, x: se_vgg_apply(p, s, x))(p["backbone"], s, port["inp"]["chunks"])
        _close(port["out"]["backbone"], ref, 1e-5)

    def test_encode_with_bucket_padding(port):
        """chunk_counts < N: padding chunks never reach valid memory positions."""
        from khmer_ocr_tpu.config import ModelConfig
        from khmer_ocr_tpu.models.layers import Ctx
        from khmer_ocr_tpu.models.ocr_model import encode

        cfg = ModelConfig(**TOY)
        p, s = port["toy"]
        ctx = Ctx(num_heads=cfg.num_heads, dropout=0.0, deterministic=True)
        with jax.default_matmul_precision("highest"):
            mem, pad, _ = jax.jit(lambda p, s, c, n: encode(p, s, c, n, cfg, ctx))(
                p, s, port["out"]["enc_chunks"], port["out"]["enc_counts"])
        np.testing.assert_array_equal(port["out"]["enc_pad"], np.asarray(pad))
        valid = ~np.asarray(pad)
        _close(port["out"]["enc_memory"][valid], np.asarray(mem)[valid], 1e-4)

    def test_lstm_plain_vs_scan_and_interpret_kernel(port, monkeypatch):
        """H=192: the port's plain recurrence == lax.scan and == the Pallas
        kernel in interpret mode."""
        from jax.experimental import pallas as pl

        import khmer_ocr_tpu.ops.pallas.lstm as L
        from khmer_ocr_tpu.models.bilstm import _cell_factory

        xg, w = jnp.asarray(port["inp"]["xg"]), jnp.asarray(port["inp"]["w_hh"])
        h0 = jnp.zeros((xg.shape[0], 192), jnp.float32)
        (_, _), scan = jax.lax.scan(_cell_factory(w), (h0, h0), xg.transpose(1, 0, 2))
        _close(port["out"]["lstm"], scan.transpose(1, 0, 2), 1e-5)
        orig = pl.pallas_call
        monkeypatch.setattr(pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True}))
        _close(port["out"]["lstm"], L.lstm_recurrence(xg, w, 192), 1e-5)

    @pytest.mark.parametrize("lin,w,tm", STEP_CASES)
    def test_decoder_step_plain_vs_reference_and_interpret_kernel(port, lin, w, tm):
        """D=384, 8 heads: the port's plain step == decoder_layer_step and ==
        fused_decoder_layer_step in interpret mode (output and both caches)."""
        from khmer_ocr_tpu.models.layers import Ctx, decoder_layer_step, pack_step_params
        from khmer_ocr_tpu.ops.pallas.decode_step import fused_decoder_layer_step, layer_weights

        p, _ = seeded_params(PortModelConfig(), 0)
        lp = pack_step_params(jax.tree.map(jnp.asarray, p["dec"]["layers"][0]))
        c = {k: port["inp"][f"step_{int(lin)}_{w}_{tm}_{k}"] for k in
             ("x", "sk", "sv", "mk", "mv", "valid", "lin", "pos")}
        pos, lanes = int(c["pos"]), 3 if lin else 1
        b = c["x"].shape[0]
        idx = None
        if lin:
            rows = np.arange(b)[:, None]
            idx = jnp.asarray(np.where(np.arange(w)[None, :] == pos, rows, c["lin"] + lanes * (rows // lanes)))
        ctx = Ctx(num_heads=8, dropout=0.0, deterministic=True)
        with jax.default_matmul_precision("highest"):
            x_ref, k_ref, v_ref = decoder_layer_step(lp, ctx, c["x"], pos, c["sk"], c["sv"], c["mk"], c["mv"],
                                                     c["valid"] > 0, window=w, lineage_idx=idx)
            x_f, k_f, v_f = fused_decoder_layer_step(
                layer_weights(lp), jnp.asarray(c["x"]), pos, jnp.asarray(c["sk"]), jnp.asarray(c["sv"]),
                jnp.asarray(c["mk"]), jnp.asarray(c["mv"]), jnp.asarray(c["valid"]),
                jnp.asarray(c["lin"]) if lin else None, num_heads=8, window=w, lanes=lanes, interpret=True)
        key = f"step_{int(lin)}_{w}_{tm}"
        for ref_x, ref_k, ref_v in ((x_ref, k_ref, v_ref), (x_f, k_f, v_f)):
            _close(port["out"][f"{key}_x"], ref_x, 1e-5)
            _close(port["out"][f"{key}_k"], ref_k, 1e-5)
            _close(port["out"][f"{key}_v"], ref_v, 1e-5)
        keep = np.arange(c["sk"].shape[1]) != pos
        np.testing.assert_array_equal(port["out"][f"{key}_k"][:, keep], c["sk"][:, keep])

    @pytest.mark.parametrize("i", range(len(TOPK_SHAPES)))
    def test_topk_iter_ties(port, i):
        """Values and indices == lax.top_k, ties to the lowest index."""
        for k in (1, 3, 5):
            x = port["inp"][f"topk_{i}"]
            if k > x.shape[-1]:
                continue
            v, idx = jax.lax.top_k(jnp.asarray(x), k)
            np.testing.assert_array_equal(port["out"][f"topk_{i}_{k}_v"], np.asarray(v))
            np.testing.assert_array_equal(port["out"][f"topk_{i}_{k}_i"], np.asarray(idx))

    @pytest.mark.parametrize("name", sorted(TIE_CASES))
    def test_beam_tokens_on_tie_shapes(port, name):
        """beam_decode tokens == the JAX package's on the forced-tie cases."""
        from khmer_ocr_tpu.config import DecodeConfig, ModelConfig
        from khmer_ocr_tpu.decode import beam_decode

        cfg = ModelConfig(**TIES)
        p, _ = port["ties"]
        p = jax.tree.map(jnp.asarray, p)
        p["dec"]["out"]["w"] = jnp.zeros_like(p["dec"]["out"]["w"])
        p["dec"]["out"]["b"] = jnp.asarray(TIE_CASES[name], jnp.float32)
        pad = jnp.zeros((1, 8), bool)
        for k in TIE_KS:
            ref = np.asarray(beam_decode(p, jnp.asarray(port["inp"]["ties_memory"]), pad, cfg,
                                         DecodeConfig(beam_width=k, max_len=12)))
            np.testing.assert_array_equal(port["out"][f"ties_{name}_{k}"], ref)

    @pytest.mark.parametrize("mode", ["beam", "greedy"])
    def test_decode_tokens_batched_padded_128_steps(port, mode):
        """Four memories of valid lengths 32..128 decoded together for 128
        steps: cache windows 32/64/128, key padding, early exit."""
        from khmer_ocr_tpu.config import DecodeConfig, ModelConfig
        from khmer_ocr_tpu.decode import beam_decode, greedy_decode

        cfg = ModelConfig(**STRESS)
        p = jax.tree.map(jnp.asarray, port["stress"][0])
        mem, pad = jnp.asarray(port["inp"]["stress_memory"]), jnp.asarray(port["inp"]["stress_pad"])
        fn = beam_decode if mode == "beam" else greedy_decode
        dc = DecodeConfig(beam_width=3 if mode == "beam" else 1, max_len=128)
        with jax.default_matmul_precision("highest"):
            ref = np.asarray(jax.jit(lambda p, m, pd: fn(p, m, pd, cfg, dc))(p, mem, pad))
        np.testing.assert_array_equal(port["out"][f"stress_{mode}"], ref)
        assert (ref != 0).sum(axis=1).max() > 33  # crossed the first cache window


# ---------------------------------------------------------------------------
# the port side (torch-only subprocess)
# ---------------------------------------------------------------------------


def _port_main(tmp: Path) -> None:
    sys.path.insert(0, str(REPO))
    import torch

    from khmer_ocr_torch.config import DecodeConfig, ModelConfig
    from khmer_ocr_torch.convert.from_jax import load_npz, params_from_jax, seeded_params
    from khmer_ocr_torch.data.synthetic import synthetic_lines
    from khmer_ocr_torch.decode import beam_decode, greedy_decode, topk_iter
    from khmer_ocr_torch.models.backbones import se_vgg_apply
    from khmer_ocr_torch.models.layers import pack_step_params
    from khmer_ocr_torch.models.ocr_model import encode
    from khmer_ocr_torch.ops.adaptive_pool import adaptive_avg_pool2d
    from khmer_ocr_torch.ops.kernels.decode_step import decoder_layer_step, layer_weights
    from khmer_ocr_torch.ops.kernels.lstm import lstm_recurrence
    from khmer_ocr_torch.ops.lines import device_chunk, u8_to_unit, unit_normalize
    from khmer_ocr_torch.preprocess import Preprocessor, chunk_line, normalize

    torch.set_num_threads(2)
    t = torch.from_numpy
    with np.load(tmp / "inputs.npz") as z:
        inp = {k: z[k] for k in z.files}
    out, meta = {}, {"chunk": []}
    pre = Preprocessor()
    with torch.inference_mode():
        for i, line in enumerate(synthetic_lines(CHUNK_COUNTS, seed=5)):
            bucket, n, padded = pre.prepare_one(line)
            meta["chunk"].append([bucket, n])
            out[f"chunk_padded_{i}"] = padded
            out[f"chunk_windows_{i}"] = device_chunk(unit_normalize(u8_to_unit(t(padded)[None])), (100, 84))[0].numpy()
            out[f"chunk_host_{i}"] = normalize(chunk_line(line.astype(np.float32) / 255.0, pre.cfg, bucket))
        meta["batches"] = [[b.bucket_n, b.indices] for b in
                           pre.iter_batches(synthetic_lines(CHUNK_COUNTS, seed=5), max_batch=2)]
        out["pool"] = adaptive_avg_pool2d(t(inp["pool_x"]), (2, 32)).numpy()

        toy_cfg = ModelConfig(**TOY)
        p, s, _ = load_npz(tmp / "toy.npz")
        toy = params_from_jax(p, s, toy_cfg)
        out["backbone"] = se_vgg_apply(toy["backbone"], t(inp["chunks"])).numpy()
        # two lines of 2 and 3 chunks in one 4-chunk bucket: chunk_counts < N
        wb = 3 * 84 + 100
        u8 = np.stack([np.pad(l, ((0, 0), (0, wb - l.shape[1])), constant_values=255)
                       for l in synthetic_lines([2, 3], seed=7)])
        chunks = device_chunk(unit_normalize(u8_to_unit(t(u8))), (100, 84))
        counts = np.array([2, 3], np.int32)
        mem, pad = encode(toy, chunks, t(counts), toy_cfg)
        out.update(enc_chunks=chunks.numpy(), enc_counts=counts, enc_memory=mem.numpy(),
                   enc_pad=pad.numpy())

        out["lstm"] = lstm_recurrence(t(inp["xg"]), t(inp["w_hh"])).numpy()

        p, s = seeded_params(ModelConfig(), 0)
        flag = params_from_jax(p, s, ModelConfig())
        weights = layer_weights(pack_step_params(flag["dec"]["layers"][0]))
        for lin, w, tm in STEP_CASES:
            key = f"step_{int(lin)}_{w}_{tm}"
            c = {k: t(inp[f"{key}_{k}"].copy()) for k in ("x", "sk", "sv", "mk", "mv", "valid", "lin")}
            x = decoder_layer_step(weights, c["x"], int(inp[f"{key}_pos"]), c["sk"], c["sv"], c["mk"], c["mv"],
                                   c["valid"], c["lin"] if lin else None, num_heads=8, window=w,
                                   lanes=3 if lin else 1)
            out.update({f"{key}_x": x.numpy(), f"{key}_k": c["sk"].numpy(), f"{key}_v": c["sv"].numpy()})

        for i in range(len(TOPK_SHAPES)):
            for k in (1, 3, 5):
                x = t(inp[f"topk_{i}"])
                if k <= x.shape[-1]:
                    v, idx = topk_iter(x, k)
                    out[f"topk_{i}_{k}_v"], out[f"topk_{i}_{k}_i"] = v.numpy(), idx.numpy()

        ties_cfg = ModelConfig(**TIES)
        p, s, _ = load_npz(tmp / "ties.npz")
        ties = params_from_jax(p, s, ties_cfg)
        ties["dec"]["out"]["w"] = torch.zeros_like(ties["dec"]["out"]["w"])
        memory = t(inp["ties_memory"])
        for name, bias in TIE_CASES.items():
            ties["dec"]["out"]["b"] = torch.tensor(bias, dtype=torch.float32)
            for k in TIE_KS:
                out[f"ties_{name}_{k}"] = beam_decode(ties, memory, torch.zeros(1, 8, dtype=torch.bool), ties_cfg,
                                                      DecodeConfig(beam_width=k, max_len=12)).numpy()

        stress_cfg = ModelConfig(**STRESS)
        p, s, _ = load_npz(tmp / "stress.npz")
        stress = params_from_jax(p, s, stress_cfg)
        mem, pad = t(inp["stress_memory"]), t(inp["stress_pad"])
        out["stress_beam"] = beam_decode(stress, mem, pad, stress_cfg, DecodeConfig(beam_width=3, max_len=128)).numpy()
        out["stress_greedy"] = greedy_decode(stress, mem, pad, stress_cfg,
                                             DecodeConfig(beam_width=1, max_len=128)).numpy()
    np.savez(tmp / "outputs.npz", **out)
    (tmp / "outputs.json").write_text(json.dumps(meta))


if __name__ == "__main__":
    _port_main(Path(sys.argv[1]))
