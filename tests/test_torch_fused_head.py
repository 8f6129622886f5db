"""The decode head fused into kernel K2's last launch, on the CPU, against the JAX package's.

The JAX kernel (ops/pallas/decode_step.py::fused_decoder_layer_step with
``head=(out_w, out_b, v_real)``) also returns the log-probs of the decode
head: the vocabulary projection of the layer output, the f32 sums rounded
to the compute dtype, the bias rounded to it added and rounded again, then a
log-softmax over the first v_real of the 128-padded columns. The port's
plain version (ops/kernels/decode_step.py::decoder_layer_step_plain with
``head=``, the CPU path and the card's oracle) is held to it, run here in
interpret mode as tests/test_fused_decode.py runs it:

  * float32, greedy and beam lineage: the layer output within 1e-5 and the
    log-probs within 2e-5 (float32 sums in another order); the padded
    columns NEG_INF;
  * bfloat16: the layer output within 4 bf16 steps of its largest value,
    the log-probs within 0.05 + 1% (tests/test_fused_decode.py's own bf16
    bound for its head is 0.02 + 1% against the same layer output; here
    the two layers' outputs differ by bf16 steps too, the JAX kernel
    rounding every elementwise product of its attention);
  * beam 3 through ``infer_batch`` with ``DecodeConfig(head_mode="1")``:
    the tokens of the host loop without the head, float32 and bfloat16,
    with the head counted as fused; at a D narrower than the padded
    vocabulary the head is not fused and the tokens are the same; the
    gate's geometry (``decode_step.head_fits``); greedy ignores the
    switch; the Predictor snapshots ``KHMER_OCR_FUSED_HEAD`` at each call.

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
D, H, F, V = 64, 4, 256, 40
CASES = [(lanes, dt) for lanes in (1, 3) for dt in ("float32", "bfloat16")]
TOY = dict(vocab_size=124, emb_dim=128, num_heads=4, enc_layers=1, dec_layers=2, enc_ffn_dim=64, max_global_len=512,
           decode_max_len=24, dropout=0.0)
NARROW = dict(TOY, emb_dim=32)  # the 128 padded head columns are wider than D: the head cannot be fused
# (n_img, lanes, heads, Tm, D, vocab, dtype) -> whether K2's launch can fuse the head
FITS = [((4, 3, 8, 128, 384, 124, "float32"), True), ((4, 3, 8, 128, 384, 124, "bfloat16"), True),
        ((4, 3, 4, 128, 128, 124, "bfloat16"), True), ((4, 3, 4, 128, 32, 124, "float32"), False),
        ((4, 3, 8, 128, 384, 400, "float32"), False), ((1, 3, 8, 4096, 384, 124, "bfloat16"), True),
        ((1, 3, 8, 4096, 384, 300, "float32"), True), ((4, 3, 8, 128, 384, 129, "float32"), True)]


def layer_and_inputs(lanes: int) -> dict:
    """A seeded decoder layer in the JAX layout, a head, and one step's inputs (float32)."""
    r = np.random.RandomState(40 + lanes)
    lin = lambda i, o, s: {"w": r.randn(i, o).astype(np.float32) * s, "b": r.randn(o).astype(np.float32) * 0.1}
    ln = lambda: {"scale": 1 + r.randn(D).astype(np.float32) * 0.1, "bias": r.randn(D).astype(np.float32) * 0.1}
    att = lambda: {n: lin(D, D, D ** -0.5) for n in ("q", "k", "v", "o")}
    layer = {"self": att(), "cross": att(), "ln1": ln(), "ln2": ln(), "ln3": ln(), "lin1": lin(D, F, D ** -0.5),
             "lin2": lin(F, D, F ** -0.5)}
    n_img, cache_len, tm, w, pos = 4, 32, 24, 16, 7
    b = n_img * lanes
    valid = r.rand(n_img, tm) > 0.2
    valid[:, 0] = True
    return dict(layer=layer, out_w=r.randn(D, V).astype(np.float32) * 0.3, out_b=r.randn(V).astype(np.float32) * 0.1,
                x=r.randn(b, D).astype(np.float32) * 0.3, sk=r.randn(b, cache_len, D).astype(np.float32) * 0.3,
                sv=r.randn(b, cache_len, D).astype(np.float32) * 0.3,
                mk=r.randn(n_img, tm, D).astype(np.float32) * 0.3, mv=r.randn(n_img, tm, D).astype(np.float32) * 0.3,
                valid=valid, lin=r.randint(0, lanes, (b, w)).astype(np.int32) if lanes > 1 else None, w=w, pos=pos)


if __name__ != "__main__":
    import jax
    import jax.numpy as jnp

    @pytest.fixture(scope="module")
    def port(tmp_path_factory):
        tmp = tmp_path_factory.mktemp("torch_fused_head")
        subprocess.run([sys.executable, __file__, "port", str(tmp)], cwd=REPO, check=True, timeout=600)
        return dict(np.load(tmp / "port.npz")), json.loads((tmp / "port.json").read_text())

    def _jax_head_step(lanes: int, dt: str):
        from khmer_ocr_tpu.models.layers import pack_step_params
        from khmer_ocr_tpu.ops.pallas.decode_step import fused_decoder_layer_step, layer_weights

        s = layer_and_inputs(lanes)
        cdt = jnp.float32 if dt == "float32" else jnp.bfloat16
        c = lambda a: jnp.asarray(a).astype(cdt)  # noqa: E731
        lp = jax.tree.map(c, pack_step_params(jax.tree.map(jnp.asarray, s["layer"])))
        vp = 128
        hw = jnp.zeros((D, vp), cdt).at[:, :V].set(c(s["out_w"]))
        hb = jnp.zeros((1, vp), jnp.float32).at[0, :V].set(c(s["out_b"]).astype(jnp.float32))
        lin = None if s["lin"] is None else jnp.asarray(s["lin"])
        x, k, _, logp = fused_decoder_layer_step(
            layer_weights(lp), c(s["x"]), s["pos"], c(s["sk"]), c(s["sv"]), c(s["mk"]), c(s["mv"]),
            jnp.asarray(s["valid"], jnp.float32), lin, num_heads=H, window=s["w"], lanes=lanes, interpret=True,
            head=(hw, hb, V))
        return np.asarray(x.astype(jnp.float32)), np.asarray(logp)

    @pytest.mark.parametrize("lanes,dt", CASES, ids=[f"{'beam' if k > 1 else 'greedy'}-{d}" for k, d in CASES])
    def test_plain_head_against_jax_interpret(port, lanes, dt):
        x_ref, logp_ref = _jax_head_step(lanes, dt)
        x, logp = port[0][f"x_{lanes}_{dt}"], port[0][f"logp_{lanes}_{dt}"]
        assert logp.shape == logp_ref.shape == (x.shape[0], 128)
        assert (logp[:, V:] == -1e30).all() and logp_ref[:, V:].max() < -1e20
        if dt == "float32":
            np.testing.assert_allclose(x, x_ref, atol=1e-5, rtol=0)
            np.testing.assert_allclose(logp[:, :V], logp_ref[:, :V], atol=2e-5, rtol=1e-5)
        else:
            assert np.abs(x - x_ref).max() <= 4 * 2.0 ** -7 * max(1.0, np.abs(x_ref).max())
            np.testing.assert_allclose(logp[:, :V], logp_ref[:, :V], atol=0.05, rtol=0.01)

    @pytest.mark.parametrize("dt", ["float32", "bfloat16"])
    def test_beam_tokens_with_the_head_equal_without(port, dt):
        meta = port[1][dt]
        assert meta["head_stat"] == 1 and meta["plain_stat"] == 0
        assert meta["tokens_head"] == meta["tokens_plain"]

    def test_head_wider_than_d_decodes_with_the_normal_head(port):
        """At D=32 the 128 padded columns do not fit K2's launch: with the
        switch on, beam 3 runs the normal head (none fused) and gives the
        same tokens, where the kernel's wrapper would raise."""
        meta = port[1]["narrow"]
        assert meta["head_stat"] == 0 and meta["tokens_head"] == meta["tokens_plain"]

    @pytest.mark.parametrize("shape,fits", FITS, ids=[f"D{s[4]}-V{s[5]}-Tm{s[3]}-{s[6]}" for s, _ in FITS])
    def test_head_fits_the_launch(port, shape, fits):
        """The head's gate: the padded vocabulary at most D and a multiple
        of 16 bytes x the cluster's CTAs (two a head at Tm 4096)."""
        assert port[1]["fits"][FITS.index((shape, fits))] == fits

    def test_greedy_ignores_the_switch(port):
        assert port[1]["float32"]["greedy_equal"] and port[1]["float32"]["greedy_head_stat"] == 0

    def test_predictor_snapshots_the_switch_per_call(port):
        """Head batches counted after a call with the switch off, two one-line
        calls with it on, and one more with it off."""
        assert port[1]["predictor"] == {"head_batches": [0, 2, 2], "strings_equal": True}


def _port_main(tmp: Path) -> None:
    sys.path.insert(0, str(REPO))
    import os

    import torch

    from khmer_ocr_torch.config import DecodeConfig, ModelConfig
    from khmer_ocr_torch.convert.from_jax import params_from_jax, seeded_params
    from khmer_ocr_torch.data.synthetic import synthetic_lines
    from khmer_ocr_torch.infer.predictor import Predictor, cast_params, infer_batch
    from khmer_ocr_torch.models.layers import pack_step_params
    from khmer_ocr_torch.ops.kernels import decode_step as K

    torch.set_num_threads(2)
    out, meta = {}, {}
    for lanes, dt in CASES:
        s = layer_and_inputs(lanes)
        cdt = getattr(torch, dt)
        c = lambda a: torch.from_numpy(a).to(cdt)  # noqa: E731
        layer = {k: ({n: {m: c(a) for m, a in sub.items()} for n, sub in v.items()}
                     if k in ("self", "cross") else {m: c(a) for m, a in v.items()}) for k, v in s["layer"].items()}
        wt = K.layer_weights(pack_step_params(layer))
        head = K.head_weights({"w": c(s["out_w"]), "b": c(s["out_b"])})
        lin = None if s["lin"] is None else torch.from_numpy(s["lin"])
        x, logp = K.decoder_layer_step_plain(wt, c(s["x"]), s["pos"], c(s["sk"]), c(s["sv"]), c(s["mk"]), c(s["mv"]),
                                             torch.from_numpy(s["valid"]).float(), lin, num_heads=H, window=s["w"],
                                             lanes=lanes, head=head)
        out[f"x_{lanes}_{dt}"], out[f"logp_{lanes}_{dt}"] = x.float().numpy(), logp.numpy()

    cfg = ModelConfig(**TOY)
    params, stats = seeded_params(cfg, 5)
    params["dec"]["out"]["w"] = params["dec"]["out"]["w"] * 8.0  # a sharper head: fewer near-ties to flip
    wb = 3 * 84 + 100
    counts = [1, 2, 3, 4, 2, 1]
    lines = np.full((len(counts), 48, wb), 255, np.uint8)
    for i, line in enumerate(synthetic_lines(counts, seed=5)):
        lines[i, :, :min(wb, line.shape[1])] = line[:, :wb]
    lt, ct = torch.from_numpy(lines), torch.tensor(counts, dtype=torch.int32)
    state32 = params_from_jax(params, stats, cfg)
    for dt, state in (("float32", state32), ("bfloat16", cast_params(state32, torch.bfloat16))):
        m = {}
        for name, mode in (("head", "1"), ("plain", "0")):
            st: dict = {}
            dc = DecodeConfig(beam_width=3, max_len=16, head_mode=mode)
            m[f"tokens_{name}"] = infer_batch(state, lt, ct, cfg, dc, (100, 84), stats=st).tolist()
            m[f"{name}_stat"] = st["head"]
        if dt == "float32":
            st = {}
            g1 = infer_batch(state, lt, ct, cfg, DecodeConfig(beam_width=1, max_len=16, head_mode="1"), (100, 84),
                             stats=st)
            g0 = infer_batch(state, lt, ct, cfg, DecodeConfig(beam_width=1, max_len=16, head_mode="0"), (100, 84))
            m["greedy_equal"] = bool(torch.equal(g0, g1))
            m["greedy_head_stat"] = st.get("head", 0)
        meta[dt] = m

    narrow = ModelConfig(**NARROW)
    p_n, s_n = seeded_params(narrow, 5)
    state_n = params_from_jax(p_n, s_n, narrow)
    m = {}
    for name, mode in (("head", "1"), ("plain", "0")):
        st = {}
        dc = DecodeConfig(beam_width=3, max_len=16, head_mode=mode)
        m[f"tokens_{name}"] = infer_batch(state_n, lt, ct, narrow, dc, (100, 84), stats=st).tolist()
        m[f"{name}_stat"] = st["head"]
    meta["narrow"] = m
    meta["fits"] = [K.head_fits(*shape[:6], getattr(torch, shape[6])) for shape, _ in FITS]

    pred = Predictor(params=params, batch_stats=stats, model_cfg=cfg, device="cpu")
    src = synthetic_lines([1, 2], seed=6)
    os.environ["KHMER_OCR_FUSED_HEAD"] = "0"
    a = pred.predict_batch(src, beam_width=3, max_len=16)
    off = pred.head_batches
    os.environ["KHMER_OCR_FUSED_HEAD"] = "1"
    b = pred.predict_batch(src[:1], beam_width=3, max_len=16) + pred.predict_batch(src[1:], beam_width=3, max_len=16)
    on = pred.head_batches
    os.environ["KHMER_OCR_FUSED_HEAD"] = "0"
    pred.predict_batch(src[:1], beam_width=3, max_len=16)
    meta["predictor"] = {"head_batches": [off, on, pred.head_batches], "strings_equal": a == b}
    np.savez(tmp / "port.npz", **out)
    (tmp / "port.json").write_text(json.dumps(meta))


if __name__ == "__main__":
    if sys.argv[1] == "port":
        _port_main(Path(sys.argv[2]))
