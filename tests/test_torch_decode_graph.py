"""The decode's step loop with the position on the device, on the CPU, against the JAX package's.

On the card the port runs the decode's steps as captured CUDA graphs
(khmer_ocr_torch/decode/graphs.py): each step reads and advances a 0-d int32
``pos`` on the device, and kernel K2 reads ``pos`` there too, as the JAX
package's ``lax.while_loop`` carries a traced ``pos`` and its Pallas kernel
reads it from scalar prefetch. A CUDA graph cannot be captured here, so
these tests hold what the graphs replay, the same body and the same chunks
run from the Python loop on CPU tensors:

  * the whole decode (``beam_decode`` / ``greedy_decode``: the body looped
    in chunks of EXIT_CHECK_EVERY, the exit tested between chunks) token-
    equal to JAX's ``beam_decode`` / ``greedy_decode`` on its plain (XLA)
    path, at beam 1 (greedy), 3 and 5 and max_len 8, 37 (a tail chunk) and
    40 (across the 32 window), with the early exit firing (a bias on <eos>)
    and not firing (a bias against it);
  * the same decode with the exit tested after every step (JAX's count of
    steps) gives the same tokens, and the chunked decode runs at most 3
    steps more;
  * one layer, ``decoder_layer_step_plain`` with ``pos`` a tensor bit-equal
    to ``pos`` an int (the output, the written caches, the head's
    log-probs) at pos 0 and w - 1, lanes 1, 3 and 5, float32 and bf16;
  * one chunk of the beam and the greedy body with ``Tensor.item``,
    ``__bool__``, ``__int__``, ``__index__``, ``tolist``, ``numpy`` and
    ``cpu`` made to raise: the body reads nothing on the host (the CPU's
    stand-in for "capturable");
  * the chunk schedule (``step_chunks``) and the host's window check;
  * a shape's bytes, counted from its buffers (the cache that holds the
    shapes: tests/test_torch_cuda_graphs.py).

Models: TINY (2 + 2 layers, D 64, 4 heads, vocab 124), weights and memories
made with numpy from a seed (convert/from_jax.py::seeded_params, the JAX
package's layout). The port runs in one torch-only subprocess (this file
run as a script).
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
TINY = dict(emb_dim=64, num_heads=4, enc_layers=2, dec_layers=2, enc_ffn_dim=128, max_global_len=256,
            decode_max_len=64, backbone="vgg", use_bilstm=False, vocab_size=124)
EOS = 3
BIAS = {"exit": 3.0, "no_exit": -30.0}  # added to <eos>'s logit: the exit fires / can never fire
# (beam width, max_len, <eos> bias): every beam width at every max_len, the exit firing and not
CASES = [(1, 8, "no_exit"), (1, 37, "exit"), (1, 40, "no_exit"), (3, 8, "exit"), (3, 37, "no_exit"),
         (3, 40, "exit"), (5, 8, "no_exit"), (5, 37, "exit"), (5, 40, "no_exit")]
IDS = [f"{'greedy' if k == 1 else f'beam{k}'}-len{ml}-{bias}" for k, ml, bias in CASES]
LAYER_CASES = [(lanes, dt) for lanes in (1, 3, 5) for dt in ("float32", "bfloat16")]
B, TM, SEED = 3, 32, 12
# max_len -> (window, first position, steps) of every chunk
SCHEDULES = {8: [(8, 0, 4), (8, 4, 4)],
             37: [(32, p, 4) for p in range(0, 32, 4)] + [(37, 32, 4), (37, 36, 1)],
             40: [(32, p, 4) for p in range(0, 32, 4)] + [(40, 32, 4), (40, 36, 4)]}


def tiny_params(bias: str) -> dict:
    """Seeded TINY params in the JAX package's layout (numpy) with ``bias``
    added to <eos>'s logit."""
    from khmer_ocr_torch.config import ModelConfig
    from khmer_ocr_torch.convert.from_jax import seeded_params

    params, _ = seeded_params(ModelConfig(**TINY), SEED)
    params["dec"]["out"]["b"] = params["dec"]["out"]["b"].copy()
    params["dec"]["out"]["b"][EOS] += np.float32(BIAS[bias])
    return params


def memory_and_pad():
    rng = np.random.RandomState(SEED)
    memory = rng.randn(B, TM, TINY["emb_dim"]).astype(np.float32) * 0.5
    lens = rng.randint(TM // 2, TM + 1, size=B)
    return memory, np.arange(TM)[None, :] >= lens[:, None]


if __name__ != "__main__":
    import jax
    import jax.numpy as jnp

    @pytest.fixture(scope="module")
    def port(tmp_path_factory):
        tmp = tmp_path_factory.mktemp("torch_decode_graph")
        subprocess.run([sys.executable, __file__, str(tmp)], cwd=REPO, check=True, timeout=600)
        with np.load(tmp / "out.npz") as z:
            out = {k: z[k] for k in z.files}
        return {"out": out, "meta": json.loads((tmp / "out.json").read_text())}

    @pytest.mark.parametrize("k,max_len,bias", CASES, ids=IDS)
    def test_device_pos_decode_equals_jax(port, k, max_len, bias):
        """The port's chunked body with ``pos`` on the device: JAX's tokens."""
        from khmer_ocr_tpu.config import DecodeConfig, ModelConfig
        from khmer_ocr_tpu.decode import beam_decode, greedy_decode

        cfg = ModelConfig(**TINY)
        dc = DecodeConfig(beam_width=k, max_len=max_len, eos_idx=EOS, fused_mode="0", mega_mode="0")
        decode = greedy_decode if k == 1 else beam_decode
        memory, pad = memory_and_pad()
        ref = jax.jit(lambda p, m, pm: decode(p, m, pm, cfg, dc))(jax.tree.map(jnp.asarray, tiny_params(bias)),
                                                                  jnp.asarray(memory), jnp.asarray(pad))
        key = f"{k}_{max_len}_{bias}"
        np.testing.assert_array_equal(port["out"][f"tokens4_{key}"], np.asarray(ref))
        assert port["meta"][key]["replays"] == 0  # CPU tensors: the Python loop

    @pytest.mark.parametrize("k,max_len,bias", CASES, ids=IDS)
    def test_exit_tested_every_step_gives_the_same_tokens_and_at_most_three_steps_fewer(port, k, max_len, bias):
        """The exit tested between chunks of EXIT_CHECK_EVERY steps against
        after every step (the JAX loop's test): the same tokens; the chunked
        decode runs at most 3 steps more. Without <eos> the exit never fires
        (every step runs); with the bias it fires before max_len."""
        key = f"{k}_{max_len}_{bias}"
        m = port["meta"][key]
        np.testing.assert_array_equal(port["out"][f"tokens4_{key}"], port["out"][f"tokens1_{key}"])
        assert 0 <= m["steps4"] - m["steps1"] <= 3, m
        if bias == "no_exit":
            assert m["steps4"] == m["steps1"] == max_len, m
        else:
            assert m["steps4"] < max_len, m

    @pytest.mark.parametrize("lanes,dt", LAYER_CASES, ids=[f"lanes{n}-{d}" for n, d in LAYER_CASES])
    def test_layer_step_tensor_pos_bit_equal_to_int_pos(port, lanes, dt):
        """decoder_layer_step_plain with pos a 0-d int32 tensor and with pos
        an int: the output, both caches and the head's log-probs bit-equal,
        at pos 0 and w - 1."""
        for pos in ("first", "last"):
            assert port["meta"]["layer"][f"{lanes}_{dt}_{pos}"] == {"out": True, "caches": True, "logp": True}

    @pytest.mark.parametrize("kind", ["beam", "greedy"])
    def test_body_reads_nothing_on_the_host(port, kind):
        """One chunk of the body with the host reads patched to raise runs
        through, and advances the device position by the chunk's steps."""
        assert port["meta"]["no_sync"][kind] == "ok 4"

    @pytest.mark.parametrize("max_len", sorted(SCHEDULES))
    def test_step_chunks(max_len):
        """Chunks of 4 steps within each cache window, a tail where the
        window's positions do not divide, every chunk starting where the
        exit test is due."""
        from khmer_ocr_torch.decode.graphs import step_chunks

        assert step_chunks(max_len) == SCHEDULES[max_len]
        assert step_chunks(max_len, 1) == [(w, p, 1) for w, p0, n in SCHEDULES[max_len] for p in range(p0, p0 + n)]

    @pytest.mark.parametrize("kind", ["beam", "greedy"])
    def test_shape_bytes_are_its_buffers(port, kind):
        """A shape's ``nbytes``: the self caches, memory K/V, masks and search
        state, by their shapes and item sizes."""
        got, want = port["meta"]["nbytes"][kind]
        assert got == want

    def test_window_check_on_the_host(port):
        """The kernel reads pos on the device and cannot check it: the loop
        raises before a position past the caches' slots."""
        assert port["meta"]["past_the_caches"].startswith("ValueError: decode: position")


def _port_main(tmp: Path) -> None:
    sys.path.insert(0, str(REPO))
    import torch

    from khmer_ocr_torch.config import DecodeConfig, ModelConfig
    from khmer_ocr_torch.convert.from_jax import params_from_jax, seeded_params
    from khmer_ocr_torch.decode import graphs
    from khmer_ocr_torch.decode.beam import _beam_shape, beam_answer, beam_decode, beam_finished, beam_state, beam_step
    from khmer_ocr_torch.decode.greedy import _greedy_shape, greedy_decode, greedy_finished, greedy_state, greedy_step
    from khmer_ocr_torch.infer.predictor import cast_params
    from khmer_ocr_torch.models.layers import pack_step_params
    from khmer_ocr_torch.models.ocr_model import init_decode_state, pack_decode_params
    from khmer_ocr_torch.ops.kernels import decode_step as K

    torch.set_num_threads(2)
    cfg = ModelConfig(**TINY)
    memory, pad = (torch.from_numpy(a) for a in memory_and_pad())
    batch_stats = seeded_params(cfg, SEED)[1]
    states = {bias: params_from_jax(tiny_params(bias), batch_stats, cfg) for bias in BIAS}
    out, meta = {}, {}

    def every_step(state, dc):
        """The decode with the exit tested after every step: (tokens, steps)."""
        k = dc.beam_width
        dstate = init_decode_state(state, memory, pad, cfg, lanes=k, cache_len=dc.max_len)
        packed = pack_decode_params(state)
        n = dstate["self_kv"][0][0].shape[1]
        if k == 1:
            st = greedy_state(B, dc, "cpu")
            step, finished = (lambda w: lambda cur: greedy_step(packed, dstate, cur, w, cfg, dc)), greedy_finished
        else:
            st = beam_state(B, k, n, dc, "cpu")
            step = lambda w: lambda cur: beam_step(packed, dstate, cur, w, cfg, dc)  # noqa: E731
            finished = lambda s: beam_finished(s, dc.max_len)  # noqa: E731
        steps = graphs.run_chunks(dc.max_len, n, lambda: finished(st),
                                  lambda w, m: graphs.run_steps(st, m, step(w)), every=1)
        return (st["tokens"] if k == 1 else beam_answer(st)), steps

    with torch.inference_mode():
        for k, max_len, bias in CASES:
            key = f"{k}_{max_len}_{bias}"
            dc = DecodeConfig(beam_width=k, max_len=max_len, eos_idx=EOS)
            stats: dict = {}
            decode = greedy_decode if k == 1 else beam_decode
            out[f"tokens4_{key}"] = decode(states[bias], memory, pad, cfg, dc, stats=stats).numpy()
            out[f"tokens1_{key}"], steps1 = every_step(states[bias], dc)
            meta[key] = dict(steps4=stats["steps"], steps1=steps1, replays=stats["replays"])

        # one layer: pos a tensor against pos an int
        layer = {}
        rng = np.random.RandomState(SEED + 1)
        d, cache_len, w, n_img = TINY["emb_dim"], 24, 16, 2
        lp = pack_step_params(states["exit"]["dec"]["layers"][0])
        for lanes, dt in LAYER_CASES:
            cdt = getattr(torch, dt)
            wt = K.layer_weights(cast_params(lp, cdt))
            head = K.head_weights({kk: v.to(cdt) for kk, v in states["exit"]["dec"]["out"].items()})
            b = n_img * lanes
            r = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.3).to(cdt)  # noqa: E731
            x, sk, sv, mk, mv = r(b, d), r(b, cache_len, d), r(b, cache_len, d), r(n_img, TM, d), r(n_img, TM, d)
            valid = torch.from_numpy(rng.rand(n_img, TM) > 0.2).float()
            valid[:, 0] = 1.0
            lin = torch.from_numpy(rng.randint(0, lanes, (b, w)).astype(np.int32)) if lanes > 1 else None
            for name, pos in (("first", 0), ("last", w - 1)):
                k_i, v_i, k_t, v_t = sk.clone(), sv.clone(), sk.clone(), sv.clone()
                kw = dict(num_heads=TINY["num_heads"], window=w, lanes=lanes, head=head)
                o_i, lp_i = K.decoder_layer_step_plain(wt, x, pos, k_i, v_i, mk, mv, valid, lin, **kw)
                o_t, lp_t = K.decoder_layer_step_plain(wt, x, torch.tensor(pos, dtype=torch.int32), k_t, v_t, mk, mv,
                                                       valid, lin, **kw)
                layer[f"{lanes}_{dt}_{name}"] = {
                    "out": bool(torch.equal(o_i, o_t)),
                    "caches": bool(torch.equal(k_i, k_t) and torch.equal(v_i, v_t) and not torch.equal(k_i, sk)),
                    "logp": bool(torch.equal(lp_i, lp_t))}
        meta["layer"] = layer

        # one chunk of the body with every host read made to raise
        no_sync = {}
        for kind in ("beam", "greedy"):
            dc = DecodeConfig(beam_width=3 if kind == "beam" else 1, max_len=8, eos_idx=EOS)
            k = dc.beam_width
            packed = pack_decode_params(states["no_exit"])
            dstate = init_decode_state(states["no_exit"], memory, pad, cfg, lanes=k, cache_len=8)
            st = beam_state(B, k, 8, dc, "cpu") if kind == "beam" else greedy_state(B, dc, "cpu")
            step = ((lambda cur: beam_step(packed, dstate, cur, 8, cfg, dc)) if kind == "beam"
                    else (lambda cur: greedy_step(packed, dstate, cur, 8, cfg, dc)))
            saved = {}

            def refuse(*a, **kw):
                raise RuntimeError("a host read inside the body")

            try:
                for attr in ("item", "__bool__", "__int__", "__index__", "tolist", "numpy", "cpu"):
                    saved[attr] = getattr(torch.Tensor, attr)
                    setattr(torch.Tensor, attr, refuse)
                graphs.run_steps(st, 4, step)
                res = "ok"
            except Exception as e:  # recorded and asserted on by the test
                res = f"{type(e).__name__}: {e}"
            finally:
                for attr, fn in saved.items():
                    setattr(torch.Tensor, attr, fn)
            no_sync[kind] = f"{res} {int(st['pos'])}" if res == "ok" else res
        meta["no_sync"] = no_sync

        try:
            greedy_decode(states["no_exit"], memory, pad, ModelConfig(**{**TINY, "decode_max_len": 20}),
                          DecodeConfig(beam_width=1, max_len=30, eos_idx=EOS))
            meta["past_the_caches"] = "returned"
        except Exception as e:  # recorded and asserted on by the test
            meta["past_the_caches"] = f"{type(e).__name__}: {e}"
        dc = DecodeConfig(beam_width=3, max_len=8, eos_idx=EOS)
        packed = pack_decode_params(states["exit"])

        # a shape's bytes against its buffers' shapes (beam 3, max_len 8, float32)
        ml, k, d, layers = 8, 3, TINY["emb_dim"], TINY["dec_layers"]
        caches, mem = 2 * layers * B * k * ml * d * 4, 2 * layers * B * TM * d * 4
        masks = B * TM * (1 + 4)
        search = (B * k * (ml + 2) * 8 + B * k * 4 + B * 4 + B * (ml + 2) * 8 + B * k * ml * 4 + B * 8 + (ml + 2) * 4
                  + 4)
        beam = _beam_shape(packed, memory, pad, cfg, dc, False)
        greedy = _greedy_shape(packed, memory, pad, cfg, DecodeConfig(beam_width=1, max_len=ml, eos_idx=EOS))
        meta["nbytes"] = {"beam": [beam.nbytes, caches + mem + masks + search],
                          "greedy": [greedy.nbytes, caches // k + mem + masks + B * (ml + 1) * 8 + B + 4]}
    np.savez(tmp / "out.npz", **out)
    (tmp / "out.json").write_text(json.dumps(meta))


if __name__ == "__main__":
    _port_main(Path(sys.argv[1]))
