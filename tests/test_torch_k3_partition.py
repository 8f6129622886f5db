"""The cluster decomposition of kernel K3 (the whole beam decode), on the CPU.

K3 (``csrc/decode_loop.cu``) runs one thread-block cluster of one CTA per
attention head for each image, resident for all max_len steps:
  * every layer of every step is K2's cluster layer: CTA h computes head h's
    q, k, v, writes and reads only its own slice (lanes, max_len, hd) of
    each layer's self caches, and computes one H-th of every projection's
    columns; the column slices are gathered and every CTA runs the
    LayerNorms on the full rows; the FFN's partial sums are added in the
    fixed order of the CTAs;
  * the embedding rows are built in every CTA;
  * the head is split by columns (Vp/H each, Vp padded to a multiple of
    4 H) and gathered;
  * the search (log-softmax, per-lane top-K, <eos> retirement, next beams,
    tokens and lineage) runs in every CTA on the same logits, and rank 0's
    answer is the output.

The decomposition is written out here in PyTorch as the kernel computes it,
with every CTA's state kept apart, and held against the port's plain
``fused_beam_decode_plain`` (tokens exactly, scores within 1e-5 x max(1,
|ref|): float32 sums taken in another order) and, for one case, against the
JAX package's ``fused_beam_decode`` in interpret mode (tokens exactly). Every
CTA's search state must be bit-identical to rank 0's at every step. The
torch side runs in one torch-only subprocess (this file run as a script),
because torch compute followed by jitted JAX in one process can hang
(tests/conftest.py). The launch geometry of ``ops/kernels/geometry.py``
(CTAs per cluster, the self caches' route, the byte count) is plain Python,
tested in the pytest process.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
from khmer_ocr_torch.ops.kernels import geometry  # noqa: E402

TOL = 1e-5
NEG_INF = -1e30  # the kernels' masking constant (csrc/decoder_common.cuh)
# tests/test_torch_decode_loop.py's TINY config: D = 64, 4 heads, 2 decoder layers
TINY = dict(emb_dim=64, num_heads=4, enc_layers=1, dec_layers=2, enc_ffn_dim=128, max_global_len=256,
            decode_max_len=64, backbone="vgg", use_bilstm=False, vocab_size=124)
# name: (images, Tm, seed, beam, max_len, weight edit)
CASES = {
    "beam2": (3, 32, 0, 2, 12, None),
    "beam3": (3, 32, 0, 3, 12, None),
    "beam4": (2, 48, 1, 4, 16, None),
    "eos": (3, 16, 5, 3, 16, "eos"),
    "ties": (2, 16, 7, 3, 10, "ties"),
}
JAX_CASE = "beam3"
FLAGSHIP = dict(d=384, heads=8, f=1536, vocab=124, n_layers=2)


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), f"max |diff| {err:.3e} > {tol} x max(1, |ref|)"


def _inputs(case: str):
    """(params, batch_stats) in the JAX layout, numpy-seeded and edited, and
    the memory (B, Tm, D) with its ragged padding mask."""
    from khmer_ocr_torch.config import ModelConfig
    from khmer_ocr_torch.convert.from_jax import seeded_params

    b, tm, seed, _, _, edit = CASES[case]
    p, s = seeded_params(ModelConfig(**TINY), seed)
    out = p["dec"]["out"]
    if edit == "eos":
        out["b"][3] += 4.0  # eos_idx = 3: completions retire early
    elif edit == "ties":  # duplicated vocabulary columns, raised into the top-K: exact ties every step
        out["b"][[10, 20]] += 3.0
        out["w"][:, 11], out["w"][:, 21] = out["w"][:, 10], out["w"][:, 20]
        out["b"][11], out["b"][21] = out["b"][10], out["b"][20]
    r = np.random.RandomState(100 + seed)
    memory = (r.randn(b, tm, TINY["emb_dim"]) * 0.5).astype(np.float32)
    lens = r.randint(max(tm // 2, 1), tm + 1, size=b)
    return p, s, memory, np.arange(tm)[None, :] >= lens[:, None]


# ---------------------------------------------------------------------------
# the launch geometry (pytest process, plain Python)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,on_chip", [(2, True), (3, True), (4, False)])
def test_k3_flagship_route(k, on_chip):
    """At the flagship (D = 384, 8 heads, 2 layers, vocab 124, max_len 64,
    Tm = 128): one CTA per head, 8 a cluster; the self caches on chip at
    beam 2 and 3, in global memory at beam 4."""
    ctas, chip, tc = geometry.k3_geometry(k, FLAGSHIP["d"], FLAGSHIP["heads"], FLAGSHIP["f"], 64,
                                          FLAGSHIP["vocab"], FLAGSHIP["n_layers"], 128)
    assert (ctas, chip, tc) == (8, on_chip, 128)


@pytest.mark.parametrize("k", [2, 3, 4])
def test_k3_bytes_never_above_the_limit(k):
    """The route chosen at every size inside the gate fits one CTA's shared
    memory; the global route fits everywhere."""
    for tm in (1, 32, 64, 96, 128):
        for max_len in (1, 16, 63, 64):
            args = (k, FLAGSHIP["d"], FLAGSHIP["heads"], FLAGSHIP["f"], max_len)
            _, on_chip, tc = geometry.k3_geometry(*args, FLAGSHIP["vocab"], FLAGSHIP["n_layers"], tm)
            vp = geometry.k3_vocab_cols(FLAGSHIP["vocab"], FLAGSHIP["heads"])
            chosen = geometry.k3_smem_bytes(*args, vp, FLAGSHIP["n_layers"], on_chip, tc)
            assert chosen <= geometry.SMEM_LIMIT, (tm, max_len, chosen)
            assert geometry.k3_smem_bytes(*args, vp, FLAGSHIP["n_layers"], False, tc) <= geometry.SMEM_LIMIT


def test_k3_byte_count_of_the_layout():
    """K2's layer at TC = 512 is 57,840 B at 3 lanes; with K3's chunk of
    128 positions 48,624 B; one head's slice of one layer's caches at beam 3
    and max_len 64 is 73,728 B; the search state adds the rest."""
    d, heads, f = FLAGSHIP["d"], FLAGSHIP["heads"], FLAGSHIP["f"]
    assert 4 * geometry.layer_smem_floats(3, d, heads, f, 1, geometry.K2_TC) == 57840
    assert 4 * geometry.layer_smem_floats(3, d, heads, f, 1, 128) == 48624
    on = geometry.k3_smem_bytes(3, d, heads, f, 64, 128, 1, True, 128)
    off = geometry.k3_smem_bytes(3, d, heads, f, 64, 128, 1, False, 128)
    assert on - off == 73728
    assert off - 48624 == 4 * (2 * 3 * 66 + 2 * 3 * 64 + 66 + 3 * 128 + 2 * 9 + 9 + 1)


@pytest.mark.parametrize("vocab,heads,want", [(124, 8, 128), (124, 4, 128), (60, 4, 64), (128, 8, 128), (1, 2, 8)])
def test_k3_head_columns(vocab, heads, want):
    """Vp is the vocabulary rounded up to a multiple of 4 x heads."""
    assert geometry.k3_vocab_cols(vocab, heads) == want


@pytest.mark.parametrize("tm,max_len,want", [(128, 64, 128), (32, 16, 32), (40, 12, 64), (16, 64, 64), (1, 1, 32)])
def test_k3_attention_chunk_covers_every_position(tm, max_len, want):
    assert geometry.k3_tc(tm, max_len) == want


# ---------------------------------------------------------------------------
# the JAX side and the port's outputs (pytest process)
# ---------------------------------------------------------------------------

if __name__ != "__main__":
    import jax
    import jax.numpy as jnp

    @pytest.fixture(scope="module")
    def port(tmp_path_factory):
        """Run the torch side once; its outputs by case."""
        tmp = tmp_path_factory.mktemp("torch_k3_partition")
        subprocess.run([sys.executable, __file__, str(tmp)], cwd=REPO, check=True, timeout=600)
        with np.load(tmp / "outputs.npz") as z:
            return {k: z[k] for k in z.files}

    @pytest.mark.parametrize("case", sorted(CASES))
    def test_k3_partition_tokens_equal_plain(port, case):
        """The clusters' tokens == fused_beam_decode_plain's, exactly."""
        np.testing.assert_array_equal(port[f"{case}_part_tokens"], port[f"{case}_plain_tokens"])

    @pytest.mark.parametrize("case", sorted(CASES))
    def test_k3_partition_scores_match_plain(port, case):
        """The K running scores and the best completion's score."""
        _close(port[f"{case}_part_scores"], port[f"{case}_plain_scores"])

    @pytest.mark.parametrize("case", sorted(CASES))
    def test_k3_every_cta_holds_the_same_search_state(port, case):
        """Tokens, lineage, scores and the best completion of every CTA ==
        rank 0's, bit for bit, after every step."""
        assert port[f"{case}_states_agree"].all()

    @pytest.mark.parametrize("route", ["on_chip", "global"])
    def test_k3_kernel_wrapper_never_falls_back_to_plain(port, route):
        """fused_beam_decode_kernel on CPU tensors raises on either cache
        route: only fused_beam_decode takes the plain version, and only
        for a CPU tensor."""
        assert port[f"kernel_raises_{route}"]

    def test_k3_partition_tokens_equal_jax_kernel(port):
        """The JAX package's Pallas kernel in interpret mode gives the same
        tokens."""
        from khmer_ocr_tpu.config import DecodeConfig, ModelConfig
        from khmer_ocr_tpu.ops.pallas.decode_loop import fused_beam_decode

        _, _, _, k, max_len, _ = CASES[JAX_CASE]
        p, _, memory, pad = _inputs(JAX_CASE)
        ref = fused_beam_decode(jax.tree.map(jnp.asarray, p), jnp.asarray(memory), jnp.asarray(pad),
                                ModelConfig(**TINY), DecodeConfig(beam_width=k, max_len=max_len), interpret=True)
        np.testing.assert_array_equal(port[f"{JAX_CASE}_part_tokens"], np.asarray(ref))


# ---------------------------------------------------------------------------
# the decomposition, as the kernel computes it (torch-only subprocess)
# ---------------------------------------------------------------------------


def _layer_norm(x, s, b, eps=1e-5):
    import torch

    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * s + b


def _softmax_rows(logits, v):
    """softmax over the last axis of (rows, T) logits, then @ v (T, hd); the
    masked positions carry NEG_INF and weigh exactly 0."""
    import torch

    m = logits.max(-1, keepdim=True).values
    e = torch.where(logits > NEG_INF / 2, torch.exp(logits - m), torch.zeros(()))
    return (e @ v) / e.sum(-1, keepdim=True)


def cluster_layer(wt, xs, caches, lins, pos, mk, mv, valid):
    """One decoder layer of one image's K lanes on its cluster of H CTAs:
    ``xs`` every CTA's copy of the (K, D) rows, ``caches`` every CTA's own
    (k, v) slice (K, max_len, hd) of this layer, ``lins`` every CTA's copy
    of the lineage (K, max_len). Returns every CTA's new rows."""
    import torch

    heads = len(xs)
    k, d = xs[0].shape
    hd = d // heads
    cols = [slice(h * hd, (h + 1) * hd) for h in range(heads)]
    scale = 1.0 / hd ** 0.5

    # 1-2. CTA h: head h's q, k, v from its own rows; slot pos of its own cache slice; self-attention
    #      of each lane through the lineage, slot pos read from the new k, v
    heads_out = []
    for h, c in enumerate(cols):
        q, kk, vv = (xs[h] @ wt["qkv_w"][:, j * d:(j + 1) * d][:, c] + wt["qkv_b"][j * d:(j + 1) * d][c]
                     for j in range(3))
        ck, cv = caches[h]
        ck[:, pos], cv[:, pos] = kk, vv
        rows = []
        for r in range(k):
            src = lins[h][r, :pos].long()
            keys = torch.cat([ck[src, torch.arange(pos)], kk[r:r + 1]])
            vals = torch.cat([cv[src, torch.arange(pos)], vv[r:r + 1]])
            rows.append(_softmax_rows((keys @ q[r] * scale)[None], vals)[0])
        heads_out.append(torch.stack(rows))
    a = torch.cat(heads_out, dim=1)  # gathered in every CTA

    def sliced(inp, w, bias):  # CTA h's columns of a D-wide projection, gathered
        return torch.cat([inp[h] @ w[:, c] + bias[c] for h, c in enumerate(cols)], dim=1)

    # 3. out-projection by column slices, gathered; residual and LN1 in every CTA
    t = sliced([a] * heads, wt["so_w"], wt["so_b"])
    xs = [_layer_norm(x + t, wt["ln1_s"], wt["ln1_b"]) for x in xs]
    # 4. cross-attention of head h over its columns of the image's memory
    ok = valid > 0
    heads_out = []
    for h, c in enumerate(cols):
        qc = xs[h] @ wt["cq_w"][:, c] + wt["cq_b"][c]
        logits = torch.where(ok[None], qc @ mk[:, c].T * scale, torch.tensor(NEG_INF))
        heads_out.append(_softmax_rows(logits, mv[:, c]))
    a = torch.cat(heads_out, dim=1)
    # 5. out-projection, LN2
    t = sliced([a] * heads, wt["co_w"], wt["co_b"])
    xs = [_layer_norm(x + t, wt["ln2_s"], wt["ln2_b"]) for x in xs]
    # 6. FFN: CTA h's hidden slice and its partial of the full output; CTA q adds every CTA's
    #    partial of its columns in CTA order, then the bias; gathered; LN3 in every CTA
    fs = wt["l1_w"].shape[1] // heads
    partial = []
    for h in range(heads):
        hs = slice(h * fs, (h + 1) * fs)
        partial.append(torch.relu(xs[h] @ wt["l1_w"][:, hs] + wt["l1_b"][hs]) @ wt["l2_w"][hs])
    y = []
    for c in cols:
        acc = torch.zeros(k, hd)
        for p in partial:
            acc = acc + p[:, c]
        y.append(acc + wt["l2_b"][c])
    t = torch.cat(y, dim=1)
    return [_layer_norm(x + t, wt["ln3_s"], wt["ln3_b"]) for x in xs]


def search_step(st, logits, step, eos):
    """The kernel's steps 4-8 on one CTA's state ``st`` (tok, lin, score,
    best_score, best_tok) with the gathered (K, V) logits, in float32."""
    import torch

    k = st["score"].shape[0]
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    m = logits.max(-1, keepdim=True).values
    lr = (logits - m) - torch.log(torch.exp(logits - m).sum(-1, keepdim=True))
    top_lp, top_id = torch.empty(k, k), torch.empty(k, k, dtype=torch.long)
    for r in range(k):  # iterative max, the lowest index on ties, taken entries masked
        row = lr[r].clone()
        for j in range(k):
            bi = int(torch.argmax(row))
            top_lp[r, j], top_id[r, j] = row[bi], bi
            row[bi] = NEG_INF
    den = f32(step + 2)
    step_best, best_beam = f32(NEG_INF), 0
    for lane in range(k):
        e = f32(NEG_INF)
        for j in range(k):
            if top_id[lane, j] == eos:
                e = torch.maximum(e, (st["score"][lane] + top_lp[lane, j]) / den)
        if e > step_best:  # the first maximum
            step_best, best_beam = e, lane
    if step_best > st["best_score"]:
        st["best_score"] = step_best
        st["best_tok"] = st["tok"][best_beam].clone()
        st["best_tok"][step + 1] = eos
    flat = torch.where(top_id.reshape(-1) == eos, f32(NEG_INF), (st["score"][:, None] + top_lp).reshape(-1))
    nxt, parent, new_tok = torch.empty(k), torch.empty(k, dtype=torch.long), torch.empty(k, dtype=torch.long)
    for r in range(k):
        bi = int(torch.argmax(flat))
        nxt[r], parent[r], new_tok[r] = flat[bi], bi // k, top_id.reshape(-1)[bi]
        flat[bi] = NEG_INF
    st["score"] = nxt
    st["tok"] = st["tok"][parent].clone()
    st["tok"][:, step + 1] = new_tok
    st["lin"] = st["lin"][parent].clone()
    st["lin"][:, step] = parent.to(torch.int32)


def k3_partition(dec, mem_kv, valid, *, k, max_len, heads, sos, eos, pad):
    """K3's decode as its clusters compute it: (tokens (B, max_len + 2),
    scores (B, K + 1), whether every CTA's search state equalled rank 0's
    after every step)."""
    import torch

    n_img = valid.shape[0]
    v, d = dec["tok_emb"].shape
    hd = d // heads
    vp = geometry.k3_vocab_cols(v, heads)
    vw = vp // heads
    out_w = torch.zeros(d, vp)
    out_w[:, :v] = dec["out"]["w"]
    out_b = torch.zeros(vp)
    out_b[:v] = dec["out"]["b"]
    lp_ = max_len + 2
    tokens = torch.empty(n_img, lp_, dtype=torch.long)
    scores = torch.empty(n_img, k + 1)
    agree = True
    for img in range(n_img):
        tok0 = torch.full((k, lp_), pad, dtype=torch.long)
        tok0[:, 0] = sos
        states = [dict(tok=tok0.clone(), lin=torch.arange(k, dtype=torch.int32)[:, None].repeat(1, max_len),
                       score=torch.tensor([0.0] + [NEG_INF] * (k - 1)), best_score=torch.tensor(NEG_INF),
                       best_tok=torch.full((lp_,), pad, dtype=torch.long)) for _ in range(heads)]
        # CTA h's own slice of every layer's self caches
        caches = [[(torch.zeros(k, max_len, hd), torch.zeros(k, max_len, hd)) for _ in dec["layers_kernel"]]
                  for _ in range(heads)]
        for step in range(max_len):
            xs = [dec["tok_emb"][st["tok"][:, step]] + dec["pos_emb"][step] for st in states]
            for li, (wt, (mk, mv)) in enumerate(zip(dec["layers_kernel"], mem_kv)):
                xs = cluster_layer(wt, xs, [caches[h][li] for h in range(heads)], [st["lin"] for st in states],
                                   step, mk[img], mv[img], valid[img])
            # the head: CTA h's Vp/H columns, gathered in every CTA
            logits = torch.cat([xs[h] @ out_w[:, h * vw:(h + 1) * vw] + out_b[h * vw:(h + 1) * vw]
                                for h in range(heads)], dim=1)[:, :v]
            for st in states:
                search_step(st, logits.clone(), step, eos)
            agree = agree and all(torch.equal(st[key], states[0][key]) for st in states[1:] for key in states[0])
        st = states[0]  # rank 0 writes the answer
        tokens[img] = st["best_tok"] if st["best_score"] > NEG_INF / 2 else st["tok"][0]
        scores[img] = torch.cat([st["score"], st["best_score"][None]])
    return tokens, scores, agree


def _port_main(tmp: Path) -> None:
    import torch

    from khmer_ocr_torch.config import DecodeConfig, ModelConfig
    from khmer_ocr_torch.convert.from_jax import params_from_jax
    from khmer_ocr_torch.models.ocr_model import memory_kv, pack_decode_params
    from khmer_ocr_torch.ops.kernels.decode_loop import fused_beam_decode_kernel, fused_beam_decode_plain

    torch.set_num_threads(2)
    cfg = ModelConfig(**TINY)
    out = {}
    with torch.inference_mode():
        for case, (_, _, _, k, max_len, _) in CASES.items():
            p, s, memory, pad = _inputs(case)
            params = params_from_jax(p, s, cfg)
            memory, pad = torch.from_numpy(memory), torch.from_numpy(pad)
            dec_cfg = DecodeConfig(beam_width=k, max_len=max_len)
            tok, sc = fused_beam_decode_plain(params, memory, pad, cfg, dec_cfg, return_scores=True)
            out[f"{case}_plain_tokens"], out[f"{case}_plain_scores"] = tok.numpy(), sc.numpy()
            tok, sc, agree = k3_partition(pack_decode_params(params)["dec"], memory_kv(params, memory),
                                          (~pad).float(), k=k, max_len=max_len, heads=cfg.num_heads,
                                          sos=dec_cfg.sos_idx, eos=dec_cfg.eos_idx, pad=dec_cfg.pad_idx)
            out[f"{case}_part_tokens"], out[f"{case}_part_scores"] = tok.numpy(), sc.numpy()
            out[f"{case}_states_agree"] = np.array(agree)
        for route, on_chip in (("on_chip", True), ("global", False)):
            try:
                fused_beam_decode_kernel(params, memory, pad, cfg, dec_cfg, on_chip=on_chip)
                out[f"kernel_raises_{route}"] = np.array(False)
            except RuntimeError:
                out[f"kernel_raises_{route}"] = np.array(True)
    np.savez(tmp / "outputs.npz", **out)


if __name__ == "__main__":
    _port_main(Path(sys.argv[1]))
