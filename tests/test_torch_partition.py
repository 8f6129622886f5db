"""The cluster decompositions of kernels K1 and K2, on the CPU.

K1 (``csrc/lstm_recurrence.cu``, cluster route) splits one LSTM recurrence
over the C CTAs of a thread-block cluster: CTA c owns hidden units [c H/C,
(c+1) H/C) and their four gate columns, keeps its slice of W_hh for all
steps, updates the c and h of its units, and writes its new h slice into
every CTA's copy of h (double-buffered). K2 (``csrc/decoder_layer_step.cu``)
runs one cluster of one CTA per attention head for each image and group of
its lanes: head-sliced QKV and attention, column-sliced out-projections
exchanged before a redundant LayerNorm on full rows, and the FFN split by
the second weight's input rows, its partial sums added in the fixed order of
the CTAs. With two CTAs a head, the pair also splits the head's columns of
every projection and its memory positions, whose halves merge by their
log-sum-exp.

Each decomposition is written out here in PyTorch as the kernel computes
it and held against the port's plain version and the JAX package's function
on the same numpy-seeded inputs, at 1e-5 x max(1, |ref|) (float32 sums taken
in another order). The torch side runs in one torch-only subprocess (this
file run as a script), because torch compute followed by jitted JAX in one
process can hang (tests/conftest.py); the JAX Pallas decoder step runs in
interpret mode. The launch-geometry rules (``ops/kernels/geometry.py``) are
plain Python, tested in the pytest process.
"""

from __future__ import annotations

import itertools
import math
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

LSTM_B, LSTM_T, LSTM_D, LSTM_H = 3, 48, 64, 32
LSTM_LENGTHS = (48, 31, 9)
K1_CASES = [(ctas, stacked) for ctas in (1, 2, 4, 8) for stacked in (False, True)]

TOY = dict(emb_dim=64, num_heads=4, enc_layers=1, dec_layers=1, enc_ffn_dim=128, max_global_len=256,
           decode_max_len=64)
HEADS, N_IMG, CACHE_LEN = 4, 2, 64
STEP_CASES = [(lanes, w, tm) for lanes in (1, 3, 5) for w in (32, 64) for tm in (32, 256)]


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), f"max |diff| {err:.3e} > {tol} x max(1, |ref|)"


def _lstm_inputs():
    r = np.random.RandomState(7)
    p = {d: dict(w_ih=(r.randn(LSTM_D, 4 * LSTM_H) * 0.15).astype(np.float32),
                 w_hh=(r.randn(LSTM_H, 4 * LSTM_H) * 0.2).astype(np.float32),
                 b_ih=(r.randn(4 * LSTM_H) * 0.1).astype(np.float32),
                 b_hh=(r.randn(4 * LSTM_H) * 0.1).astype(np.float32)) for d in ("fw", "bw")}
    x = (r.randn(LSTM_B, LSTM_T, LSTM_D) * 0.7).astype(np.float32)
    return p, x, np.array(LSTM_LENGTHS, np.int32)


def _step_inputs(lanes: int, w: int, tm: int):
    r = np.random.RandomState(300 + 7 * lanes + w + tm)
    b, d = N_IMG * lanes, TOY["emb_dim"]
    valid_len = r.randint(1, tm + 1, size=N_IMG)
    valid_len[0] = max(1, tm // 3)  # the second half of image 0's positions all masked
    return dict(
        x=r.randn(b, d).astype(np.float32) * 0.5,
        sk=r.randn(b, CACHE_LEN, d).astype(np.float32) * 0.3,
        sv=r.randn(b, CACHE_LEN, d).astype(np.float32) * 0.3,
        mk=r.randn(N_IMG, tm, d).astype(np.float32) * 0.3,
        mv=r.randn(N_IMG, tm, d).astype(np.float32) * 0.3,
        valid=(np.arange(tm)[None, :] < valid_len[:, None]).astype(np.float32),
        lin=r.randint(0, lanes, size=(b, w)).astype(np.int32),
        pos=np.int32(w - 1 - (w // 4)),
    )


def _key(lanes, w, tm):
    return f"step_{lanes}_{w}_{tm}"


# ---------------------------------------------------------------------------
# the launch geometry (pytest process, plain Python)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hidden,ctas", [(32, 1), (32, 2), (32, 4), (32, 8), (192, 8), (192, 16)])
def test_k1_slices_cover_each_gate_column_once(hidden, ctas):
    """Every gate column of W_hh belongs to exactly one CTA, and a CTA's
    columns are the i, f, g, o columns of its own hidden units."""
    slices = geometry.cluster_slices(hidden, ctas)
    assert len(slices) == ctas
    assert sorted(itertools.chain(*slices)) == list(range(4 * hidden))
    units = hidden // ctas
    for c, cols in enumerate(slices):
        assert {col % hidden for col in cols} == set(range(c * units, (c + 1) * units))
        assert cols[:4] == [c * units + g * hidden for g in range(4)]


@pytest.mark.parametrize("batch,ndir,want", [
    (1, 2, (8, 1)), (4, 2, (8, 1)), (8, 2, (8, 2)), (8, 1, (8, 1)), (32, 1, (8, 4)), (64, 1, (8, 8)),
    (64, 2, (8, 8)), (127, 2, (8, 8)), (128, 2, (0, 2)), (256, 2, (0, 4)), (383, 1, (8, 8)), (384, 1, (0, 4)),
    (1024, 1, (0, 8)),
])
def test_k1_route_by_batch(batch, ndir, want):
    """Below the crossover the cluster route, with the fewest rows per
    cluster that keep every cluster in the first wave; from it on the tile
    route."""
    assert geometry.k1_route(batch, 192, ndir) == want


@pytest.mark.parametrize("hidden", [32, 128, 256])
def test_k1_other_widths_take_the_tile_route(hidden):
    assert geometry.k1_route(4, hidden, 2) == (0, 1)


@pytest.mark.parametrize("n_img,lanes,heads,tm,want", [
    (8, 1, 8, 256, (1, 8, 8)), (8, 3, 8, 256, (3, 8, 8)), (1, 5, 8, 256, (5, 1, 8)), (64, 8, 8, 256, (8, 64, 8)),
    (2, 9, 8, 256, (3, 6, 8)), (2, 16, 4, 256, (8, 4, 4)), (3, 11, 8, 256, (1, 33, 8)),
])
def test_k2_cluster_geometry(n_img, lanes, heads, tm, want):
    """All of an image's lanes in one cluster up to 8, else the largest
    divisor of the lane count up to 8; one CTA per head."""
    assert geometry.k2_geometry(n_img, lanes, heads, tm) == want


@pytest.mark.parametrize("n_img,lanes,heads,tm,ctas", [
    (1, 3, 8, 4096, 16), (8, 3, 8, 4096, 16), (8, 3, 8, 1024, 16), (8, 3, 8, 512, 8), (9, 3, 8, 4096, 8),
    (8, 9, 8, 4096, 8), (4, 3, 4, 4096, 8), (1, 3, 16, 4096, 16),
])
def test_k2_two_ctas_a_head_for_long_memories_that_fit(n_img, lanes, heads, tm, ctas):
    """Two CTAs a head from Tm = 1024 on, while the cluster stays within 16
    CTAs and the launch within the 132 SMs at one CTA each."""
    assert geometry.k2_geometry(n_img, lanes, heads, tm)[2] == ctas


@pytest.mark.parametrize("n_img,lanes,heads,tm,two", [
    (1, 3, 8, 256, False), (8, 3, 8, 256, False), (15, 3, 8, 256, False), (16, 3, 8, 256, True),
    (64, 3, 8, 256, True), (8, 3, 8, 4096, True), (7, 3, 8, 4096, False), (9, 3, 8, 4096, False),
    (30, 3, 4, 256, False), (31, 3, 4, 256, True),
])
def test_k2_float_library_by_resident_clusters(n_img, lanes, heads, tm, two):
    """The library bounded for two CTAs an SM only for launches with more
    clusters than one CTA an SM holds (30, 15 and 7 clusters of 4, 8 and 16
    CTAs on the H100): 8 images x 3 lanes at Tm 256 stay at one, 64 images
    and 8 at Tm 4096 (two CTAs a head) take two; 9 at Tm 4096 go back to one
    CTA a head, 9 clusters of 8."""
    _, clusters, ctas = geometry.k2_geometry(n_img, lanes, heads, tm)
    assert geometry.k2_two_ctas_an_sm(clusters, ctas) == two


# ---------------------------------------------------------------------------
# the JAX side and the port's outputs (pytest process)
# ---------------------------------------------------------------------------

if __name__ != "__main__":
    import jax
    import jax.numpy as jnp

    from khmer_ocr_torch.config import ModelConfig as PortModelConfig
    from khmer_ocr_torch.convert.from_jax import seeded_params

    @pytest.fixture(scope="module")
    def port(tmp_path_factory):
        """Build every case's inputs, run the torch side once, return its outputs."""
        tmp = tmp_path_factory.mktemp("torch_partition")
        inp = {}
        for lanes, w, tm in STEP_CASES:
            for k, v in _step_inputs(lanes, w, tm).items():
                inp[f"{_key(lanes, w, tm)}_{k}"] = v
        np.savez(tmp / "inputs.npz", **inp)
        subprocess.run([sys.executable, __file__, str(tmp)], cwd=REPO, check=True, timeout=600)
        with np.load(tmp / "outputs.npz") as z:
            return {"out": {k: z[k] for k in z.files}, "inp": inp}

    @pytest.fixture(scope="module")
    def lstm_ref():
        """JAX lstm_scan (lax.scan) per direction and bilstm_apply."""
        from khmer_ocr_tpu.models.bilstm import bilstm_apply, flip_within_length, lstm_scan

        p, x, lengths = _lstm_inputs()
        jp = jax.tree.map(jnp.asarray, p)
        with jax.default_matmul_precision("highest"):
            fw = np.asarray(lstm_scan(jp["fw"], jnp.asarray(x), use_pallas=False))
            x_rev = flip_within_length(jnp.asarray(x), jnp.asarray(lengths))
            bw = np.asarray(lstm_scan(jp["bw"], x_rev, use_pallas=False))
            bi = np.asarray(bilstm_apply(jp, jnp.asarray(x), jnp.asarray(lengths), use_pallas=False))
        return {"single": fw, "stacked": np.stack([fw, bw]), "bilstm": bi}

    @pytest.mark.parametrize("ctas,stacked", K1_CASES)
    def test_k1_partition_matches_plain_and_jax(port, lstm_ref, ctas, stacked):
        """C CTAs, each with its hidden slice and four gate columns, h
        exchanged every step: == lstm_recurrence_plain and JAX lstm_scan,
        for one direction and for the two stacked directions; every CTA's
        copy of h ends the same."""
        kind = "stacked" if stacked else "single"
        got = port["out"][f"k1_{ctas}_{kind}"]
        _close(got, port["out"][f"k1_plain_{kind}"])
        _close(got, lstm_ref[kind])
        assert port["out"][f"k1_{ctas}_{kind}_copies_agree"].all()
        if stacked:
            _close(port["out"][f"k1_{ctas}_bilstm"], lstm_ref["bilstm"])
            _close(port["out"]["k1_port_bilstm"], lstm_ref["bilstm"])

    @pytest.mark.parametrize("lanes,w,tm", STEP_CASES)
    def test_k2_partition_matches_plain_and_jax(port, lanes, w, tm):
        """One cluster per (image, lane group), one CTA per head, with and
        without the two-way position split: output and written cache slot ==
        the port's plain step, JAX decoder_layer_step and the JAX Pallas
        kernel in interpret mode; every other cache slot untouched."""
        from khmer_ocr_tpu.models.layers import Ctx, decoder_layer_step, pack_step_params
        from khmer_ocr_tpu.ops.pallas.decode_step import fused_decoder_layer_step, layer_weights

        key = _key(lanes, w, tm)
        c = {k: port["inp"][f"{key}_{k}"] for k in ("x", "sk", "sv", "mk", "mv", "valid", "lin", "pos")}
        pos = int(c["pos"])
        lin = lanes > 1
        p, _ = seeded_params(PortModelConfig(**TOY), 3)
        lp = pack_step_params(jax.tree.map(jnp.asarray, p["dec"]["layers"][0]))
        b = c["x"].shape[0]
        idx = None
        if lin:
            rows = np.arange(b)[:, None]
            idx = jnp.asarray(np.where(np.arange(w)[None, :] == pos, rows, c["lin"] + lanes * (rows // lanes)))
        ctx = Ctx(num_heads=HEADS, dropout=0.0, deterministic=True)
        with jax.default_matmul_precision("highest"):
            refs = [decoder_layer_step(lp, ctx, c["x"], pos, c["sk"], c["sv"], c["mk"], c["mv"], c["valid"] > 0,
                                       window=w, lineage_idx=idx)]
            refs.append(fused_decoder_layer_step(
                layer_weights(lp), jnp.asarray(c["x"]), pos, jnp.asarray(c["sk"]), jnp.asarray(c["sv"]),
                jnp.asarray(c["mk"]), jnp.asarray(c["mv"]), jnp.asarray(c["valid"]),
                jnp.asarray(c["lin"]) if lin else None, num_heads=HEADS, window=w, lanes=lanes, interpret=True))
        out = port["out"]
        plain = (out[f"{key}_plain_x"], out[f"{key}_plain_k"], out[f"{key}_plain_v"])
        keep = np.arange(CACHE_LEN) != pos
        for split in (1, 2):
            got = (out[f"{key}_part{split}_x"], out[f"{key}_part{split}_k"], out[f"{key}_part{split}_v"])
            for ref in (plain, *refs):
                for g, r in zip(got, ref):
                    _close(g, r)
            np.testing.assert_array_equal(got[1][:, keep], c["sk"][:, keep])
            np.testing.assert_array_equal(got[2][:, keep], c["sv"][:, keep])


# ---------------------------------------------------------------------------
# the decompositions, as the kernels compute them (torch-only subprocess)
# ---------------------------------------------------------------------------


def k1_partition(xg, w_hh, ctas: int):
    """The cluster route's recurrence for xg ([ndir,] B, T, 4H). Returns (h
    for every step, whether every CTA's copy of h agreed at the end)."""
    import torch

    stacked = xg.dim() == 4
    outs, agree = [], True
    for x, w in zip(xg if stacked else xg[None], w_hh if stacked else w_hh[None]):
        b, t, g = x.shape
        hidden = g // 4
        units = hidden // ctas
        slices = geometry.cluster_slices(hidden, ctas)
        w_slices = [w[:, cols] for cols in slices]  # loaded once, before the time loop
        h_copy = [[x.new_zeros(b, hidden) for _ in range(ctas)] for _ in range(2)]  # [buffer][CTA]
        c_state = [x.new_zeros(b, units) for _ in range(ctas)]
        out = x.new_empty(b, t, hidden)
        for step in range(t):
            cur, nxt = step & 1, (step & 1) ^ 1
            for c in range(ctas):
                pre = (x[:, step, slices[c]] + h_copy[cur][c] @ w_slices[c]).reshape(b, units, 4)
                i, f, gg, o = pre.unbind(-1)
                cc = torch.sigmoid(f) * c_state[c] + torch.sigmoid(i) * torch.tanh(gg)
                hh = torch.sigmoid(o) * torch.tanh(cc)
                c_state[c] = cc
                for q in range(ctas):  # into every CTA's next buffer
                    h_copy[nxt][q][:, c * units:(c + 1) * units] = hh
                out[:, step, c * units:(c + 1) * units] = hh
        last = h_copy[t & 1]
        agree = agree and all(torch.equal(last[0], other) for other in last[1:])
        outs.append(out)
    res = torch.stack(outs)
    return (res if stacked else res[0]), agree


def _layer_norm(x, s, b, eps=1e-5):
    import torch

    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * s + b


def _head_attention(q, k, v, ok, split: int):
    """softmax(q . k_t / sqrt(hd)) @ v over the positions where ok, for one
    query row; with split = 2 the positions go to two CTAs whose unnormalised
    results merge by their log-sum-exp, in fixed order."""
    import torch

    logits = torch.where(ok, k @ q / math.sqrt(q.shape[0]), torch.tensor(-1e30))
    parts = []
    for idx in torch.arange(logits.shape[0]).tensor_split(split):
        lg, okh = logits[idx], ok[idx]
        m = lg.max()
        e = torch.where(okh, torch.exp(lg - m), torch.zeros(()))
        parts.append((m, e.sum(), e @ v[idx]))
    m = max(p[0] for p in parts)
    l, o = torch.zeros(()), torch.zeros(v.shape[1])
    for m_s, l_s, o_s in parts:
        c = torch.exp(m_s - m)
        l, o = l + l_s * c, o + o_s * c
    return o / l


def k2_partition(wt, x, pos, sk, sv, mk, mv, valid, lineage, *, num_heads, lanes, split=1):
    """K2's layer step as its clusters compute it, with ``split`` CTAs per
    head (rank = head x split + part owns columns [rank hd/split, (rank+1)
    hd/split) of every D-wide projection and F/(heads x split) hidden
    columns); writes the caches' slot ``pos`` in place and returns the layer
    output."""
    import torch

    b, d = x.shape
    hd = d // num_heads
    ncta = num_heads * split
    sw = d // ncta
    fs = wt["l1_w"].shape[1] // ncta
    n_img = mk.shape[0]
    group, n_clusters, _ = geometry.k2_geometry(n_img, lanes, num_heads, mk.shape[1])
    own = [slice(rank * sw, (rank + 1) * sw) for rank in range(ncta)]  # each CTA's columns
    head_cols = [slice(h * hd, (h + 1) * hd) for h in range(num_heads)]

    def sliced(inp, w, bias):  # a D-wide projection, one column slice per CTA, gathered
        return torch.cat([inp @ w[:, c] + bias[c] for c in own], dim=1)

    out = torch.empty_like(x)
    for cl in range(n_clusters):
        img, grp = divmod(cl, lanes // group)
        row0 = img * lanes + grp * group
        xr = x[row0:row0 + group]
        # 1-2. q, k, v by column slices (each CTA writes its slice of slot pos); self-attention per head
        q, k, v = (sliced(xr, wt["qkv_w"][:, j * d:(j + 1) * d], wt["qkv_b"][j * d:(j + 1) * d]) for j in range(3))
        for c in own:
            sk[row0:row0 + group, pos, c] = k[:, c]
            sv[row0:row0 + group, pos, c] = v[:, c]
        heads_out = []
        for hc in head_cols:
            rows_out = []
            for r in range(group):
                src = lineage[row0 + r, :pos].long() if lineage is not None else torch.full((pos,), grp * group + r)
                kr = torch.cat([sk[img * lanes + src, torch.arange(pos), hc], k[r:r + 1, hc]])
                vr = torch.cat([sv[img * lanes + src, torch.arange(pos), hc], v[r:r + 1, hc]])
                rows_out.append(_head_attention(q[r, hc], kr, vr, torch.ones(pos + 1, dtype=torch.bool), 1))
            heads_out.append(torch.stack(rows_out))
        a = torch.cat(heads_out, dim=1)  # gathered in every CTA
        # 3. out-projection by column slices, gathered; residual and LN1 on full rows
        x1 = _layer_norm(xr + sliced(a, wt["so_w"], wt["so_b"]), wt["ln1_s"], wt["ln1_b"])
        # 4. cross-attention per head over its columns of the image's memory, its
        #    positions split over the head's CTAs
        qc = sliced(x1, wt["cq_w"], wt["cq_b"])
        ok = valid[img] > 0
        a = torch.cat([torch.stack([_head_attention(qc[r, hc], mk[img][:, hc], mv[img][:, hc], ok, split)
                                    for r in range(group)]) for hc in head_cols], dim=1)
        # 5. out-projection, LN2
        x2 = _layer_norm(x1 + sliced(a, wt["co_w"], wt["co_b"]), wt["ln2_s"], wt["ln2_b"])
        # 6. FFN: hidden slice and partial output per CTA; CTA q adds every
        #    CTA's partial of its columns in CTA order, then the bias; gathered
        partial = []
        for rank in range(ncta):
            hs = slice(rank * fs, (rank + 1) * fs)
            partial.append(torch.relu(x2 @ wt["l1_w"][:, hs] + wt["l1_b"][hs]) @ wt["l2_w"][hs])
        y = []
        for c in own:
            acc = torch.zeros(group, sw)
            for p in partial:
                acc = acc + p[:, c]
            y.append(acc + wt["l2_b"][c])
        out[row0:row0 + group] = _layer_norm(x2 + torch.cat(y, dim=1), wt["ln3_s"], wt["ln3_b"])
    return out


def _port_main(tmp: Path) -> None:
    import torch

    from khmer_ocr_torch.config import ModelConfig
    from khmer_ocr_torch.convert.from_jax import params_from_jax, seeded_params
    from khmer_ocr_torch.models.bilstm import bilstm_apply, flip_within_length, input_gates
    from khmer_ocr_torch.models.layers import pack_step_params
    from khmer_ocr_torch.ops.kernels.decode_step import decoder_layer_step_plain, layer_weights
    from khmer_ocr_torch.ops.kernels.lstm import lstm_recurrence_plain

    torch.set_num_threads(2)
    t = torch.from_numpy
    with np.load(tmp / "inputs.npz") as z:
        inp = {k: z[k] for k in z.files}
    out = {}
    with torch.inference_mode():
        p, x, lengths = _lstm_inputs()
        tp = {d: {k: t(v) for k, v in p[d].items()} for d in p}
        x, lengths = t(x), t(lengths)
        x_rev = flip_within_length(x, lengths)
        xg = {"single": input_gates(tp["fw"], x).contiguous(),
              "stacked": torch.stack([input_gates(tp["fw"], x), input_gates(tp["bw"], x_rev)])}
        w = {"single": tp["fw"]["w_hh"], "stacked": torch.stack([tp["fw"]["w_hh"], tp["bw"]["w_hh"]])}
        for kind in ("single", "stacked"):
            out[f"k1_plain_{kind}"] = lstm_recurrence_plain(xg[kind], w[kind]).numpy()
        for ctas, stacked in K1_CASES:
            kind = "stacked" if stacked else "single"
            h, agree = k1_partition(xg[kind], w[kind], ctas)
            out[f"k1_{ctas}_{kind}"], out[f"k1_{ctas}_{kind}_copies_agree"] = h.numpy(), np.array(agree)
            if stacked:
                out[f"k1_{ctas}_bilstm"] = torch.cat([h[0], flip_within_length(h[1], lengths)], dim=-1).numpy()
        out["k1_port_bilstm"] = bilstm_apply(tp, x, lengths).numpy()

        cfg = ModelConfig(**TOY)
        ps, ss = seeded_params(cfg, 3)
        weights = layer_weights(pack_step_params(params_from_jax(ps, ss, cfg)["dec"]["layers"][0]))
        for lanes, w_, tm in STEP_CASES:
            key = _key(lanes, w_, tm)
            c = {k: t(inp[f"{key}_{k}"].copy()) for k in ("x", "sk", "sv", "mk", "mv", "valid", "lin")}
            pos = int(inp[f"{key}_pos"])
            lin = c["lin"] if lanes > 1 else None
            sk, sv = c["sk"].clone(), c["sv"].clone()
            out[f"{key}_plain_x"] = decoder_layer_step_plain(weights, c["x"], pos, sk, sv, c["mk"], c["mv"],
                                                             c["valid"], lin, num_heads=HEADS, window=w_,
                                                             lanes=lanes).numpy()
            out[f"{key}_plain_k"], out[f"{key}_plain_v"] = sk.numpy(), sv.numpy()
            for split in (1, 2):
                sk, sv = c["sk"].clone(), c["sv"].clone()
                out[f"{key}_part{split}_x"] = k2_partition(weights, c["x"], pos, sk, sv, c["mk"], c["mv"],
                                                           c["valid"], lin, num_heads=HEADS, lanes=lanes,
                                                           split=split).numpy()
                out[f"{key}_part{split}_k"], out[f"{key}_part{split}_v"] = sk.numpy(), sv.numpy()
    np.savez(tmp / "outputs.npz", **out)


if __name__ == "__main__":
    _port_main(Path(sys.argv[1]))
