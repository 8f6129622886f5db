"""Kernel K2's card route (csrc/decoder_layer_card.cu), on the CPU.

The card route runs one decoder layer step of a greedy batch (one lane an
image, at most 32 rows) as seven launches over the whole card: every
projection's output columns split over CTAs of ``geometry.k2_card_split``
columns, each CTA applying its slice of the weight to every row of the
batch (warps of 8 rows, the input dimension split over a warp's 32 lanes
and over ``wpu`` warps, the lanes summed by a butterfly and the warps in
order; the FFN's second weight also split by its 1536 inputs into 4 parts,
whose partial sums the last launch adds in order before the bias), the
self-attention over (row, head) CTAs, each then its head's partial of the
out-projection, the cross-attention over (row, head) CTAs, which first add
the heads' partials in order and make LN1 of their row and its cross q in
the head's columns (8 lanes an output and a butterfly), each attention in
one pass whose weighted sum of V runs in 32 position groups added in
order, and the three residual LayerNorms on full rows.

A restatement of that split in PyTorch (this file's ``card_route``) is held
against the port's plain version, ``decode_step.decoder_layer_step_plain``,
at float32 on numpy-seeded inputs at the flagship's widths (D 384, 8 heads,
F 1536), within 1e-5 x max(1, |ref|) (float32 sums in another order): greedy
32 x 1 at Tm 384 with masked memory rows at the window's first, middle and
last slot; 32 x 1 at Tm 128 (the greedy batch of chip_smoke.py's [e2e]);
31 x 1 at Tm 256 and one row, whose last warp's group of 8 rows is partly
empty. Beam batches never take the card route (``geometry.k2_route``), so
no case has a lineage. The cache slot ``pos`` is written as the plain
version writes it and no other slot changes. The torch side runs in one torch-only
subprocess (this file run as a script), as the other port tests do; the
route's choice (``geometry.k2_route``) is plain Python, tested in the pytest
process at every shape the serving cells run.
"""

from __future__ import annotations

import json
import math
import os
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
D, HEADS, F = 384, 8, 1536
RT, RG, KC, WARPS, TGROUPS = 32, 8, 384, 12, 32

# name -> (rows (one an image), window (= cache length), Tm, pos, seed)
CASES = {
    "greedy_32x1_tm384_pos0": (32, 160, 384, 0, 1),
    "greedy_32x1_tm384_mid": (32, 160, 384, 80, 2),
    "greedy_32x1_tm384_last": (32, 160, 384, 159, 3),
    "greedy_32x1_tm128_last": (32, 64, 128, 63, 4),
    "greedy_31x1_tm256_mid": (31, 64, 256, 31, 5),
    "greedy_1x1_tm64": (1, 32, 64, 17, 7),
}

# (images, lanes, Tm, itemsize, head) -> route, at the flagship's widths: the serving cells' shapes (resnet:
# greedy batches of 32 over memories of 256 and 384 positions, and their tails; pages and seeded: beam 3, batches
# of 8 and their tails, memories of 2-7 chunks, 64-256 positions), then what keeps the cluster route whatever
# its batch (bfloat16, the fused head, long memories)
ROUTES = [
    ((32, 1, 384, 4, False), "card"), ((32, 1, 256, 4, False), "card"), ((31, 1, 384, 4, False), "card"),
    ((30, 1, 384, 4, False), "cluster"), ((11, 1, 384, 4, False), "cluster"), ((1, 1, 256, 4, False), "cluster"),
    ((8, 3, 256, 4, False), "cluster"), ((8, 3, 64, 4, False), "cluster"), ((1, 3, 64, 4, False), "cluster"),
    ((5, 3, 192, 4, False), "cluster"), ((1, 3, 256, 4, False), "cluster"),
    ((32, 1, 384, 2, False), "cluster"), ((32, 1, 384, 4, True), "cluster"), ((64, 3, 256, 4, False), "cluster"),
    ((32, 1, 4096, 4, False), "cluster"), ((8, 3, 4096, 4, False), "cluster"), ((32, 1, 128, 4, False), "card"),
    ((16, 2, 384, 4, False), "cluster"), ((33, 1, 384, 4, False), "cluster"),
]


def case_inputs(name: str) -> dict:
    b, w, tm, pos, seed = CASES[name]
    n_img = b
    rng = np.random.default_rng(seed)
    f32 = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    valid_len = rng.integers(1, tm, size=n_img)  # every memory masked past its length
    if n_img > 1:
        valid_len[0] = tm  # but the first image's, whole
    out = {
        "x": f32(b, D, scale=0.5), "self_k": f32(b, w, D, scale=0.3), "self_v": f32(b, w, D, scale=0.3),
        "mem_k": f32(n_img, tm, D, scale=0.3), "mem_v": f32(n_img, tm, D, scale=0.3),
        "mem_valid_f": (np.arange(tm)[None, :] < valid_len[:, None]).astype(np.float32),
    }
    shapes = {"qkv_w": (D, 3 * D), "so_w": (D, D), "cq_w": (D, D), "co_w": (D, D), "l1_w": (D, F), "l2_w": (F, D)}
    for k, s in shapes.items():
        out[k] = f32(*s, scale=1.0 / math.sqrt(s[0]))
    for k, n in (("qkv_b", 3 * D), ("so_b", D), ("cq_b", D), ("co_b", D), ("l1_b", F), ("l2_b", D)):
        out[k] = f32(n, scale=0.1)
    for k in ("ln1", "ln2", "ln3"):
        out[f"{k}_s"] = (1.0 + rng.normal(size=D) * 0.1).astype(np.float32)
        out[f"{k}_b"] = f32(D, scale=0.1)
    return out


# ---- geometry, in the pytest process -------------------------------------------------------------------------------


@pytest.mark.parametrize("key,route", ROUTES, ids=[f"{k[0]}x{k[1]}-Tm{k[2]}-b{k[3]}-head{int(k[4])}"
                                                  for k, _ in ROUTES])
def test_route_at_the_cells_shapes(key, route):
    n_img, lanes, tm, itemsize, head = key
    assert geometry.k2_route(n_img, lanes, tm, itemsize, head, D, HEADS, F) == route


@pytest.mark.parametrize("n,k,nc,parts", [(3 * D, D, 12, 1), (D, D, 4, 1), (F, D, 12, 1), (D, F, 12, 4)])
def test_card_split_keeps_the_ctas_within_the_sms(n, k, nc, parts):
    assert geometry.k2_card_split(n, k) == (nc, parts)
    assert n % nc == 0 and n // nc * parts <= geometry.SMS and k // parts * nc <= geometry.CARD_WS_MAX
    assert k // parts <= geometry.CARD_KC
    assert nc == min(c for c in range(4, 13, 4) if n % c == 0 and n // c * parts <= geometry.SMS)


def test_card_route_fits_only_widths_its_kernels_take():
    assert geometry.k2_card_fits(D, HEADS, F)
    assert not geometry.k2_card_fits(512, 8, 2048)  # a LayerNorm row wider than one staged chunk
    assert not geometry.k2_card_fits(D, 5, F)       # heads that do not divide D
    assert not geometry.k2_card_fits(D, 4, F)       # heads of 96 columns: no attention instantiation
    assert geometry.k2_route(32, 1, 384, 4, False, 512, 8, 2048) == "cluster"


@pytest.mark.parametrize("n_img", range(1, 33))
def test_card_route_exactly_where_the_cluster_route_takes_a_second_wave(n_img):
    """Greedy batches of 1-32 images at Tm 384: the card route from the
    first batch whose clusters of 8 CTAs outnumber what two CTAs an SM hold
    at once (240 SMs' worth), the cluster route below."""
    _, clusters, ctas = geometry.k2_geometry(n_img, 1, HEADS, 384)
    want = "card" if clusters * ctas > 2 * geometry.ONE_CTA_CLUSTER_SMS else "cluster"
    assert geometry.k2_route(n_img, 1, 384, 4, False, D, HEADS, F) == want
    assert want == ("card" if n_img >= 31 else "cluster")


# ---- the restatement against the plain version (torch subprocess) --------------------------------------------------


if __name__ != "__main__":

    @pytest.fixture(scope="module")
    def port(tmp_path_factory):
        tmp = tmp_path_factory.mktemp("torch_k2_card")
        for name in CASES:
            np.savez(tmp / f"in_{name}.npz", **case_inputs(name))
        proc = subprocess.run([sys.executable, __file__, str(tmp)], cwd=REPO, capture_output=True, text=True,
                              env={**os.environ, "OMP_NUM_THREADS": "2"}, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        return json.loads((tmp / "port.json").read_text())

    @pytest.mark.parametrize("name", sorted(CASES))
    def test_card_route_restatement_equals_the_plain_step(port, name):
        res = port[name]
        assert res["out_err"] <= TOL * max(1.0, res["out_max"]), res
        assert res["slot_err"] <= TOL * max(1.0, res["slot_max"]), res
        assert res["other_slots_untouched"], res

    def test_cases_exercise_what_they_name(port):
        """Masked memory rows in every case (one image whole, others cut),
        and batches whose last warp's group of 8 rows is partly empty."""
        for name, res in port.items():
            assert res["masked_rows"] > 0, name
        assert port["greedy_31x1_tm256_mid"]["rows"] % RG and port["greedy_1x1_tm64"]["rows"] % RG


# ---- the torch side (run as a script) ------------------------------------------------------------------------------


def card_proj(inp, w, bias, relu=False):
    """One projection as the card route's CTAs compute it: the inputs in
    ``geometry.k2_card_split``'s parts of at most 384, nc columns a CTA
    (every column's sum depends only on its CTA's split, the same for all
    CTAs of the launch), every row at once, lane lambda = part x 32 + lane of
    a unit's 32 x wpu summing inputs lambda, lambda + 32 wpu, ... of its
    part in order, the 32 lanes of each warp by a butterfly, the wpu warps in
    order; then the bias, or, with more than one part, the list of the
    parts' sums without it."""
    import torch

    k, n = w.shape
    nc, parts = geometry.k2_card_split(n, k)
    kp = k // parts
    assert kp <= KC and inp.shape[0] <= RT
    lane = torch.arange(32)
    rows = inp.shape[0]
    units = (nc // 4) * -(-rows // RG)
    wpu = WARPS // units
    span = 32 * wpu
    sums = []
    for p in range(parts):
        xt = inp[:, p * kp:(p + 1) * kp]
        wp = w[p * kp:(p + 1) * kp]
        acc = torch.zeros(span, rows, n)
        for j0 in range(0, kp, span):
            ks = torch.arange(j0, min(j0 + span, kp))
            acc[:len(ks)] += xt[:, ks].t()[:, :, None] * wp[ks][:, None, :]
        acc = acc.reshape(wpu, 32, rows, n)
        for o in (16, 8, 4, 2, 1):
            acc = acc + acc[:, lane ^ o]
        tot = acc[0, 0]
        for q in range(1, wpu):
            tot = tot + acc[q, 0]
        sums.append(tot)
    if parts > 1:
        return sums
    out = sums[0] + bias
    return torch.relu(out) if relu else out


def cross_q(x1, w, b):
    """The cross q as the cross-attention CTAs make it: 8 lanes an output,
    lane s summing inputs s, s + 8, ... in order, the 8 lanes by a butterfly,
    then the bias."""
    import torch

    acc = torch.zeros(8, x1.shape[0], w.shape[1])
    for s in range(8):
        for k in range(s, x1.shape[1], 8):
            acc[s] += x1[:, k, None] * w[k][None, :]
    idx = torch.arange(8)
    for o in (4, 2, 1):
        acc = acc + acc[idx ^ o]
    return acc[0] + b


def head_attention(q, k, v, ok):
    """The card route's attention of one query row of one head, in one
    pass: the logits, their largest and the sum of the weights, the weighted
    sum of V in 32 position groups (position t in group t % 32), the groups
    added in order, divided by the sum."""
    import torch

    lg = torch.where(ok, (k @ q) * (1.0 / math.sqrt(q.shape[0])), torch.tensor(-1e30))
    e = torch.where(ok, torch.exp(lg - lg.max()), torch.zeros(()))
    grp = torch.arange(e.shape[0]) % TGROUPS
    out = torch.zeros(q.shape[0])
    for g in range(TGROUPS):
        out = out + e[grp == g] @ v[grp == g]
    return out / e.sum()


def layer_norm(x, s, b, eps=1e-5):
    import torch

    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * s + b


def card_route(wt, x, pos, sk, sv, mk, mv, valid, *, num_heads):
    """The layer step of a greedy batch as the card route's seven launches
    compute it; writes the caches' slot ``pos`` in place and returns the
    layer output."""
    import torch

    b, d = x.shape
    hd = d // num_heads
    qkv = card_proj(x, wt["qkv_w"], wt["qkv_b"])                       # 1
    q = qkv[:, :d]
    sk[:, pos] = qkv[:, d:2 * d]
    sv[:, pos] = qkv[:, 2 * d:]
    partial = torch.empty(num_heads, b, d)
    ok = torch.ones(pos + 1, dtype=torch.bool)
    for row in range(b):                                                # 2: (row, head)
        for h in range(num_heads):
            c = slice(h * hd, (h + 1) * hd)
            o = head_attention(q[row, c], sk[row, :pos + 1, c], sv[row, :pos + 1, c], ok)
            acc = torch.zeros(d)  # the head's partial of the out-projection, its hd rows of Wso in order
            for j in range(hd):
                acc = acc + o[j] * wt["so_w"][h * hd + j]
            partial[h, row] = acc
    t1 = partial[0]
    for h in range(1, num_heads):
        t1 = t1 + partial[h]
    x1 = layer_norm(x + (t1 + wt["so_b"]), wt["ln1_s"], wt["ln1_b"])    # 3: LN1, the cross q, the attention
    qc = cross_q(x1, wt["cq_w"], wt["cq_b"])
    att = torch.empty(b, d)
    for row in range(b):                                                # (row, head): a row is an image
        for h in range(num_heads):
            c = slice(h * hd, (h + 1) * hd)
            att[row, c] = head_attention(qc[row, c], mk[row][:, c], mv[row][:, c], valid[row] > 0)
    t2 = card_proj(att, wt["co_w"], wt["co_b"])                         # 4
    x2 = layer_norm(x1 + t2, wt["ln2_s"], wt["ln2_b"])                  # 5
    hid = card_proj(x2, wt["l1_w"], wt["l1_b"], relu=True)
    parts = card_proj(hid, wt["l2_w"], wt["l2_b"])                      # 6: partial sums
    t3 = parts[0]
    for p in parts[1:]:
        t3 = t3 + p
    return layer_norm(x2 + (t3 + wt["l2_b"]), wt["ln3_s"], wt["ln3_b"])  # 7


def _port_main(tmp: Path) -> None:
    import torch

    from khmer_ocr_torch.ops.kernels.decode_step import WEIGHT_FIELDS, decoder_layer_step_plain

    torch.set_num_threads(2)
    res = {}
    for name, (b, w, tm, pos, _) in CASES.items():
        z = {k: torch.from_numpy(v) for k, v in np.load(tmp / f"in_{name}.npz").items()}
        wt = {k: z[k] for k in WEIGHT_FIELDS}
        sk_c, sv_c, sk_p, sv_p = (z[k].clone() for k in ("self_k", "self_v", "self_k", "self_v"))
        got = card_route(wt, z["x"], pos, sk_c, sv_c, z["mem_k"], z["mem_v"], z["mem_valid_f"], num_heads=HEADS)
        ref = decoder_layer_step_plain(wt, z["x"], pos, sk_p, sv_p, z["mem_k"], z["mem_v"], z["mem_valid_f"], None,
                                       num_heads=HEADS, window=w, lanes=1)
        keep = torch.arange(w) != pos
        res[name] = dict(
            out_err=(got - ref).abs().max().item(), out_max=ref.abs().max().item(),
            slot_err=max((sk_c[:, pos] - sk_p[:, pos]).abs().max().item(),
                         (sv_c[:, pos] - sv_p[:, pos]).abs().max().item()),
            slot_max=max(sk_p[:, pos].abs().max().item(), sv_p[:, pos].abs().max().item()),
            other_slots_untouched=bool(torch.equal(sk_c[:, keep], z["self_k"][:, keep])
                                       and torch.equal(sv_c[:, keep], z["self_v"][:, keep])
                                       and torch.equal(sk_p[:, keep], z["self_k"][:, keep])),
            masked_rows=int((z["mem_valid_f"] == 0).sum()), rows=b)
    (tmp / "port.json").write_text(json.dumps(res))


if __name__ == "__main__":
    _port_main(Path(sys.argv[1]))
