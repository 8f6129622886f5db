"""The cluster decomposition of kernel K1b (the LSTM's adjoint), on the CPU.

K1b's cluster route (``csrc/lstm_backward.cu``) splits one adjoint recurrence
over the C CTAs of a thread-block cluster, as K1's forward splits the
recurrence: CTA c owns hidden units [c H/C, (c+1) H/C) and their four gate
columns, keeps its slice W_hh[:, cols(c)] for all steps, and carries the dc of
its units. A step t, from t = T - 1 down:

1. each CTA adds the C partial sums of dh_next that step t + 1 left in its
   buffer, in rank order 0..C-1, to dh_seq[t] of its units;
2. it forms the dz of its units' gate columns from the pre-activation gates,
   c[t], c[t-1], dh and its dc carry;
3. it takes the partial product dz[:, cols(c)] @ W_hh[:, cols(c)]^T over its
   own columns, in two shares added in order (the kernel's two lanes per
   input k);
4. it writes the sum for unit k into the buffer of k's owner (a
   reduce-scatter); the buffers are double-buffered, one per step parity.

The decomposition is written out here in PyTorch as the kernel computes it.
A buffer is filled with NaN once its step has read it, so a step that read
the wrong buffer would show. dz and dW_hh = sum over t and rows of
h[t-1]^T dz[t] are held against the port's ``lstm_adjoint_plain`` and the
JAX package's ``_vjp_bwd`` (its residuals from JAX's ``lstm_recurrence(...,
with_cell=True)``, the Pallas kernel in interpret mode) on the same
numpy-seeded inputs, at 1e-5 x max(1, |ref|) (float32 sums taken in another
order). The torch side runs in one torch-only subprocess (this file run as a
script), because torch compute followed by jitted JAX in one process can
hang (tests/conftest.py). K1b's route rule (``geometry.k1b_route``) is plain
Python, tested in the pytest process.
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
SHARES = 2  # lanes that split a CTA's columns for one input k (NT / H in the kernel)
# (hidden, B, T): a toy width, and the flagship's with clusters of 8 (24 units a CTA)
SIZES = {32: (3, 12), 192: (2, 6)}
CASES = [(32, ctas, stacked) for ctas in (1, 2, 4, 8) for stacked in (False, True)] + [(192, 8, True)]


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), f"max |diff| {err:.3e} > {tol} x max(1, |ref|)"


def _inputs(hidden: int, stacked: bool):
    b, t = SIZES[hidden]
    r = np.random.RandomState(11 + hidden + stacked)
    lead = (2,) if stacked else ()
    return dict(xg=(r.randn(*lead, b, t, 4 * hidden) * 0.5).astype(np.float32),
                w=(r.randn(*lead, hidden, 4 * hidden) * (0.2 if hidden == 32 else 0.05)).astype(np.float32),
                dh=r.randn(*lead, b, t, hidden).astype(np.float32))


def _kind(hidden: int, stacked: bool) -> str:
    return f"{hidden}_{'stacked' if stacked else 'single'}"


# ---------------------------------------------------------------------------
# the route rule (pytest process, plain Python)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch,ndir,want", [
    (1, 1, (8, 1)), (1, 2, (8, 1)), (8, 2, (8, 2)), (16, 2, (8, 4)), (32, 2, (8, 8)), (32, 1, (8, 4)),
    (64, 1, (8, 8)), (64, 2, (8, 8)), (384, 2, (8, 8)), (512, 2, (8, 8)), (1024, 1, (8, 8)), (2048, 2, (8, 8)),
    (4096, 1, (8, 8)),
])
def test_k1b_route_by_batch(batch, ndir, want):
    """At hidden width 192 the cluster route at every batch (it measured no
    slower than the tile route up to 2048 rows a direction), with the fewest
    rows per cluster that keep every cluster in the first wave: 8 rows, 8
    clusters at the train step's 2 x 32."""
    assert geometry.k1b_route(batch, 192, ndir) == want


@pytest.mark.parametrize("hidden", [32, 128, 256])
def test_k1b_other_widths_take_the_tile_route(hidden):
    """The cluster route is compiled for H = 192 only."""
    assert geometry.k1b_route(32, hidden, 2) == (0, geometry.k1b_rows(32, 2))


# ---------------------------------------------------------------------------
# the JAX side (pytest process)
# ---------------------------------------------------------------------------

if __name__ != "__main__":
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    @pytest.fixture(scope="module")
    def port(tmp_path_factory):
        """Run the torch side once; its outputs by name."""
        tmp = tmp_path_factory.mktemp("torch_k1b_partition")
        subprocess.run([sys.executable, __file__, str(tmp)], cwd=REPO, check=True, timeout=600)
        with np.load(tmp / "outputs.npz") as z:
            return {k: z[k] for k in z.files}

    @pytest.fixture(scope="module")
    def jax_ref():
        """(dxg, dW_hh) of JAX's _vjp_bwd for each input set, its residuals
        from the Pallas forward with cells in interpret mode."""
        import khmer_ocr_tpu.ops.pallas.lstm as L

        orig = pl.pallas_call
        refs = {}
        with pytest.MonkeyPatch.context() as mp, jax.default_matmul_precision("highest"):
            mp.setattr(pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True}))
            for hidden, _, stacked in CASES:
                kind = _kind(hidden, stacked)
                if kind in refs:
                    continue
                inp = _inputs(hidden, stacked)
                outs = []
                for xg, w, dh in zip(*(inp[k] if stacked else inp[k][None] for k in ("xg", "w", "dh"))):
                    xg, w, dh = jnp.asarray(xg), jnp.asarray(w), jnp.asarray(dh)
                    h, c = L.lstm_recurrence(xg, w, hidden, with_cell=True)
                    outs.append([np.asarray(v) for v in L._vjp_bwd(hidden, (xg, w, h, c), dh)])
                refs[kind] = tuple(np.stack([o[i] for o in outs]) if stacked else outs[0][i] for i in range(2))
        return refs

    @pytest.mark.parametrize("hidden,ctas,stacked", CASES)
    def test_k1b_partition_matches_plain_and_jax(port, jax_ref, hidden, ctas, stacked):
        """C CTAs, each with its units' dz, its partial dh sums over its own
        columns, reduce-scattered in rank order through double-buffered
        partials: dz and dW_hh == lstm_adjoint_plain and JAX _vjp_bwd, for one
        direction and for the two stacked directions."""
        kind = _kind(hidden, stacked)
        dz, dw = port[f"dz_{ctas}_{kind}"], port[f"dw_{ctas}_{kind}"]
        _close(dz, port[f"dz_plain_{kind}"])
        _close(dw, port[f"dw_plain_{kind}"])
        _close(dz, jax_ref[kind][0])
        _close(dw, jax_ref[kind][1])
        assert np.isfinite(dz).all() and np.abs(dz).max() > 0


# ---------------------------------------------------------------------------
# the decomposition, as the kernel computes it (torch-only subprocess)
# ---------------------------------------------------------------------------


def k1b_partition(gates, c, dh, w_hh, ctas: int):
    """The cluster route's adjoint for gates ([ndir,] B, T, 4H), c and dh
    ([ndir,] B, T, H), w_hh ([ndir,] H, 4H). Returns dz ([ndir,] B, T, 4H)."""
    import torch

    stacked = gates.dim() == 4
    outs = []
    for z_all, c_all, dh_all, w in zip(*(x if stacked else x[None] for x in (gates, c, dh, w_hh))):
        b, t, g = z_all.shape
        hidden = g // 4
        units = hidden // ctas
        # each CTA's columns, gate-major as the kernel keeps them: gate * H + c * U + u
        cols = [sorted(s) for s in geometry.cluster_slices(hidden, ctas)]
        w_slices = [w[:, cs] for cs in cols]  # loaded once, before the time loop
        share = 4 * units // SHARES
        # part[buf][owner][source]: source CTA's partial of dh_next for owner's units
        part = [[[z_all.new_full((b, units), float("nan")) for _ in range(ctas)] for _ in range(ctas)]
                for _ in range(2)]
        dc_next = [z_all.new_zeros(b, units) for _ in range(ctas)]
        dz = z_all.new_empty(b, t, g)
        for step in range(t - 1, -1, -1):
            buf = step & 1  # written at this step, read at the next (step - 1)
            dz_s = []
            for cta in range(ctas):
                own = slice(cta * units, (cta + 1) * units)
                carry = z_all.new_zeros(b, units)
                if step < t - 1:
                    for q in range(ctas):  # rank order
                        carry = carry + part[buf ^ 1][cta][q]
                d = dh_all[:, step, own] + carry
                i, f, gg, o = z_all[:, step, cols[cta]].reshape(b, 4, units).unbind(1)
                i, f, o, gg = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o), torch.tanh(gg)
                tc = torch.tanh(c_all[:, step, own])
                cp = c_all[:, step - 1, own] if step > 0 else torch.zeros_like(tc)
                do = d * tc
                dc = d * o * (1.0 - tc * tc) + dc_next[cta]
                dzc = torch.cat([dc * gg * i * (1 - i), dc * cp * f * (1 - f), dc * i * (1 - gg * gg),
                                 do * o * (1 - o)], dim=1)
                dc_next[cta] = dc * f
                dz[:, step, cols[cta]] = dzc
                dz_s.append(dzc)
            for owner in range(ctas):  # every CTA has read this buffer: a stale read would now see NaN
                for q in range(ctas):
                    part[buf ^ 1][owner][q] = torch.full_like(part[buf ^ 1][owner][q], float("nan"))
            if step == 0:
                break
            for cta in range(ctas):
                partial = z_all.new_zeros(b, hidden)
                for s in range(SHARES):  # the lanes of input k, added in order
                    js = slice(s * share, (s + 1) * share)
                    partial = partial + dz_s[cta][:, js] @ w_slices[cta][:, js].t()
                for owner in range(ctas):  # the reduce-scatter over distributed shared memory
                    part[buf][owner][cta] = partial[:, owner * units:(owner + 1) * units]
        outs.append(dz)
    res = torch.stack(outs)
    return res if stacked else res[0]


def _port_main(tmp: Path) -> None:
    import torch

    from khmer_ocr_torch.ops.kernels.lstm import lstm_recurrence_plain
    from khmer_ocr_torch.ops.kernels.lstm_backward import lstm_adjoint_plain

    torch.set_num_threads(2)
    out = {}
    with torch.inference_mode():
        for hidden, stacked in sorted({(h, s) for h, _, s in CASES}):
            kind = _kind(hidden, stacked)
            inp = {k: torch.from_numpy(v) for k, v in _inputs(hidden, stacked).items()}
            xg, w, dh = inp["xg"], inp["w"], inp["dh"]
            h, c = lstm_recurrence_plain(xg, w, with_cell=True)
            hp = torch.cat([torch.zeros_like(h[..., :1, :]), h[..., :-1, :]], dim=-2)
            hp = hp.reshape(*h.shape[:-3], -1, hidden)  # ([ndir,] B*T, H)
            gates = (xg.reshape(*hp.shape[:-1], -1) + hp @ w).reshape(xg.shape)

            def dw_of(dz):
                return (hp.transpose(-1, -2) @ dz.reshape(*hp.shape[:-1], -1)).numpy()

            dz = lstm_adjoint_plain(gates, c, dh, w)
            out[f"dz_plain_{kind}"], out[f"dw_plain_{kind}"] = dz.numpy(), dw_of(dz)
            for hid, ctas, st in CASES:
                if (hid, st) == (hidden, stacked):
                    dz = k1b_partition(gates, c, dh, w, ctas)
                    out[f"dz_{ctas}_{kind}"], out[f"dw_{ctas}_{kind}"] = dz.numpy(), dw_of(dz)
    np.savez(tmp / "outputs.npz", **out)


if __name__ == "__main__":
    _port_main(Path(sys.argv[1]))
