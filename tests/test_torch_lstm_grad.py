"""The LSTM recurrence's training path in the PyTorch port, on the CPU.

* K1's cell-state output (``lstm_recurrence(..., with_cell=True)``, one
  direction and two stacked) against the JAX package's
  ``lstm_recurrence(..., with_cell=True)``, its Pallas kernel run in
  interpret mode.
* ``LSTMRecurrence``'s gradients (dxg, dW_hh: the gates matmul, the plain
  adjoint of kernel K1b, the dW_hh matmul) against JAX's
  ``lstm_recurrence_vjp`` (interpret mode) and against autodiff through
  ``lax.scan``, within 2e-6 x max(|ref|, 1), the tolerance of
  tests/test_pallas_lstm.py: float32 sums in another order.
* The bidirectional, length-aware ``bilstm_apply``: gradients of every
  param and of the input against JAX's ``bilstm_apply`` (scan path).
* K1b's launch geometry, and the wrappers raising where there is no card.

The torch side runs in one torch-only subprocess (this file run as a
script); torch compute followed by jitted JAX in one process can hang.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
H = 192
TOL = 2e-6
# (directions, B, T) at the flagship's hidden width
CASES = ((1, 8, 5), (2, 8, 4), (1, 16, 3))
BI = dict(b=3, t=9, d=32, lengths=(9, 5, 2))  # bilstm_apply at hidden 16
RAISES = ("with_cell_on_meta", "adjoint_on_meta", "autograd_on_meta")


def _inputs(ndir, b, t, seed):
    r = np.random.RandomState(seed)
    lead = (ndir,) if ndir == 2 else ()
    return dict(xg=(r.randn(*lead, b, t, 4 * H) * 0.3).astype(np.float32),
                w=(r.randn(*lead, H, 4 * H) * 0.05).astype(np.float32),
                dh=r.randn(*lead, b, t, H).astype(np.float32))


def _bi_inputs():
    r = np.random.RandomState(7)
    d, hid = BI["d"], BI["d"] // 2
    p = {dr: {"w_ih": r.uniform(-0.25, 0.25, (d, 4 * hid)), "w_hh": r.uniform(-0.25, 0.25, (hid, 4 * hid)),
              "b_ih": r.uniform(-0.25, 0.25, 4 * hid), "b_hh": r.uniform(-0.25, 0.25, 4 * hid)} for dr in ("fw", "bw")}
    p = {dr: {k: v.astype(np.float32) for k, v in q.items()} for dr, q in p.items()}
    x = r.randn(BI["b"], BI["t"], d).astype(np.float32)
    g = r.randn(BI["b"], BI["t"], d).astype(np.float32)
    return p, x, g


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), f"max |diff| {err:.3e} > {tol} x max(1, |ref|)"


if __name__ != "__main__":
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    @pytest.fixture(scope="module")
    def port(tmp_path_factory):
        tmp = tmp_path_factory.mktemp("torch_lstm_grad")
        subprocess.run([sys.executable, __file__, str(tmp)], cwd=REPO, check=True, timeout=300)
        with np.load(tmp / "out.npz") as z:
            out = {k: z[k] for k in z.files}
        return out, json.loads((tmp / "raised.json").read_text())

    @pytest.fixture
    def interpret(monkeypatch):
        orig = pl.pallas_call
        monkeypatch.setattr(pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True}))

    def _per_direction(fn, xg, w):
        """fn over each direction of a stacked input, stacked back."""
        if xg.ndim == 4:
            outs = [fn(jnp.asarray(x), jnp.asarray(v)) for x, v in zip(xg, w)]
            return tuple(np.stack([np.asarray(o[i]) for o in outs]) for i in range(len(outs[0])))
        return tuple(np.asarray(o) for o in fn(jnp.asarray(xg), jnp.asarray(w)))

    def _scan(xg, w):
        from khmer_ocr_tpu.models.bilstm import _cell_factory

        h0 = jnp.zeros((xg.shape[0], H), jnp.float32)
        (_, _), hs = jax.lax.scan(_cell_factory(w), (h0, h0), xg.transpose(1, 0, 2))
        return hs.transpose(1, 0, 2)

    @pytest.mark.parametrize("case", range(len(CASES)))
    def test_forward_with_cells_matches_jax_kernel(port, interpret, case):
        import khmer_ocr_tpu.ops.pallas.lstm as L

        inp = _inputs(*CASES[case], seed=case)
        h_ref, c_ref = _per_direction(lambda x, w: L.lstm_recurrence(x, w, H, with_cell=True), inp["xg"], inp["w"])
        _close(port[0][f"h_{case}"], h_ref, 1e-5)
        _close(port[0][f"c_{case}"], c_ref, 1e-5)

    @pytest.mark.parametrize("case", range(len(CASES)))
    def test_autograd_matches_jax_custom_vjp(port, interpret, case):
        import khmer_ocr_tpu.ops.pallas.lstm as L

        inp = _inputs(*CASES[case], seed=case)

        def vjp(x, w, dh):
            return jax.grad(lambda x, w: (L.lstm_recurrence_vjp(x, w, H) * dh).sum(), argnums=(0, 1))(x, w)

        dh = inp["dh"]
        if inp["xg"].ndim == 4:
            grads = [vjp(jnp.asarray(x), jnp.asarray(w), jnp.asarray(d)) for x, w, d in zip(inp["xg"], inp["w"], dh)]
            refs = [np.stack([np.asarray(g[i]) for g in grads]) for i in range(2)]
        else:
            refs = [np.asarray(g) for g in vjp(jnp.asarray(inp["xg"]), jnp.asarray(inp["w"]), jnp.asarray(dh))]
        _close(port[0][f"dxg_{case}"], refs[0])
        _close(port[0][f"dw_{case}"], refs[1])

    @pytest.mark.parametrize("case", range(len(CASES)))
    def test_autograd_matches_scan_autodiff(port, case):
        inp = _inputs(*CASES[case], seed=case)

        def grads(x, w, dh):
            return jax.grad(lambda x, w: (_scan(x, w) * dh).sum(), argnums=(0, 1))(x, w)

        if inp["xg"].ndim == 4:
            gs = [grads(jnp.asarray(x), jnp.asarray(w), jnp.asarray(d))
                  for x, w, d in zip(inp["xg"], inp["w"], inp["dh"])]
            refs = [np.stack([np.asarray(g[i]) for g in gs]) for i in range(2)]
        else:
            refs = [np.asarray(g) for g in grads(jnp.asarray(inp["xg"]), jnp.asarray(inp["w"]),
                                                 jnp.asarray(inp["dh"]))]
        _close(port[0][f"dxg_{case}"], refs[0])
        _close(port[0][f"dw_{case}"], refs[1])

    def test_bilstm_length_aware_gradients(port):
        """concat(forward, length-aware backward) with rows of lengths 9, 5, 2:
        the output and the gradients of x and every param of both directions."""
        from khmer_ocr_tpu.models.bilstm import bilstm_apply

        p, x, g = _bi_inputs()
        lengths = jnp.asarray(BI["lengths"], jnp.int32)

        def loss(p, x):
            return (bilstm_apply(p, x, lengths, use_pallas=False) * g).sum()

        out = np.asarray(bilstm_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), lengths, use_pallas=False))
        _close(port[0]["bi_out"], out)
        gp, gx = jax.grad(loss, argnums=(0, 1))(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
        _close(port[0]["bi_dx"], gx)
        for dr in ("fw", "bw"):
            for k in ("w_ih", "w_hh", "b_ih", "b_hh"):
                _close(port[0][f"bi_d_{dr}_{k}"], gp[dr][k])

    @pytest.mark.parametrize("case", RAISES)
    def test_wrappers_raise_without_a_card(port, case):
        assert port[1][case].startswith("RuntimeError"), port[1][case]

    @pytest.mark.parametrize("batch,ndir,rows", [(32, 2, 1), (8, 2, 1), (1, 1, 1), (66, 2, 1), (67, 2, 2),
                                                 (256, 2, 4), (1024, 2, 8), (4096, 2, 8)])
    def test_k1b_rows(batch, ndir, rows):
        """The fewest rows a CTA that keep every CTA on its own SM."""
        from khmer_ocr_torch.ops.kernels.geometry import k1b_rows

        assert k1b_rows(batch, ndir) == rows


def _port_main(tmp: Path) -> None:
    sys.path.insert(0, str(REPO))
    import torch

    from khmer_ocr_torch.models.bilstm import bilstm_apply
    from khmer_ocr_torch.ops.kernels import lstm as K
    from khmer_ocr_torch.ops.kernels import lstm_backward as KB

    torch.set_num_threads(2)
    t = torch.from_numpy
    out = {}
    for case, shape in enumerate(CASES):
        inp = _inputs(*shape, seed=case)
        h, c = K.lstm_recurrence(t(inp["xg"]), t(inp["w"]), with_cell=True)
        out[f"h_{case}"], out[f"c_{case}"] = h.numpy(), c.numpy()
        xg, w = t(inp["xg"]).requires_grad_(True), t(inp["w"]).requires_grad_(True)
        dxg, dw = torch.autograd.grad(K.LSTMRecurrence.apply(xg, w), (xg, w), t(inp["dh"]))
        out[f"dxg_{case}"], out[f"dw_{case}"] = dxg.numpy(), dw.numpy()
    p, x, g = _bi_inputs()
    tp = {dr: {k: t(v).requires_grad_(True) for k, v in q.items()} for dr, q in p.items()}
    tx = t(x).requires_grad_(True)
    y = bilstm_apply(tp, tx, torch.tensor(BI["lengths"]))
    leaves = [tx] + [tp[dr][k] for dr in ("fw", "bw") for k in ("w_ih", "w_hh", "b_ih", "b_hh")]
    grads = torch.autograd.grad(y, leaves, t(g))
    out["bi_out"], out["bi_dx"] = y.detach().numpy(), grads[0].numpy()
    for (dr, k), gr in zip([(dr, k) for dr in ("fw", "bw") for k in ("w_ih", "w_hh", "b_ih", "b_hh")], grads[1:]):
        out[f"bi_d_{dr}_{k}"] = gr.numpy()
    np.savez(tmp / "out.npz", **out)

    meta = dict(device="meta")
    raised = {}
    calls = {
        "with_cell_on_meta": lambda: K.lstm_recurrence(torch.empty(1, 4, 768, **meta), torch.empty(192, 768, **meta),
                                                       with_cell=True),
        "adjoint_on_meta": lambda: KB.lstm_adjoint(torch.empty(2, 1, 4, 768, **meta), torch.empty(2, 1, 4, 192, **meta),
                                                   torch.empty(2, 1, 4, 192, **meta), torch.empty(2, 192, 768, **meta)),
        "autograd_on_meta": lambda: K.LSTMRecurrence.apply(torch.empty(1, 4, 768, requires_grad=True, **meta),
                                                           torch.empty(192, 768, **meta)),
    }
    for name, fn in calls.items():
        try:
            fn()
            raised[name] = "returned"
        except Exception as e:  # recorded and asserted on by the tests
            raised[name] = f"{type(e).__name__}: {e}"
    (tmp / "raised.json").write_text(json.dumps(raised))


if __name__ == "__main__":
    _port_main(Path(sys.argv[1]))
