"""The port's vgg and resnet backbones against the JAX package, on the CPU.

The reference's two baseline families run without the BiLSTM. For each:
  * ``vgg_apply``/``resnet_apply`` on a (3, 48, 100, 1) chunk batch against
    the JAX functions, with non-trivial BatchNorm statistics (the seeded
    weights' scale, bias, mean and var): within 1e-5 x max(1, |ref|), the
    spread of float32 convolution sums taken in another order;
  * ``params_from_jax`` on the JAX ``init_model`` trees consumes every leaf
    (it raises on a missing, extra or misshapen one);
  * ``encode`` memory against the JAX ``encode``, with bucket padding:
    within 1e-4 x max(1, |ref|), a backbone, the patch projection and an
    encoder layer later;
  * ``seeded_params`` makes the JAX layout exactly (same leaves, same
    shapes) and its weights encode to finite memory.

The port side runs once in a torch-only subprocess (this file run as a
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
BACKBONES = ("vgg", "resnet")
CFG = dict(emb_dim=64, num_heads=4, enc_layers=1, dec_layers=1, enc_ffn_dim=128, max_global_len=256,
           decode_max_len=16, use_bilstm=False)
COUNTS = (2, 3)  # chunk counts of the two encoded lines; both pad to N = 3


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), f"max |diff| {err:.3e} > {tol} x max(1, |ref|)"


if __name__ != "__main__":
    import jax
    import jax.numpy as jnp

    from khmer_ocr_torch.config import ModelConfig as PortModelConfig
    from khmer_ocr_torch.convert.from_jax import _flatten, save_npz, seeded_params

    @pytest.fixture(scope="module")
    def port(tmp_path_factory):
        """Save the inputs and trees, run the port side once, return its outputs."""
        from khmer_ocr_tpu.config import ModelConfig
        from khmer_ocr_tpu.models.ocr_model import init_model

        tmp = tmp_path_factory.mktemp("torch_backbones")
        r = np.random.RandomState(0)
        inp = {"chunks": r.uniform(-1, 1, size=(3, 48, 100, 1)).astype(np.float32),
               "enc_chunks": r.uniform(-1, 1, size=(2, 3, 48, 100)).astype(np.float32),
               "enc_counts": np.array(COUNTS, np.int32)}
        np.savez(tmp / "inputs.npz", **inp)
        trees = {}
        for name in BACKBONES:
            trees[f"seeded_{name}"] = seeded_params(PortModelConfig(backbone=name, **CFG), 1)
            p, s = init_model(jax.random.PRNGKey(2), ModelConfig(backbone=name, **CFG))
            trees[f"init_{name}"] = (jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, s))
        for key, (p, s) in trees.items():
            save_npz(tmp / f"{key}.npz", p, s)
        subprocess.run([sys.executable, __file__, str(tmp)], cwd=REPO, check=True, timeout=600)
        with np.load(tmp / "outputs.npz") as z:
            out = {k: z[k] for k in z.files}
        return {"out": out, "inp": inp, "trees": trees, "meta": json.loads((tmp / "outputs.json").read_text())}

    @pytest.mark.parametrize("name", BACKBONES)
    def test_backbone_apply(port, name):
        from khmer_ocr_tpu.models.backbones import BACKBONE_APPLY

        p, s = port["trees"][f"seeded_{name}"]
        with jax.default_matmul_precision("highest"):
            ref, _ = jax.jit(lambda p, s, x: BACKBONE_APPLY[name](p, s, x))(p["backbone"], s, port["inp"]["chunks"])
        assert ref.shape == (3, 2, 32, 512)
        _close(port["out"][f"backbone_{name}"], ref, 1e-5)

    @pytest.mark.parametrize("name", BACKBONES)
    def test_params_from_jax_consumes_init_model_tree(port, name):
        """Every leaf of the JAX init_model trees is taken, and the port's state
        has the same number of values."""
        p, s = port["trees"][f"init_{name}"]
        n_leaves = sum(int(np.prod(v.shape)) for v in list(_flatten(p).values()) + list(_flatten(s).values()))
        assert port["meta"][f"init_{name}"] == {"error": None, "values": n_leaves}

    @pytest.mark.parametrize("name", BACKBONES)
    def test_encode_memory(port, name):
        from khmer_ocr_tpu.config import ModelConfig
        from khmer_ocr_tpu.models.layers import Ctx
        from khmer_ocr_tpu.models.ocr_model import encode

        cfg = ModelConfig(backbone=name, **CFG)
        p, s = port["trees"][f"init_{name}"]
        ctx = Ctx(num_heads=cfg.num_heads, dropout=0.0, deterministic=True)
        with jax.default_matmul_precision("highest"):
            mem, pad, _ = jax.jit(lambda p, s, c, n: encode(p, s, c, n, cfg, ctx))(
                p, s, jnp.asarray(port["inp"]["enc_chunks"]), jnp.asarray(port["inp"]["enc_counts"]))
        np.testing.assert_array_equal(port["out"][f"enc_pad_{name}"], np.asarray(pad))
        valid = ~np.asarray(pad)
        _close(port["out"][f"enc_memory_{name}"][valid], np.asarray(mem)[valid], 1e-4)

    @pytest.mark.parametrize("name", BACKBONES)
    def test_seeded_params(port, name):
        """The seeded trees have the JAX init_model layout, leaf for leaf, and
        their weights encode to finite memory of the expected shape."""
        shapes = lambda t: {k: tuple(np.shape(v)) for k, v in _flatten(t).items()}
        (sp, ss), (ip, is_) = port["trees"][f"seeded_{name}"], port["trees"][f"init_{name}"]
        assert shapes(sp) == shapes(ip)
        assert shapes(ss) == shapes(is_)
        assert port["meta"][f"seeded_{name}"] == {"shape": [2, 3 * 32, CFG["emb_dim"]], "finite": True}


def _port_main(tmp: Path) -> None:
    sys.path.insert(0, str(REPO))
    import torch

    from khmer_ocr_torch.config import ModelConfig
    from khmer_ocr_torch.convert.from_jax import load_npz, params_from_jax
    from khmer_ocr_torch.models.backbones import BACKBONE_APPLY
    from khmer_ocr_torch.models.ocr_model import encode

    torch.set_num_threads(2)
    t = torch.from_numpy
    with np.load(tmp / "inputs.npz") as z:
        inp = {k: z[k] for k in z.files}
    out, meta = {}, {}
    with torch.inference_mode():
        for name in BACKBONES:
            cfg = ModelConfig(backbone=name, **CFG)
            p, s, _ = load_npz(tmp / f"seeded_{name}.npz")
            seeded = params_from_jax(p, s, cfg)
            out[f"backbone_{name}"] = BACKBONE_APPLY[name](seeded["backbone"], t(inp["chunks"]))[0].numpy()
            mem, _ = encode(seeded, t(inp["enc_chunks"]), t(inp["enc_counts"]), cfg)
            meta[f"seeded_{name}"] = {"shape": list(mem.shape), "finite": bool(torch.isfinite(mem).all())}

            p, s, _ = load_npz(tmp / f"init_{name}.npz")
            try:
                state = params_from_jax(p, s, cfg)
            except ValueError as e:  # recorded and asserted on by the test
                meta[f"init_{name}"] = {"error": str(e), "values": 0}
                continue
            leaves = []
            stack = [state]
            while stack:
                node = stack.pop()
                if isinstance(node, dict):
                    stack += list(node.values())
                elif isinstance(node, list):
                    stack += node
                else:
                    leaves.append(node)
            meta[f"init_{name}"] = {"error": None, "values": sum(v.numel() for v in leaves)}
            mem, pad = encode(state, t(inp["enc_chunks"]), t(inp["enc_counts"]), cfg)
            out[f"enc_memory_{name}"], out[f"enc_pad_{name}"] = mem.numpy(), pad.numpy()
    np.savez(tmp / "outputs.npz", **out)
    (tmp / "outputs.json").write_text(json.dumps(meta))


if __name__ == "__main__":
    _port_main(Path(sys.argv[1]))
