"""The tensor-parallel model axis of the PyTorch port (parallel/mesh.py,
parallel/placement.py), on the CPU over gloo, against one process and the JAX package.

Ranks are separate torch-only processes (this file run as a script) on a
model axis of 2 (a 1 x 2 mesh) and on a 2 x 2 mesh (2 data x 2 model
ranks), each group meeting through a ``FileStore`` in the test's temporary
directory; one more process computes the one-process references. Every rank
builds its part of the seeded params (``shard_params`` on the JAX-layout
tree, ``params_from_jax(..., model_group=)``) and its data rows, and:

  * ``forward_train`` (dropout 0, eval BatchNorm) gives the logits of its
    rows: within the JAX package's own bound (atol 2e-4, rtol 1e-3,
    tests/test_parallel.py) of one process's and of JAX's replicated
    ``forward_train``;
  * in float64, the gradients of the summed cross-entropy of its rows,
    summed over its data group: each rank's part of every leaf equal to the
    one-process gradient's part within 1e-10 x max(1, |ref|) (float64
    leaves only summation order);
  * ``infer_batch`` at beam 3 and greedy (max_len 16): tokens equal to one
    process's and to JAX's ``_infer_jit`` on the whole params, exactly, as
    tests/test_parallel.py asserts for JAX's own placement;
  * the three plain blocks of a decoder layer (ops/kernels/decode_step.py::
    decoder_block) chained through ``tp_decode_layers`` with an all-reduce
    after each give the unsplit step's output within 1e-5 (float32) or
    2 bf16 steps of its largest value (bfloat16: a partial sum's rounding
    can move an output by one step), and write the local columns of the
    unsplit step's cache slot.

In the pytest process: the placement table equals JAX's ``_spec_for_path``
leaf for leaf, and ``shard_params`` cuts each split leaf into blocks that
join back to it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
MESHES = ((1, 2), (2, 2))  # (n_data, n_model)
TP = dict(vocab_size=124, emb_dim=32, num_heads=4, enc_layers=1, dec_layers=2, enc_ffn_dim=64, max_global_len=512,
          decode_max_len=24, backbone="vgg", dropout=0.0)
SEED = 6
N_LINES = 8
MAX_LEN = 16
COUNTS = [1, 2, 2, 1, 2, 1, 1, 2]


def batch() -> dict:
    """8 seeded noise lines in the 2-chunk bucket (uint8, white past each
    line's width) and labels of 3 to 8 tokens."""
    rng = np.random.RandomState(SEED)
    wb = 184
    lines = np.full((N_LINES, 48, wb), 255, np.uint8)
    for i, n in enumerate(COUNTS):
        w = 100 if n == 1 else wb
        lines[i, :, :w] = rng.randint(0, 256, (48, w))
    labels = np.zeros((N_LINES, 9), np.int64)
    for i in range(N_LINES):
        k = 3 + i % 6
        labels[i, 0] = 2
        labels[i, 1:k] = rng.randint(4, 124, k - 1)
        labels[i, k] = 3
    return {"lines": lines, "counts": np.array(COUNTS, np.int32), "labels": labels}


def _name(n_data: int, n_model: int, rank: int) -> str:
    return f"mesh{n_data}x{n_model}_r{rank}"


if __name__ != "__main__":
    import jax
    import jax.numpy as jnp

    @pytest.fixture(scope="module")
    def runs(tmp_path_factory):
        tmp = tmp_path_factory.mktemp("torch_tp")
        env = {**os.environ, "OMP_NUM_THREADS": "1"}
        cmds = [[sys.executable, __file__, "ref", str(tmp)]] + [
            [sys.executable, __file__, "rank", str(tmp), str(nd), str(nm), str(r)]
            for nd, nm in MESHES for r in range(nd * nm)]
        procs = [subprocess.Popen(c, cwd=REPO, env=env) for c in cmds]
        try:
            assert [p.wait(timeout=600) for p in procs] == [0] * len(procs), "a rank or the reference failed"
        finally:
            for p in procs:
                p.kill()
        load = lambda n: (dict(np.load(tmp / f"{n}.npz")), json.loads((tmp / f"{n}.json").read_text()))  # noqa: E731
        return {"ref": load("ref"), **{(nd, nm, r): load(_name(nd, nm, r)) for nd, nm in MESHES
                                        for r in range(nd * nm)}}

    @pytest.fixture(scope="module")
    def jax_ref():
        from khmer_ocr_torch.convert.from_jax import seeded_params
        from khmer_ocr_tpu.config import DecodeConfig, ModelConfig
        from khmer_ocr_tpu.infer.predictor import _device_chunk, _infer_jit
        from khmer_ocr_tpu.models.layers import Ctx
        from khmer_ocr_tpu.models.ocr_model import forward_train

        cfg = ModelConfig(**TP)
        params, stats = seeded_params(cfg, SEED)
        params, stats = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats)
        b = batch()
        lines, counts = jnp.asarray(b["lines"]), jnp.asarray(b["counts"])
        ctx = Ctx(num_heads=cfg.num_heads, dropout=0.0, deterministic=True)

        @jax.jit
        def logits_fn(p, s, u8, n, t):
            chunks = _device_chunk((u8.astype(jnp.float32) / 255.0 - 0.5) / 0.5, (100, 84))
            return forward_train(p, s, chunks, n, t, cfg, ctx, False)[0]

        with jax.default_matmul_precision("highest"):
            logits = np.asarray(logits_fn(params, stats, lines, counts, jnp.asarray(b["labels"][:, :-1])))
        tokens = {}
        for beam in (1, 3):
            dc = DecodeConfig(beam_width=beam, max_len=MAX_LEN)
            tokens[beam] = np.asarray(_infer_jit(params, stats, lines, counts, cfg, dc, beam > 1, "highest",
                                                 (100, 84))).tolist()
        return {"logits": logits, "tokens": tokens}

    def _rows(runs, nd, nm, key):
        """The whole batch's rows of ``key`` from model rank 0 of each data index."""
        return np.concatenate([runs[(nd, nm, d * nm)][0][key] for d in range(nd)])

    def test_placement_table_equals_jax():
        from khmer_ocr_torch.convert.from_jax import seeded_params
        from khmer_ocr_torch.parallel.placement import param_sharding
        from khmer_ocr_tpu.config import ModelConfig
        from khmer_ocr_tpu.parallel.mesh import _path_str, _spec_for_path

        params, _ = seeded_params(ModelConfig(**TP), 0)
        ours = {}

        def walk(tree, prefix):
            if isinstance(tree, dict):
                for k, v in tree.items():
                    walk(v, prefix + (k,))
            elif isinstance(tree, list):
                for i, v in enumerate(tree):
                    walk(v, prefix + (i,))
            else:
                ours[prefix] = tree

        walk(param_sharding(params), ())
        theirs = {}
        for path, leaf in jax.tree_util.tree_leaves_with_path(params):
            keys = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
            theirs[keys] = tuple(_spec_for_path(_path_str(path), leaf))
        assert ours.keys() == theirs.keys() and ours == theirs
        split = [k for k, v in ours.items() if v]
        # q, k, v, o, lin1, lin2 of each encoder layer; self and cross q, k, v, o and lin1, lin2 of each decoder
        # layer; the vocabulary projection and the token embedding
        assert len(split) == 6 * TP["enc_layers"] + 10 * TP["dec_layers"] + 2, split

    def test_shard_params_blocks_join_back():
        from khmer_ocr_torch.convert.from_jax import seeded_params
        from khmer_ocr_torch.parallel.placement import MODEL_AXIS, shard_params, spec_for_path

        from khmer_ocr_torch.config import ModelConfig

        params, _ = seeded_params(ModelConfig(**TP), 1)
        for n_model in (2, 4):
            parts = [shard_params(params, r, n_model) for r in range(n_model)]
            for path, leaf in _leaves(params):
                blocks = [_get(p, path) for p in parts]
                spec = spec_for_path(".".join(map(str, path)), leaf.ndim)
                if MODEL_AXIS in spec:
                    axis = spec.index(MODEL_AXIS)
                    assert all(b.shape[axis] == leaf.shape[axis] // n_model for b in blocks)
                    np.testing.assert_array_equal(np.concatenate(blocks, axis=axis), leaf)
                else:
                    assert all(b is leaf for b in blocks)

    @pytest.mark.parametrize("nd,nm", MESHES, ids=[f"{a}x{b}" for a, b in MESHES])
    def test_forward_train_logits_equal_one_process_and_jax(runs, jax_ref, nd, nm):
        got = _rows(runs, nd, nm, "logits")
        for r in range(nd * nm):  # the model ranks of a data index hold the same gathered logits
            d = r // nm
            np.testing.assert_array_equal(runs[(nd, nm, r)][0]["logits"], runs[(nd, nm, d * nm)][0]["logits"])
        np.testing.assert_allclose(got, runs["ref"][0]["logits"], atol=2e-4, rtol=1e-3)
        np.testing.assert_allclose(got, jax_ref["logits"], atol=2e-4, rtol=1e-3)

    @pytest.mark.parametrize("nd,nm", MESHES, ids=[f"{a}x{b}" for a, b in MESHES])
    def test_gradients_float64_equal_one_process(runs, nd, nm):
        ref = runs["ref"][0]
        keys = [k for k in ref if k.startswith("grad/")]
        assert len(keys) > 40
        for r in range(nd * nm):
            got = runs[(nd, nm, r)][0]
            m = r % nm
            for k in keys:
                part = _local_block(k[len("grad/"):], ref[k], m, nm)
                err = np.abs(got[k] - part).max() if part.size else 0.0
                assert err <= 1e-10 * max(1.0, np.abs(part).max()), (r, k, err)

    @pytest.mark.parametrize("beam", [1, 3], ids=["greedy", "beam3"])
    @pytest.mark.parametrize("nd,nm", MESHES, ids=[f"{a}x{b}" for a, b in MESHES])
    def test_infer_batch_tokens_equal_one_process_and_jax(runs, jax_ref, nd, nm, beam):
        for r in range(nd * nm):
            d = r // nm
            np.testing.assert_array_equal(runs[(nd, nm, r)][0][f"tokens{beam}"],
                                          runs[(nd, nm, d * nm)][0][f"tokens{beam}"])
        got = _rows(runs, nd, nm, f"tokens{beam}")
        np.testing.assert_array_equal(got, runs["ref"][0][f"tokens{beam}"])
        np.testing.assert_array_equal(got, np.array(jax_ref["tokens"][beam]))

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("nd,nm", [(1, 1), *MESHES], ids=["1x1", *[f"{a}x{b}" for a, b in MESHES]])
    def test_chained_blocks_equal_the_unsplit_step(runs, nd, nm, dtype):
        """1 x 1: the blocks chained over a gloo group of one rank (the
        all-reduces are the identity) on the whole params."""
        metas = [runs["ref"][1]] if nm == 1 else [runs[(nd, nm, r)][1] for r in range(nd * nm)]
        for meta in metas:
            got = meta["blocks"][dtype]
            assert got["launches"] == {"self": 1, "cross": 1, "ffn": 1, "finish": 1}
            assert got["x_err"] <= got["tol"] and got["cache_err"] <= got["tol"], got


# the helpers the tests share (numpy only)

def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _local_block(key: str, full: np.ndarray, m: int, nm: int) -> np.ndarray:
    """Model rank m's block of a port-layout leaf "a/b/c" (the split axis of
    its placement, and the biases of split columns)."""
    from khmer_ocr_torch.parallel.placement import MODEL_AXIS, spec_for_path

    parts = key.split("/")
    spec = spec_for_path(".".join(parts), full.ndim)
    if parts[-1] == "b" and spec_for_path(".".join(parts[:-1] + ["w"]), 2) == (None, MODEL_AXIS):
        spec = (MODEL_AXIS,)
    for axis, name in enumerate(spec):
        if name == MODEL_AXIS:
            n = full.shape[axis] // nm
            full = np.take(full, range(m * n, (m + 1) * n), axis=axis)
    return full


# ---------------------------------------------------------------------------
# the ranks and the reference (torch only)
# ---------------------------------------------------------------------------


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, prefix + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, prefix + (i,)).items()}
    return {"/".join(map(str, prefix)): tree}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _blocks_check(torch, full_state, local_state, cfg, group, dtype) -> dict:
    """One decoder layer at pos 5 for 2 images x 3 lanes: the unsplit plain
    step on the whole params against ``tp_decode_layers``' chained blocks on
    this rank's part (a group of one when ``group`` is None)."""
    from khmer_ocr_torch.models.layers import pack_step_params
    from khmer_ocr_torch.models.ocr_model import tp_decode_layers
    from khmer_ocr_torch.ops.kernels import decode_step as K
    from khmer_ocr_torch.parallel.mesh import world_of

    m, nm = world_of(group)
    cast = (lambda t: t.to(dtype)) if dtype != torch.float32 else (lambda t: t)
    full = K.layer_weights(pack_step_params(_map(cast, full_state["dec"]["layers"][0])))
    local = K.layer_weights(pack_step_params(_map(cast, local_state["dec"]["layers"][0])))
    d, lanes, n_img, cache_len, tm, pos = cfg.emb_dim, 3, 2, 8, 20, 5
    da = d // nm
    gen = torch.Generator().manual_seed(11)
    x = cast(torch.randn(n_img * lanes, d, generator=gen) * 0.5)
    sk = cast(torch.randn(n_img * lanes, cache_len, d, generator=gen) * 0.3)
    sv = cast(torch.randn(n_img * lanes, cache_len, d, generator=gen) * 0.3)
    mk = cast(torch.randn(n_img, tm, d, generator=gen) * 0.3)
    mv = cast(torch.randn(n_img, tm, d, generator=gen) * 0.3)
    mvf = (torch.arange(tm)[None, :] < torch.tensor([[13], [20]])).float()
    lin = torch.randint(0, lanes, (n_img * lanes, cache_len), generator=gen, dtype=torch.int32)
    cols = slice(m * da, (m + 1) * da)
    sk_l, sv_l = sk[..., cols].clone(), sv[..., cols].clone()
    state = {"self_kv": [(sk_l, sv_l)], "mem_kv": [(mk[..., cols].contiguous(), mv[..., cols].contiguous())],
             "mem_valid_f": mvf}
    ref = K.decoder_layer_step_plain(full, x, pos, sk, sv, mk, mv, mvf, lin, num_heads=cfg.num_heads,
                                     window=cache_len, lanes=lanes)
    launches = {"self": 0, "cross": 0, "ffn": 0, "finish": 0}

    def block(kind, *a, **kw):
        launches[kind] += 1
        return K.decoder_block(kind, *a, **kw)

    got = tp_decode_layers([local], state, x, pos, cfg, cache_len, lin, lanes, group, block=block)
    step = 2.0 ** -7 if dtype != torch.float32 else 0.0  # 2 bf16 steps of a value below 2
    tol = 1e-5 if dtype == torch.float32 else 2 * step * float(ref.float().abs().max())
    x_err = float((got.float() - ref.float()).abs().max())
    cache_err = max(float((sk_l[:, pos].float() - sk[:, pos, cols].float()).abs().max()),
                    float((sv_l[:, pos].float() - sv[:, pos, cols].float()).abs().max()))
    return {"x_err": x_err, "cache_err": cache_err, "tol": tol, "launches": launches}


def _run(tmp: Path, n_data: int, n_model: int, rank: int) -> None:
    sys.path.insert(0, str(REPO))
    import torch
    import torch.distributed as dist

    from khmer_ocr_torch.config import DecodeConfig, ModelConfig
    from khmer_ocr_torch.convert.from_jax import params_from_jax, seeded_params
    from khmer_ocr_torch.infer.predictor import infer_batch
    from khmer_ocr_torch.models.ocr_model import forward_train
    from khmer_ocr_torch.ops.lines import device_chunk, u8_to_unit, unit_normalize
    from khmer_ocr_torch.parallel import mesh as M

    torch.set_num_threads(1)
    cfg = ModelConfig(**TP)
    params, stats = seeded_params(cfg, SEED)
    b = batch()
    out, meta = {}, {}
    group = data_group = None
    d = 0
    if n_data * n_model > 1:
        dist.init_process_group("gloo", store=dist.FileStore(str(tmp / f"store{n_data}x{n_model}"),
                                                              n_data * n_model), rank=rank,
                                world_size=n_data * n_model)
        mesh = M.make_mesh(n_data, n_model)
        group, data_group, d = mesh.model_group, mesh.data_group, mesh.data_rank
        local = M.shard_params(params, mesh.model_rank, n_model)
    else:
        local = params
    per = N_LINES // n_data
    rows = slice(d * per, (d + 1) * per)
    state = params_from_jax(local, stats, cfg, model_group=group)
    lines = torch.from_numpy(b["lines"][rows])
    counts = torch.from_numpy(b["counts"][rows])
    labels = torch.from_numpy(b["labels"][rows])

    # forward_train logits, float32
    chunks = device_chunk(unit_normalize(u8_to_unit(lines)), (100, 84))
    with torch.no_grad():
        logits, _ = forward_train(state, None, chunks, counts, labels[:, :-1], cfg, train=False, model_group=group)
    out["logits"] = logits.numpy()

    # float64 gradients of the summed cross-entropy, summed over the data group
    s64 = _map(lambda t: t.detach().to(torch.float64).requires_grad_(True), state)
    leaves = _flat(s64)
    logits64, _ = forward_train(s64, None, chunks.double(), counts, labels[:, :-1], cfg, train=False,
                                model_group=group)
    loss = torch.nn.functional.cross_entropy(logits64.reshape(-1, logits64.shape[-1]), labels[:, 1:].reshape(-1),
                                             ignore_index=0, reduction="sum")
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    grads = [torch.zeros_like(v) if g is None else g for v, g in zip(leaves.values(), grads)]
    if data_group is not None and n_data > 1:
        M.all_reduce_sum_(grads, data_group)
    out.update({f"grad/{k}": g.numpy() for k, g in zip(leaves, grads)})

    # serving
    for beam in (1, 3):
        dc = DecodeConfig(beam_width=beam, max_len=MAX_LEN)
        out[f"tokens{beam}"] = infer_batch(state, lines, counts, cfg, dc, (100, 84), model_group=group).numpy()

    # the chained blocks against the unsplit step (the reference chains them over a gloo group of one rank)
    if group is None:
        dist.init_process_group("gloo", store=dist.FileStore(str(tmp / "store1x1"), 1), rank=0, world_size=1)
        group = dist.group.WORLD
    full = params_from_jax(params, stats, cfg)
    meta["blocks"] = {name: _blocks_check(torch, full, state, cfg, group, dt)
                      for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16))}
    dist.barrier()
    dist.destroy_process_group()
    name = "ref" if n_data * n_model == 1 else _name(n_data, n_model, rank)
    np.savez(tmp / f"{name}.npz", **out)
    (tmp / f"{name}.json").write_text(json.dumps(meta))


if __name__ == "__main__":
    if sys.argv[1] == "ref":
        _run(Path(sys.argv[2]), 1, 1, 0)
    else:
        _run(Path(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5]))
