"""Data-parallel training and serving in the PyTorch port (parallel/mesh.py), on the CPU over gloo.

Ranks are separate torch-only processes (this file run as a script), 2 and
4 of them, each group meeting through a ``FileStore`` in the test's
temporary directory (no TCP port: several test workers share the machine);
one more process computes the one-process references. All run at once;
this process only compares their outputs. Checked against the one-process
step on the whole batch:

  * one train step at tests/test_torch_train.py's toy widths (se_vgg with
    the BiLSTM, dropout 0), the global batch of 8 lines of 1 and 2 chunks
    with labels of different lengths, so the ranks' shards hold different
    numbers of targets (unequal padding), in float64 on the "chunks"
    layout: the summed gradients and the new BatchNorm statistics within
    1e-12 x max(1, |ref|), the params after Adam within 1e-9 (Adam's first
    step divides by |g| + 1e-8: it scales a gradient's rounding by up to
    lr / 1e-8), the loss within 1e-6 relative (``loss_fn`` takes its
    log-softmax in float32 whatever the params' type). float64 makes every
    difference one of summation order: in float32 a max-pool window whose
    two values lie within rounding routes a whole gradient term to either
    (tests/test_torch_train.py), and Adam's first step then turns a gradient
    near 0 into +-lr. The same step in float32 on the "lines" layout: the
    loss within 1e-5 relative, the statistics within 1e-6 of the float64
    one-process step's (PyTorch's float32 BatchNorm on the CPU, the
    one-process path, is itself 4e-5 off its float64 statistics here; the
    group's two-pass sums are 3e-8 off);
  * every rank's params after the step are bit-identical (replicated);
  * ``batch_norm`` under the group against the one-process BatchNorm on
    the concatenated batch: output, gradients of x (per rank) and of the
    scale and bias (summed over the ranks) within 1e-5 x max(1, |ref|),
    the running pair within 1e-6;
  * ``Predictor(process_group=)``: the strings and tokens of 7 lines at
    batch 5 over batch buckets (1, 3, 5) (odd batches, padded to the world
    size) identical to one process's, greedy and beam 3; at batch 1 through
    the in-flight pipeline with ``max_inflight_batches`` 1, the one
    process's strings and tokens, at most two batches in flight;
  * ``train()`` over the group: one epoch of 8 lines at batch 4 (3 steps:
    the bucket tails are padded) leaves every
    rank's params bit-identical, rank 0 alone writes the metrics and the
    checkpoint, and the epoch's mean loss is the one-process run's within
    1e-5 relative;
  * ``data_shard`` pads by repeating the last row and cuts in rank order;
    ``train/cli.py --data-parallel`` without torchrun's environment raises.
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
WORLDS = (2, 4)
TOY = dict(vocab_size=124, emb_dim=64, num_heads=4, enc_layers=1, dec_layers=1, enc_ffn_dim=128,
           max_global_len=512, decode_max_len=64, dropout=0.0)  # tests/test_torch_train.py's TOY
SERVE = dict(emb_dim=32, num_heads=4, enc_layers=1, dec_layers=1, enc_ffn_dim=64, max_global_len=512,
             decode_max_len=24)
LR = 1e-3
N_LINES = 7


def toy_batch() -> dict:
    """8 lines of 1 and 2 chunks in the 2-chunk bucket, uint8 "lines" layout,
    labels of 2 to 15 targets padded to 16 (the shards' target counts differ)."""
    from khmer_ocr_torch.config import PreprocessConfig
    from khmer_ocr_torch.data.synthetic import synthetic_samples
    from khmer_ocr_torch.tokenizer import Tokenizer

    pre, tok = PreprocessConfig(), Tokenizer()
    counts = [1, 2, 2, 1, 2, 1, 1, 2]
    wb = pre.chunk_stride + pre.chunk_width
    lines = np.full((8, pre.img_height, wb), 255, np.uint8)
    widths = np.zeros(8, np.int32)
    labels = np.zeros((8, 16), np.int32)
    for i, (line, text) in enumerate(synthetic_samples(counts, 5)):
        widths[i] = min(line.shape[1], wb)
        lines[i, :, :widths[i]] = line[:, :widths[i]]
        ids = tok.encode(text[:[1, 13, 4, 9, 2, 14, 6, 3][i]])
        labels[i, :len(ids)] = ids
    return {"lines": lines, "widths": widths, "chunk_counts": np.array(counts, np.int32), "labels": labels}


def chunks64(batch: dict) -> dict:
    """The "chunks" layout of a lines batch in float64."""
    unit = batch["lines"].astype(np.float64) / 255.0
    chunks = np.stack([unit[:, :, x:x + 100] for x in range(0, unit.shape[2] - 100 + 1, 84)], axis=1)
    return {"chunks": (chunks - 0.5) / 0.5, "chunk_counts": batch["chunk_counts"], "labels": batch["labels"]}


def _load(path: Path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


if __name__ != "__main__":

    @pytest.fixture(scope="module")
    def runs(tmp_path_factory):
        tmp = tmp_path_factory.mktemp("torch_parallel")
        env = {**os.environ, "OMP_NUM_THREADS": "1"}
        cmds = [[sys.executable, __file__, "ref", str(tmp)]] + [
            [sys.executable, __file__, "rank", str(tmp), str(w), str(r)] for w in WORLDS for r in range(w)]
        procs = [subprocess.Popen(c, cwd=REPO, env=env) for c in cmds]
        try:
            assert [p.wait(timeout=600) for p in procs] == [0] * len(procs), "a rank or the reference failed"
        finally:
            for p in procs:
                p.kill()
        ranks = {(w, r): _load(tmp / f"rank{w}_{r}.npz") for w in WORLDS for r in range(w)}
        meta = {(w, r): json.loads((tmp / f"rank{w}_{r}.json").read_text()) for w in WORLDS for r in range(w)}
        return {"ref": _load(tmp / "ref.npz"), "ref_meta": json.loads((tmp / "ref.json").read_text()),
                "ranks": ranks, "meta": meta, "tmp": tmp}

    def _close(got, ref, tol, name):
        err = np.abs(got - ref).max() if got.size else 0.0
        assert err <= tol * max(1.0, np.abs(ref).max() if ref.size else 0.0), (name, err)

    @pytest.mark.parametrize("world", WORLDS)
    def test_train_step_float64_equals_one_process(runs, world):
        ref, got = runs["ref"], runs["ranks"][(world, 0)]
        assert abs(float(got["f64/loss"]) - float(ref["f64/loss"])) <= 1e-6 * abs(float(ref["f64/loss"]))
        for prefix, tol in (("f64/grad/", 1e-12), ("f64/stats/", 1e-12), ("f64/params/", 1e-9)):
            keys = [k for k in ref if k.startswith(prefix)]
            assert len(keys) > 10 and all(k in got for k in keys)
            for k in keys:
                _close(got[k], ref[k], tol, k)

    @pytest.mark.parametrize("world", WORLDS)
    def test_train_step_float32_loss_and_statistics(runs, world):
        ref, got = runs["ref"], runs["ranks"][(world, 0)]
        assert abs(float(got["f32/loss"]) - float(ref["f32/loss"])) <= 1e-5 * abs(float(ref["f32/loss"]))
        for k in (k for k in ref if k.startswith("f32/stats/")):
            _close(got[k], ref["f64" + k[3:]], 1e-6, k)

    @pytest.mark.parametrize("world", WORLDS)
    def test_shards_hold_unequal_target_counts(runs, world):
        counts = [runs["meta"][(world, r)]["targets"] for r in range(world)]
        assert len(set(counts)) > 1 and sum(counts) == runs["ref_meta"]["targets"]

    @pytest.mark.parametrize("world", WORLDS)
    def test_params_stay_replicated(runs, world):
        for prefix in ("f64/params/", "f32/params/"):
            r0 = runs["ranks"][(world, 0)]
            for r in range(1, world):
                other = runs["ranks"][(world, r)]
                for k in (k for k in r0 if k.startswith(prefix)):
                    np.testing.assert_array_equal(other[k], r0[k], err_msg=f"rank {r} {k}")

    @pytest.mark.parametrize("world", WORLDS)
    def test_global_batch_norm_equals_one_process(runs, world):
        ref = runs["ref"]
        shards = [runs["ranks"][(world, r)] for r in range(world)]
        for name in ("y", "dx"):
            _close(np.concatenate([s[f"bn/{name}"] for s in shards]), ref[f"bn/{name}"], 1e-5, name)
        for name in ("dscale", "dbias"):
            _close(sum(s[f"bn/{name}"] for s in shards), ref[f"bn/{name}"], 1e-5, name)
        for name in ("mean", "var"):
            for s in shards:
                _close(s[f"bn/{name}"], ref[f"bn/{name}"], 1e-6, name)

    @pytest.mark.parametrize("beam", [1, 3], ids=["greedy", "beam3"])
    @pytest.mark.parametrize("world", WORLDS)
    def test_predictor_process_group_equals_one_process(runs, world, beam):
        ref = runs["ref_meta"][f"serve_{beam}"]
        assert len(ref["strings"]) == N_LINES
        for r in range(world):
            got = runs["meta"][(world, r)][f"serve_{beam}"]
            assert got["strings"] == ref["strings"] and got["tokens"] == ref["tokens"], f"rank {r}"

    @pytest.mark.parametrize("world", WORLDS)
    def test_predictor_pipeline_over_the_group_equals_one_process(runs, world):
        """Every rank serving the 7 lines a batch a line through the
        in-flight pipeline (``max_inflight_batches`` 1: the dispatch stage
        runs a batch ahead, the decode stage gathers each batch's rows in
        order): the one process's strings at batch 5, and its tokens."""
        ref = runs["ref_meta"]["serve_pipeline"]
        assert ref["strings"] == runs["ref_meta"]["serve_3"]["strings"]
        for r in range(world):
            got = runs["meta"][(world, r)]["serve_pipeline"]
            assert got["strings"] == ref["strings"] and got["tokens"] == ref["tokens"], f"rank {r}"
            assert 1 <= got["high"] <= 2, got

    @pytest.mark.parametrize("world", WORLDS)
    def test_train_loop_over_the_group(runs, world):
        metas = [runs["meta"][(world, r)]["loop"] for r in range(world)]
        assert all(m["steps"] == runs["ref_meta"]["loop"]["steps"] == 3 for m in metas)  # 2 full batches, 1 tail
        assert len({m["params_digest"] for m in metas}) == 1
        assert [m["wrote_metrics"] for m in metas] == [True] + [False] * (world - 1)
        assert metas[0]["checkpoints"] == ["epoch001"]
        ref_loss = runs["ref_meta"]["loop"]["mean_loss"]
        assert abs(metas[0]["mean_loss"] - ref_loss) <= 1e-5 * ref_loss

    @pytest.mark.parametrize("b,world", [(5, 2), (8, 4), (3, 4), (1, 2)])
    def test_data_shard_pads_and_cuts_in_rank_order(b, world):
        from khmer_ocr_torch.parallel.mesh import data_shard

        batch = {"x": np.arange(b * 3).reshape(b, 3), "y": np.arange(b)}
        shards = [data_shard(batch, r, world) for r in range(world)]
        per = -(-b // world)
        assert all(len(s["x"]) == len(s["y"]) == per for s in shards)
        whole = np.concatenate([s["y"] for s in shards])
        np.testing.assert_array_equal(whole, np.concatenate([np.arange(b), np.full(per * world - b, b - 1)]))

    def test_data_parallel_cli_without_a_group_raises(runs):
        assert runs["ref_meta"]["cli_without_group"].startswith("RuntimeError")
        assert "torchrun" in runs["ref_meta"]["cli_without_group"]


# ---------------------------------------------------------------------------
# the ranks and the reference (torch only)
# ---------------------------------------------------------------------------


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, prefix + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, prefix + (i,)).items()}
    return {"/".join(map(str, prefix)): tree.detach().cpu().numpy()}


def _run(tmp: Path, world: int, rank: int) -> None:
    """One rank's work (``world`` 1: the one-process reference)."""
    import hashlib

    sys.path.insert(0, str(REPO))
    import torch
    import torch.distributed as dist

    from khmer_ocr_torch.config import ModelConfig, OCRConfig, RuntimeConfig, TrainConfig
    from khmer_ocr_torch.convert.from_jax import seeded_params, trainable_from_jax
    from khmer_ocr_torch.data.synthetic import synthetic_lines, synthetic_samples
    from khmer_ocr_torch.infer.predictor import Predictor
    from khmer_ocr_torch.models.backbones import batch_norm
    from khmer_ocr_torch.parallel.mesh import data_shard
    from khmer_ocr_torch.train.data import LineDataset
    from khmer_ocr_torch.train.loop import train
    from khmer_ocr_torch.train.step import batch_to_device, make_train_step, state_from, tree_leaves

    torch.set_num_threads(1)
    group = None
    if world > 1:
        dist.init_process_group("gloo", store=dist.FileStore(str(tmp / f"store{world}"), world), rank=rank,
                                world_size=world)
        group = dist.group.WORLD
    shard = lambda b: data_shard(b, rank, world)  # noqa: E731
    out, meta = {}, {}

    # one train step, float64 "chunks" and float32 "lines"
    cfg = ModelConfig(**TOY)
    base = trainable_from_jax(*seeded_params(cfg, 3), cfg)
    meta["targets"] = int((shard(toy_batch())["labels"][:, 1:] != cfg.pad_idx).sum())
    for tag, cast, batch in (("f64", torch.float64, chunks64(toy_batch())), ("f32", torch.float32, toy_batch())):
        state = state_from(*(_map(lambda t: t.detach().to(cast), tree) for tree in base))
        step = make_train_step(cfg, group=group)
        grads_seen = []
        real_grad = torch.autograd.grad

        def spy(loss, inputs, **kw):  # the gradients Adam receives: summed over the group after this
            g = real_grad(loss, inputs, **kw)
            grads_seen.append(g)
            return g

        torch.autograd.grad = spy
        state, m = step(state, batch_to_device(shard(batch), "cpu"), torch.Generator().manual_seed(0), LR)
        torch.autograd.grad = real_grad
        out[f"{tag}/loss"] = m["loss"].numpy()
        out.update({f"{tag}/params/{k}": v for k, v in _flat(state.params).items()})
        out.update({f"{tag}/stats/{k}": v for k, v in _flat(state.batch_stats).items()})
        it = iter(grads_seen[0])
        out.update({f"{tag}/grad/{k}": v for k, v in _flat(_map(lambda _: next(it), state.params)).items()})

    # BatchNorm under the group, forward and backward
    rs = np.random.RandomState(1)
    x_all = rs.standard_normal((8, 6, 5, 7)).astype(np.float32) * 2 + 0.5
    w_all = rs.standard_normal((8, 6, 5, 7)).astype(np.float32)
    p = {"scale": torch.tensor(rs.rand(6).astype(np.float32) + 0.5, requires_grad=True),
         "bias": torch.tensor(rs.standard_normal(6).astype(np.float32), requires_grad=True)}
    s = {"mean": torch.tensor(rs.standard_normal(6).astype(np.float32)),
         "var": torch.tensor(rs.rand(6).astype(np.float32) + 0.5)}
    x = torch.tensor(shard({"x": x_all})["x"], requires_grad=True)
    y, ns = batch_norm(p, s, x, train=True, group=group)
    dx, dscale, dbias = torch.autograd.grad((y * torch.tensor(shard({"w": w_all})["w"])).sum(), [x, p["scale"],
                                                                                               p["bias"]])
    out.update({"bn/y": y.detach().numpy(), "bn/dx": dx.numpy(), "bn/dscale": dscale.numpy(),
                "bn/dbias": dbias.numpy(), "bn/mean": ns["mean"].numpy(), "bn/var": ns["var"].numpy()})

    # serving: 7 lines at batch 5 over batch buckets (1, 3, 5)
    scfg = ModelConfig(**SERVE)
    params, stats = seeded_params(scfg, 2)
    ocfg = OCRConfig(runtime=RuntimeConfig(batch_buckets=(1, 3, 5)))
    pred = Predictor(params=params, batch_stats=stats, model_cfg=scfg, device="cpu", config=ocfg,
                     process_group=group)
    lines = synthetic_lines([1, 2, 1, 3, 2, 1, 2], seed=4)
    for beam in (1, 3):
        tokens = pred.predict_batch_tokens(lines, beam_width=beam, batch_size=5)
        meta[f"serve_{beam}"] = {"strings": [pred.tokenizer.decode(t) for t in tokens],
                                 "tokens": [t.tolist() for t in tokens]}
    # the same lines through the in-flight pipeline, a batch a line, at most two batches in flight
    pipe = Predictor(params=params, batch_stats=stats, model_cfg=scfg, device="cpu", process_group=group,
                     config=OCRConfig(runtime=RuntimeConfig(batch_buckets=(1, 3, 5), max_inflight_batches=1)))
    tokens = pipe.predict_batch_tokens(lines, beam_width=3, batch_size=1)
    meta["serve_pipeline"] = {"strings": [pipe.tokenizer.decode(t) for t in tokens],
                              "tokens": [t.tolist() for t in tokens], "high": pipe.max_batches_in_flight}

    # train() over the group: one epoch of 8 lines at batch 4
    lcfg = OCRConfig(model=ModelConfig(**{**SERVE, "dropout": 0.0}),
                     train=TrainConfig(batch_size=4, epoch_sample_size=8, checkpoint_every_epochs=1))
    ds = LineDataset(synthetic_samples([1, 2, 1, 1, 2, 2, 1, 1], 6), train_cfg=lcfg.train)
    run_dir = tmp / f"loop{world}"
    state = train(ds, lcfg, run_dir, device="cpu", num_epochs=1, metrics_path=run_dir.with_suffix(f".{rank}.jsonl"),
                  process_group=group)
    digest = hashlib.sha256(b"".join(t.detach().numpy().tobytes() for t in tree_leaves(state.params))).hexdigest()
    metrics = run_dir.with_suffix(f".{rank}.jsonl")
    meta["loop"] = {"steps": state.step, "params_digest": digest, "wrote_metrics": metrics.exists(),
                    "mean_loss": json.loads(metrics.read_text())["mean_loss"] if metrics.exists() else None,
                    "checkpoints": sorted(p.name for p in run_dir.iterdir()) if run_dir.exists() else []}

    if world == 1:
        from khmer_ocr_torch.train import cli

        for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
            os.environ.pop(var, None)
        try:
            cli.main(["--synthetic", "2", "--data-parallel", "--device", "cpu", "--checkpoint-dir", str(tmp / "cli")])
            meta["cli_without_group"] = "returned"
        except Exception as e:  # asserted on by the test
            meta["cli_without_group"] = f"{type(e).__name__}: {e}"
    else:
        dist.barrier()
        dist.destroy_process_group()
    name = "ref" if world == 1 else f"rank{world}_{rank}"
    np.savez(tmp / f"{name}.npz", **out)
    (tmp / f"{name}.json").write_text(json.dumps(meta))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


if __name__ == "__main__":
    if sys.argv[1] == "ref":
        _run(Path(sys.argv[2]), 1, 0)
    else:
        _run(Path(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
