"""The port's whole-decode beam path (kernel K3's plain version) against the
JAX package's Pallas kernel, on the CPU.

The cases of tests/test_decode_loop.py, with its TINY config (vgg backbone,
no BiLSTM, D=64, 2 decoder layers) and the same init_model weights and
memories, converted with ``params_from_jax``:
  * beam 2 and 3 at max_len 12; b=2, Tm=64, max_len 48 (padded memory); an
    <eos>-heavy case; exact ties from duplicated vocabulary columns; the gate
    through ``beam_decode(mega_mode="1")``.
  * The port's ``fused_beam_decode`` (plain, on the CPU) must give EXACTLY the
    tokens of JAX ``fused_beam_decode(..., interpret=True)``: a beam search
    is exact in tokens, and its ties resolve to the lowest index on both
    sides. (The JAX interpret runs take about 40 s in all, so no case falls
    back to JAX's XLA loop.)
  * The port's ``beam_decode`` gives the same tokens with ``mega_mode`` "1"
    (the whole decode, no early exit) and None (the host loop); so it does at
    the flagship width too (D=384, 2 images, Tm=128, max_len 16).
  * The gate: beam 5, Tm 160 and max_len 65 each route to the host loop.

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
TINY = dict(emb_dim=64, num_heads=4, enc_layers=1, dec_layers=2, enc_ffn_dim=128, max_global_len=256,
            decode_max_len=64, backbone="vgg", use_bilstm=False, vocab_size=124)
# name: (images, Tm, seed, beam, max_len, weight edit) as in tests/test_decode_loop.py
CASES = {
    "parity_beam2": (4, 32, 0, 2, 12, None),
    "parity_beam3": (4, 32, 0, 3, 12, None),
    "long_padded": (2, 64, 3, 3, 48, None),
    "eos_heavy": (4, 16, 5, 3, 16, "eos"),
    "exact_ties": (2, 16, 7, 3, 10, "ties"),
    "gate": (2, 16, 9, 2, 8, None),
}
SEEDS = sorted({c[2] for c in CASES.values()})
# (beam, Tm, max_len) just outside K3's envelope, each on one axis
OFF_GATE = {"beam5": (5, 32, 12), "tm160": (3, 160, 12), "max_len65": (3, 32, 65)}


def _memory(b: int, tm: int, seed: int):
    """tests/test_decode_loop.py::_setup's memory and padding."""
    rng = np.random.RandomState(seed)
    memory = (rng.randn(b, tm, TINY["emb_dim"]).astype(np.float32) * 0.5)
    lens = rng.randint(max(tm // 2, 1), tm + 1, size=b)
    return memory, np.arange(tm)[None, :] >= lens[:, None]


if __name__ != "__main__":
    import jax
    import jax.numpy as jnp

    from khmer_ocr_torch.convert.from_jax import save_npz

    def _edit_jax(params, edit):
        """The weight edits of tests/test_decode_loop.py."""
        params = jax.tree_util.tree_map(lambda x: x, params)
        out = dict(params["dec"]["out"])
        if edit == "eos":
            out["b"] = out["b"].at[3].add(4.0)  # eos_idx = 3
        elif edit == "ties":
            w, b = out["w"], out["b"]
            w = w.at[:, 11].set(w[:, 10]).at[:, 21].set(w[:, 20])
            out["w"], out["b"] = w, b.at[11].set(b[10]).at[21].set(b[20])
        params["dec"] = {**params["dec"], "out": out}
        return params

    @pytest.fixture(scope="module")
    def port(tmp_path_factory):
        from khmer_ocr_tpu.config import ModelConfig
        from khmer_ocr_tpu.models.ocr_model import init_model

        tmp = tmp_path_factory.mktemp("torch_decode_loop")
        params = {}
        for seed in SEEDS:
            p, s = init_model(jax.random.PRNGKey(seed), ModelConfig(**TINY))
            params[seed] = p
            save_npz(tmp / f"tiny_{seed}.npz", jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, s))
        subprocess.run([sys.executable, __file__, str(tmp)], cwd=REPO, check=True, timeout=600)
        with np.load(tmp / "outputs.npz") as z:
            out = {k: z[k] for k in z.files}
        return {"out": out, "params": params, "meta": json.loads((tmp / "outputs.json").read_text())}

    @pytest.mark.parametrize("case", sorted(CASES))
    def test_fused_beam_decode_tokens_equal_jax_kernel(port, case):
        from khmer_ocr_tpu.config import DecodeConfig, ModelConfig
        from khmer_ocr_tpu.decode.beam import beam_decode
        from khmer_ocr_tpu.ops.pallas.decode_loop import fused_beam_decode

        b, tm, seed, k, max_len, edit = CASES[case]
        memory, pad = _memory(b, tm, seed)
        params = _edit_jax(port["params"][seed], edit)
        cfg, dec = ModelConfig(**TINY), DecodeConfig(beam_width=k, max_len=max_len)
        if case == "gate":  # through the JAX package's own gate
            ref = beam_decode(params, jnp.asarray(memory), jnp.asarray(pad), cfg,
                              DecodeConfig(beam_width=k, max_len=max_len, mega_mode="1"))
        else:
            ref = fused_beam_decode(params, jnp.asarray(memory), jnp.asarray(pad), cfg, dec, interpret=True)
        np.testing.assert_array_equal(port["out"][f"{case}_fused"], np.asarray(ref))

    @pytest.mark.parametrize("case", sorted(CASES))
    def test_beam_decode_mega_on_equals_host_loop(port, case):
        """beam_decode(mega_mode="1") takes the whole-decode path, None the
        host loop; the tokens are the same."""
        assert port["meta"][case] == {"mega_on": {"steps": 0, "mega": 1}, "mega_off_mega": 0}
        np.testing.assert_array_equal(port["out"][f"{case}_mega_on"], port["out"][f"{case}_mega_off"])
        np.testing.assert_array_equal(port["out"][f"{case}_mega_on"], port["out"][f"{case}_fused"])

    def test_flagship_width_mega_on_equals_host_loop(port):
        """D=384, 8 heads, FFN 1536 (seeded weights), 2 images, Tm=128, beam 3."""
        assert port["meta"]["flagship"]["mega"] == 1
        assert port["out"]["flagship_mega_on"].shape == (2, 18)
        np.testing.assert_array_equal(port["out"]["flagship_mega_on"], port["out"]["flagship_mega_off"])

    @pytest.mark.parametrize("name", sorted(OFF_GATE))
    def test_outside_the_envelope_runs_the_host_loop(port, name):
        """Beam 5, Tm 160 or max_len 65: the host loop (steps counted, no
        whole-decode batch, no K3 launch)."""
        got = port["meta"][f"off_{name}"]
        assert got["mega"] == 0 and got["steps"] > 0 and got["k3_launches"] == 0, got


def _port_main(tmp: Path) -> None:
    import dataclasses

    sys.path.insert(0, str(REPO))
    import torch

    from khmer_ocr_torch.config import DecodeConfig, ModelConfig
    from khmer_ocr_torch.convert.from_jax import load_npz, params_from_jax, seeded_params
    from khmer_ocr_torch.decode.beam import beam_decode
    from khmer_ocr_torch.ops.kernels import build, decode_loop

    torch.set_num_threads(2)
    cfg = ModelConfig(**TINY)
    out, meta = {}, {}
    with torch.inference_mode():
        for case, (b, tm, seed, k, max_len, edit) in CASES.items():
            p, s, _ = load_npz(tmp / f"tiny_{seed}.npz")
            params = params_from_jax(p, s, cfg)
            head = params["dec"]["out"]
            if edit == "eos":
                head["b"][3] += 4.0
            elif edit == "ties":
                head["w"][:, 11], head["w"][:, 21] = head["w"][:, 10], head["w"][:, 20]
                head["b"][11], head["b"][21] = head["b"][10], head["b"][20]
            memory, pad = (torch.from_numpy(a) for a in _memory(b, tm, seed))
            dec = DecodeConfig(beam_width=k, max_len=max_len)
            out[f"{case}_fused"] = decode_loop.fused_beam_decode(params, memory, pad, cfg, dec).numpy()
            on, off = {}, {}
            out[f"{case}_mega_on"] = beam_decode(params, memory, pad, cfg, dataclasses.replace(dec, mega_mode="1"),
                                                 stats=on).numpy()
            out[f"{case}_mega_off"] = beam_decode(params, memory, pad, cfg, dec, stats=off).numpy()
            meta[case] = {"mega_on": on, "mega_off_mega": off["mega"]}

        for name, (k, tm, max_len) in OFF_GATE.items():
            off_cfg = dataclasses.replace(cfg, decode_max_len=max(cfg.decode_max_len, max_len))
            params = params_from_jax(*seeded_params(off_cfg, 0), off_cfg)
            memory, pad = (torch.from_numpy(a) for a in _memory(2, tm, 11))
            stats = {}
            build.reset_launches()
            beam_decode(params, memory, pad, off_cfg, DecodeConfig(beam_width=k, max_len=max_len, mega_mode="1"),
                        stats=stats)
            meta[f"off_{name}"] = {**stats, "k3_launches": build.launches["k3"]}

        flag = ModelConfig()
        params = params_from_jax(*seeded_params(flag, 0), flag)
        r = np.random.RandomState(21)
        memory = torch.from_numpy((r.randn(2, 128, flag.emb_dim) * 0.5).astype(np.float32))
        pad = torch.from_numpy(np.arange(128)[None, :] >= np.array([77, 128])[:, None])
        dec = DecodeConfig(beam_width=3, max_len=16)
        stats = {}
        out["flagship_mega_on"] = beam_decode(params, memory, pad, flag, dataclasses.replace(dec, mega_mode="1"),
                                              stats=stats).numpy()
        out["flagship_mega_off"] = beam_decode(params, memory, pad, flag, dec).numpy()
        meta["flagship"] = stats
    np.savez(tmp / "outputs.npz", **out)
    (tmp / "outputs.json").write_text(json.dumps(meta))


if __name__ == "__main__":
    _port_main(Path(sys.argv[1]))
