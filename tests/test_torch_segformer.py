"""The port's SegFormer layout model against the JAX package's, on the CPU.

The same seeded numpy weights (``convert.from_jax.seeded_segformer_state``,
HF keys; the JAX side takes them through its ``convert_hf_state_dict``) and
the same inputs go through JAX's ``segformer_logits``/``predict_maps``
(jitted, matmul precision "highest") and through the port:

* logits within 1e-4 of max|logit|, at 128x128 and at 100x132, where every
  spatial-reduction conv floors (stage grids 25x33, 13x17, 7x9 against
  ratios 8, 4, 2);
* class maps equal except at near-tied pixels (top-two logits of JAX closer
  than 1e-4, counted and printed), probabilities within 1e-5, for an
  upsampling, a downsampling (antialiased, as ``jax.image.resize`` shrinks)
  and a mixed ``out_hw``; the packed uint8 maps within 1 step;
* ``LayoutInference`` at image size 128: the per-page path's size buckets
  (packed and ``exact_maps``), the batched path against JAX's, a page's
  maps independent of its group mates, and the batched path against the
  per-page one as tests/test_detection.py holds JAX's;
* the HF oracle of tests/segformer_oracle_dump.py: its state dict loads by
  ``load_state_dict`` and the logits match (LayerNorm eps 1e-6 here, 1e-5
  there: the JAX package's tolerance);
* ``segformer_params_from_jax`` inverts JAX's ``convert_hf_state_dict``
  exactly; ``load_hf_checkpoint`` reads ``model.safetensors`` and
  ``pytorch_model.bin``; ``prepare_image`` equals JAX's (NCHW here).

The port runs in a torch-only subprocess (this file run as a script).
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
HERE = Path(__file__).parent
SEED = 0
INPUTS = {"main": (2, 3, 128, 128), "sr_floor": (1, 3, 100, 132)}
OUT_HW = {"up": (97, 113), "down": (20, 24), "mixed": (40, 20)}
PAGES = [(333, 205), (180, 260), (333, 205)]
NEAR_TIE = 1e-4

sys.path.insert(0, str(REPO))


def inputs() -> dict:
    return {k: np.random.RandomState(2 + i).randn(*s).astype(np.float32) for i, (k, s) in enumerate(INPUTS.items())}


def pages():
    from PIL import Image

    rs = np.random.RandomState(0)
    return [Image.fromarray(rs.randint(200, 256, (h, w, 3), np.uint8)) for h, w in PAGES]


def oracle_path(tmp: Path) -> Path:
    """The HF oracle's dump: tests/test_detection.py's cached copy where it
    loads whole, else a fresh one in ``tmp`` (another worker may be writing
    the cache)."""
    key = hashlib.sha256((HERE / "segformer_oracle_dump.py").read_bytes()).hexdigest()[:12]
    path = HERE / "_oracle_cache" / f"segformer-{key}.npz"
    try:
        with np.load(path) as z:
            if "logits" in z.files:
                return path
    except (OSError, ValueError, EOFError, zipfile.BadZipFile):
        pass
    path = tmp / "segformer_oracle.npz"
    subprocess.run([sys.executable, str(HERE / "segformer_oracle_dump.py"), str(path)], check=True, cwd=HERE,
                   timeout=600)
    return path


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, prefix + (str(key),)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, prefix + (str(i),)).items()}
    return {"/".join(prefix): np.asarray(tree)}


# ---------------------------------------------------------------------------
# the port, in a torch-only subprocess
# ---------------------------------------------------------------------------


def _port_main(tmp: Path) -> None:
    import torch

    from khmer_ocr_torch.convert.from_jax import _unflatten, seeded_segformer_state, segformer_params_from_jax
    from khmer_ocr_torch.detection.config import LayoutConfig
    from khmer_ocr_torch.detection.detector import LayoutInference
    from khmer_ocr_torch.detection.segformer import (
        build_model, convert_hf_state_dict, load_hf_checkpoint, predict_maps, save_hf_checkpoint)

    torch.set_num_threads(4)
    state = seeded_segformer_state(None, SEED)
    model = build_model(state)
    out, res = {}, {}
    with torch.inference_mode():
        for name, x in inputs().items():
            out[f"logits/{name}"] = model(torch.from_numpy(x)).numpy()
        x = torch.from_numpy(inputs()["main"])
        for name, hw in OUT_HW.items():
            cm, hm = predict_maps(model, x, hw)
            out[f"cm/{name}"], out[f"hm/{name}"] = cm.numpy(), hm.numpy()
            out[f"packed/{name}"] = predict_maps(model, x, hw, compact=True).numpy()
        oracle = dict(np.load(sys.argv[3]))
        hf = build_model({k[3:]: v for k, v in oracle.items() if k.startswith("sd/")})
        out["oracle_logits"] = hf(torch.from_numpy(oracle["x"])).numpy()

    cfg = LayoutConfig(image_size=128)
    det = LayoutInference(None, config=cfg, params=state, device="cpu")
    det_exact = LayoutInference(None, config=LayoutConfig(image_size=128, exact_maps=True), params=state, device="cpu")
    page_list = pages()
    _, out["page/cm"], out["page/hm"] = det.predict_maps(page_list[0])
    _, out["page/cm_exact"], out["page/hm_exact"] = det_exact.predict_maps(page_list[0])
    for i, (_, cm, hm) in enumerate(det.predict_maps_batch(page_list, group=2)):
        out[f"batch/cm/{i}"], out[f"batch/hm/{i}"] = cm, hm
        _, out[f"per_page/cm/{i}"], out[f"per_page/hm/{i}"] = det.predict_maps(page_list[i])
    from khmer_ocr_torch.detection.preprocess import prepare_image

    px = [prepare_image(p, 128)[1] for p in page_list]
    for name, group in (("alone", [px[0]]), ("with_b", [px[0], px[1]]), ("with_c", [px[0], px[2], px[1]])):
        out[f"mates/{name}"] = det.packed_maps(np.concatenate(group))[0]

    with np.load(tmp / "jax_tree.npz") as z:
        tree = _unflatten({tuple(int(p) if p.isdigit() else p for p in k.split("/")): z[k] for k in z.files})
    bridged = segformer_params_from_jax(tree)
    want = convert_hf_state_dict(state)
    res["bridge_keys_equal"] = sorted(bridged) == sorted(want)
    res["bridge_bit_equal"] = all(np.array_equal(bridged[k].numpy(), want[k]) for k in want)
    res["model_keys_equal"] = sorted(model.state_dict()) == sorted(want)
    from safetensors.numpy import save_file

    from khmer_ocr_torch.detection.segformer import hf_config

    save_hf_checkpoint(tmp / "bin", state)
    (tmp / "safetensors").mkdir()
    (tmp / "safetensors" / "config.json").write_text(json.dumps(hf_config(model.cfg)))
    save_file({k: v for k, v in state.items() if v.ndim}, str(tmp / "safetensors" / "model.safetensors"))
    for kind in ("safetensors", "bin"):
        loaded, lcfg = load_hf_checkpoint(tmp / kind)
        res[f"load_{kind}"] = (sorted(loaded) == sorted(want) and all(np.array_equal(np.asarray(loaded[k]), want[k])
                                                                      for k in want) and lcfg == model.cfg)
    np.savez(tmp / "port.npz", **out)
    (tmp / "port.json").write_text(json.dumps(res))


# ---------------------------------------------------------------------------
# the tests: the JAX package in the pytest process
# ---------------------------------------------------------------------------


if __name__ != "__main__":
    import jax
    import jax.numpy as jnp

    from khmer_ocr_tpu.detection.segformer import SegFormerConfig, _resize_bilinear, convert_hf_state_dict
    from khmer_ocr_tpu.detection.segformer import predict_maps as jax_predict_maps
    from khmer_ocr_tpu.detection.segformer import segformer_logits

    CFG = SegFormerConfig()

    @pytest.fixture(scope="module")
    def params():
        from khmer_ocr_torch.convert.from_jax import seeded_segformer_state

        return convert_hf_state_dict(seeded_segformer_state(None, SEED))

    @pytest.fixture(scope="module")
    def port(tmp_path_factory, params):
        tmp = tmp_path_factory.mktemp("torch_segformer")
        np.savez(tmp / "jax_tree.npz", **_flat(params))
        oracle = oracle_path(tmp)
        subprocess.run([sys.executable, __file__, "port", str(tmp), str(oracle)], cwd=REPO, check=True, timeout=600)
        with np.load(tmp / "port.npz") as z:
            arrays = {k: z[k] for k in z.files}
        return arrays, json.loads((tmp / "port.json").read_text()), oracle

    def _margin(logits, hw):
        top = jax.lax.top_k(_resize_bilinear(logits, hw), 2)[0]
        return top[..., 0] - top[..., 1]

    @pytest.fixture(scope="module")
    def ref(params):
        """JAX's logits, maps and near-tie margins, all from one jitted program."""
        @jax.jit
        def run(p, xs):
            out = {f"logits/{k}": segformer_logits(p, x, CFG) for k, x in xs.items()}
            for name, hw in OUT_HW.items():
                out[f"cm/{name}"], out[f"hm/{name}"] = jax_predict_maps(p, xs["main"], CFG, hw)
                out[f"packed/{name}"] = jax_predict_maps(p, xs["main"], CFG, hw, compact=True)
                out[f"margin/{name}"] = _margin(out["logits/main"], hw)
            return out

        xs = {k: jnp.asarray(v.transpose(0, 2, 3, 1)) for k, v in inputs().items()}
        with jax.default_matmul_precision("highest"):
            return {k: np.asarray(v) for k, v in run(params, xs).items()}

    @pytest.mark.parametrize("name", INPUTS)
    def test_logits_match_jax(port, ref, name):
        got, want = port[0][f"logits/{name}"], ref[f"logits/{name}"].transpose(0, 3, 1, 2)
        assert got.shape == want.shape
        err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
        print(f"{name}: logits {got.shape}, max |port - JAX| {err:.2e} of max |logit| {scale:.3f}")
        assert err <= 1e-4 * scale

    @pytest.mark.parametrize("name", OUT_HW)
    def test_maps_match_jax_off_near_ties(port, ref, name):
        tied = ref[f"margin/{name}"] < NEAR_TIE
        differ = port[0][f"cm/{name}"] != ref[f"cm/{name}"]
        print(f"{name} {OUT_HW[name]}: {int(tied.sum())} near-tied pixels, {int(differ.sum())} class ids differ")
        assert not (differ & ~tied).any()
        np.testing.assert_allclose(port[0][f"hm/{name}"], ref[f"hm/{name}"], atol=1e-5)

    @pytest.mark.parametrize("name", OUT_HW)
    def test_compact_maps_within_one_step(port, ref, name):
        got, want = port[0][f"packed/{name}"], ref[f"packed/{name}"]
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
        tied = ref[f"margin/{name}"] < NEAR_TIE
        assert not ((got[:, 0] != want[:, 0]) & ~tied).any()
        assert np.abs(got[:, 1].astype(int) - want[:, 1].astype(int)).max() <= 1

    @pytest.fixture(scope="module")
    def jax_layout(params):
        """JAX's LayoutInference at image size 128 on the pages, and the
        near-tie masks resized as its maps are (nearest)."""
        import cv2

        from khmer_ocr_tpu.detection.config import LayoutConfig
        from khmer_ocr_tpu.detection.detector import LayoutInference
        from khmer_ocr_tpu.detection.preprocess import prepare_image

        det = LayoutInference(None, config=LayoutConfig(image_size=128), params=params, seg_cfg=CFG)
        det_exact = LayoutInference(None, config=LayoutConfig(image_size=128, exact_maps=True), params=params,
                                    seg_cfg=CFG)
        page_list = pages()
        out = {}
        with jax.default_matmul_precision("highest"):
            _, out["page/cm"], out["page/hm"] = det.predict_maps(page_list[0])
            _, out["page/cm_exact"], out["page/hm_exact"] = det_exact.predict_maps(page_list[0])
            batch = det.predict_maps_batch(page_list, group=2)
            logits = jax.jit(lambda p, x: segformer_logits(p, x, CFG))(
                params, jnp.asarray(np.concatenate([prepare_image(p, 128)[1] for p in page_list])))
            h, w = PAGES[0]
            bucket = np.asarray(jax.jit(_margin, static_argnums=1)(logits[:1], (512, 256)))[0]
            tile = np.asarray(jax.jit(_margin, static_argnums=1)(logits, (128, 128)))
        tied = lambda m, hw: cv2.resize((m < NEAR_TIE).astype(np.uint8), hw[::-1],  # noqa: E731
                                        interpolation=cv2.INTER_NEAREST).astype(bool)
        out["page/tied"] = tied(bucket, (h, w))
        for i, (_, cm, hm) in enumerate(batch):
            out[f"batch/cm/{i}"], out[f"batch/hm/{i}"] = cm, hm
            out[f"batch/tied/{i}"] = tied(tile[i], PAGES[i])
        out["tile_tied"] = tile < NEAR_TIE
        return out

    @pytest.mark.parametrize("kind", ["packed", "exact"])
    def test_layout_inference_size_buckets(port, jax_layout, kind):
        """The per-page path: logits to a 256-rounded bucket on the device,
        the maps to the page size on the host; packed and exact maps."""
        sfx = "_exact" if kind == "exact" else ""
        cm, hm = port[0][f"page/cm{sfx}"], port[0][f"page/hm{sfx}"]
        assert cm.shape == hm.shape == PAGES[0] and cm.dtype == np.int32 and hm.dtype == np.float32
        assert not ((cm != jax_layout[f"page/cm{sfx}"]) & ~jax_layout["page/tied"]).any()
        np.testing.assert_allclose(hm, jax_layout[f"page/hm{sfx}"], atol=1e-5 if kind == "exact" else 1 / 255 + 1e-6)
        if kind == "exact":  # the packed maps against the exact ones, as JAX's test holds its own
            np.testing.assert_array_equal(port[0]["page/cm"], cm)
            np.testing.assert_allclose(port[0]["page/hm"], hm, atol=0.5 / 255 + 1e-6)

    @pytest.mark.parametrize("page", range(len(PAGES)))
    def test_batched_maps_match_jax(port, jax_layout, page):
        cm, hm = port[0][f"batch/cm/{page}"], port[0][f"batch/hm/{page}"]
        assert cm.shape == PAGES[page] and cm.dtype == np.int32
        assert not ((cm != jax_layout[f"batch/cm/{page}"]) & ~jax_layout[f"batch/tied/{page}"]).any()
        np.testing.assert_allclose(hm, jax_layout[f"batch/hm/{page}"], atol=1 / 255 + 1e-6)

    @pytest.mark.parametrize("mates", ["with_b", "with_c"])
    def test_page_maps_do_not_depend_on_group_mates(port, jax_layout, mates):
        alone, grouped = port[0]["mates/alone"], port[0][f"mates/{mates}"]
        differ = alone[0] != grouped[0]
        print(f"{mates}: {int(differ.sum())} class ids differ from the page alone")
        assert not (differ & ~jax_layout["tile_tied"][0]).any()
        assert np.abs(alone[1].astype(int) - grouped[1].astype(int)).max() <= 1

    @pytest.mark.parametrize("page", range(len(PAGES)))
    def test_batched_maps_against_per_page(port, page):
        """The sense of tests/test_detection.py: boundaries may move a few
        pixels between the two orders of resize and argmax."""
        agree = (port[0][f"batch/cm/{page}"] == port[0][f"per_page/cm/{page}"]).mean()
        assert agree > 0.95, agree
        assert abs(float(port[0][f"batch/hm/{page}"].mean()) - float(port[0][f"per_page/hm/{page}"].mean())) < 0.05

    def test_hf_oracle_logits(port):
        oracle = np.load(port[2])
        np.testing.assert_allclose(port[0]["oracle_logits"], oracle["logits"], atol=2e-3, rtol=1e-3)

    @pytest.mark.parametrize("check", ["model_keys_equal", "bridge_keys_equal", "bridge_bit_equal"])
    def test_state_keys_and_weight_bridge(port, check):
        """The module's keys are HF's without the prefix; the bridge from
        JAX's tree gives the seeded state bit for bit."""
        assert port[1][check]

    @pytest.mark.parametrize("kind", ["safetensors", "bin"])
    def test_load_hf_checkpoint(port, kind):
        assert port[1][f"load_{kind}"]

    def test_seeded_state_has_the_hf_oracle_keys_and_shapes(port):
        from khmer_ocr_torch.convert.from_jax import seeded_segformer_state

        oracle = np.load(port[2])
        sd = {k[3:]: oracle[k] for k in oracle.files if k.startswith("sd/")}
        seeded = seeded_segformer_state(None, SEED)
        assert sorted(seeded) == sorted(sd)
        assert all(seeded[k].shape == sd[k].shape for k in sd)

    def test_prepare_image_matches_jax():
        from khmer_ocr_torch.detection.preprocess import prepare_image
        from khmer_ocr_tpu.detection.preprocess import prepare_image as jax_prepare

        for page in pages():
            _, got, size = prepare_image(page, 64)
            _, want, want_size = jax_prepare(page, 64)
            assert size == want_size and got.shape == (1, 3, 64, 64)
            np.testing.assert_array_equal(got, want.transpose(0, 3, 1, 2))


if __name__ == "__main__":
    _port_main(Path(sys.argv[2]))
