"""The port's device augmentation (train/device_augment.py) against the JAX
package's, on the CPU.

Each op at fixed parameters against the JAX op (geometry in its three
modes, blur, shift; the noise step against the JAX step's formula): within
2e-6 (float32 bilinear weights and 3-tap sums in another order). The random
streams of the two packages differ by design, so the whole chain is held
to its contract: ``augment_prob=0`` passes lines through unchanged, a fixed
generator gives the same output twice, other seeds and other lines differ,
values stay in [0, 1], and the share of lines augmented matches JAX's and
``augment_prob``.

The torch side runs in a torch-only subprocess (this file run as a script).
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
WIDTHS = (300, 352, 173)
WB = 352
GEOMS = [(0, 0.7, 0.8), (1, 0.7, 0.9), (1, 0.85, 0.9), (1, 0.97, 0.9), (2, 0.8, 0.8), (2, 0.8, 0.9),
         (2, 0.8, 0.97)]
SIGMAS = (0.05, 0.5, 0.75, 1.0)
SHIFTS = (-8, -3, 0, 5, 8)
N_RATE = 256  # lines in the augmented-share check


def _lines(seed=0):
    r = np.random.RandomState(seed)
    img = np.ones((len(WIDTHS), 48, WB), np.float32)
    for i, w in enumerate(WIDTHS):
        img[i, :, :w] = r.uniform(0.0, 1.0, (48, w))
    return img


def _noise():
    return np.random.RandomState(3).randn(len(WIDTHS), 48, WB).astype(np.float32)


def _changed_share(a, b):
    return float(np.mean([not np.array_equal(x, y) for x, y in zip(a, b)]))


if __name__ != "__main__":
    import jax
    import jax.numpy as jnp

    @pytest.fixture(scope="module")
    def port(tmp_path_factory):
        tmp = tmp_path_factory.mktemp("torch_device_augment")
        subprocess.run([sys.executable, __file__, str(tmp)], cwd=REPO, check=True, timeout=300)
        with np.load(tmp / "out.npz") as z:
            return {k: z[k] for k in z.files}

    def _close(got, ref, tol=2e-6):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=tol)

    @pytest.mark.parametrize("case", range(len(GEOMS)))
    def test_geometry_matches_jax(port, case):
        from khmer_ocr_tpu.train.device_augment import _geometry

        geom, sh, sa = GEOMS[case]
        for i, (img, w) in enumerate(zip(_lines(), WIDTHS)):
            ref = _geometry(jnp.asarray(img), jnp.int32(w), jnp.int32(geom), jnp.float32(sh), jnp.float32(sa), 1.0)
            _close(port[f"geometry_{case}"][i], ref)

    @pytest.mark.parametrize("sigma", SIGMAS)
    def test_blur_matches_jax(port, sigma):
        from khmer_ocr_tpu.train.device_augment import _blur3

        for i, img in enumerate(_lines()):
            _close(port[f"blur_{sigma}"][i], _blur3(jnp.asarray(img), jnp.float32(sigma)))

    @pytest.mark.parametrize("shift", SHIFTS)
    def test_shift_matches_jax(port, shift):
        from khmer_ocr_tpu.train.device_augment import _shift_x

        for i, img in enumerate(_lines()):
            np.testing.assert_array_equal(port[f"shift_{shift}"][i], np.asarray(_shift_x(jnp.asarray(img),
                                                                                           jnp.int32(shift), 1.0)))

    def test_noise_matches_jax_step(port):
        """The JAX chain's noise step (device_augment.py::_augment_one):
        noise x std x on x (x < width), added and clipped to [0, 1]."""
        xs = np.arange(WB, dtype=np.float32)
        for i, (img, w) in enumerate(zip(_lines(), WIDTHS)):
            on, std = i != 1, 0.05
            ref = jnp.clip(img + _noise()[i] * std * on * (xs[None, :] < w), 0.0, 1.0)
            _close(port["noise"][i], ref)

    def test_augment_prob_zero_passes_through(port):
        np.testing.assert_array_equal(port["prob0"], _lines())

    def test_fixed_generator_repeats_and_seeds_differ(port):
        np.testing.assert_array_equal(port["seed7_a"], port["seed7_b"])
        assert not np.array_equal(port["seed7_a"], port["seed8"])
        assert port["seed7_a"].min() >= 0.0 and port["seed7_a"].max() <= 1.0
        assert not np.array_equal(port["seed7_a"][0], port["seed7_a"][1])  # lines drawn independently

    def test_augmented_share_matches_jax(port):
        """Of N_RATE copies of one line at augment_prob 0.8, the share the
        chain changed: the port's and JAX's both within 0.08 of 0.8 (a
        binomial's standard deviation is 0.025 here)."""
        from khmer_ocr_tpu.train.device_augment import augment_lines

        imgs = np.repeat(_lines()[:1], N_RATE, axis=0)
        out = np.asarray(augment_lines(jnp.asarray(imgs), jnp.full((N_RATE,), WIDTHS[0], jnp.int32),
                                       jax.random.PRNGKey(0), augment_prob=0.8))
        for share in (_changed_share(out, imgs), float(port["share"])):
            assert abs(share - 0.8) < 0.08, share


def _port_main(tmp: Path) -> None:
    sys.path.insert(0, str(REPO))
    import torch

    from khmer_ocr_torch.train import device_augment as A

    torch.set_num_threads(2)
    imgs, n = torch.from_numpy(_lines()), len(WIDTHS)
    widths = torch.tensor(WIDTHS)
    full = lambda v, dtype=torch.float32: torch.full((n,), v, dtype=dtype)
    out = {}
    for case, (geom, sh, sa) in enumerate(GEOMS):
        out[f"geometry_{case}"] = A.geometry(imgs, widths, full(geom, torch.long), full(sh), full(sa)).numpy()
    for sigma in SIGMAS:
        out[f"blur_{sigma}"] = A.blur3(imgs, full(sigma)).numpy()
    for shift in SHIFTS:
        out[f"shift_{shift}"] = A.shift_x(imgs, full(shift, torch.long)).numpy()
    out["noise"] = A.add_noise(imgs, widths, torch.from_numpy(_noise()), full(0.05),
                               torch.tensor([True, False, True])).numpy()
    gen = lambda seed: torch.Generator().manual_seed(seed)
    out["prob0"] = A.augment_lines(imgs, widths, gen(0), augment_prob=0.0).numpy()
    out["seed7_a"] = A.augment_lines(imgs, widths, gen(7), augment_prob=1.0).numpy()
    out["seed7_b"] = A.augment_lines(imgs, widths, gen(7), augment_prob=1.0).numpy()
    out["seed8"] = A.augment_lines(imgs, widths, gen(8), augment_prob=1.0).numpy()
    many = imgs[:1].repeat(N_RATE, 1, 1)
    got = A.augment_lines(many, torch.full((N_RATE,), WIDTHS[0]), gen(0), augment_prob=0.8).numpy()
    out["share"] = np.float64(_changed_share(got, many.numpy()))
    np.savez(tmp / "out.npz", **out)


if __name__ == "__main__":
    _port_main(Path(sys.argv[1]))
