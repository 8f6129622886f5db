"""Per-line training augmentation on the host (numpy and OpenCV): the JAX
package's ``train/augment.py`` draw for draw (the reference's
``ConsistentAugmenter``, CNN-Transformer.ipynb [cell 8]).

Works on float32 (H, W) lines in [0, 1] (white = 1.0), before
normalisation, with draws from a ``numpy.random.Generator`` in a fixed
order, so that one epoch's augmented lines equal the JAX package's bit for
bit. ``--host-augment`` (train/cli.py) selects it in place of the device
augmentation (train/device_augment.py).

Low-res input mode (the notebooks'): geometry none/short/shrink (uniform),
blur p 0.3 (sigma 0.5-1.0, separable 3-tap Gaussian, zero border), additive
noise p 0.5 (sigma 0.02-0.08), horizontal shift p 0.5 (+-8 px). The hi-res
mode adds pixelate p 0.5 and erode p 0.2 and blurs with sigma 1.0-2.0.

OpenCV is imported when an ``Augmenter`` is built, not with the package;
without it the constructor raises.
"""

from __future__ import annotations

import numpy as np


class Augmenter:
    def __init__(self, augment_prob: float = 0.8, is_low_res_input: bool = True, pad_value: float = 1.0):
        try:
            import cv2
        except ImportError as e:
            raise RuntimeError("host augmentation (Augmenter, --host-augment) needs OpenCV (cv2)") from e
        self._cv2 = cv2
        self.augment_prob = augment_prob
        self.is_low_res = is_low_res_input
        self.pad_value = pad_value

    def _resize(self, img: np.ndarray, h: int, w: int) -> np.ndarray:
        # INTER_LINEAR: half-pixel bilinear, as F.interpolate(align_corners=False)
        return self._cv2.resize(img, (w, h), interpolation=self._cv2.INTER_LINEAR)

    def __call__(self, img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        cv2 = self._cv2
        if rng.random() > self.augment_prob:
            return img
        h, w = img.shape

        geom_mode = rng.choice(["none", "short", "shrink"])
        scale_h = rng.uniform(0.7, 0.98)
        scale_all = rng.uniform(0.8, 0.98)
        do_pixelate = (not self.is_low_res) and rng.random() < 0.5
        do_blur = rng.random() < 0.3
        blur_sigma = rng.uniform(0.5, 1.0) if self.is_low_res else rng.uniform(1.0, 2.0)
        do_noise = rng.random() < 0.5
        noise_std = rng.uniform(0.02, 0.08)
        do_shift = rng.random() < 0.5
        shift_x = int(rng.integers(-8, 9))
        do_erode = (not self.is_low_res) and rng.random() < 0.2

        if geom_mode == "short":
            new_h = int(h * scale_h)
            if new_h < h:
                resized = self._resize(img, new_h, w)
                bg = np.full_like(img, self.pad_value)
                top = (h - new_h) // 2
                bg[top:top + new_h, :] = resized
                img = bg
        elif geom_mode == "shrink":
            new_h, new_w = int(h * scale_all), max(1, int(w * scale_all))
            if new_h < h:
                resized = self._resize(img, new_h, new_w)
                bg = np.full_like(img, self.pad_value)
                top, left = (h - new_h) // 2, (w - new_w) // 2
                if top + new_h <= h and left + new_w <= w:
                    bg[top:top + new_h, left:left + new_w] = resized
                    img = bg

        if do_pixelate:
            s = rng.uniform(0.4, 0.7)
            sh, sw = max(16, int(h * s)), max(4, int(w * s))
            img = self._resize(self._resize(img, sh, sw), h, w)

        if do_erode:
            # a 3x3 max on white-background text erodes the black strokes
            eroded = cv2.dilate(img, np.ones((3, 3), np.uint8))
            t = rng.uniform(0.5, 0.8)
            img = img * (1 - t) + eroded * t

        if do_blur:
            k = 3
            x = np.arange(k, dtype=np.float32) - k // 2
            k1d = np.exp(-(x ** 2) / (2 * blur_sigma ** 2))
            k1d /= k1d.sum()
            img = cv2.sepFilter2D(img, -1, k1d, k1d, borderType=cv2.BORDER_CONSTANT)

        if do_noise:
            img = np.clip(img + rng.standard_normal(img.shape).astype(np.float32) * noise_std, 0.0, 1.0)

        if do_shift and shift_x != 0:
            shifted = np.full_like(img, self.pad_value)
            if 0 < shift_x < w:
                shifted[:, shift_x:] = img[:, :-shift_x]
            elif -w < shift_x < 0:
                shifted[:, :shift_x] = img[:, -shift_x:]
            img = shifted

        return img.astype(np.float32)
