"""Training augmentation on the device, batched over the lines.

The same transforms as the JAX package's ``train/device_augment.py`` (the
reference's low-resolution ``ConsistentAugmenter``), as whole-batch tensor
ops with static shapes, so that the host ships uint8 lines and nothing
else:

  * geometry (none / short / shrink, uniform): one axis-aligned bilinear
    warp with cv2.INTER_LINEAR's half-pixel mapping; ``shrink`` centres on
    each line's true width, so the white bucket padding stays padding;
  * blur, p = 0.3: 3-tap separable Gaussian, sigma U(0.5, 1.0), zero border
    (when off, sigma 0.05 makes the kernel the identity);
  * noise, p = 0.5: additive N(0, sigma), sigma U(0.02, 0.08), only on the
    true width, clipped to [0, 1];
  * shift, p = 0.5: integer horizontal shift U{-8..8}, white fill;
  * the whole chain applied to a line with probability ``augment_prob``.

Every draw comes from the caller's ``torch.Generator`` (on the lines'
device), in a fixed order, so one generator state gives one output. The
JAX package's random stream cannot be reproduced: what the two share is
each op's arithmetic at fixed parameters and the distributions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _resample(img: torch.Tensor, coord: torch.Tensor, dim: int, n_valid: torch.Tensor) -> torch.Tensor:
    """Bilinear resample of (B, H, W) along ``dim`` (1 or 2) at per-sample
    coordinates (B, n_out), clamped to the first ``n_valid`` (B,) pixels."""
    top = (n_valid - 1).to(coord.dtype)[:, None]
    c = torch.minimum(coord.clamp_min(0.0), top)
    i0 = torch.minimum(torch.floor(c).to(torch.long).clamp_min(0), (n_valid - 2).clamp_min(0)[:, None])
    frac = c - i0
    i1 = torch.minimum(i0 + 1, (n_valid - 1)[:, None])
    if dim == 1:
        idx0, idx1 = (i[:, :, None].expand(-1, -1, img.shape[2]) for i in (i0, i1))
        f = frac[:, :, None]
    else:
        idx0, idx1 = (i[:, None, :].expand(-1, img.shape[1], -1) for i in (i0, i1))
        f = frac[:, None, :]
    return torch.gather(img, dim, idx0) * (1.0 - f) + torch.gather(img, dim, idx1) * f


def geometry(imgs, widths, geom, scale_h, scale_all, pad_value: float = 1.0):
    """imgs (B, H, Wb) in [0, 1]; widths (B,) true widths; geom (B,) in
    {0 none, 1 short, 2 shrink}; scale_h, scale_all (B,). The reference's
    resize-then-centre-paste, with its int() floors."""
    b, h, wb = imgs.shape
    w = widths.to(imgs.dtype)
    new_h = torch.where(geom == 1, torch.floor(h * scale_h),
                        torch.where(geom == 2, torch.floor(h * scale_all), torch.full_like(scale_h, float(h))))
    new_w = torch.where(geom == 2, torch.clamp_min(torch.floor(w * scale_all), 1.0), w)
    top = torch.floor((h - new_h) / 2.0)
    left = torch.where(geom == 2, torch.floor((w - new_w) / 2.0), torch.zeros_like(w))
    ys = torch.arange(h, device=imgs.device, dtype=imgs.dtype)[None, :]
    xs = torch.arange(wb, device=imgs.device, dtype=imgs.dtype)[None, :]
    sy = (ys - top[:, None] + 0.5) * (h / new_h)[:, None] - 0.5
    sx = (xs - left[:, None] + 0.5) * (w / new_w)[:, None] - 0.5
    inside = (((ys >= top[:, None]) & (ys < (top + new_h)[:, None]))[:, :, None]
              & ((xs >= left[:, None]) & (xs < (left + new_w)[:, None]))[:, None, :])
    rows = _resample(imgs, sy, 1, torch.full_like(widths, h).to(torch.long))
    warped = _resample(rows, sx, 2, widths.to(torch.long))
    return torch.where(inside, warped, torch.full((), pad_value, dtype=imgs.dtype, device=imgs.device))


def blur3(imgs, sigma):
    """3-tap separable Gaussian of per-sample ``sigma`` (B,), zero border."""
    side = torch.exp(-1.0 / (2.0 * sigma * sigma))
    norm = side + 1.0 + side
    k0, k1 = (side / norm)[:, None, None], (1.0 / norm)[:, None, None]
    p = F.pad(imgs, (0, 0, 1, 1))
    imgs = p[:, :-2] * k0 + p[:, 1:-1] * k1 + p[:, 2:] * k0
    p = F.pad(imgs, (1, 1))
    return p[:, :, :-2] * k0 + p[:, :, 1:-1] * k1 + p[:, :, 2:] * k0


def shift_x(imgs, shift, pad_value: float = 1.0):
    """Integer horizontal shift (B,) with constant fill."""
    wb = imgs.shape[2]
    src = torch.arange(wb, device=imgs.device)[None, :] - shift[:, None].to(torch.long)
    valid = (src >= 0) & (src < wb)
    moved = torch.gather(imgs, 2, src.clamp(0, wb - 1)[:, None, :].expand(-1, imgs.shape[1], -1))
    return torch.where(valid[:, None, :], moved, torch.full((), pad_value, dtype=imgs.dtype, device=imgs.device))


def add_noise(imgs, widths, noise, std, on):
    """imgs + noise (B, H, Wb) x std (B,), where ``on`` (B,) and inside the
    true width, clipped to [0, 1]."""
    xs = torch.arange(imgs.shape[2], device=imgs.device)[None, :]
    mask = (on[:, None] & (xs < widths[:, None]))[:, None, :]
    return torch.clamp(imgs + noise * std[:, None, None] * mask, 0.0, 1.0)


def augment_lines(imgs, widths, generator: torch.Generator, augment_prob: float = 0.8, pad_value: float = 1.0):
    """imgs (B, H, Wb) float32 in [0, 1] (ops/lines.py::u8_to_unit), widths
    (B,) true widths -> augmented (B, H, Wb) in [0, 1]."""
    b = imgs.shape[0]
    dev, f32 = imgs.device, imgs.dtype

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(b, generator=generator, device=dev, dtype=f32)

    geom = torch.randint(0, 3, (b,), generator=generator, device=dev)
    scale_h, scale_all = uniform(0.7, 0.98), uniform(0.8, 0.98)
    do_blur, blur_sigma = uniform(0.0, 1.0) < 0.3, uniform(0.5, 1.0)
    do_noise, noise_std = uniform(0.0, 1.0) < 0.5, uniform(0.02, 0.08)
    do_shift = uniform(0.0, 1.0) < 0.5
    shift = torch.randint(-8, 9, (b,), generator=generator, device=dev)
    noise = torch.randn(imgs.shape, generator=generator, device=dev, dtype=f32)
    apply = uniform(0.0, 1.0) < augment_prob

    out = geometry(imgs, widths, geom, scale_h, scale_all, pad_value)
    out = blur3(out, torch.where(do_blur, blur_sigma, torch.full_like(blur_sigma, 0.05)))
    out = add_noise(out, widths, noise, noise_std, do_noise)
    out = shift_x(out, torch.where(do_shift, shift, torch.zeros_like(shift)), pad_value)
    return torch.where(apply[:, None, None], out, imgs)
