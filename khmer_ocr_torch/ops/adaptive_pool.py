"""Exact ``AdaptiveAvgPool2d`` with overlapping bins, as ``A_h @ X @ A_w^T``.

Bin i of an ``in -> out`` pool covers [floor(i * in / out), ceil((i + 1) * in
/ out)). For the 48x100 chunk geometry the backbone's (3, 25) map becomes
(2, 32): the width is upsampled with overlapping bins. The bins are separable,
so the pool is two small matmuls with averaging matrices.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def adaptive_pool_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) float32 M with M[i, j] = 1/|bin_i| for j in bin_i."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        start = (i * in_size) // out_size
        end = math.ceil((i + 1) * in_size / out_size)
        m[i, start:end] = 1.0 / (end - start)
    return m


@functools.lru_cache(maxsize=64)
def pool_matrix_on(in_size: int, out_size: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``adaptive_pool_matrix`` on ``device`` in ``dtype``, copied there once:
    a call then makes no host-to-device copy, which would wait on the
    stream and which a CUDA graph's capture cannot hold. Made outside
    inference mode, so that training may use it too."""
    with torch.inference_mode(False):
        return torch.from_numpy(adaptive_pool_matrix(in_size, out_size)).to(device, dtype)


def adaptive_avg_pool2d(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """x: (..., H, W, C) NHWC -> (..., out_h, out_w, C)."""
    h, w = x.shape[-3], x.shape[-2]
    ah = pool_matrix_on(h, out_hw[0], x.device, x.dtype)
    aw = pool_matrix_on(w, out_hw[1], x.device, x.dtype)
    x = torch.einsum("oh,...hwc->...owc", ah, x)
    return torch.einsum("pw,...hwc->...hpc", aw, x)
