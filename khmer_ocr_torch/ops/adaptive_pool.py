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


def adaptive_avg_pool2d(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """x: (..., H, W, C) NHWC -> (..., out_h, out_w, C)."""
    h, w = x.shape[-3], x.shape[-2]
    ah = torch.from_numpy(adaptive_pool_matrix(h, out_hw[0])).to(x.device, x.dtype)
    aw = torch.from_numpy(adaptive_pool_matrix(w, out_hw[1])).to(x.device, x.dtype)
    x = torch.einsum("oh,...hwc->...owc", ah, x)
    return torch.einsum("pw,...hwc->...hpc", aw, x)
