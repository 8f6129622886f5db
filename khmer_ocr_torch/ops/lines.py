"""On-device line-image ops: window extraction and normalisation.

The host ships whole uint8 lines padded with white to a bucket width; the
device cuts the overlapping 100-px windows and normalises them. Bit-identical
to ``preprocess.normalize(chunk_line(...))`` on the host: every window lies
fully inside the padded line, and u8 / 255 reproduces the host's float pixels.
"""

from __future__ import annotations

import torch


def device_chunk(lines: torch.Tensor, chunk_geom: tuple[int, int]) -> torch.Tensor:
    """(B, H, Wb) -> (B, N, H, CW) windows, N = (Wb - CW) // stride + 1."""
    cw, stride = chunk_geom
    wb = lines.shape[2]
    n = (wb - cw) // stride + 1
    return lines.unfold(2, cw, stride)[:, :, :n].permute(0, 2, 1, 3).contiguous()


def u8_to_unit(x: torch.Tensor) -> torch.Tensor:
    """uint8 pixels -> float32 [0, 1]."""
    return x.to(torch.float32) / 255.0


def unit_normalize(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] -> [-1, 1]."""
    return (x - 0.5) / 0.5
