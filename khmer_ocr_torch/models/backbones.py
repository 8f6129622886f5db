"""SE-VGG feature extractor (the flagship backbone) for inference.

Seven 3x3 conv + BatchNorm + ReLU blocks, 1-D squeeze-excitation after conv4,
conv6 and conv7 (pooled over height only, so the width axis survives), max
pools 2x2, 2x2, (2,1), (2,1), and the exact overlapping-bin adaptive pool to
(2, 32). A (B, 48, 100, 1) chunk batch maps to (B, 2, 32, 512).

The public function keeps the JAX package's NHWC layout at its boundary; the
convolutions run in PyTorch's NCHW inside. Convolutions pad SAME (1 px for
3x3), max pools are VALID, BatchNorm uses the stored statistics with eps 1e-5.
Parameters: ``conv*`` {"w" (O, I, 3, 3), "b"}, ``bn_conv*`` {"scale", "bias",
"mean", "var"}, ``se*`` {"fc1", "fc2"} each {"w" (in, out), "b"}.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.adaptive_pool import adaptive_avg_pool2d

BN_EPS = 1e-5


def conv_bn_relu(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """NCHW conv (SAME) + inference BatchNorm + ReLU."""
    x = F.conv2d(x, p[name]["w"], p[name]["b"], padding=1)
    bn = p[f"bn_{name}"]
    inv = torch.rsqrt(bn["var"] + BN_EPS) * bn["scale"]
    x = (x - bn["mean"][:, None, None]) * inv[:, None, None] + bn["bias"][:, None, None]
    return torch.relu(x)


def se_block(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Sequence squeeze-excitation on NCHW: mean over height, per-column gates."""
    y = x.mean(dim=2).transpose(1, 2)  # (B, W, C)
    y = torch.relu(y @ p["fc1"]["w"] + p["fc1"]["b"])
    y = torch.sigmoid(y @ p["fc2"]["w"] + p["fc2"]["b"])
    return x * y.transpose(1, 2)[:, :, None, :]


def se_vgg_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, 1) NHWC -> (B, 2, 32, 512) NHWC."""
    x = x.permute(0, 3, 1, 2)
    x = conv_bn_relu(p, "conv1", x)
    x = F.max_pool2d(x, (2, 2), (2, 2))
    x = conv_bn_relu(p, "conv2", x)
    x = F.max_pool2d(x, (2, 2), (2, 2))
    x = conv_bn_relu(p, "conv3", x)
    x = conv_bn_relu(p, "conv4", x)
    x = se_block(p["se3"], x)
    x = F.max_pool2d(x, (2, 1), (2, 1))
    x = conv_bn_relu(p, "conv5", x)
    x = conv_bn_relu(p, "conv6", x)
    x = se_block(p["se4"], x)
    x = F.max_pool2d(x, (2, 1), (2, 1))
    x = conv_bn_relu(p, "conv7", x)
    x = se_block(p["se5"], x)
    return adaptive_avg_pool2d(x.permute(0, 2, 3, 1), (2, 32))


BACKBONE_APPLY = {"se_vgg": se_vgg_apply}
