"""CNN feature extractors: SE-VGG (the flagship), VGG, ResNet.

  * SE-VGG: seven 3x3 conv + BatchNorm + ReLU blocks, 1-D squeeze-excitation
    after conv4, conv6 and conv7 (pooled over height only, so the width axis
    survives), max pools 2x2, 2x2, (2,1), (2,1).
  * VGG: the same trail without squeeze-excitation; conv7 is a plain conv
    with no BatchNorm or ReLU.
  * ResNet: a 3x3 stem conv + BatchNorm + ReLU and a 2x2 pool, then stages of
    BasicBlocks (convert/from_jax.py::RESNET_STAGES: 1x128, 2x256, 2x512,
    1x512) with pools 2x2, (2,1), (2,1) after the first three. Its convs have
    no bias; a 1x1 conv + BatchNorm shortcut joins blocks whose width changes.
All end in the exact overlapping-bin adaptive pool to (2, 32): a (B, 48, 100,
1) chunk batch maps to (B, 2, 32, 512).

The public functions keep the JAX package's NHWC layout at their boundary;
the convolutions run in PyTorch's NCHW inside (cuDNN on the card, with TF32
off in the parity mode's precision scope: precision.py). Convolutions pad
SAME (1 px for 3x3), max pools are VALID, BatchNorm has eps 1e-5.
Parameters: convs {"w" (O, I, kh, kw), "b" where the conv has one}, BatchNorms
{"scale", "bias"}, ``se*`` {"fc1", "fc2"} each {"w" (in, out), "b"}; ResNet's
blocks are lists under ``layer1``..``layer4``. The BatchNorm statistics
{"mean", "var"} sit at the same paths of ``stats``; for inference they are
merged into the params (convert/from_jax.py::params_from_jax) and ``stats``
is omitted. Every ``*_apply(p, x, stats=None, train=False)`` returns
(features, new stats): in training BatchNorm normalises with the batch's
statistics and returns updated running ones (batch_norm).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops.adaptive_pool import adaptive_avg_pool2d

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def conv2d(p: dict, x: torch.Tensor) -> torch.Tensor:
    """NCHW conv, SAME padding (odd kernels), bias where the conv has one."""
    return F.conv2d(x, p["w"], p.get("b"), padding=p["w"].shape[-1] // 2)


def batch_norm(p: dict, s: dict, x: torch.Tensor, train: bool = False, group=None):
    """BatchNorm over NCHW -> (y, new statistics). Inference normalises with
    the stored ``s["mean"]``/``s["var"]``; training with the batch's mean and
    biased variance over (N, H, W), every sample of the batch included, and
    moves the running statistics by momentum 0.1 towards the batch mean and
    the unbiased variance (PyTorch's BatchNorm2d). Under a process group
    of more than one rank (data-parallel training) the batch is every
    rank's: the statistics are summed over the group
    (parallel/mesh.py::global_batch_norm); a group of one rank holds the
    whole batch, and takes the path without a group."""
    if train and group is not None and dist.get_world_size(group) > 1:
        from ..parallel.mesh import global_batch_norm

        y, mean, var, count = global_batch_norm(x, p["scale"], p["bias"], BN_EPS, group)
        with torch.no_grad():
            new_s = {"mean": s["mean"] * (1 - BN_MOMENTUM) + mean * BN_MOMENTUM,
                     "var": s["var"] * (1 - BN_MOMENTUM) + var * (count / (count - 1)) * BN_MOMENTUM}
        return y, new_s
    if train:  # PyTorch's own training BatchNorm, which moves the copies of the running statistics in place
        new_s = {"mean": s["mean"].clone(), "var": s["var"].clone()}
        y = F.batch_norm(x, new_s["mean"], new_s["var"], p["scale"], p["bias"], training=True,
                         momentum=BN_MOMENTUM, eps=BN_EPS)
        return y, new_s
    # the float32 statistics in x's dtype, as the JAX package casts them (the identity in float32)
    mean, var = s["mean"].to(x.dtype), s["var"].to(x.dtype)
    inv = torch.rsqrt(var + BN_EPS) * p["scale"]
    return (x - mean[:, None, None]) * inv[:, None, None] + p["bias"][:, None, None], s


def conv_bn_relu(p: dict, s: dict, name: str, x: torch.Tensor, train: bool, ns: dict, group=None) -> torch.Tensor:
    """NCHW conv (SAME) + BatchNorm + ReLU; the BatchNorm's new statistics go to ``ns``."""
    y, ns[f"bn_{name}"] = batch_norm(p[f"bn_{name}"], s[f"bn_{name}"], conv2d(p[name], x), train, group)
    return torch.relu(y)


def se_block(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Sequence squeeze-excitation on NCHW: mean over height, per-column gates."""
    y = x.mean(dim=2).transpose(1, 2)  # (B, W, C)
    y = torch.relu(y @ p["fc1"]["w"] + p["fc1"]["b"])
    y = torch.sigmoid(y @ p["fc2"]["w"] + p["fc2"]["b"])
    return x * y.transpose(1, 2)[:, :, None, :]


def se_vgg_apply(p: dict, x: torch.Tensor, stats: dict | None = None, train: bool = False, group=None):
    """x: (B, H, W, 1) NHWC -> ((B, 2, 32, 512) NHWC, new stats)."""
    s, ns = p if stats is None else stats, {}
    x = x.permute(0, 3, 1, 2)
    x = conv_bn_relu(p, s, "conv1", x, train, ns, group)
    x = F.max_pool2d(x, (2, 2), (2, 2))
    x = conv_bn_relu(p, s, "conv2", x, train, ns, group)
    x = F.max_pool2d(x, (2, 2), (2, 2))
    x = conv_bn_relu(p, s, "conv3", x, train, ns, group)
    x = conv_bn_relu(p, s, "conv4", x, train, ns, group)
    x = se_block(p["se3"], x)
    x = F.max_pool2d(x, (2, 1), (2, 1))
    x = conv_bn_relu(p, s, "conv5", x, train, ns, group)
    x = conv_bn_relu(p, s, "conv6", x, train, ns, group)
    x = se_block(p["se4"], x)
    x = F.max_pool2d(x, (2, 1), (2, 1))
    x = conv_bn_relu(p, s, "conv7", x, train, ns, group)
    x = se_block(p["se5"], x)
    return adaptive_avg_pool2d(x.permute(0, 2, 3, 1), (2, 32)), ns


def vgg_apply(p: dict, x: torch.Tensor, stats: dict | None = None, train: bool = False, group=None):
    """x: (B, H, W, 1) NHWC -> ((B, 2, 32, 512) NHWC, new stats)."""
    s, ns = p if stats is None else stats, {}
    x = x.permute(0, 3, 1, 2)
    x = conv_bn_relu(p, s, "conv1", x, train, ns, group)
    x = F.max_pool2d(x, (2, 2), (2, 2))
    x = conv_bn_relu(p, s, "conv2", x, train, ns, group)
    x = F.max_pool2d(x, (2, 2), (2, 2))
    x = conv_bn_relu(p, s, "conv3", x, train, ns, group)
    x = conv_bn_relu(p, s, "conv4", x, train, ns, group)
    x = F.max_pool2d(x, (2, 1), (2, 1))
    x = conv_bn_relu(p, s, "conv5", x, train, ns, group)
    x = conv_bn_relu(p, s, "conv6", x, train, ns, group)
    x = F.max_pool2d(x, (2, 1), (2, 1))
    x = conv2d(p["conv7"], x)  # plain conv: no BatchNorm, no ReLU
    return adaptive_avg_pool2d(x.permute(0, 2, 3, 1), (2, 32)), ns


_RESNET_POOLS = [(2, 2), (2, 1), (2, 1), None]  # after each stage of convert/from_jax.py::RESNET_STAGES


def basic_block_apply(p: dict, s: dict, x: torch.Tensor, train: bool, group=None):
    """ResNet BasicBlock on NCHW: two conv + BatchNorm, a projected shortcut
    where the width changes, ReLU of the sum. -> (y, new stats)."""
    ns = {}
    out, ns["bn1"] = batch_norm(p["bn1"], s["bn1"], conv2d(p["conv1"], x), train, group)
    out, ns["bn2"] = batch_norm(p["bn2"], s["bn2"], conv2d(p["conv2"], torch.relu(out)), train, group)
    sc = x
    if "short_conv" in p:
        sc, ns["short_bn"] = batch_norm(p["short_bn"], s["short_bn"], conv2d(p["short_conv"], x), train, group)
    return torch.relu(out + sc), ns


def resnet_apply(p: dict, x: torch.Tensor, stats: dict | None = None, train: bool = False, group=None):
    """x: (B, H, W, 1) NHWC -> ((B, 2, 32, 512) NHWC, new stats)."""
    s, ns = p if stats is None else stats, {}
    x = x.permute(0, 3, 1, 2)
    x, ns["stem_bn"] = batch_norm(p["stem_bn"], s["stem_bn"], conv2d(p["stem_conv"], x), train, group)
    x = F.max_pool2d(torch.relu(x), (2, 2), (2, 2))
    for i, pool in enumerate(_RESNET_POOLS):
        stage = f"layer{i + 1}"
        ns[stage] = []
        for block, block_s in zip(p[stage], s[stage]):
            x, block_ns = basic_block_apply(block, block_s, x, train, group)
            ns[stage].append(block_ns)
        if pool is not None:
            x = F.max_pool2d(x, pool, pool)
    return adaptive_avg_pool2d(x.permute(0, 2, 3, 1), (2, 32)), ns


BACKBONE_APPLY = {"se_vgg": se_vgg_apply, "vgg": vgg_apply, "resnet": resnet_apply}
