"""SegFormer (MiT-b0) semantic segmentation, the layout model, in PyTorch (NCHW).

The function of the JAX package's ``detection/segformer.py``, the layout
model the reference serves through Hugging Face transformers
(netra_ocr/detection/model.py:6-33: mit-b0 with 12 DocLayNet classes,
bilinear logit upsampling, argmax class map and max-softmax heatmap).

Architecture (det-b0/config.json): 4 stages, depths [2,2,2,2], hidden
[32,64,160,256], heads [1,2,5,8], spatial-reduction ratios [8,4,2,1],
Mix-FFN ratio 4, patch convs k7s4/k3s2/k3s2/k3s2; the decode head projects
each stage, upsamples to 1/4, fuses with a 1x1 conv, BatchNorm (running
statistics) and ReLU, and classifies.

The submodules carry the names of Hugging Face's
``SegformerForSemanticSegmentation`` without its ``segformer.`` prefix, so
``load_state_dict`` takes an HF state dict once ``convert_hf_state_dict``
has removed the prefix and BatchNorm's ``num_batches_tracked``.

Numerics follow the JAX package in its float32 parity mode, not HF's
modules: LayerNorm eps 1e-6 (HF's use 1e-5), BatchNorm eps 1e-5, exact (erf)
GELU; attention logits are divided by sqrt(head dim) held as a float32
tensor on the logits' device (CUDA multiplies by the reciprocal of a CPU
scalar divisor instead) and computed by plain matmuls
(``scaled_dot_product_attention``'s fused backends reorder the sums).
Every convolution, matmul and softmax here is a library call: the JAX
package runs them as XLA operations outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6
BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # PyTorch BatchNorm2d's default


@dataclasses.dataclass(frozen=True)
class SegFormerConfig:
    num_labels: int = 12
    depths: tuple[int, ...] = (2, 2, 2, 2)
    hidden_sizes: tuple[int, ...] = (32, 64, 160, 256)
    num_heads: tuple[int, ...] = (1, 2, 5, 8)
    sr_ratios: tuple[int, ...] = (8, 4, 2, 1)
    patch_sizes: tuple[int, ...] = (7, 3, 3, 3)
    strides: tuple[int, ...] = (4, 2, 2, 2)
    mlp_ratio: int = 4
    decoder_hidden: int = 256


def resize_bilinear(x: torch.Tensor, out_hw) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, *out_hw), half-pixel bilinear, antialiased
    where it shrinks: ``jax.image.resize(method="linear")``'s convention,
    which scales its triangle kernel by the factor when downsampling.

    An upsample of a CUDA tensor that takes a gradient goes through
    ``_Upsample``: the same forward, and a backward without atomics, so
    that a train step gives the same bits every run (and a captured step
    those of the eager one). The CPU's backward is deterministic as it is."""
    h, w = x.shape[2:]
    out_hw = tuple(int(v) for v in out_hw)
    if x.is_cuda and x.requires_grad and torch.is_grad_enabled() and out_hw[0] >= h and out_hw[1] >= w:
        return _Upsample.apply(x, out_hw)
    return F.interpolate(x, size=out_hw, mode="bilinear", align_corners=False,
                         antialias=out_hw[0] < h or out_hw[1] < w)


def upsample_matrix(n_out: int, n_in: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """(n_out, n_in): row o holds the two weights with which a half-pixel
    bilinear upsample from ``n_in`` to ``n_out`` samples (``F.interpolate``,
    ``align_corners=False``: source o' = (o + 0.5) * n_in / n_out - 0.5,
    clamped at 0, the upper neighbour clamped at n_in - 1), made on
    ``device`` from device operations alone (a capture can hold them)."""
    scale = torch.full((), n_in, dtype=torch.float32, device=device) / n_out
    src = (scale * (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) - 0.5).clamp_min(0)
    i0 = src.floor().long().clamp(max=n_in - 1)
    upper = src - i0
    m = torch.zeros(n_out, n_in, dtype=torch.float32, device=device)
    m.scatter_add_(1, i0[:, None], (1 - upper)[:, None])
    m.scatter_add_(1, (i0 + 1).clamp(max=n_in - 1)[:, None], upper[:, None])
    return m.to(dtype)


class _Upsample(torch.autograd.Function):
    """``F.interpolate``'s half-pixel bilinear upsample, whose gradient is
    the transposed interpolation, two matmuls with ``upsample_matrix``:
    CUDA's own backward adds each output pixel's gradient into its four
    sources with atomics, whose order (and so last bits) changes from run
    to run."""

    @staticmethod
    def forward(ctx, x, out_hw):
        ctx.in_hw = tuple(x.shape[2:])
        return F.interpolate(x, size=out_hw, mode="bilinear", align_corners=False)

    @staticmethod
    def backward(ctx, g):
        (hi, wi), (ho, wo) = ctx.in_hw, g.shape[2:]
        mh, mw = upsample_matrix(ho, hi, g.device, g.dtype), upsample_matrix(wo, wi, g.device, g.dtype)
        return torch.matmul(mh.t(), torch.matmul(g, mw)), None


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H*W, C), row-major tokens."""
    return x.flatten(2).transpose(1, 2)


def _spatial(tok: torch.Tensor, hw) -> torch.Tensor:
    """(B, H*W, C) -> (B, C, H, W)."""
    b, _, c = tok.shape
    return tok.transpose(1, 2).reshape(b, c, *hw)


class _PatchEmbed(nn.Module):
    def __init__(self, cin: int, c: int, k: int, stride: int):
        super().__init__()
        self.proj = nn.Conv2d(cin, c, k, stride, padding=k // 2)
        self.layer_norm = nn.LayerNorm(c, eps=LN_EPS)


class _SelfAttention(nn.Module):
    """Efficient self-attention: K and V from a spatially reduced grid (a
    VALID conv with stride = kernel = ratio, which floors, then LayerNorm)."""

    def __init__(self, c: int, num_heads: int, sr_ratio: int):
        super().__init__()
        self.num_heads, self.sr_ratio = num_heads, sr_ratio
        self.query, self.key, self.value = nn.Linear(c, c), nn.Linear(c, c), nn.Linear(c, c)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(c, c, sr_ratio, sr_ratio)
            self.layer_norm = nn.LayerNorm(c, eps=LN_EPS)

    def forward(self, x: torch.Tensor, hw) -> torch.Tensor:
        b, n, c = x.shape
        hd = c // self.num_heads
        q = self.query(x).reshape(b, n, self.num_heads, hd).transpose(1, 2)
        kv_in = x
        if self.sr_ratio > 1:
            kv_in = self.layer_norm(_tokens(self.sr(_spatial(x, hw))))
        k = self.key(kv_in).reshape(b, -1, self.num_heads, hd).transpose(1, 2)
        v = self.value(kv_in).reshape(b, -1, self.num_heads, hd).transpose(1, 2)
        scale = torch.full((), math.sqrt(hd), dtype=x.dtype, device=x.device)
        attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / scale, dim=-1)
        return torch.matmul(attn, v).transpose(1, 2).reshape(b, n, c)


class _SelfOutput(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.dense = nn.Linear(c, c)


class _Attention(nn.Module):
    def __init__(self, c: int, num_heads: int, sr_ratio: int):
        super().__init__()
        self.self = _SelfAttention(c, num_heads, sr_ratio)
        self.output = _SelfOutput(c)

    def forward(self, x: torch.Tensor, hw) -> torch.Tensor:
        return self.output.dense(self.self(x, hw))


class _DWConv(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.dwconv = nn.Conv2d(c, c, 3, 1, padding=1, groups=c)


class _MixFFN(nn.Module):
    """dense -> 3x3 depthwise conv ("SAME") -> exact GELU -> dense."""

    def __init__(self, c: int, hidden: int):
        super().__init__()
        self.dense1 = nn.Linear(c, hidden)
        self.dwconv = _DWConv(hidden)
        self.dense2 = nn.Linear(hidden, c)

    def forward(self, x: torch.Tensor, hw) -> torch.Tensor:
        x = _tokens(self.dwconv.dwconv(_spatial(self.dense1(x), hw)))
        return self.dense2(F.gelu(x, approximate="none"))


class _Layer(nn.Module):
    def __init__(self, c: int, num_heads: int, sr_ratio: int, mlp_ratio: int):
        super().__init__()
        self.layer_norm_1 = nn.LayerNorm(c, eps=LN_EPS)
        self.attention = _Attention(c, num_heads, sr_ratio)
        self.layer_norm_2 = nn.LayerNorm(c, eps=LN_EPS)
        self.mlp = _MixFFN(c, c * mlp_ratio)

    def forward(self, tok: torch.Tensor, hw) -> torch.Tensor:
        tok = tok + self.attention(self.layer_norm_1(tok), hw)
        return tok + self.mlp(self.layer_norm_2(tok), hw)


class _Encoder(nn.Module):
    def __init__(self, cfg: SegFormerConfig):
        super().__init__()
        cins = (3,) + cfg.hidden_sizes[:-1]
        self.patch_embeddings = nn.ModuleList(
            _PatchEmbed(cin, c, k, s) for cin, c, k, s in zip(cins, cfg.hidden_sizes, cfg.patch_sizes, cfg.strides))
        self.block = nn.ModuleList(
            nn.ModuleList(_Layer(c, heads, sr, cfg.mlp_ratio) for _ in range(depth))
            for c, heads, sr, depth in zip(cfg.hidden_sizes, cfg.num_heads, cfg.sr_ratios, cfg.depths))
        self.layer_norm = nn.ModuleList(nn.LayerNorm(c, eps=LN_EPS) for c in cfg.hidden_sizes)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x: (B, 3, H, W) normalised -> the 4 stage features (B, Ci, Hi, Wi)."""
        feats = []
        for patch, blocks, final_ln in zip(self.patch_embeddings, self.block, self.layer_norm):
            x = patch.proj(x)
            hw = tuple(x.shape[2:])
            tok = patch.layer_norm(_tokens(x))
            for layer in blocks:
                tok = layer(tok, hw)
            x = _spatial(final_ln(tok), hw)
            feats.append(x)
        return feats


class _MLP(nn.Module):
    def __init__(self, c: int, out: int):
        super().__init__()
        self.proj = nn.Linear(c, out)


class _BatchNorm(nn.Module):
    """BatchNorm as the JAX package computes it, (x - mean) * rsqrt(var +
    eps) * scale + bias; holds no ``num_batches_tracked``. In eval mode on
    the running statistics. In train mode (detection/train.py) on the
    batch's mean and biased variance over (N, H, W), and the running pair
    moves by momentum ``BN_MOMENTUM`` towards the batch mean and unbiased
    variance."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        col = lambda t: t[:, None, None]  # noqa: E731
        if not self.training:
            return (x - col(self.running_mean)) * col(torch.rsqrt(self.running_var + BN_EPS)) * col(
                self.weight) + col(self.bias)
        mean = x.mean(dim=(0, 2, 3))
        var = (x - col(mean)).square().mean(dim=(0, 2, 3))
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mean)
            self.running_var.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * var * (n / max(n - 1, 1)))
        return (x - col(mean)) * col(torch.rsqrt(var + BN_EPS)) * col(self.weight) + col(self.bias)


class _DecodeHead(nn.Module):
    def __init__(self, cfg: SegFormerConfig):
        super().__init__()
        dh = cfg.decoder_hidden
        self.linear_c = nn.ModuleList(_MLP(c, dh) for c in cfg.hidden_sizes)
        self.linear_fuse = nn.Conv2d(dh * len(cfg.hidden_sizes), dh, 1, bias=False)
        self.batch_norm = _BatchNorm(dh)
        self.classifier = nn.Conv2d(dh, cfg.num_labels, 1)

    def forward(self, feats: list[torch.Tensor]) -> torch.Tensor:
        """Per-stage linear -> bilinear up to the first stage's grid ->
        concat in reverse stage order -> fuse + BN + ReLU -> classifier:
        logits (B, num_labels, H/4, W/4)."""
        target = tuple(feats[0].shape[2:])
        proj = []
        for mlp, f in zip(self.linear_c, feats):
            hw = tuple(f.shape[2:])
            p = _spatial(mlp.proj(_tokens(f)), hw)
            proj.append(p if hw == target else resize_bilinear(p, target))
        x = self.linear_fuse(torch.cat(proj[::-1], dim=1))
        return self.classifier(torch.relu(self.batch_norm(x)))


class SegFormer(nn.Module):
    """MiT encoder + all-MLP decode head; ``forward`` gives the logits."""

    def __init__(self, cfg: SegFormerConfig | None = None):
        super().__init__()
        self.cfg = cfg or SegFormerConfig()
        self.encoder = _Encoder(self.cfg)
        self.decode_head = _DecodeHead(self.cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode_head(self.encoder(x))


def predict_maps(model: SegFormer, x: torch.Tensor, out_hw, compact: bool = False):
    """The reference's ``LayoutModel.predict`` (model.py:20-33): logits
    resized to ``out_hw``, softmax, argmax class map and max-probability
    heatmap, each (B, H, W).

    ``compact``: both maps packed into ONE (B, 2, H, W) uint8 tensor, the
    class ids exact (num_labels <= 255) and the heatmap quantised to 1/255
    (``hm * 255 + 0.5`` truncated), so one small array leaves the card; the
    step is far below the post-process's thresholds (0.2 on contour means)."""
    logits = resize_bilinear(model(x), out_hw)
    hm = torch.softmax(logits, dim=1).amax(dim=1)
    cm = logits.argmax(dim=1)
    if compact:
        return torch.stack([cm.to(torch.uint8), (hm * 255.0 + 0.5).to(torch.uint8)], dim=1)
    return cm, hm


# ---------------------------------------------------------------------------
# Hugging Face checkpoints
# ---------------------------------------------------------------------------


def convert_hf_state_dict(sd: dict) -> dict:
    """An HF ``SegformerForSemanticSegmentation`` state dict -> this module's
    keys: the ``segformer.`` prefix removed, ``num_batches_tracked`` dropped."""
    return {k.removeprefix("segformer."): v for k, v in sd.items() if not k.endswith("num_batches_tracked")}


def build_model(state: dict, cfg: SegFormerConfig | None = None, device="cpu") -> SegFormer:
    """A SegFormer in eval mode on ``device`` holding ``state`` (HF keys, with
    or without the prefix; numpy arrays or tensors); every key must match."""
    model = SegFormer(cfg)
    model.load_state_dict({k: torch.as_tensor(np.asarray(v, np.float32)) if not isinstance(v, torch.Tensor) else v
                           for k, v in convert_hf_state_dict(state).items()})
    return model.to(device).eval()


def config_from_hf(hf: dict) -> SegFormerConfig:
    """An HF SegFormer ``config.json`` (as a dict) -> SegFormerConfig."""
    return SegFormerConfig(
        num_labels=len(hf.get("id2label", {})) or 12,
        depths=tuple(hf["depths"]),
        hidden_sizes=tuple(hf["hidden_sizes"]),
        num_heads=tuple(hf["num_attention_heads"]),
        sr_ratios=tuple(hf["sr_ratios"]),
        patch_sizes=tuple(hf["patch_sizes"]),
        strides=tuple(hf["strides"]),
        mlp_ratio=hf["mlp_ratios"][0],
        decoder_hidden=hf["decoder_hidden_size"],
    )


def load_hf_checkpoint(model_dir):
    """A local HF checkpoint directory -> (state dict of numpy arrays with
    this module's keys, SegFormerConfig). Reads ``config.json`` and
    ``model.safetensors`` (the port's numpy reader), else
    ``pytorch_model.bin`` (``torch.load``, weights only)."""
    import json
    from pathlib import Path

    from ..convert.torch_loader import load_safetensors

    model_dir = Path(model_dir)
    cfg = config_from_hf(json.loads((model_dir / "config.json").read_text()))
    st = model_dir / "model.safetensors"
    if st.exists():
        sd = load_safetensors(st)
    else:
        sd = {k: v.numpy() for k, v in torch.load(model_dir / "pytorch_model.bin", map_location="cpu",
                                                  weights_only=True).items()}
    return convert_hf_state_dict(sd), cfg


def hf_config(cfg: SegFormerConfig) -> dict:
    """The HF ``config.json`` of ``cfg`` (the keys ``config_from_hf`` reads)."""
    from .config import ID2LABEL

    labels = ID2LABEL if cfg.num_labels == len(ID2LABEL) else {i: f"LABEL_{i}" for i in range(cfg.num_labels)}
    return {"model_type": "segformer", "id2label": {str(i): n for i, n in labels.items()},
            "depths": list(cfg.depths), "hidden_sizes": list(cfg.hidden_sizes),
            "num_attention_heads": list(cfg.num_heads), "sr_ratios": list(cfg.sr_ratios),
            "patch_sizes": list(cfg.patch_sizes), "strides": list(cfg.strides),
            "mlp_ratios": [cfg.mlp_ratio] * len(cfg.depths), "decoder_hidden_size": cfg.decoder_hidden}


def save_hf_checkpoint(model_dir, state: dict, cfg: SegFormerConfig | None = None):
    """Write ``state`` (numpy arrays or tensors, HF keys) as an HF checkpoint
    directory that ``load_hf_checkpoint`` reads: ``config.json`` and
    ``pytorch_model.bin``."""
    import json
    from pathlib import Path

    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    (model_dir / "config.json").write_text(json.dumps(hf_config(cfg or SegFormerConfig()), indent=1))
    torch.save({k: torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
                for k, v in state.items()}, model_dir / "pytorch_model.bin")
    return model_dir
