"""The recognizer's train step written out in plain PyTorch.

One step on a batch of uint8 lines (B, 48, Wb) white-padded to their chunk
bucket, true widths (B,), chunk counts (B,) and labels (B, L) <sos> ... <eos>
<pad>*:

  * augmentation on the device, drawn from a ``torch.Generator`` on the
    lines' device in a fixed order (a frozen copy of the augmentation that
    the configuration's recipe states: geometry none / short / shrink, blur
    p 0.3, noise p 0.5, shift p 0.5, each line with probability p);
  * normalisation, windows of 100 px every 84;
  * the model in train mode: BatchNorm on the batch's statistics (biased
    variance; the running ones moved by 0.1 towards the batch mean and the
    unbiased variance), inverted dropout drawn from the same generator on
    every attention matrix and every residual branch and FFN hidden layer,
    in the order the layers run them;
  * the cross-entropy of ``labels[:, 1:]`` given ``labels[:, :-1]``, padding
    masked in the decoder's keys and in the mean;
  * Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected) at the step's rate.

``params`` and ``stats`` are JAX-layout trees of tensors (reference/model.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .model import CHUNK_STRIDE, CHUNK_TOKENS, CHUNK_W, IMG_H, NEG, Ref
from .weights import tree_map

B1, B2, EPS = 0.9, 0.999, 1e-8
BN_MOMENTUM = 0.1


# -- augmentation ---------------------------------------------------------------------------------------------------
def _resample(img, coord, dim: int, n_valid):
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


def augment(imgs, widths, gen, p: float):
    """imgs (B, H, Wb) in [0, 1], widths (B,) -> augmented (B, H, Wb)."""
    b, h, wb = imgs.shape
    dev, f32 = imgs.device, imgs.dtype

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(b, generator=gen, device=dev, dtype=f32)

    geom = torch.randint(0, 3, (b,), generator=gen, device=dev)
    scale_h, scale_all = uniform(0.7, 0.98), uniform(0.8, 0.98)
    do_blur, blur_sigma = uniform(0.0, 1.0) < 0.3, uniform(0.5, 1.0)
    do_noise, noise_std = uniform(0.0, 1.0) < 0.5, uniform(0.02, 0.08)
    do_shift = uniform(0.0, 1.0) < 0.5
    shift = torch.randint(-8, 9, (b,), generator=gen, device=dev)
    noise = torch.randn(imgs.shape, generator=gen, device=dev, dtype=f32)
    apply = uniform(0.0, 1.0) < p
    # geometry: resize then paste, centred on the true width when shrinking
    w = widths.to(f32)
    new_h = torch.where(geom == 1, torch.floor(h * scale_h),
                        torch.where(geom == 2, torch.floor(h * scale_all), torch.full_like(scale_h, float(h))))
    new_w = torch.where(geom == 2, torch.clamp_min(torch.floor(w * scale_all), 1.0), w)
    top = torch.floor((h - new_h) / 2.0)
    left = torch.where(geom == 2, torch.floor((w - new_w) / 2.0), torch.zeros_like(w))
    ys = torch.arange(h, device=dev, dtype=f32)[None, :]
    xs = torch.arange(wb, device=dev, dtype=f32)[None, :]
    sy = (ys - top[:, None] + 0.5) * (h / new_h)[:, None] - 0.5
    sx = (xs - left[:, None] + 0.5) * (w / new_w)[:, None] - 0.5
    inside = (((ys >= top[:, None]) & (ys < (top + new_h)[:, None]))[:, :, None]
              & ((xs >= left[:, None]) & (xs < (left + new_w)[:, None]))[:, None, :])
    rows = _resample(imgs, sy, 1, torch.full_like(widths, h).to(torch.long))
    out = torch.where(inside, _resample(rows, sx, 2, widths.to(torch.long)), torch.ones((), dtype=f32, device=dev))
    # blur: 3 taps, zero border; sigma 0.05 (the identity) where off
    sigma = torch.where(do_blur, blur_sigma, torch.full_like(blur_sigma, 0.05))
    side = torch.exp(-1.0 / (2.0 * sigma * sigma))
    norm = side + 1.0 + side
    k0, k1 = (side / norm)[:, None, None], (1.0 / norm)[:, None, None]
    q = F.pad(out, (0, 0, 1, 1))
    out = q[:, :-2] * k0 + q[:, 1:-1] * k1 + q[:, 2:] * k0
    q = F.pad(out, (1, 1))
    out = q[:, :, :-2] * k0 + q[:, :, 1:-1] * k1 + q[:, :, 2:] * k0
    # noise inside the true width
    mask = (do_noise[:, None] & (torch.arange(wb, device=dev)[None, :] < widths[:, None]))[:, None, :]
    out = torch.clamp(out + noise * noise_std[:, None, None] * mask, 0.0, 1.0)
    # shift with white fill
    s = torch.where(do_shift, shift, torch.zeros_like(shift))
    src = torch.arange(wb, device=dev)[None, :] - s[:, None].to(torch.long)
    valid = (src >= 0) & (src < wb)
    moved = torch.gather(out, 2, src.clamp(0, wb - 1)[:, None, :].expand(-1, h, -1))
    out = torch.where(valid[:, None, :], moved, torch.ones((), dtype=f32, device=dev))
    return torch.where(apply[:, None, None], out, imgs)


class RefTrain(Ref):
    """``Ref`` in train mode: batch statistics, dropout from ``gen``."""

    def __init__(self, params, stats, cfg, gen, mode: str = "f32"):
        super().__init__(params, stats, cfg, mode)
        self.gen, self.rate, self.new_stats = gen, cfg["dropout"], {}

    def drop(self, x):
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=self.gen, device=x.device, dtype=x.dtype) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))

    def batch_norm(self, p, s, x):
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        n = x.numel() // x.shape[1]
        self.new_stats[id(s)] = (s, {"mean": s["mean"] * (1 - BN_MOMENTUM) + mean.detach() * BN_MOMENTUM,
                                     "var": s["var"] * (1 - BN_MOMENTUM) + var.detach() * (n / (n - 1)) * BN_MOMENTUM})
        shape = (1, -1, 1, 1)
        return (x - mean.view(shape)) / torch.sqrt(var.view(shape) + 1e-5) * p["scale"].view(shape) \
            + p["bias"].view(shape)

    def mha(self, p, q_in, kv_in, key_pad=None, causal: bool = False):
        h = self.cfg["num_heads"]
        b, tq, d = q_in.shape
        tk = kv_in.shape[1]
        q = self.dense(p["q"], q_in).view(b, tq, h, d // h).transpose(1, 2)
        k = self.dense(p["k"], kv_in).view(b, tk, h, d // h).transpose(1, 2)
        v = self.dense(p["v"], kv_in).view(b, tk, h, d // h).transpose(1, 2)
        logits = self.mm(q, k.transpose(-1, -2)) / (d // h) ** 0.5
        if causal:
            logits = logits.masked_fill(~torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril(), NEG)
        if key_pad is not None:
            logits = logits.masked_fill(key_pad[:, None, None, :], NEG)
        w = self.drop(torch.softmax(logits, dim=-1))
        return self.dense(p["o"], self.mm(w, v).transpose(1, 2).reshape(b, tq, d))

    def ffn(self, p, x):
        return self.dense(p["lin2"], self.drop(torch.relu(self.dense(p["lin1"], x))))

    def encode_train(self, chunks, counts):
        """As ``Ref.encode``, with dropout on the encoder's layers."""
        b, n = chunks.shape[:2]
        x = chunks.reshape(b * n, 1, IMG_H, CHUNK_W)
        x = self.se_vgg(x) if self.cfg["backbone"] == "se_vgg" else self.resnet(x)
        x = F.adaptive_avg_pool2d(x, (2, 32)).permute(0, 3, 2, 1).reshape(b * n, CHUNK_TOKENS, -1)
        tok = self.dense(self.p["patch"]["proj"], x) + self.p["patch"]["pos_emb"][:CHUNK_TOKENS]
        for lp in self.p["enc"]:
            tok = self.layer_norm(lp["ln1"], tok + self.drop(self.mha(lp["self"], tok, tok)))
            tok = self.layer_norm(lp["ln2"], tok + self.drop(self.ffn(lp, tok)))
        t = n * CHUNK_TOKENS
        memory = tok.reshape(b, t, -1) + self.p["global_pos"][:t]
        lengths = counts.long() * CHUNK_TOKENS
        if self.cfg["use_bilstm"]:
            fw = self.lstm(self.p["bilstm"]["fw"], memory)
            bw = self.flip_valid(self.lstm(self.p["bilstm"]["bw"], self.flip_valid(memory, lengths)), lengths)
            memory = torch.cat([fw, bw], dim=-1)
        return memory, torch.arange(t, device=memory.device)[None, :] >= lengths[:, None]

    def loss(self, batch: dict, p_aug: float):
        unit = batch["lines"].float() / 255.0
        if p_aug > 0.0:  # at probability 0 nothing is drawn
            unit = augment(unit, batch["widths"], self.gen, p_aug)
        x = (unit - 0.5) / 0.5
        n = (x.shape[2] - CHUNK_W) // CHUNK_STRIDE + 1
        chunks = torch.stack([x[:, :, s * CHUNK_STRIDE:s * CHUNK_STRIDE + CHUNK_W] for s in range(n)], dim=1)
        memory, pad = self.encode_train(chunks, batch["chunk_counts"])
        labels = batch["labels"].long()
        inp, tgt = labels[:, :-1], labels[:, 1:]
        dec = self.p["dec"]
        t = inp.shape[1]
        y = dec["tok_emb"][inp] + dec["pos_emb"][:t][None]
        tgt_pad = inp == self.cfg["pad_idx"]
        for lp in dec["layers"]:
            y = self.layer_norm(lp["ln1"], y + self.drop(self.mha(lp["self"], y, y, key_pad=tgt_pad, causal=True)))
            y = self.layer_norm(lp["ln2"], y + self.drop(self.mha(lp["cross"], y, memory, key_pad=pad)))
            y = self.layer_norm(lp["ln3"], y + self.drop(self.ffn(lp, y)))
        logp = torch.log_softmax(self.dense(dec["out"], y), dim=-1)
        mask = (tgt != self.cfg["pad_idx"]).float()
        nll = -logp.gather(-1, tgt[..., None])[..., 0]
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def leaves(tree, prefix=()):
    """{path: tensor} of a tree."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in leaves(sub, prefix + (key,)).items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree) for k, v in leaves(sub, prefix + (i,)).items()}
    return {prefix: tree}


def train_steps(params: dict, stats: dict, cfg: dict, batches: list, lrs: list, gen, p_aug: float,
                mode: str = "f32", adam: dict | None = None):
    """The reference's steps from (params, stats) -> (losses, {path: first
    gradient}, {path: params after the steps}). ``adam``: the moments
    ({path: tensor} "mu" and "nu") and the count of steps that came before
    (zeros and 0 by default). ``params`` is left as it was."""
    flat = {k: v.detach().clone().requires_grad_(True) for k, v in leaves(params).items()}
    adam = adam or {"mu": {}, "nu": {}, "count": 0}
    mu = {k: adam["mu"][k].clone() if k in adam["mu"] else torch.zeros_like(v) for k, v in flat.items()}
    nu = {k: adam["nu"][k].clone() if k in adam["nu"] else torch.zeros_like(v) for k, v in flat.items()}
    stats = tree_map(lambda t: t.detach().clone(), stats)
    losses, first = [], None
    for t, (batch, lr) in enumerate(zip(batches, lrs), adam["count"] + 1):
        tree = rebuild(params, flat)
        ref = RefTrain(tree, stats, cfg, gen, mode)
        loss = ref.loss(batch, p_aug)
        grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(flat[k])) for k, g in zip(flat, grads)}
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        with torch.no_grad():
            for k, g in grads.items():
                mu[k] = B1 * mu[k] + (1 - B1) * g
                nu[k] = B2 * nu[k] + (1 - B2) * g * g
                step = (mu[k] / (1 - B1 ** t)) / (torch.sqrt(nu[k] / (1 - B2 ** t)) + EPS)
                flat[k] -= lr * step
            for s, new in ref.new_stats.values():
                s["mean"].copy_(new["mean"])
                s["var"].copy_(new["var"])
        losses.append(float(loss.detach()))
    return losses, first, {k: v.detach() for k, v in flat.items()}


def rebuild(like, flat: dict, prefix=()):
    if isinstance(like, dict):
        return {k: rebuild(v, flat, prefix + (k,)) for k, v in like.items()}
    if isinstance(like, list):
        return [rebuild(v, flat, prefix + (i,)) for i, v in enumerate(like)]
    return flat[prefix]
