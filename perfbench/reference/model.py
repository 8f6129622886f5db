"""The recognizer written out in plain PyTorch: the benchmark's reference.

The model of netra-ai-lab/Khmer-OCR-CNN-Transformer (se_model.py,
resnet_model.py): a CNN over 48x100 chunks that overlap by 16 px, a patch
projection to 32 tokens a chunk, a transformer encoder over each chunk, the
chunks of a line joined with learned global positions, a BiLSTM over the
line (se_vgg only), and a transformer decoder over characters. Post-LN,
ReLU, LayerNorm eps 1e-5, BatchNorm eps 1e-5.

Weights are trees in the JAX package's layout (nested dicts, lists for
layers): dense weights (in, out), conv kernels HWIO, BatchNorm statistics in
a tree of their own. The reference reads them as given and shares no code
with the program under test: every operation is a plain torch call, the
decoder runs teacher-forced over whole sequences (no cache), the LSTM is a
loop over time.

``Ref(..., mode="tf32")`` rounds both operands of every matrix product and
convolution to TF32 (10 mantissa bits, to nearest), the precision one step
below the float32 at "highest" that the configurations state: the control
that the comparison has to fail.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG = -1e30
CHUNK_W, CHUNK_STRIDE, CHUNK_TOKENS, IMG_H = 100, 84, 32, 48
SE_VGG_POOLS = {1: (2, 2), 2: (2, 2), 4: (2, 1), 6: (2, 1)}  # max pool after conv i
SE_AFTER = {4: "se3", 6: "se4", 7: "se5"}  # squeeze-excitation after conv i
RESNET_POOLS = [(2, 2), (2, 1), (2, 1), None]  # after each stage


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties away from zero), as float32."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def chunk_lines(lines: list, device) -> tuple[torch.Tensor, torch.Tensor]:
    """uint8 (48, W) lines -> normalised chunks (B, N, 48, 100), white past
    each line's end, and the chunk counts (B,): windows start every 84 px
    while the start lies inside the line."""
    counts = [max(1, (ln.shape[1] - 1) // CHUNK_STRIDE + 1) for ln in lines]
    n = max(counts)
    width = (n - 1) * CHUNK_STRIDE + CHUNK_W
    out = torch.full((len(lines), IMG_H, width), 255, dtype=torch.uint8)
    for i, ln in enumerate(lines):
        if ln.shape[0] != IMG_H:
            raise ValueError(f"line {i} is {ln.shape[0]} px high; the reference takes {IMG_H}")
        out[i, :, :ln.shape[1]] = torch.from_numpy(ln)
    x = (out.to(device).float() / 255.0 - 0.5) / 0.5
    chunks = torch.stack([x[:, :, s * CHUNK_STRIDE:s * CHUNK_STRIDE + CHUNK_W] for s in range(n)], dim=1)
    return chunks, torch.tensor(counts, device=device)


class Ref:
    """One model's reference forward. ``params``/``stats``: the JAX-layout
    trees as tensors on one device; ``cfg``: the configuration's "model"
    dict; ``mode``: "f32" (TF32 off) or "tf32" (the control)."""

    def __init__(self, params: dict, stats: dict, cfg: dict, mode: str = "f32"):
        if mode not in ("f32", "tf32"):
            raise ValueError(f"mode {mode!r}: f32 or tf32")
        self.p, self.s, self.cfg, self.mode = params, stats, cfg, mode

    # -- arithmetic with the mode's operand rounding --------------------------------------------------------------
    def r(self, x: torch.Tensor) -> torch.Tensor:
        """The operand in the mode's precision; TF32's rounding passes the
        gradient straight through, so that the control trains."""
        return x + (round_tf32(x.detach()) - x.detach()) if self.mode == "tf32" else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.r(a), self.r(b))

    def dense(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        return self.mm(x, p["w"]) + p["b"]

    def conv(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        w = p["w"].permute(3, 2, 0, 1)  # HWIO -> OIHW
        return F.conv2d(self.r(x), self.r(w), p.get("b"), padding=w.shape[-1] // 2)

    @staticmethod
    def layer_norm(p: dict, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + 1e-5) * p["scale"] + p["bias"]

    @staticmethod
    def batch_norm(p: dict, s: dict, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        return (x - s["mean"].view(shape)) / torch.sqrt(s["var"].view(shape) + 1e-5) * p["scale"].view(shape) \
            + p["bias"].view(shape)

    # -- backbones (NCHW inside) ----------------------------------------------------------------------------------
    def se(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        y = x.mean(dim=2).transpose(1, 2)  # (B, W, C)
        y = torch.sigmoid(self.dense(p["fc2"], torch.relu(self.dense(p["fc1"], y))))
        return x * y.transpose(1, 2)[:, :, None, :]

    def se_vgg(self, x: torch.Tensor) -> torch.Tensor:
        p, s = self.p["backbone"], self.s
        for i in range(1, 8):
            name = f"conv{i}"
            x = torch.relu(self.batch_norm(p[f"bn_{name}"], s[f"bn_{name}"], self.conv(p[name], x)))
            if i in SE_AFTER:
                x = self.se(p[SE_AFTER[i]], x)
            if i in SE_VGG_POOLS:
                x = F.max_pool2d(x, SE_VGG_POOLS[i])
        return x

    def resnet(self, x: torch.Tensor) -> torch.Tensor:
        p, s = self.p["backbone"], self.s
        x = F.max_pool2d(torch.relu(self.batch_norm(p["stem_bn"], s["stem_bn"], self.conv(p["stem_conv"], x))), 2)
        for i, pool in enumerate(RESNET_POOLS):
            for bp, bs in zip(p[f"layer{i + 1}"], s[f"layer{i + 1}"]):
                out = torch.relu(self.batch_norm(bp["bn1"], bs["bn1"], self.conv(bp["conv1"], x)))
                out = self.batch_norm(bp["bn2"], bs["bn2"], self.conv(bp["conv2"], out))
                short = x
                if "short_conv" in bp:
                    short = self.batch_norm(bp["short_bn"], bs["short_bn"], self.conv(bp["short_conv"], x))
                x = torch.relu(out + short)
            if pool is not None:
                x = F.max_pool2d(x, pool)
        return x

    # -- the encoder ----------------------------------------------------------------------------------------------
    def mha(self, p: dict, q_in, kv_in, key_pad=None, causal: bool = False) -> torch.Tensor:
        h = self.cfg["num_heads"]
        b, tq, d = q_in.shape
        tk = kv_in.shape[1]
        q = self.dense(p["q"], q_in).view(b, tq, h, d // h).transpose(1, 2)
        k = self.dense(p["k"], kv_in).view(b, tk, h, d // h).transpose(1, 2)
        v = self.dense(p["v"], kv_in).view(b, tk, h, d // h).transpose(1, 2)
        logits = self.mm(q, k.transpose(-1, -2)) / math.sqrt(d // h)
        if causal:
            logits = logits.masked_fill(~torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril(), NEG)
        if key_pad is not None:
            logits = logits.masked_fill(key_pad[:, None, None, :], NEG)
        out = self.mm(torch.softmax(logits, dim=-1), v).transpose(1, 2).reshape(b, tq, d)
        return self.dense(p["o"], out)

    def ffn(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        return self.dense(p["lin2"], torch.relu(self.dense(p["lin1"], x)))

    def lstm(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        """One direction over (B, T, D) -> (B, T, H); gates i, f, g, o."""
        b, t, _ = x.shape
        hid = p["w_hh"].shape[0]
        xg = self.mm(x, p["w_ih"]) + p["b_ih"] + p["b_hh"]
        h = x.new_zeros(b, hid)
        c = x.new_zeros(b, hid)
        out = []
        for step in range(t):
            g = xg[:, step] + self.mm(h, p["w_hh"])
            i, f, gg, o = g.split(hid, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
            h = torch.sigmoid(o) * torch.tanh(c)
            out.append(h)
        return torch.stack(out, dim=1)

    @staticmethod
    def flip_valid(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        t = x.shape[1]
        pos = torch.arange(t, device=x.device)[None, :]
        idx = torch.where(pos < lengths[:, None], lengths[:, None] - 1 - pos, pos)
        return torch.gather(x, 1, idx[:, :, None].expand_as(x))

    def encode(self, chunks: torch.Tensor, counts: torch.Tensor):
        """(B, N, 48, 100) normalised chunks, (B,) counts -> memory (B, N*32, D)
        and its padding mask (True = padding)."""
        b, n = chunks.shape[:2]
        x = chunks.reshape(b * n, 1, IMG_H, CHUNK_W)
        x = self.se_vgg(x) if self.cfg["backbone"] == "se_vgg" else self.resnet(x)
        x = F.adaptive_avg_pool2d(x, (2, 32))  # (BN, C, 2, 32)
        x = x.permute(0, 3, 2, 1).reshape(b * n, CHUNK_TOKENS, -1)  # each column's two rows, h-major then c
        tok = self.dense(self.p["patch"]["proj"], x) + self.p["patch"]["pos_emb"][:CHUNK_TOKENS]
        for lp in self.p["enc"]:
            tok = self.layer_norm(lp["ln1"], tok + self.mha(lp["self"], tok, tok))
            tok = self.layer_norm(lp["ln2"], tok + self.ffn(lp, tok))
        t = n * CHUNK_TOKENS
        memory = tok.reshape(b, t, -1) + self.p["global_pos"][:t]
        lengths = counts.long() * CHUNK_TOKENS
        if self.cfg["use_bilstm"]:
            fw = self.lstm(self.p["bilstm"]["fw"], memory)
            bw = self.flip_valid(self.lstm(self.p["bilstm"]["bw"], self.flip_valid(memory, lengths)), lengths)
            memory = torch.cat([fw, bw], dim=-1)
        pad = torch.arange(t, device=memory.device)[None, :] >= lengths[:, None]
        return memory, pad

    # -- the decoder ----------------------------------------------------------------------------------------------
    def decode_logp(self, memory, pad, tokens: torch.Tensor) -> torch.Tensor:
        """Teacher-forced: tokens (B, T) from <sos> -> log-probs (B, T, V) of
        the token after each position. Causal self-attention over every
        token fed, as an incremental decode attends its cache."""
        dec = self.p["dec"]
        t = tokens.shape[1]
        x = dec["tok_emb"][tokens] + dec["pos_emb"][:t][None]
        for lp in dec["layers"]:
            x = self.layer_norm(lp["ln1"], x + self.mha(lp["self"], x, x, causal=True))
            x = self.layer_norm(lp["ln2"], x + self.mha(lp["cross"], x, memory, key_pad=pad))
            x = self.layer_norm(lp["ln3"], x + self.ffn(lp, x))
        return torch.log_softmax(self.dense(dec["out"], x), dim=-1)


def calibrate_batch_norm(ref: Ref, chunks: torch.Tensor) -> None:
    """Set every BatchNorm's statistics of ``ref`` to the mean and biased
    variance that its input takes over ``chunks`` (N, 48, 100), layer after
    layer, so that each normalises the features of real lines to unit scale:
    seeded weights whose features then differ from line to line."""
    stats = ref.s

    def bn(p, s, x):
        s["mean"] = x.mean(dim=(0, 2, 3))
        s["var"] = x.var(dim=(0, 2, 3), unbiased=False)
        return Ref.batch_norm(p, s, x)

    ref.batch_norm = bn
    try:
        x = chunks.reshape(-1, 1, IMG_H, CHUNK_W)
        ref.se_vgg(x) if ref.cfg["backbone"] == "se_vgg" else ref.resnet(x)
    finally:
        del ref.batch_norm
    ref.s = stats
