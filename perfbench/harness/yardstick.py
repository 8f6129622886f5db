"""The benchmark's fixed arithmetic: peaks, the union of busy intervals, the
least time of a kernel launch, and the FLOPs that a model's inputs need.

Frozen copies, kept apart from the program so that a change to the program
cannot move them: ``union`` is ``khmer_ocr_torch/profiling.py::union_us``,
``bound_s`` is ``chip_smoke.py::bound_ms`` in seconds, ``k2_cost`` is
``chip_smoke.py::k2_cost`` with the distinct cache rows passed in as a
count. Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores (TF32 off)
BF16_OPS_PER_S = 989e12  # dense bf16 x bf16 -> f32 on the tensor cores
CHUNK_TOKENS = 32
CHUNK_H, CHUNK_W = 48, 100


def union(intervals) -> float:
    """The length of the union of (start, stop) intervals."""
    total, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if stop <= end:
            continue
        total += stop - max(start, end)
        end = stop
    return total


def peak_ops(itemsize: int) -> float:
    """The card's peak for the storage type: float32 for 4-byte operands, bf16 for 2-byte ones."""
    return F32_OPS_PER_S if itemsize == 4 else BF16_OPS_PER_S


def bound_s(nbytes: float, ops: float, itemsize: int = 4) -> float:
    """The least time for these bytes and operations."""
    return max(nbytes / HBM_BYTES_PER_S, ops / peak_ops(itemsize))


def k2_cost(n_img: int, lanes: int, d: int, f: int, heads: int, pos: int, tm: int, tm_valid: int, pairs: int,
            weights_numel: int, beam: bool) -> tuple[int, int]:
    """Bytes and operations of one launch of K2 (one decoder layer step):
    each input read once and each output written once. ``pairs``: the
    distinct (row, slot) cache rows read below slot ``pos``; ``tm``: the
    memory's padded length, ``tm_valid`` its valid rows over the images."""
    b = n_img * lanes
    lin_ints = b * pos if beam else 0
    nbytes = 4 * (weights_numel + 2 * b * d + 2 * b * d + 2 * pairs * d + 2 * tm_valid * d + n_img * tm + lin_ints)
    matvec = 2 * b * (d * 3 * d + 3 * d * d + 2 * d * f)
    attn = 4 * b * (pos + 1) * d + 4 * lanes * tm_valid * d + 6 * heads * (b * (pos + 1) + lanes * tm_valid)
    return nbytes, matvec + attn + 30 * b * d


def k2_layer_numel(d: int, f: int) -> int:
    """The weights of one decoder layer that K2 reads: the packed self QKV,
    the self output, the cross query and output, the FFN, with their biases
    and the three LayerNorms (the cross K/V of the memory are inputs)."""
    mats = d * 3 * d + d * d + d * d + d * d + d * f + f * d
    vecs = 3 * d + d + d + d + f + d + 6 * d
    return mats + vecs


def conv_flops(c_in: int, c_out: int, k: int, h: int, w: int) -> int:
    return 2 * c_in * c_out * k * k * h * w


def backbone_flops(m: dict) -> int:
    """Multiply-adds x 2 of the convolutions and squeeze-excitation of one
    48 x 100 chunk."""
    h, w = CHUNK_H, CHUNK_W
    total = 0
    if m["backbone"] == "se_vgg":
        chans = [(1, 64), (64, 128), (128, 256), (256, 256), (256, 512), (512, 512), (512, 512)]
        pools = {1: (2, 2), 2: (2, 2), 4: (2, 1), 6: (2, 1)}
        se_after = {4, 6, 7}
        for i, (ci, co) in enumerate(chans, 1):
            total += conv_flops(ci, co, 3, h, w)
            if i in se_after:
                total += 2 * w * (2 * co * (co // 16))
            if i in pools:
                h, w = h // pools[i][0], w // pools[i][1]
        return total
    if m["backbone"] == "resnet":
        total += conv_flops(1, 64, 3, h, w)
        h, w = h // 2, w // 2
        stages = [(64, 128, 1), (128, 256, 2), (256, 512, 2), (512, 512, 1)]
        pools = [(2, 2), (2, 1), (2, 1), None]
        for (ci, co, n), pool in zip(stages, pools):
            c = ci
            for _ in range(n):
                total += conv_flops(c, co, 3, h, w) + conv_flops(co, co, 3, h, w)
                if c != co:
                    total += conv_flops(c, co, 1, h, w)
                c = co
            if pool is not None:
                h, w = h // pool[0], w // pool[1]
        return total
    raise ValueError(f"backbone {m['backbone']!r}")


def chunk_flops(m: dict) -> int:
    """One chunk through the backbone, the patch projection and the encoder layers."""
    d, t, fe = m["emb_dim"], CHUNK_TOKENS, m["enc_ffn_dim"]
    patch = 2 * t * 1024 * d
    enc = m["enc_layers"] * (4 * 2 * t * d * d + 2 * 2 * t * t * d + 2 * 2 * t * d * fe)
    return backbone_flops(m) + patch + enc


def line_encode_flops(m: dict, chunks: int) -> int:
    """A line of ``chunks`` real chunks encoded: every chunk, the BiLSTM over
    its tokens (both directions: input gates and recurrence), and each
    decoder layer's cross K and V of the memory."""
    d, t = m["emb_dim"], chunks * CHUNK_TOKENS
    total = chunks * chunk_flops(m)
    if m["use_bilstm"]:
        hid = d // 2
        total += 2 * t * (2 * d * 4 * hid + 2 * hid * 4 * hid)
    return total + m["dec_layers"] * 2 * 2 * t * d * d


def decode_step_flops(m: dict, pos: int, tm_valid: int) -> int:
    """One lane's decoder step at position ``pos`` over ``tm_valid`` memory
    rows: every layer's projections, attention and FFN, and the vocabulary
    projection."""
    d, f, v = m["emb_dim"], m["dec_ffn_dim"], m["vocab_size"]
    layer = 2 * d * 3 * d + 4 * (pos + 1) * d + 2 * d * d + 2 * d * d + 4 * tm_valid * d + 2 * d * d + 2 * 2 * d * f
    return m["dec_layers"] * layer + 2 * d * v


def line_decode_flops(m: dict, steps: int, lanes: int, tm_valid: int) -> int:
    """A line decoded for ``steps`` steps on ``lanes`` lanes."""
    return lanes * sum(decode_step_flops(m, pos, tm_valid) for pos in range(steps))


def line_train_flops(m: dict, chunks: int, label_len: int) -> int:
    """Forward and backward (three times the forward) of one training line:
    its chunks encoded, and the teacher-forced decoder over ``label_len``
    input positions with causal self-attention."""
    d, f, v = m["emb_dim"], m["dec_ffn_dim"], m["vocab_size"]
    tm = chunks * CHUNK_TOKENS
    t = label_len
    dec = m["dec_layers"] * (2 * t * d * 3 * d + 2 * 2 * t * t * d + 2 * t * d * d + 2 * t * d * d
                             + 2 * 2 * t * tm * d + 2 * t * d * d + 2 * 2 * t * d * f) + 2 * t * d * v
    return 3 * (line_encode_flops(m, chunks) + dec)


def decode_batches(served, chunk_buckets, batch_size: int):
    """The bucket batches of the served requests, as the Predictor forms
    them: each request's lines grouped by chunk bucket in arrival order, in
    batches of at most ``batch_size`` -> [(lines, bucket, [(chunks, steps)])]."""
    out = []
    for req in served:
        groups: dict = {}
        for c, s in zip(req.chunks, req.steps):
            b = next((k for k in chunk_buckets if c <= k), c)
            groups.setdefault(b, []).append((c, s))
        for b, items in groups.items():
            for i in range(0, len(items), batch_size):
                part = items[i:i + batch_size]
                out.append((len(part), b, part))
    return out


def k2_least_s(run) -> float:
    """The least time of the K2 launches the served lines need: per bucket
    batch, every step up to the last step one of its lines took, every
    decoder layer; the lanes of a beam counted as sharing their history
    (the least cache rows they can read)."""
    m = run.model
    d, f, heads, layers = m["emb_dim"], m["dec_ffn_dim"], m["num_heads"], m["dec_layers"]
    lanes = run.counters["lanes"]
    numel = k2_layer_numel(d, f)
    total = 0.0
    for n, bucket, part in decode_batches(run.served, run.counters["chunk_buckets"], run.counters["batch_size"]):
        tm_valid = sum(c for c, _ in part) * CHUNK_TOKENS
        for pos in range(max(s for _, s in part)):
            nbytes, ops = k2_cost(n, lanes, d, f, heads, pos, bucket * CHUNK_TOKENS, tm_valid, n * pos, numel,
                                  lanes > 1)
            total += layers * bound_s(nbytes, ops)
    return total


def serve_flops(run) -> int:
    """The FLOPs the served lines need: each line's real chunks encoded, and
    its decode steps on every lane over its own memory."""
    m, lanes = run.model, run.counters["lanes"]
    total = 0
    for req in run.served:
        for c, s in zip(req.chunks, req.steps):
            total += line_encode_flops(m, c) + line_decode_flops(m, s, lanes, c * CHUNK_TOKENS)
    return total
