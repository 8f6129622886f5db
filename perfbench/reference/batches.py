"""The training batches of an epoch, worked out from the samples alone.

The recipe's bucketing: every sample's line has min(windows, 16) chunks
(windows of 100 px every 84), its label <sos> text <eos> by the
vocabulary; samples are taken in the order of a shuffle drawn from the
sampler (``numpy`` ``default_rng``; one seed each is drawn after it) and
grouped by (chunk bucket, label bucket): chunk buckets 1-4, 6, 8, 12, 16;
label buckets 16-256 by powers of two, at least 32 for 1-2 chunks, 64 for
3-6, 128 for 8-12 and 256 for 16, at most ``max_label_len``. A group that
fills emits its batch: the lines white-padded to the bucket's width
(uint8), their true widths, chunk counts, and labels padded with <pad> (a
longer label cut, keeping its <eos>).
"""

from __future__ import annotations

import numpy as np

CHUNK_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16)
LABEL_BUCKETS = (16, 32, 64, 128, 256)
LABEL_FLOOR = {1: 32, 2: 32, 3: 64, 4: 64, 6: 64, 8: 128, 12: 128, 16: 256}


def _bucket(n: int, buckets) -> int:
    return next((b for b in buckets if n <= b), buckets[-1])


def first_batches(samples: list, vocab: dict, batch_size: int, sampler: np.random.Generator, n: int,
                  max_label_len: int) -> list:
    """The first ``n`` batches the epoch emits, as dicts of numpy arrays."""
    order = np.arange(len(samples))
    sampler.shuffle(order)
    sampler.integers(0, 2 ** 31, size=len(order))
    groups: dict = {}
    out = []
    for i in order.tolist():
        line, text = samples[i][0], samples[i][1]
        chunks = min((line.shape[1] - 1) // 84 + 1, CHUNK_BUCKETS[-1])
        ids = [vocab["<sos>"]] + [vocab.get(ch, vocab["<unk>"]) for ch in text] + [vocab["<eos>"]]
        nb = _bucket(chunks, CHUNK_BUCKETS)
        lb = min(max(_bucket(len(ids), LABEL_BUCKETS), LABEL_FLOOR[nb]), max_label_len)
        group = groups.setdefault((nb, lb), [])
        group.append((line, chunks, ids))
        if len(group) == batch_size:
            out.append(assemble(group, nb, lb, vocab))
            groups[(nb, lb)] = []
            if len(out) == n:
                return out
    raise ValueError(f"the epoch emits fewer than {n} full batches")


def assemble(part: list, nb: int, lb: int, vocab: dict) -> dict:
    b, wb = len(part), (nb - 1) * 84 + 100
    lines = np.full((b, 48, wb), 255, np.uint8)
    widths = np.zeros(b, np.int32)
    counts = np.zeros(b, np.int32)
    labels = np.full((b, lb), vocab["<pad>"], np.int32)
    for i, (line, chunks, ids) in enumerate(part):
        keep = min(line.shape[1], wb)
        lines[i, :, :keep] = line[:, :keep]
        widths[i], counts[i] = keep, chunks
        if len(ids) > lb:
            ids = ids[:lb - 1] + [vocab["<eos>"]]
        labels[i, :len(ids)] = ids
    return {"lines": lines, "widths": widths, "chunk_counts": counts, "labels": labels}
