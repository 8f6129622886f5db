"""Synthetic uint8 text-line images from a numpy seed (no fonts, no PIL).

Dark blocks with holes on a white, lightly noisy background: enough structure
for a randomly initialised model to give each line its own output, made the
same way on every machine. ``synthetic_samples`` pairs them with label
strings drawn from the vocabulary, and ``synthetic_dataset`` makes a
training dataset of them: training runs that need no fonts and no Pillow
(the rendered lines of data/generator.py need both).
"""

from __future__ import annotations

import numpy as np

from ..config import PreprocessConfig


def width_for_chunks(n_chunks: int, cfg: PreprocessConfig | None = None) -> int:
    """A line width that the chunker cuts into exactly ``n_chunks`` windows."""
    cfg = cfg or PreprocessConfig()
    return max(cfg.min_width, (n_chunks - 1) * cfg.chunk_stride + cfg.chunk_stride * 3 // 4)


def synthetic_lines(chunk_counts, seed: int = 0, cfg: PreprocessConfig | None = None) -> list[np.ndarray]:
    """One (img_height, W) uint8 line per entry of ``chunk_counts``."""
    cfg = cfg or PreprocessConfig()
    rs = np.random.RandomState(seed)
    h = cfg.img_height
    lines = []
    for n in chunk_counts:
        w = width_for_chunks(int(n), cfg)
        img = np.full((h, w), 255, np.int32)
        x = int(rs.randint(2, 8))
        while x < w - 12:
            gw = int(rs.randint(3, 11))
            top, bot = int(rs.randint(h // 6, h // 2)), int(rs.randint(h // 2 + 4, h - 4))
            img[top:bot, x:x + gw] = int(rs.randint(0, 90))
            img[int(rs.randint(top, bot)), x:x + gw] = 255
            x += gw + int(rs.randint(2, 8))
        img += rs.randint(-12, 13, size=img.shape)
        lines.append(np.clip(img, 0, 255).astype(np.uint8))
    return lines


def synthetic_samples(chunk_counts, seed: int = 0, cfg: PreprocessConfig | None = None) -> list[tuple]:
    """(line, text) per entry of ``chunk_counts``: ``synthetic_lines`` and a
    string of 2 to 14 x chunks characters of the bundled vocabulary (its
    Khmer and ASCII entries), drawn from the same seed."""
    from ..tokenizer import Tokenizer

    chars = [c for c in Tokenizer().char2idx if not c.startswith("<")]
    rs = np.random.RandomState(seed + 1)
    texts = ["".join(rs.choice(chars, size=int(rs.randint(2, 14 * int(n) + 1)))) for n in chunk_counts]
    return list(zip(synthetic_lines(chunk_counts, seed, cfg), texts))


def synthetic_dataset(n: int, seed: int, train_cfg=None, device_augment: bool = True):
    """A LineDataset of ``n`` seeded lines of 1-16 chunks with label strings
    drawn from the vocabulary (``synthetic_samples``)."""
    from ..train.data import LineDataset

    counts = np.random.RandomState(seed).randint(1, 17, size=n)
    return LineDataset(synthetic_samples(counts.tolist(), seed), train_cfg=train_cfg, device_augment=device_augment)
