"""Host-side line preprocessing: load -> resize to 48 px -> bucket.

A line is grayscale uint8 of height ``img_height``. It is white-padded (255)
to the width of its chunk bucket, so that the device can cut the 100-px
windows with one strided gather (ops/lines.py) and normalise there. Lines are
grouped by chunk bucket, in arrival order, into batches of at most
``max_batch``; full batches are emitted as they fill and the partial tails
afterwards, in ascending bucket order.

PIL is imported only where it is needed: for file paths, PIL images, and
arrays that are not already ``img_height`` px high.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from .config import PreprocessConfig, RuntimeConfig

WHITE = 1.0  # pre-normalisation white padding value


def chunk_line(line: np.ndarray, cfg: PreprocessConfig, n_chunks: int | None = None) -> np.ndarray:
    """Slice an (H, W) float line into (N, H, chunk_width) windows.

    Windows start at multiples of the stride while start < W; anything past W
    is white (1.0). A larger ``n_chunks`` appends all-white chunks; a smaller
    one truncates the line to the windows' coverage."""
    h, w = line.shape
    n = cfg.num_chunks(w) if n_chunks is None else n_chunks
    padded_w = (n - 1) * cfg.chunk_stride + cfg.chunk_width
    padded = np.full((h, padded_w), WHITE, dtype=np.float32)
    keep = min(w, padded_w)
    padded[:, :keep] = line[:, :keep]
    s0, s1 = padded.strides
    view = np.lib.stride_tricks.as_strided(
        padded, shape=(n, h, cfg.chunk_width), strides=(cfg.chunk_stride * s1, s0, s1))
    return np.ascontiguousarray(view)


def normalize(x: np.ndarray) -> np.ndarray:
    return (x - 0.5) / 0.5


def bucket_for(n_chunks: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n_chunks <= b:
            return b
    return buckets[-1]


@dataclasses.dataclass
class PreparedBatch:
    """lines: (B, H, Wb) uint8, white-padded to the bucket width;
    chunk_counts: (B,) int32 true chunks per line (<= bucket_n);
    indices: positions of these lines in the caller's list."""

    lines: np.ndarray
    chunk_counts: np.ndarray
    indices: list[int]
    bucket_n: int


def _to_uint8(arr: np.ndarray) -> np.ndarray:
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0 if arr.max() <= 1.0 else arr, 0, 255).astype(np.uint8)
    return arr


class Preprocessor:
    """Turns line images into bucketed uint8 batches."""

    def __init__(self, cfg: PreprocessConfig | None = None, runtime: RuntimeConfig | None = None):
        self.cfg = cfg or PreprocessConfig()
        self.runtime = runtime or RuntimeConfig()

    def load_line_u8(self, src) -> np.ndarray:
        """One source -> uint8 (img_height, W). A 2-D array that is already
        ``img_height`` px high and at least ``min_width`` wide is taken as it
        is (the resize would be the identity); everything else goes through
        PIL's grayscale conversion and bilinear resize."""
        cfg = self.cfg
        if isinstance(src, np.ndarray):
            arr = _to_uint8(src)
            if arr.ndim == 2 and arr.shape[0] == cfg.img_height and arr.shape[1] >= cfg.min_width:
                return np.ascontiguousarray(arr)
        from PIL import Image

        if isinstance(src, (str, Path)):
            p = Path(src)
            if not p.exists():
                raise FileNotFoundError(f"Image not found: {p}")
            image = Image.open(p).convert("L")
        elif isinstance(src, Image.Image):
            image = src.convert("L")
        elif isinstance(src, np.ndarray):
            image = Image.fromarray(_to_uint8(src)).convert("L")
        else:
            raise ValueError(f"Unsupported image source type: {type(src)!r}")
        new_width = max(cfg.min_width, int(cfg.img_height * (image.width / image.height)))
        image = image.resize((new_width, cfg.img_height), Image.Resampling.BILINEAR)
        return np.asarray(image, dtype=np.uint8)

    def prepare_one(self, src) -> tuple[int, int, np.ndarray]:
        """-> (bucket_n, chunk count, line white-padded to the bucket width)."""
        cfg, buckets = self.cfg, self.runtime.chunk_buckets
        line = self.load_line_u8(src)
        w = line.shape[1]
        n = min(cfg.num_chunks(w), buckets[-1])
        bucket_n = bucket_for(n, buckets)
        padded_w = (bucket_n - 1) * cfg.chunk_stride + cfg.chunk_width
        padded = np.full((line.shape[0], padded_w), 255, np.uint8)
        keep = min(w, padded_w)
        padded[:, :keep] = line[:, :keep]
        return bucket_n, n, padded

    def iter_batches(self, image_sources: list, max_batch: int | None = None):
        grouped: dict[int, list[tuple[int, int, np.ndarray]]] = {}

        def assemble(bucket_n, part) -> PreparedBatch:
            return PreparedBatch(
                lines=np.stack([c for _, _, c in part]),
                chunk_counts=np.array([n for _, n, _ in part], np.int32),
                indices=[i for i, _, _ in part],
                bucket_n=bucket_n,
            )

        for i, src in enumerate(image_sources):
            bucket_n, n, padded = self.prepare_one(src)
            bin_ = grouped.setdefault(bucket_n, [])
            bin_.append((i, n, padded))
            if max_batch and len(bin_) == max_batch:
                grouped.pop(bucket_n)
                yield assemble(bucket_n, bin_)
        for bucket_n in sorted(grouped):
            items = grouped[bucket_n]
            step = max_batch or len(items)
            for j in range(0, len(items), step):
                yield assemble(bucket_n, items[j:j + step])
