"""Training input: samples -> bucketed batches of static shape.

Every batch is (B, N_bucket) chunks, or (B, H, Wb) uint8 lines in the
device-augment layout, with (B,) chunk counts and (B, L_bucket) labels
(<sos> ... <eos> <pad>*). Samples are grouped by chunk bucket and label
bucket (the JAX package's tables), so a run meets few shapes; a bucket that
fills emits its batch at once, and the tails are padded with repeats of
their own samples at the end of the epoch (every batch keeps the batch
size). Lines are resized once (``Preprocessor.load_line_u8``: numpy lines
already ``img_height`` high need no PIL) and kept as uint8 across epochs.
With ``augment`` (and no device augmentation) each line of the "chunks"
layout goes through the host ``Augmenter`` (train/augment.py) with its own
seed drawn from the epoch's generator, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from ..config import PreprocessConfig, TrainConfig
from ..preprocess import Preprocessor, chunk_line, normalize
from ..tokenizer import Tokenizer
from .augment import Augmenter

LABEL_BUCKETS = (16, 32, 64, 128, 256)
CHUNK_BUCKETS_TRAIN = (1, 2, 3, 4, 6, 8, 12, 16)
# Label-bucket floor per chunk bucket: wider lines carry longer text, so the
# (chunk, label) shapes stay about one per chunk bucket.
LABEL_FLOOR = {1: 32, 2: 32, 3: 64, 4: 64, 6: 64, 8: 128, 12: 128, 16: 256}
IMG_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff", ".webp"}


def _bucket(n, buckets):
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _label_bucket(n_ids: int, nb: int, cap: int | None = None) -> int:
    lb = max(_bucket(n_ids, LABEL_BUCKETS), LABEL_FLOOR.get(nb, 64))
    # the teacher-forcing input (lb - 1 tokens) must fit the decoder's positions
    return min(lb, cap) if cap else lb


@dataclasses.dataclass
class Batch:
    chunks: np.ndarray | None  # (B, N, H, CW) normalised float32 ("chunks" layout)
    chunk_counts: np.ndarray  # (B,) int32
    labels: np.ndarray  # (B, L) int32, <sos>...<eos><pad>*
    texts: list[str]
    lines: np.ndarray | None = None  # (B, H, Wb) uint8 white-padded lines ("lines" layout)
    widths: np.ndarray | None = None  # (B,) int32 true widths

    def as_dict(self) -> dict:
        if self.lines is not None:
            return {"lines": self.lines, "widths": self.widths, "chunk_counts": self.chunk_counts,
                    "labels": self.labels}
        return {"chunks": self.chunks, "chunk_counts": self.chunk_counts, "labels": self.labels}


class LineDataset:
    """In-memory (image, text) samples with a random subset drawn every
    epoch. ``device_augment``: batches in the "lines" layout, augmented,
    cut and normalised by the train step on the device; otherwise in the
    "chunks" layout, cut and normalised here, after the host ``Augmenter``
    (probability ``train_cfg.augment_prob``) when ``augment`` is set."""

    def __init__(self, samples: list, tokenizer: Tokenizer | None = None,
                 preprocess: PreprocessConfig | None = None, train_cfg: TrainConfig | None = None,
                 device_augment: bool = False, augment: bool = False):
        self.samples = samples
        self.tokenizer = tokenizer or Tokenizer()
        self.pre = preprocess or PreprocessConfig()
        self.train_cfg = train_cfg or TrainConfig()
        self.device_augment = device_augment
        self.augmenter = Augmenter(self.train_cfg.augment_prob) if (augment and not device_augment) else None
        self._loader = Preprocessor(self.pre)
        self._line_cache: dict[int, np.ndarray] = {}

    def __len__(self):
        return len(self.samples)

    def _prepare_one(self, idx: int, seed: int):
        """-> (line, chunk count, text): the uint8 line in the "lines"
        layout; else the float line in [0, 1], augmented with
        ``default_rng(seed)`` when there is an augmenter."""
        line = self._line_cache.get(idx)
        if line is None:
            line = self._loader.load_line_u8(self.samples[idx][0])
            self._line_cache[idx] = line
        if not self.device_augment:
            line = line.astype(np.float32) / 255.0
            if self.augmenter is not None:
                line = self.augmenter(line, np.random.default_rng(seed))
        n = min(self.pre.num_chunks(line.shape[1]), CHUNK_BUCKETS_TRAIN[-1])
        return line, n, self.samples[idx][1]

    def epoch_draws(self, rng: np.random.Generator, sample_size: int | None = None):
        """-> (sample indices, per-sample seeds) of one epoch: every draw an
        epoch takes from ``rng``, in the JAX package's order, and no image
        work (``train()`` replays them to resume a run where it stopped)."""
        idxs = np.arange(len(self.samples))
        if sample_size is not None and sample_size < len(idxs):
            idxs = rng.choice(idxs, size=sample_size, replace=False)
        else:
            rng.shuffle(idxs)
        # the seeds are drawn in every mode, as the JAX package draws them
        return idxs, rng.integers(0, 2 ** 31, size=len(idxs))

    def epoch_batches(self, batch_size: int, rng: np.random.Generator, sample_size: int | None = None,
                      num_workers: int = 8, max_label_len: int | None = None):
        """Yields the batches of one epoch over a random subset of
        ``sample_size`` samples (all, shuffled, by default)."""
        idxs, child_seeds = self.epoch_draws(rng, sample_size)
        groups: dict[tuple[int, int], list] = {}
        cap = max_label_len or self.train_cfg.max_label_len
        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            for line, n, text in pool.map(self._prepare_one, idxs.tolist(), child_seeds.tolist()):
                ids = self.tokenizer.encode(text)
                nb = _bucket(n, CHUNK_BUCKETS_TRAIN)
                key = (nb, _label_bucket(len(ids), nb, cap))
                bucket = groups.setdefault(key, [])
                bucket.append((line, n, ids, text))
                if len(bucket) == batch_size:
                    yield self._assemble(bucket, *key)
                    groups[key] = []
        for (nb, lb), items in groups.items():
            if not items:
                continue
            while len(items) < batch_size:  # static batch: pad with repeats
                items = items + items[: batch_size - len(items)]
            yield self._assemble(items, nb, lb)

    def _assemble(self, part, nb: int, lb: int) -> Batch:
        b = len(part)
        counts = np.zeros((b,), np.int32)
        labels = np.full((b, lb), self.tokenizer.pad_idx, np.int32)
        texts = []
        if self.device_augment:
            wb = (nb - 1) * self.pre.chunk_stride + self.pre.chunk_width
            lines = np.full((b, self.pre.img_height, wb), 255, np.uint8)
            widths = np.zeros((b,), np.int32)
        else:
            chunks = np.zeros((b, nb, self.pre.img_height, self.pre.chunk_width), np.float32)
        for i, (line, n, ids, text) in enumerate(part):
            if self.device_augment:
                keep = min(line.shape[1], lines.shape[2])
                lines[i, :, :keep] = line[:, :keep]
                widths[i] = keep
            else:
                chunks[i] = normalize(chunk_line(line, self.pre, nb))
            counts[i] = n
            if len(ids) > lb:
                ids = ids[: lb - 1] + [self.tokenizer.eos_idx]
            labels[i, : len(ids)] = ids
            texts.append(text)
        if self.device_augment:
            return Batch(None, counts, labels, texts, lines=lines, widths=widths)
        return Batch(chunks, counts, labels, texts)


def load_folder_dataset(root, tokenizer=None, **kw) -> LineDataset:
    """An images/ + labels/ folder pair: each image with a label file of the
    same stem (images are read by PIL when first used)."""
    root = Path(root)
    samples = []
    for img in sorted((root / "images").iterdir()):
        if img.suffix.lower() not in IMG_EXTS:
            continue
        lab = root / "labels" / (img.stem + ".txt")
        if lab.exists():
            samples.append((str(img), lab.read_text(encoding="utf-8").strip()))
    return LineDataset(samples, tokenizer, **kw)


def load_hf_dataset(names: list, tokenizer: Tokenizer | None = None, **kw) -> LineDataset:
    """A LineDataset of every example's "image" and "label" of the given
    datasets: a name is loaded (split "train") with the Hugging Face
    ``datasets`` package, imported only then; anything else is taken as an
    iterable of such examples (a loaded dataset, a list of dicts)."""
    samples = []
    for name in names:
        if isinstance(name, str):
            import datasets as hfds

            name = hfds.load_dataset(name, split="train")
        samples += [(ex["image"], ex["label"]) for ex in name]
    return LineDataset(samples, tokenizer, **kw)
