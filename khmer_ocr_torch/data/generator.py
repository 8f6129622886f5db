"""Synthetic training and evaluation data: document-style and scene-style text lines.

A pool of pure functions returns (uint8 image, label) pairs from a seed; the
output goes to ``images/`` + ``labels/`` folder pairs (the Evaluator's
layout) or to a HuggingFace dataset. The same seed gives the same image
bytes and texts on every machine with the same Pillow and fonts.

Fonts: any directory of Khmer-capable .ttf files; the 11 that ship in
``data/fonts/`` by default, sorted by name (the seed picks one by index).
Corpus: one word per whitespace token of a UTF-8 text file, by default the
packaged ``corpus_seed.txt``; ``corpus_path="none"`` samples words from the
vocabulary's Khmer consonant and vowel ranges instead.

Pillow is imported where an image is drawn or written, OpenCV only by the
document augmentation, the ``datasets`` package only by the HuggingFace
export.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
from pathlib import Path

import numpy as np

# consonants restricted to the recognition vocabulary (char2idx.json): the
# raw Unicode range includes the obsolete U+179D/U+179E, which the vocabulary maps to <unk>
KHMER_CONSONANTS = [chr(c) for c in range(0x1780, 0x17A3) if c not in (0x179D, 0x179E)]
KHMER_VOWELS = [chr(c) for c in range(0x17B6, 0x17C6)]
KHMER_SIGNS = ["្"]  # coeng


def _default_words(rng: np.random.Generator, n: int = 4000) -> list[str]:
    words = []
    for _ in range(n):
        length = int(rng.integers(2, 8))
        chars = []
        for _ in range(length):
            chars.append(str(rng.choice(KHMER_CONSONANTS)))
            if rng.random() < 0.25:
                chars.append(KHMER_SIGNS[0] + str(rng.choice(KHMER_CONSONANTS)))
            if rng.random() < 0.6:
                chars.append(str(rng.choice(KHMER_VOWELS)))
        words.append("".join(chars))
    return words


def load_corpus_words(corpus_path: str | Path | None, rng: np.random.Generator) -> list[str]:
    """Word pool for text generation, in preference order: an explicit corpus
    file, the packaged ``corpus_seed.txt`` (1.5k real Khmer words), then the
    synthetic consonant/vowel words. ``"none"`` asks for the synthetic words."""
    if corpus_path == "none":
        return _default_words(rng)
    candidates = [corpus_path, Path(__file__).parent / "corpus_seed.txt"]
    for cand in candidates:
        if cand and Path(cand).exists():
            text = Path(cand).read_text(encoding="utf-8")
            words = [w for w in text.split() if w]
            if words:
                return words
    return _default_words(rng)


def find_fonts(font_dir: str | Path | None) -> list[Path]:
    """The .ttf and .otf files of ``font_dir``, else of the packaged
    ``data/fonts/``, each sorted by name."""
    for candidate in ([Path(font_dir)] if font_dir else []) + [Path(__file__).parent / "fonts"]:
        if candidate.is_dir():
            fonts = sorted(candidate.glob("*.ttf")) + sorted(candidate.glob("*.otf"))
            if fonts:
                return fonts
    raise FileNotFoundError("No .ttf fonts found; pass font_dir=")


def render_text_line(text: str, font_path: str | Path, font_size: int = 14,
                     pad: int = 6, fg: int = 0, bg: int = 255) -> np.ndarray:
    """Render a text line to a uint8 grayscale array on a canvas sized to the
    text's bounding box, with RAQM layout where Pillow has it (Khmer
    shaping)."""
    from PIL import Image, ImageDraw, ImageFont

    try:
        font = ImageFont.truetype(str(font_path), font_size, layout_engine=ImageFont.Layout.RAQM)
    except Exception:  # a Pillow built without RAQM: its basic layout
        font = ImageFont.truetype(str(font_path), font_size)
    probe = Image.new("L", (8, 8), bg)
    bbox = ImageDraw.Draw(probe).textbbox((0, 0), text, font=font)
    w = max(bbox[2] - bbox[0], 1) + 2 * pad
    h = max(bbox[3] - bbox[1], 1) + 2 * pad
    img = Image.new("L", (w, h), bg)
    ImageDraw.Draw(img).text((pad - bbox[0], pad - bbox[1]), text, font=font, fill=fg)
    return np.asarray(img)


def _augment_document(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Document-style degradation: noise blobs, blur, small rotation."""
    import cv2

    out = img.astype(np.float32)
    if rng.random() < 0.4:  # salt-ish noise blobs
        n_blobs = int(rng.integers(1, 6))
        for _ in range(n_blobs):
            x, y = int(rng.integers(0, img.shape[1])), int(rng.integers(0, img.shape[0]))
            r = int(rng.integers(1, 3))
            cv2.circle(out, (x, y), r, float(rng.integers(0, 120)), -1)
    if rng.random() < 0.4:
        out = cv2.GaussianBlur(out, (3, 3), float(rng.uniform(0.4, 1.0)))
    if rng.random() < 0.4:  # +-2.5 degrees rotation, white border
        angle = float(rng.uniform(-2.5, 2.5))
        h, w = out.shape
        m = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0)
        out = cv2.warpAffine(out, m, (w, h), borderValue=255.0)
    return np.clip(out, 0, 255).astype(np.uint8)


@dataclasses.dataclass
class DocumentTextGenerator:
    """Document-style lines: corpus words in black on white."""

    font_dir: str | Path | None = None
    corpus_path: str | Path | None = None
    words_per_sample: tuple[int, int] = (3, 5)
    font_size: int = 14
    augment: bool = True
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.fonts = find_fonts(self.font_dir)
        self.words = load_corpus_words(self.corpus_path, rng)

    def sample(self, rng: np.random.Generator) -> tuple[np.ndarray, str]:
        k = int(rng.integers(self.words_per_sample[0], self.words_per_sample[1] + 1))
        text = " ".join(str(rng.choice(self.words)) for _ in range(k))
        font = self.fonts[int(rng.integers(0, len(self.fonts)))]
        img = render_text_line(text, font, self.font_size)
        if self.augment:
            img = _augment_document(img, rng)
        return img, text

    def _one(self, seed: int):
        try:
            return self.sample(np.random.default_rng(seed))
        except Exception:  # a text a font cannot draw: the sample is dropped
            return None

    def generate(self, n: int, out_dir: str | Path | None = None, processes: int = 4):
        """Generate n samples (those that fail to render are dropped); write
        images/ + labels/ if ``out_dir`` is given. Returns the (image, text)
        list. With ``processes`` > 1 the samples come in completion order."""
        seeds = np.random.default_rng(self.seed).integers(0, 2**31, size=n).tolist()
        if processes > 1:
            # spawn, not fork: the caller may hold threads or a device context
            ctx = multiprocessing.get_context("spawn")
            with ctx.Pool(processes) as pool:
                results = [r for r in pool.imap_unordered(self._one, seeds) if r is not None]
        else:
            results = [r for r in map(self._one, seeds) if r is not None]
        if out_dir is None:
            return results
        from PIL import Image

        out = Path(out_dir)
        (out / "images").mkdir(parents=True, exist_ok=True)
        (out / "labels").mkdir(parents=True, exist_ok=True)
        for i, (img, text) in enumerate(results):
            Image.fromarray(img).save(out / "images" / f"{i:06d}.png")
            (out / "labels" / f"{i:06d}.txt").write_text(text, encoding="utf-8")
        return results

    # visibility of pushed datasets: document data public, scene data private
    hub_private: bool = dataclasses.field(default=False, init=False, repr=False)

    def to_hf_dataset(self, n: int, processes: int = 4):
        """Export as a HuggingFace dataset with image/label columns."""
        import datasets as hfds
        from PIL import Image

        results = self.generate(n, out_dir=None, processes=processes)
        return hfds.Dataset.from_dict(
            {"image": [Image.fromarray(img) for img, _ in results], "label": [t for _, t in results]}
        )

    def push_to_hub(self, repo_id: str, n: int, processes: int = 4, private: bool | None = None):
        """Generate and push to the HuggingFace Hub (document public, scene
        private, unless ``private`` says otherwise)."""
        ds = self.to_hf_dataset(n, processes=processes)
        ds.push_to_hub(repo_id, private=self.hub_private if private is None else private)
        return ds


@dataclasses.dataclass
class SceneTextGenerator(DocumentTextGenerator):
    """Scene-style lines: text composited on background crops, black on
    bright backgrounds and white on dark ones."""

    background_dir: str | Path | None = None
    font_size_range: tuple[int, int] = (16, 28)

    def __post_init__(self):
        super().__post_init__()
        self.hub_private = True
        self.backgrounds = []
        if self.background_dir and Path(self.background_dir).is_dir():
            self.backgrounds = sorted(
                p for p in Path(self.background_dir).iterdir() if p.suffix.lower() in {".jpg", ".png", ".jpeg"}
            )

    def _background(self, rng: np.random.Generator, w: int, h: int) -> np.ndarray:
        if self.backgrounds:
            from PIL import Image

            bg = np.asarray(Image.open(self.backgrounds[int(rng.integers(0, len(self.backgrounds)))]).convert("L"))
            if bg.shape[0] > h and bg.shape[1] > w:
                y = int(rng.integers(0, bg.shape[0] - h))
                x = int(rng.integers(0, bg.shape[1] - w))
                return bg[y : y + h, x : x + w].copy()
        # gray-noise background when no image is given or large enough
        base = rng.integers(60, 200)
        return np.clip(base + rng.standard_normal((h, w)) * 18, 0, 255).astype(np.uint8)

    def sample(self, rng: np.random.Generator) -> tuple[np.ndarray, str]:
        k = int(rng.integers(self.words_per_sample[0], self.words_per_sample[1] + 1))
        text = " ".join(str(rng.choice(self.words)) for _ in range(k))
        font_path = self.fonts[int(rng.integers(0, len(self.fonts)))]
        size = int(rng.integers(self.font_size_range[0], self.font_size_range[1] + 1))
        mask = render_text_line(text, font_path, size, fg=255, bg=0)
        h, w = mask.shape
        # the background is padded by 20 px; the text goes at (10 + dx, 10 + dy), dx, dy in [0, 5]
        pad = 20
        bg = self._background(rng, w + pad, h + pad)
        x0 = 10 + int(rng.integers(0, 6))
        y0 = 10 + int(rng.integers(0, 6))
        color = 0 if bg.mean() > 127 else 255
        out = bg.astype(np.float32)
        alpha = mask.astype(np.float32) / 255.0
        region = out[y0 : y0 + h, x0 : x0 + w]
        out[y0 : y0 + h, x0 : x0 + w] = region * (1 - alpha) + color * alpha
        return np.clip(out, 0, 255).astype(np.uint8), text
