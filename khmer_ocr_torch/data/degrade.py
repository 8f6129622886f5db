"""Severity-swept evaluation-time degradations of a clean folder-pair split.

Rendered evaluation lines come from the same generator as the training
lines, so their CER sits near zero and stops telling models apart. This
module applies calibrated, deterministic corruptions to a clean split:
severity-swept blur, sensor noise, low-resolution rescan, JPEG artifacts,
rotation and ink erosion.

Severities 1-5 follow the ImageNet-C convention: 1 mild (within the
training augmentation's range), 3 clearly out of distribution, 5 near
destruction.

Determinism: every (image filename, kind, severity, seed) gets its own
``numpy.random.Generator`` seeded from a stable hash, so two builds of the
same degraded split are byte-identical and per-image results compare across
models.

OpenCV is imported inside the functions: the suite is built where OpenCV is
installed, and read back as images.
"""

from __future__ import annotations

import hashlib
import shutil
from pathlib import Path

import numpy as np

IMG_EXTS = {".png", ".jpg", ".jpeg", ".tif", ".tiff", ".bmp", ".webp"}

# ---------------------------------------------------------------------------
# Corruptions. Input/output: float32 (H, W) in [0, 1], white background = 1.0.
# Severity s in 1-5.
# ---------------------------------------------------------------------------


def _sev(values, s: int):
    if not 1 <= s <= 5:
        raise ValueError(f"severity must be 1-5, got {s}")
    return values[s - 1]


def blur(img: np.ndarray, s: int, rng: np.random.Generator) -> np.ndarray:
    """Gaussian defocus blur past the training range (sigma 0.5-1.0)."""
    import cv2

    sigma = _sev([0.8, 1.3, 1.8, 2.4, 3.0], s)
    k = int(2 * round(3 * sigma) + 1)
    return cv2.GaussianBlur(img, (k, k), sigma, borderType=cv2.BORDER_REPLICATE)


def noise(img: np.ndarray, s: int, rng: np.random.Generator) -> np.ndarray:
    """Additive sensor noise past the training range (0.02-0.08)."""
    sigma = _sev([0.08, 0.14, 0.20, 0.27, 0.35], s)
    return np.clip(img + rng.standard_normal(img.shape).astype(np.float32) * sigma, 0.0, 1.0)


def lowres(img: np.ndarray, s: int, rng: np.random.Generator) -> np.ndarray:
    """Low-resolution rescan: bilinear down and back up; also stands in for
    small print."""
    import cv2

    scale = _sev([0.70, 0.55, 0.45, 0.36, 0.28], s)
    h, w = img.shape
    sh, sw = max(4, int(h * scale)), max(4, int(w * scale))
    small = cv2.resize(img, (sw, sh), interpolation=cv2.INTER_LINEAR)
    return cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR)


def jpeg(img: np.ndarray, s: int, rng: np.random.Generator) -> np.ndarray:
    """JPEG compression artifacts (blocks, ringing around strokes)."""
    import cv2

    quality = _sev([40, 26, 18, 12, 8], s)
    u8 = (np.clip(img, 0, 1) * 255.0 + 0.5).astype(np.uint8)
    ok, enc = cv2.imencode(".jpg", u8, [int(cv2.IMWRITE_JPEG_QUALITY), int(quality)])
    if not ok:  # imencode fails only on invalid parameters
        return img
    dec = cv2.imdecode(enc, cv2.IMREAD_GRAYSCALE)
    return dec.astype(np.float32) / 255.0


def rotate(img: np.ndarray, s: int, rng: np.random.Generator) -> np.ndarray:
    """Skewed scan: small rotation with white fill, random sign per image."""
    import cv2

    angle = _sev([0.8, 1.6, 2.5, 3.5, 5.0], s) * (1.0 if rng.random() < 0.5 else -1.0)
    h, w = img.shape
    m = cv2.getRotationMatrix2D((w / 2.0, h / 2.0), angle, 1.0)
    return cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_LINEAR,
                          borderMode=cv2.BORDER_CONSTANT, borderValue=1.0)


def erode(img: np.ndarray, s: int, rng: np.random.Generator) -> np.ndarray:
    """Ink erosion (faded print, worn type): a max filter on a white
    background thins black strokes, blended toward the eroded image."""
    import cv2

    t = _sev([0.55, 0.70, 0.82, 0.91, 0.97], s)
    eroded = cv2.dilate(img, np.ones((3, 3), np.uint8))
    if s >= 4:
        eroded = cv2.dilate(eroded, np.ones((1, 2), np.uint8))
    return img * (1 - t) + eroded * t


DEGRADATIONS = {
    "blur": blur,
    "noise": noise,
    "lowres": lowres,
    "jpeg": jpeg,
    "rotate": rotate,
    "erode": erode,
}
DEFAULT_KINDS = tuple(DEGRADATIONS)
DEFAULT_SEVERITIES = (1, 3, 5)


def _rng_for(name: str, kind: str, severity: int, seed: int) -> np.random.Generator:
    h = hashlib.sha256(f"{name}|{kind}|{severity}|{seed}".encode()).digest()
    return np.random.default_rng(int.from_bytes(h[:8], "little"))


def degrade_image(img: np.ndarray, kind: str, severity: int,
                  rng: np.random.Generator) -> np.ndarray:
    """Apply one named corruption ("mix": one drawn by ``rng``). img: float32
    (H, W) in [0, 1]."""
    if kind == "mix":
        kind = str(rng.choice(list(DEGRADATIONS)))
    fn = DEGRADATIONS[kind]
    return np.clip(fn(img.astype(np.float32), severity, rng), 0.0, 1.0)


def degrade_split(src: str | Path, dst: str | Path, kind: str, severity: int,
                  seed: int = 0, overwrite: bool = False) -> Path:
    """Build ``dst/{images,labels}`` from the clean folder pair at ``src``.

    ``kind`` is any DEGRADATIONS key or "mix" (one corruption drawn per
    image). Labels are copied verbatim. An existing complete build is reused
    unless ``overwrite``.
    """
    import cv2

    src, dst = Path(src), Path(dst)
    src_images = sorted(p for p in (src / "images").iterdir() if p.suffix.lower() in IMG_EXTS)
    if not src_images:
        raise FileNotFoundError(f"no images under {src / 'images'}")
    out_images, out_labels = dst / "images", dst / "labels"
    stamp = dst / ".complete"
    if stamp.exists() and not overwrite:
        return dst
    if dst.exists():
        shutil.rmtree(dst)
    out_images.mkdir(parents=True)
    out_labels.mkdir(parents=True)
    for p in src_images:
        raw = cv2.imread(str(p), cv2.IMREAD_GRAYSCALE)
        if raw is None:
            raise ValueError(f"unreadable image {p}")
        img = raw.astype(np.float32) / 255.0
        rng = _rng_for(p.name, kind, severity, seed)
        out = degrade_image(img, kind, severity, rng)
        u8 = (np.clip(out, 0, 1) * 255.0 + 0.5).astype(np.uint8)
        cv2.imwrite(str(out_images / (p.stem + ".png")), u8)
        label = src / "labels" / (p.stem + ".txt")
        if label.exists():
            shutil.copyfile(label, out_labels / label.name)
    stamp.write_text("ok")
    return dst


def build_degraded_suite(src: str | Path, out_root: str | Path | None = None,
                         kinds=DEFAULT_KINDS, severities=DEFAULT_SEVERITIES,
                         seed: int = 0, include_mix: bool = True) -> dict[str, Path]:
    """Build the degraded suite of one clean split (cached on disk).

    Returns {"<kind>_s<severity>": path}, with "mix_s<severity>" rows when
    ``include_mix``.
    """
    src = Path(src)
    out_root = Path(out_root) if out_root else src.parent / (src.name + "_degraded")
    suite: dict[str, Path] = {}
    all_kinds = list(kinds) + (["mix"] if include_mix else [])
    for kind in all_kinds:
        for sev in severities:
            name = f"{kind}_s{sev}"
            suite[name] = degrade_split(src, out_root / name, kind, sev, seed=seed)
    return suite
