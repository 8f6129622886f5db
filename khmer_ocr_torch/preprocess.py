"""Host-side line preprocessing: load -> resize to 48 px -> bucket.

A line is grayscale uint8 of height ``img_height``. It is white-padded (255)
to the width of its chunk bucket, so that the device can cut the 100-px
windows with one strided gather (ops/lines.py) and normalise there. Lines are
grouped by chunk bucket, in arrival order, into batches of at most
``max_batch``; full batches are emitted as they fill and the partial tails
afterwards, in ascending bucket order.

File paths and in-memory images are read by the native loader
(native/imageio.py: Pillow's pixels, bit for bit for PNG, off the GIL);
where it cannot be built, and for the binarized variant, by PIL, whose
pixels are the same. PIL is imported only where it is needed. The binarized
variant (``PreprocessConfig.binarize``) blurs and thresholds each line in
numpy before the resize.

``Preprocessor.iter_batches`` prepares lines on a pool of
``RuntimeConfig.host_workers`` threads; a list of files only goes through
the native loader's batch call, a slab of lines at a time, into a reused
buffer ``slab_cap_w`` px wide (a wider line is decoded again at full
width). ``flush_deadline_ms`` > 0 flushes a partly filled bucket whose
oldest line has waited that long. The batches are the JAX package's for the
same sources, whatever the number of workers.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
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


def _reflect101(n: int, pad: int) -> np.ndarray:
    """Source index of each of ``n + 2 pad`` positions under OpenCV's default
    border (BORDER_REFLECT_101: ... 2 1 | 0 1 2 ... n-1 | n-2 n-3 ...)."""
    idx = np.arange(-pad, n + pad)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * n - 2
    idx = np.abs(idx) % period
    return np.where(idx < n, idx, period - idx)


_GAUSS5 = (1, 4, 6, 4, 1)  # OpenCV's 5-tap kernel for sigma 0, in sixteenths
_FLT_EPSILON = float(np.finfo(np.float32).eps)


def gaussian_blur5(arr: np.ndarray) -> np.ndarray:
    """OpenCV's ``GaussianBlur(arr, (5, 5), 0)`` of a uint8 (H, W) image, bit
    for bit: the separable [1 4 6 4 1] / 16 kernel, the border reflected
    (BORDER_REFLECT_101), and the 8-bit fixed-point result rounded half up,
    which for this kernel is exact integer arithmetic."""
    a = arr.astype(np.int32)
    h, w = a.shape
    rows = a[_reflect101(h, 2)]
    v = sum(k * rows[i:i + h] for i, k in enumerate(_GAUSS5))
    cols = v[:, _reflect101(w, 2)]
    s = sum(k * cols[:, j:j + w] for j, k in enumerate(_GAUSS5))
    return ((s + 128) >> 8).astype(np.uint8)


def otsu_threshold(arr: np.ndarray) -> int:
    """OpenCV's Otsu threshold of a uint8 image: the first level whose
    between-class variance is the largest, in OpenCV's own float64
    arithmetic and order (levels where either class holds under float32
    epsilon of the pixels are skipped; a constant image gives 0)."""
    hist = np.bincount(arr.ravel(), minlength=256).tolist()
    scale = 1.0 / arr.size
    mu = 0.0
    for i, n in enumerate(hist):
        mu += i * float(n)
    mu *= scale
    mu1 = q1 = max_sigma = 0.0
    best = 0
    for i, n in enumerate(hist):
        p_i = n * scale
        mu1 *= q1
        q1 += p_i
        q2 = 1.0 - q1
        if min(q1, q2) < _FLT_EPSILON or max(q1, q2) > 1.0 - _FLT_EPSILON:
            continue
        mu1 = (mu1 + i * p_i) / q1
        mu2 = (mu - q1 * mu1) / q2
        sigma = q1 * q2 * (mu1 - mu2) * (mu1 - mu2)
        if sigma > max_sigma:
            max_sigma, best = sigma, i
    return best


def binarize_image(image):
    """The binarized evaluation variant: a 5x5 Gaussian blur, then Otsu's
    threshold (255 above it, 0 elsewhere), on a line before the resize. A
    PIL image gives a mode-L PIL image, as the JAX package's; a uint8 (H, W)
    array gives an array. Equals OpenCV's ``GaussianBlur(arr, (5, 5), 0)``
    and ``threshold(..., THRESH_BINARY + THRESH_OTSU)`` bit for bit; where
    two levels tie exactly for the largest variance, OpenCV's own code keeps
    the first, as here, while an OpenCV build that hands Otsu to Intel IPP
    may pick another."""
    if not isinstance(image, np.ndarray):
        from PIL import Image

        return Image.fromarray(binarize_image(np.asarray(image, dtype=np.uint8)))
    blurred = gaussian_blur5(image)
    return np.where(blurred > otsu_threshold(blurred), 255, 0).astype(np.uint8)


def bucket_for(n_chunks: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n_chunks <= b:
            return b
    return buckets[-1]


def load_grayscale(image_source):
    """A path, PIL image, or (H, W) / (H, W, C) array -> a mode-L PIL image
    (arrays that are not uint8 are scaled as ``_to_uint8`` does)."""
    from PIL import Image

    if isinstance(image_source, (str, Path)):
        p = Path(image_source)
        if not p.exists():
            raise FileNotFoundError(f"Image not found: {p}")
        return Image.open(p).convert("L")
    if isinstance(image_source, Image.Image):
        return image_source.convert("L")
    if isinstance(image_source, np.ndarray):
        return Image.fromarray(_to_uint8(image_source)).convert("L")
    raise ValueError(f"Unsupported image source type: {type(image_source)!r}")


def resize_line_u8(image, cfg: PreprocessConfig) -> np.ndarray:
    """A mode-L PIL image -> uint8 (img_height, W): binarized first when
    ``cfg.binarize``, then PIL's bilinear resize to W = max(min_width,
    int(img_height * aspect)), the reference's arithmetic."""
    from PIL import Image

    if cfg.binarize:
        image = binarize_image(image)
    new_width = max(cfg.min_width, int(cfg.img_height * (image.width / image.height)))
    image = image.resize((new_width, cfg.img_height), Image.Resampling.BILINEAR)
    return np.asarray(image, dtype=np.uint8)


def resize_line(image, cfg: PreprocessConfig) -> np.ndarray:
    """``resize_line_u8`` as float32 in [0, 1] (u8 / 255)."""
    return resize_line_u8(image, cfg).astype(np.float32) / 255.0


@dataclasses.dataclass
class PreparedBatch:
    """lines: (B, H, Wb) uint8, white-padded to the bucket width;
    chunk_counts: (B,) int32 true chunks per line (<= bucket_n);
    indices: positions of these lines in the caller's list."""

    lines: np.ndarray
    chunk_counts: np.ndarray
    indices: list[int]
    bucket_n: int

    @property
    def chunk_mask(self) -> np.ndarray:
        """(B, bucket_n) bool: which windows of each line are real."""
        return np.arange(self.bucket_n)[None, :] < self.chunk_counts[:, None]


def _to_uint8(arr: np.ndarray) -> np.ndarray:
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0 if arr.max() <= 1.0 else arr, 0, 255).astype(np.uint8)
    return arr


def _mem_array(src) -> np.ndarray | None:
    """An in-memory source as a uint8 array the native resize takes (gray,
    or (H, W, 1|3|4)); None: the caller takes PIL."""
    if isinstance(src, np.ndarray):
        arr = _to_uint8(src)
        return arr if arr.ndim == 2 or (arr.ndim == 3 and arr.shape[2] in (1, 3, 4)) else None
    from PIL import Image

    if isinstance(src, Image.Image):
        return np.asarray(src if src.mode in ("L", "RGB", "RGBA") else src.convert("L"))
    return None


class Preprocessor:
    """Turns line images into bucketed uint8 batches."""

    def __init__(self, cfg: PreprocessConfig | None = None, runtime: RuntimeConfig | None = None):
        self.cfg = cfg or PreprocessConfig()
        self.runtime = runtime or RuntimeConfig()
        self._slab_buf: np.ndarray | None = None  # the native batch decode's reused slab

    def _cap_w(self) -> int:
        """The widest line a bucket holds: 128 chunks, 10768 px."""
        return (self.runtime.chunk_buckets[-1] - 1) * self.cfg.chunk_stride + self.cfg.chunk_width

    def load_line_u8(self, src) -> np.ndarray:
        """One source -> uint8 (img_height, W), binarized first when
        ``cfg.binarize`` is set. A 2-D array that is already ``img_height``
        px high and at least ``min_width`` wide skips the resize (it would
        be the identity); files and other in-memory images take the native
        loader, PIL where it is unavailable or for the binarized variant.
        Lines wider than the widest bucket come back cut to it."""
        cfg = self.cfg
        if isinstance(src, np.ndarray):
            arr = _to_uint8(src)
            if arr.ndim == 2 and arr.shape[0] == cfg.img_height and arr.shape[1] >= cfg.min_width:
                return binarize_image(arr) if cfg.binarize else np.ascontiguousarray(arr)
        if not cfg.binarize:
            from .native.imageio import load_resize_gray, resize_gray_mem

            if isinstance(src, (str, Path)):
                line = load_resize_gray(src, cfg.img_height, cfg.min_width, self._cap_w(), as_uint8=True)
                if line is not None:
                    return line
            else:
                arr = _mem_array(src)
                line = None if arr is None else resize_gray_mem(arr, cfg.img_height, cfg.min_width, self._cap_w(),
                                                                 as_uint8=True)
                if line is not None:
                    return line
        return resize_line_u8(load_grayscale(src), cfg)

    def _padded(self, line: np.ndarray) -> tuple[int, int, np.ndarray]:
        cfg, buckets = self.cfg, self.runtime.chunk_buckets
        w = line.shape[1]
        n = min(cfg.num_chunks(w), buckets[-1])
        bucket_n = bucket_for(n, buckets)
        padded_w = (bucket_n - 1) * cfg.chunk_stride + cfg.chunk_width
        padded = np.full((line.shape[0], padded_w), 255, np.uint8)
        keep = min(w, padded_w)
        padded[:, :keep] = line[:, :keep]
        return bucket_n, n, padded

    def prepare_one(self, src) -> tuple[int, int, np.ndarray]:
        """-> (bucket_n, chunk count, line white-padded to the bucket width)."""
        return self._padded(self.load_line_u8(src))

    def process_line(self, image_source, n_chunks: int | None = None) -> np.ndarray:
        """One line -> (N, H, CW) normalised windows (the reference's ``process``)."""
        return normalize(chunk_line(self.load_line_u8(image_source).astype(np.float32) / 255.0, self.cfg, n_chunks))

    def iter_batches(self, image_sources: list, max_batch: int | None = None):
        """Stream (chunk bucket, batch) groups as they fill; the partial tails
        follow in ascending bucket order."""
        grouped: dict[int, list[tuple[int, int, np.ndarray]]] = {}
        arrivals: dict[int, float] = {}  # bucket -> when its oldest waiting line arrived

        def assemble(bucket_n, part) -> PreparedBatch:
            return PreparedBatch(
                lines=np.stack([c for _, _, c in part]),
                chunk_counts=np.array([n for _, n, _ in part], np.int32),
                indices=[i for i, _, _ in part],
                bucket_n=bucket_n,
            )

        for i, out in self._prepared(image_sources, max_batch):
            yield from self._feed(i, out, grouped, assemble, max_batch, arrivals)
        for bucket_n in sorted(grouped):
            items = grouped[bucket_n]
            step = max_batch or len(items)
            for j in range(0, len(items), step):
                yield assemble(bucket_n, items[j:j + step])

    def prepare_batches(self, image_sources: list, max_batch: int | None = None) -> list[PreparedBatch]:
        """``iter_batches`` as a list."""
        return list(self.iter_batches(image_sources, max_batch))

    def _prepared(self, image_sources: list, max_batch: int | None):
        """(index, (bucket_n, count, padded line)) of every source in order:
        all files through the native batch call a slab at a time, else on
        ``host_workers`` threads."""
        from .native.imageio import load_imageio_library

        cfg, rt = self.cfg, self.runtime
        files = bool(image_sources) and all(isinstance(s, (str, Path)) for s in image_sources)
        if not files or cfg.binarize or load_imageio_library() is None:
            with ThreadPoolExecutor(max_workers=max(1, rt.host_workers)) as pool:
                yield from enumerate(pool.map(self.prepare_one, image_sources))
            return

        from .native.imageio import load_resize_gray_batch

        slab = max(512, max_batch or 0)
        cap_full = self._cap_w()
        cap_w = min(cap_full, rt.slab_cap_w)
        rows = min(slab, len(image_sources))
        if self._slab_buf is None or self._slab_buf.shape[1:] != (cfg.img_height, cap_w) \
                or self._slab_buf.shape[0] < rows:
            self._slab_buf = np.empty((rows, cfg.img_height, cap_w), np.uint8)
        for start in range(0, len(image_sources), slab):
            paths = image_sources[start:start + slab]
            bufs, widths, errs = load_resize_gray_batch(paths, cfg.img_height, cfg.min_width, cap_w,
                                                        rt.host_workers, out=self._slab_buf)
            for j, path in enumerate(paths):
                if errs[j] != 0 or widths[j] > cap_w:
                    # a failed decode (a missing file raises, an exotic format takes PIL) or a line wider than the
                    # slab: read alone, at full width
                    yield start + j, self.prepare_one(path)
                    continue
                yield start + j, self._padded(bufs[j][:, :widths[j]])

    def _feed(self, i, out, grouped, assemble, max_batch, arrivals):
        bucket_n, n, padded = out
        deadline = self.runtime.flush_deadline_ms / 1e3
        bin_ = grouped.setdefault(bucket_n, [])
        if deadline and not bin_:
            arrivals[bucket_n] = time.monotonic()
        bin_.append((i, n, padded))
        if max_batch and len(bin_) == max_batch:
            grouped.pop(bucket_n)
            arrivals.pop(bucket_n, None)
            yield assemble(bucket_n, bin_)
        if deadline:
            # flush every bucket whose oldest line has waited past the deadline, not only the one fed
            now = time.monotonic()
            for b in [b for b, t0 in arrivals.items() if now - t0 > deadline]:
                arrivals.pop(b)
                items = grouped.pop(b, None)
                if items:
                    yield assemble(b, items)
