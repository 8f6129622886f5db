"""Configuration tree of the PyTorch port.

The same frozen dataclasses as the JAX package's ``config.py`` (preprocess,
model, decode, runtime and training settings), so that one set of values describes both
implementations. Fields that only steered TPU dispatch (mesh axis names,
grouped multi-batch programs and their compile budget, the uint8 and
whole-line transfer layouts, the per-step kernel policy) are dropped: the
port dispatches one bucket batch at a time, always ships uint8 lines, and
always runs its CUDA kernels on the card. ``DecodeConfig.mega_mode`` and
``head_mode`` stay: they pick the whole-decode beam path and the fused
decode head, and the Predictor snapshots them per call from
``KHMER_OCR_MEGA_DECODE`` and ``KHMER_OCR_FUSED_HEAD``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class PreprocessConfig:
    """Line geometry: resize to ``img_height`` keeping the aspect ratio (width
    floored at ``min_width``), cut into ``chunk_width``-px windows that overlap
    by ``chunk_overlap`` px, white-pad the last one, normalise (x - 0.5) / 0.5.
    ``binarize``: the binarized evaluation variant, a 5x5 Gaussian blur and
    an Otsu threshold before the resize (preprocess.py::binarize_image)."""

    img_height: int = 48
    chunk_width: int = 100
    chunk_overlap: int = 16
    min_width: int = 50
    binarize: bool = False

    @property
    def chunk_stride(self) -> int:
        return self.chunk_width - self.chunk_overlap

    def num_chunks(self, width: int) -> int:
        """Windows start at 0 with stride ``chunk_stride`` while start < width."""
        if width <= 0:
            return 1
        return (width - 1) // self.chunk_stride + 1


@dataclass(frozen=True)
class ModelConfig:
    """Recognition model hyperparameters (the flagship is the default)."""

    backbone: str = "se_vgg"
    vocab_size: int = 124
    pad_idx: int = 0
    emb_dim: int = 384
    num_heads: int = 8
    enc_layers: int = 2
    dec_layers: int = 2
    enc_ffn_dim: int = 1024
    dropout: float = 0.1
    max_global_len: int = 4096
    decode_max_len: int = 256
    patch_max: int = 256
    use_bilstm: bool = True

    @property
    def dec_ffn_dim(self) -> int:
        return self.emb_dim * 4

    @property
    def head_dim(self) -> int:
        if self.emb_dim % self.num_heads:
            raise ValueError(f"emb_dim {self.emb_dim} is not a multiple of num_heads {self.num_heads}")
        return self.emb_dim // self.num_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class DecodeConfig:
    """Decode-time settings."""

    beam_width: int = 3
    max_len: int = 256
    sos_idx: int = 2
    eos_idx: int = 3
    pad_idx: int = 0
    # Whole-decode beam path (kernel K3, ops/kernels/decode_loop.py): "1" on
    # inside its envelope, any other value off, None reads KHMER_OCR_MEGA_DECODE.
    mega_mode: str | None = None
    # The decode head fused into the last layer's launch of kernel K2 (beam
    # only, as in the JAX package): "1" on, any other value off, None reads
    # KHMER_OCR_FUSED_HEAD.
    head_mode: str | None = None


@dataclass(frozen=True)
class RuntimeConfig:
    """Serving settings.

    ``compute_dtype``/``matmul_precision`` trade parity for speed, as in the
    JAX package: parity mode is "float32" + "highest" (TF32 off for matmul
    and cuDNN), the speed mode "bfloat16" (the Predictor casts the params,
    activations and caches follow; the BatchNorm statistics stay float32)
    with "default" or "high" (TF32 on for the float32 work that remains).
    Shape buckets: lines pad to a chunk bucket, batches to a batch bucket.
    Host input: ``host_workers`` threads prepare lines (PIL or the native
    loader, native/imageio.py); all-file workloads decode through the native
    loader's batch call into a reused slab ``slab_cap_w`` px wide (wider
    lines re-decode at full width); ``flush_deadline_ms`` > 0 flushes a
    partly filled bucket whose oldest line has waited that long.
    In flight: ``predict_batch`` prepares, ships and encodes later bucket
    batches on a thread and stream of their own while earlier ones decode;
    at most 2 x ``max_inflight_batches`` batches (read as at least 1) are
    dispatched and not yet drained (their tokens read back)."""

    compute_dtype: str = "float32"
    matmul_precision: str = "highest"
    chunk_buckets: tuple[int, ...] = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128)
    batch_buckets: tuple[int, ...] = (1, 8, 32, 128, 256)
    host_workers: int = 8
    slab_cap_w: int = 2048
    flush_deadline_ms: float = 0.0
    max_inflight_batches: int = 4


@dataclass(frozen=True)
class TrainConfig:
    """Training recipe: Adam (b1 0.9, b2 0.999, eps 1e-8) at a staged cyclic
    learning rate (epochs 1-15 ``base_lr``; 16-30 cyclic over ``stage2_lr``;
    31+ over ``stage3_lr``; train/schedule.py), ``epoch_sample_size`` lines
    drawn per epoch, device augmentation with probability ``augment_prob``."""

    batch_size: int = 32
    num_epochs: int = 100
    epoch_sample_size: int = 50_000
    base_lr: float = 1e-4
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    stage2_start_epoch: int = 16
    stage3_start_epoch: int = 31
    stage2_lr: tuple[float, float] = (1e-5, 1e-4)
    stage3_lr: tuple[float, float] = (1e-6, 1e-5)
    augment_prob: float = 0.8
    checkpoint_every_epochs: int = 10
    max_label_len: int = 256
    seed: int = 0


@dataclass(frozen=True)
class OCRConfig:
    preprocess: PreprocessConfig = field(default_factory=PreprocessConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def replace(self, **kw) -> "OCRConfig":
        return dataclasses.replace(self, **kw)


def backbone_for_path(model_path: str) -> str:
    """The backbone named by a weights file's name, as the reference picks it
    (recognize_text.py:39-44): "vgg" or "resnet" in the name, else se_vgg."""
    name = str(model_path).lower()
    if "vgg" in name:
        return "vgg"
    if "resnet" in name:
        return "resnet"
    return "se_vgg"
