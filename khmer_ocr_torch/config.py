"""Configuration tree of the PyTorch port.

The same frozen dataclasses as the JAX package's ``config.py`` (preprocess,
model, decode, runtime and training settings), so that one set of values describes both
implementations. Fields that only steered TPU dispatch (mesh axes, grouped
multi-batch programs, the per-step kernel and decode-head policies) are
dropped: the port dispatches one bucket batch at a time and always runs its
CUDA kernels on the card. ``DecodeConfig.mega_mode`` stays: it picks the
whole-decode beam path, a different route through the decode, and the
Predictor snapshots it per call from ``KHMER_OCR_MEGA_DECODE``.
"""

from __future__ import annotations

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


@dataclass(frozen=True)
class RuntimeConfig:
    """Shape buckets: lines pad to a chunk bucket, batches to a batch
    bucket. The port runs in float32 with TF32 off for matmul and cuDNN
    (infer/predictor.py::set_parity_mode)."""

    chunk_buckets: tuple[int, ...] = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128)
    batch_buckets: tuple[int, ...] = (1, 8, 32, 128, 256)


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


def backbone_for_path(model_path: str) -> str:
    """The backbone named by a weights file's name, as the reference picks it
    (recognize_text.py:39-44): "vgg" or "resnet" in the name, else se_vgg."""
    name = str(model_path).lower()
    if "vgg" in name:
        return "vgg"
    if "resnet" in name:
        return "resnet"
    return "se_vgg"
