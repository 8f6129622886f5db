"""Configuration tree of the PyTorch port.

The same frozen dataclasses as the JAX package's ``config.py`` (preprocess,
model, decode and runtime settings), so that one set of values describes both
implementations. Fields that only steered TPU dispatch (mesh axes, grouped
multi-batch programs, the Pallas kernel policy snapshots) are dropped: the
port dispatches one bucket batch at a time and always runs its CUDA kernels
on the card.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class PreprocessConfig:
    """Line geometry: resize to ``img_height`` keeping the aspect ratio (width
    floored at ``min_width``), cut into ``chunk_width``-px windows that overlap
    by ``chunk_overlap`` px, white-pad the last one, normalise (x - 0.5) / 0.5."""

    img_height: int = 48
    chunk_width: int = 100
    chunk_overlap: int = 16
    min_width: int = 50

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


@dataclass(frozen=True)
class RuntimeConfig:
    """Shape buckets: lines pad to a chunk bucket, batches to a batch
    bucket. The port runs in float32 with TF32 off for matmul and cuDNN
    (infer/predictor.py::set_parity_mode)."""

    chunk_buckets: tuple[int, ...] = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128)
    batch_buckets: tuple[int, ...] = (1, 8, 32, 128, 256)


@dataclass(frozen=True)
class OCRConfig:
    preprocess: PreprocessConfig = field(default_factory=PreprocessConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
