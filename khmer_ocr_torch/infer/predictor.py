"""End-to-end recognition: uint8 lines -> device -> encode + decode -> text.

Each chunk-bucket batch is padded to its batch bucket (repeating its last
line), shipped to the device as uint8 through pinned memory, normalised and
cut into windows there, encoded, and decoded with beam search (beam_width >
1) or greedy decoding. On the card the BiLSTM recurrence runs kernel K1 and
every decoder layer step runs kernel K2.

The device is the caller's choice: ``device=None`` means the CUDA card, and
without one the constructor raises; ``device="cpu"`` runs the plain PyTorch
versions of the kernels (what the tests do).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..config import DecodeConfig, ModelConfig, OCRConfig
from ..convert.from_jax import load_npz, params_from_jax
from ..decode.beam import beam_decode
from ..decode.greedy import greedy_decode
from ..models.ocr_model import encode
from ..ops.lines import device_chunk, u8_to_unit, unit_normalize
from ..preprocess import PreparedBatch, Preprocessor
from ..tokenizer import Tokenizer


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card, raising when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def set_parity_mode() -> None:
    """Full float32 matmuls and convolutions (no TF32), the reference's
    parity mode (float32, "highest")."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _round_up(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return n


class Predictor:
    """Holds the weights on one device and decodes batches of line images.

    Weights: ``params``/``batch_stats`` in the JAX package's layout (nested
    dicts of numpy arrays), or ``model_path`` to an .npz written by
    ``convert.from_jax.save_npz``."""

    def __init__(self, params=None, batch_stats=None, model_cfg: ModelConfig | None = None, device=None,
                 config: OCRConfig | None = None, vocab_path: str | Path | None = None,
                 model_path: str | Path | None = None):
        self.device = resolve_device(device)
        set_parity_mode()
        self.config = config or OCRConfig()
        self.tokenizer = Tokenizer(vocab_path)
        if model_path is not None:
            params, batch_stats, saved_cfg = load_npz(model_path)
            model_cfg = model_cfg or saved_cfg
        if params is None:
            raise ValueError("Provide params/batch_stats or model_path")
        self.model_cfg = model_cfg or self.config.model
        self.params = params_from_jax(params, batch_stats if batch_stats is not None else {}, self.model_cfg,
                                      device=self.device)
        self.preprocessor = Preprocessor(self.config.preprocess, self.config.runtime)
        pre = self.config.preprocess
        self._chunk_geom = (pre.chunk_width, pre.chunk_stride)
        self.decode_steps = 0  # decode steps run since construction (all batches)

    def _dec_cfg(self, beam_width: int, max_len: int | None) -> DecodeConfig:
        cap = self.model_cfg.decode_max_len
        return DecodeConfig(
            beam_width=max(beam_width, 1),
            max_len=min(max_len or cap, cap),
            sos_idx=self.tokenizer.sos_idx,
            eos_idx=self.tokenizer.eos_idx,
            pad_idx=self.tokenizer.pad_idx,
        )

    def _to_device_batch(self, batch: PreparedBatch):
        b = batch.lines.shape[0]
        padded_b = _round_up(b, self.config.runtime.batch_buckets)
        lines, counts = batch.lines, batch.chunk_counts
        if padded_b != b:
            reps = padded_b - b
            lines = np.concatenate([lines, np.repeat(lines[-1:], reps, axis=0)])
            counts = np.concatenate([counts, np.repeat(counts[-1:], reps, axis=0)])
        lines_t, counts_t = torch.from_numpy(np.ascontiguousarray(lines)), torch.from_numpy(counts)
        if self.device.type == "cuda":
            lines_t = lines_t.pin_memory().to(self.device, non_blocking=True)
            counts_t = counts_t.pin_memory().to(self.device, non_blocking=True)
        return lines_t, counts_t, b

    @torch.inference_mode()
    def decode_prepared(self, batch: PreparedBatch, beam_width: int, max_len: int | None = None) -> np.ndarray:
        """One bucket batch -> tokens (B, steps + 1 or + 2) on the host."""
        dec_cfg = self._dec_cfg(beam_width, max_len)
        lines, counts, b = self._to_device_batch(batch)
        chunks = device_chunk(unit_normalize(u8_to_unit(lines)), self._chunk_geom)
        memory, pad_mask = encode(self.params, chunks, counts, self.model_cfg)
        stats: dict = {}
        if dec_cfg.beam_width > 1:
            tokens = beam_decode(self.params, memory, pad_mask, self.model_cfg, dec_cfg, stats=stats)
        else:
            tokens = greedy_decode(self.params, memory, pad_mask, self.model_cfg, dec_cfg, stats=stats)
        self.decode_steps += stats["steps"]
        return tokens[:b].cpu().numpy()

    def predict_batch_tokens(self, image_list: list, beam_width: int = 1, batch_size: int = 8,
                             max_len: int | None = None) -> list[np.ndarray]:
        """Token rows (with <sos>, <eos> and trailing <pad>) in input order."""
        results: list = [None] * len(image_list)
        for batch in self.preprocessor.iter_batches(image_list, max_batch=batch_size):
            tokens = self.decode_prepared(batch, beam_width, max_len)
            for idx, row in zip(batch.indices, tokens):
                results[idx] = row
        return results

    def predict_batch(self, image_list: list, beam_width: int = 1, batch_size: int = 8,
                      max_len: int | None = None) -> list[str]:
        if not image_list:
            return []
        rows = self.predict_batch_tokens(image_list, beam_width, batch_size, max_len)
        return [self.tokenizer.decode(r) for r in rows]

    def predict(self, image_input, beam_width: int = 3, max_len: int | None = None) -> str:
        return self.predict_batch([image_input], beam_width=beam_width, max_len=max_len)[0]
