"""khmer_ocr_torch — the PyTorch/CUDA port of the JAX Khmer OCR package, for an NVIDIA H100.

Beam-3 recognition of uint8 text lines end to end: chunking and
normalisation on the device, the SE-VGG backbone, the per-chunk encoder, the
length-aware BiLSTM (CUDA kernel K1 on the card) and KV-cached beam decoding
(CUDA kernel K2 for every decoder layer step). Entry points run on the CUDA
card unless the caller passes ``device="cpu"``.

Importing the package loads neither torch nor the heavy modules; they load
with the first use of ``recognize``, ``recognize_batch`` or ``Predictor``.
"""

__version__ = "0.1.0"

from .config import DecodeConfig, ModelConfig, OCRConfig, PreprocessConfig, RuntimeConfig
from .tokenizer import Tokenizer


def recognize(image_input, beam_width: int = 3, model_path=None, vocab_path=None, device=None) -> str:
    """Recognise one line image (see infer/api.py)."""
    from .infer.api import recognize as _recognize

    return _recognize(image_input, beam_width=beam_width, model_path=model_path, vocab_path=vocab_path,
                      device=device)


def recognize_batch(image_list, beam_width: int = 1, batch_size: int = 8, model_path=None, vocab_path=None,
                    device=None, max_len=None):
    """Recognise a list of line images with batched decoding (see infer/api.py)."""
    from .infer.api import recognize_batch as _recognize_batch

    return _recognize_batch(image_list, beam_width=beam_width, batch_size=batch_size, model_path=model_path,
                            vocab_path=vocab_path, device=device, max_len=max_len)


def __getattr__(name):
    if name == "Predictor":
        from .infer.predictor import Predictor

        return Predictor
    raise AttributeError(f"module 'khmer_ocr_torch' has no attribute {name!r}")


__all__ = ["DecodeConfig", "ModelConfig", "OCRConfig", "Predictor", "PreprocessConfig", "RuntimeConfig",
           "Tokenizer", "recognize", "recognize_batch"]
