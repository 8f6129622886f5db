"""khmer_ocr_torch — the PyTorch/CUDA port of the JAX Khmer OCR package, for an NVIDIA H100.

Beam-3 recognition of uint8 text lines end to end: chunking and
normalisation on the device, the SE-VGG backbone, the per-chunk encoder, the
length-aware BiLSTM (CUDA kernel K1 on the card) and KV-cached beam decoding
(CUDA kernel K2 for every decoder layer step). Entry points run on the CUDA
card unless the caller passes ``device="cpu"``.

Whole pages go through ``KhmerOCRPipeline`` (pipeline/engine.py): the
SegFormer layout model on the card, its classical-CV post-process on the
host, then the recognizer on every detected line; ``pipeline/pdf.py`` writes
a searchable PDF, and ``KhmerOCRInference`` (infer/standalone.py) is the
reference's class API.

Importing the package loads neither torch nor the heavy modules; they load
with the first use of ``recognize``, ``recognize_batch`` or a lazy export
(``Predictor``, ``KhmerOCRInference``, ``KhmerOCRPipeline``, ``Evaluator``,
``calculate_cer``, ``levenshtein``).
"""

__version__ = "0.1.0"

from .config import DecodeConfig, ModelConfig, OCRConfig, PreprocessConfig, RuntimeConfig, TrainConfig
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
    if name == "KhmerOCRInference":
        from .infer.standalone import KhmerOCRInference

        return KhmerOCRInference
    if name == "KhmerOCRPipeline":
        from .pipeline.engine import KhmerOCRPipeline

        return KhmerOCRPipeline
    if name in ("Evaluator", "calculate_cer", "levenshtein"):
        from . import metrics

        return getattr(metrics, name)
    raise AttributeError(f"module 'khmer_ocr_torch' has no attribute {name!r}")


__all__ = ["DecodeConfig", "Evaluator", "KhmerOCRInference", "KhmerOCRPipeline", "ModelConfig", "OCRConfig",
           "Predictor", "PreprocessConfig", "RuntimeConfig", "Tokenizer", "TrainConfig", "calculate_cer",
           "levenshtein", "recognize", "recognize_batch"]
