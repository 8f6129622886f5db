"""The recognition model as functions over dicts of tensors: the three
backbones, the encoder and decoder layers, the BiLSTM, and the model's
encode, teacher-forced decode and KV-cached decode step."""

from .._exports import lazy_getattr

__all__ = ["CHUNK_TOKENS", "decode_step", "decode_train", "encode", "forward_train", "init_decode_state",
           "init_model"]
__getattr__ = lazy_getattr(__name__, {name: "ocr_model" for name in __all__})
