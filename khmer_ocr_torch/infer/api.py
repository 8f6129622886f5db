"""Public recognition API behind a locked singleton predictor.

``recognize``/``recognize_batch`` run on the CUDA card unless ``device`` says
otherwise, and raise when there is none. Errors propagate to the caller: no
call falls back to another device or to an empty answer.
"""

from __future__ import annotations

import threading

from .predictor import Predictor

_LOCK = threading.Lock()
_PREDICTOR: Predictor | None = None
_PREDICTOR_KEY: tuple | None = None


def get_predictor(model_path=None, vocab_path=None, device=None) -> Predictor:
    """The loaded predictor; ``model_path`` (an .npz of ``save_npz``) loads or
    reloads it, ``None`` reuses whatever is loaded."""
    global _PREDICTOR, _PREDICTOR_KEY
    key = (str(model_path), str(vocab_path), str(device))
    with _LOCK:
        if _PREDICTOR is not None and (model_path is None or _PREDICTOR_KEY == key):
            return _PREDICTOR
        if model_path is None:
            raise FileNotFoundError("No model weights loaded: pass model_path= (an .npz written by "
                                    "khmer_ocr_torch.convert.from_jax.save_npz) or call set_predictor()")
        _PREDICTOR = Predictor(model_path=model_path, vocab_path=vocab_path, device=device)
        _PREDICTOR_KEY = key
        return _PREDICTOR


def set_predictor(predictor: Predictor | None) -> None:
    """Install (or with None, drop) the singleton."""
    global _PREDICTOR, _PREDICTOR_KEY
    with _LOCK:
        _PREDICTOR, _PREDICTOR_KEY = predictor, None


def recognize(image_input, beam_width: int = 3, model_path=None, vocab_path=None, device=None) -> str:
    """Recognise the text of one line image (beam 3 by default)."""
    return get_predictor(model_path, vocab_path, device=device).predict(image_input, beam_width=beam_width)


def recognize_batch(image_list, beam_width: int = 1, batch_size: int = 8, model_path=None, vocab_path=None,
                    device=None, max_len: int | None = None) -> list[str]:
    """Recognise a list of line images with batched decoding."""
    if not image_list:
        return []
    predictor = get_predictor(model_path, vocab_path, device=device)
    return predictor.predict_batch(image_list, beam_width=beam_width, batch_size=batch_size, max_len=max_len)
