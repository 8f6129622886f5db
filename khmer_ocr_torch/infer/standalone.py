"""``KhmerOCRInference``: the standalone class API of the reference's HF-Hub
distribution (inference.py:36-295): construct with explicit model and vocab
paths and call ``.predict(image, beam_width)`` a line at a time.

Where it differs from the packaged Predictor path, it keeps the standalone
variant's behaviour:
  * ``max_length`` (the decode cap of ``predict``) defaults to 128, against
    the packaged 256 (inference.py:213 against config.py:12, a disagreement
    inside the reference itself);
  * ``binarize=True`` applies Otsu after a blur before the resize (the
    notebook's binarized evaluation variant).
The packaged min-width floor (50) is used rather than the standalone's 10,
as in the published-CER configuration. The backbone comes from the weights
file's name (``config.backbone_for_path``) unless the weights record their
own configuration. ``device``: the CUDA card by default (raising without
one), or ``"cpu"``.
"""

from __future__ import annotations

import dataclasses

from ..config import OCRConfig, backbone_for_path
from .predictor import Predictor


class KhmerOCRInference:
    def __init__(self, model_path, char2idx_path=None, model_class=None, emb_dim: int = 384,
                 max_global_len: int = 4096, device=None, binarize: bool = False,
                 max_length: int = 128):
        del model_class  # accepted for the reference's signature; the backbone comes from the path
        config = OCRConfig()
        config = dataclasses.replace(
            config,
            preprocess=dataclasses.replace(config.preprocess, binarize=binarize),
            model=dataclasses.replace(config.model, backbone=backbone_for_path(model_path), emb_dim=emb_dim,
                                      max_global_len=max_global_len),
        )
        self._predictor = Predictor(model_path=model_path, vocab_path=char2idx_path, config=config, device=device)
        self.max_length = max_length

    def predict(self, image_input, beam_width: int = 3) -> str:
        # the standalone decode cap (inference.py:213) as a per-call override
        return self._predictor.predict(image_input, beam_width=beam_width, max_len=self.max_length)

    def predict_batch(self, images, beam_width: int = 1, batch_size: int = 8):
        return self._predictor.predict_batch(images, beam_width=beam_width, batch_size=batch_size)
