"""Recognition of line images: the ``Predictor`` (batched beam and greedy
decode through the kernels), ``recognize`` and ``recognize_batch``, the CLI,
the encode graphs and the reference's ``KhmerOCRInference`` class."""

from .._exports import lazy_getattr

__all__ = ["Predictor"]
__getattr__ = lazy_getattr(__name__, {"Predictor": "predictor"})
