"""Layout detection: the SegFormer (MiT-b0) layout model, its classical-CV
post-process, ``LayoutInference`` and the layout CLI; the import-gated Surya
text-line engine."""

from .._exports import lazy_getattr

__all__ = ["LayoutConfig"]
__getattr__ = lazy_getattr(__name__, {"LayoutConfig": "config"})
