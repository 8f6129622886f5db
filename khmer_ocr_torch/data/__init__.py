"""Synthetic data: the Khmer font renderer and its generators, the document
degradations, the seeded block lines and pages of the tests, and the data
CLI."""

from .._exports import lazy_getattr

__all__ = ["DocumentTextGenerator", "SceneTextGenerator", "render_text_line"]
__getattr__ = lazy_getattr(__name__, {name: "generator" for name in __all__})
