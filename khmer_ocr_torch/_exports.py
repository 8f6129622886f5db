"""The subpackages' re-exports, resolved at first use.

Each subpackage's ``__init__`` names the same ``__all__`` as the JAX
package's and serves it through ``lazy_getattr``: ``from
khmer_ocr_torch.infer import Predictor`` imports ``infer/predictor.py`` then,
and ``import khmer_ocr_torch.infer`` alone loads no more than before (no
torch, Pillow or OpenCV).
"""

from __future__ import annotations

import sys
from importlib import import_module


def lazy_getattr(package: str, exports: dict[str, str]):
    """-> a module ``__getattr__`` for ``package`` that serves each name of
    ``exports`` ({name: submodule}) from that submodule and keeps it on the
    package."""

    def __getattr__(name: str):
        if name not in exports:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        value = getattr(import_module(f"{package}.{exports[name]}"), name)
        setattr(sys.modules[package], name, value)
        return value

    return __getattr__
