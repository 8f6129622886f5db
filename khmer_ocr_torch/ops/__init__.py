"""Device operations: line chunking (lines.py), the exact adaptive pool
(adaptive_pool.py) and the hand-written CUDA kernels with their plain
versions (kernels/)."""

from .._exports import lazy_getattr

__all__ = ["adaptive_avg_pool2d", "adaptive_pool_matrix"]
__getattr__ = lazy_getattr(__name__, {name: "adaptive_pool" for name in __all__})
