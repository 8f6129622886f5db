"""Data and tensor parallelism over torch.distributed (parallel/mesh.py), and the
model axis's placement table (parallel/placement.py, numpy only)."""

from .._exports import lazy_getattr

__all__ = ["make_mesh", "param_sharding"]
__getattr__ = lazy_getattr(__name__, {"make_mesh": "mesh", "param_sharding": "placement"})
