"""Data and tensor parallelism over torch.distributed (parallel/mesh.py), and the
model axis's placement table (parallel/placement.py, numpy only)."""
