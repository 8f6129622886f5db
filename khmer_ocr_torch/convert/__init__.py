"""Reference checkpoints into the port: the PyTorch trainer's .pth/.pt and
.safetensors files (torch_loader.py), the JAX package's trees as numpy
(from_jax.py) and the Orbax checkpoint through a weights index
(orbax_index.py)."""

from .._exports import lazy_getattr

__all__ = ["convert_state_dict", "detect_model_config", "load_torch_checkpoint"]
__getattr__ = lazy_getattr(__name__, {name: "torch_loader" for name in __all__})
