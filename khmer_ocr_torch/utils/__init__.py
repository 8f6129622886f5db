"""Logging set-up, per-stage timers and trace capture, as the JAX package's
``utils``. Its XLA compile cache has no counterpart: the port compiles no XLA
programs, and its kernels are cached in ``khmer_ocr_torch/_build/``."""

from .logging import setup_logging
from .profiling import StageTimes, profile_trace, stage_timer

__all__ = ["setup_logging", "profile_trace", "stage_timer", "StageTimes"]
