"""Staged cyclic learning-rate schedule, on the host (numpy).

  * epochs 1-15:  fixed ``base_lr`` (1e-4)
  * epochs 16-30: triangular cycle between ``stage2_lr`` (1e-5, 1e-4)
  * epochs 31+:   triangular cycle between ``stage3_lr`` (1e-6, 1e-5)
with ``step_size_up = steps_per_epoch // 2`` and the cycle restarted every
epoch: one triangle per epoch, up over the first half, down over the second
(PyTorch's CyclicLR recreated each epoch).

Triangular: ``cycle = floor(1 + it / (2 step_size))``,
``x = |it / step_size - 2 cycle + 1|``, ``lr = base + (max - base) max(0, 1 - x)``.
"""

from __future__ import annotations

import numpy as np

from ..config import TrainConfig


def _triangular(it, base: float, peak: float, step_size: int):
    step_size = max(step_size, 1)
    cycle = np.floor(1 + it / (2 * step_size))
    x = np.abs(it / step_size - 2 * cycle + 1)
    return base + (peak - base) * np.maximum(0.0, 1.0 - x)


def staged_cyclic_lr(cfg: TrainConfig, steps_per_epoch: int):
    """-> schedule(global step) -> learning rate (a Python float)."""
    step_size = steps_per_epoch // 2

    def schedule(step):
        epoch = step // steps_per_epoch + 1  # 1-based epochs
        it = step % steps_per_epoch  # the cycle restarts every epoch
        lr2 = _triangular(it, cfg.stage2_lr[0], cfg.stage2_lr[1], step_size)
        lr3 = _triangular(it, cfg.stage3_lr[0], cfg.stage3_lr[1], step_size)
        return float(np.where(
            epoch < cfg.stage2_start_epoch,
            cfg.base_lr,
            np.where(epoch < cfg.stage3_start_epoch, lr2, lr3),
        ))

    return schedule
