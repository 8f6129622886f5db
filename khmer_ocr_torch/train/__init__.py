"""Training of the recognition model: teacher-forced train step, device
augmentation, bucketed data, the staged learning-rate schedule,
checkpoints, the loop and its CLI."""

from .._exports import lazy_getattr

__all__ = ["TrainState", "init_train_state", "loss_fn", "make_train_step", "staged_cyclic_lr"]
__getattr__ = lazy_getattr(__name__, {"TrainState": "step", "init_train_state": "step", "loss_fn": "step",
                                      "make_train_step": "step", "staged_cyclic_lr": "schedule"})
