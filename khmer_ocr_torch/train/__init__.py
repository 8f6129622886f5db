"""Training of the recognition model: teacher-forced train step, device
augmentation, bucketed data, the staged learning-rate schedule,
checkpoints, the loop and its CLI."""
