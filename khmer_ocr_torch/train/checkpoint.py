"""Checkpoints of the training state, in PyTorch's own format.

A checkpoint is a directory: ``state.pt`` (``torch.save`` of the params,
batch_stats, the Adam moments and count, the step and the epoch, as trees
of CPU tensors) and ``model_config.json`` (the ModelConfig). It resumes a run
exactly. ``convert/from_jax.py::params_to_jax`` turns its params and
batch_stats into the JAX package's layout.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import torch

from ..config import ModelConfig

_META = "model_config.json"
_STATE = "state.pt"


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cpu(v) for v in tree]
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def save_checkpoint(path, params, batch_stats, model_cfg: ModelConfig, opt_state=None, step: int | None = None,
                    epoch: int | None = None) -> Path:
    """Write the checkpoint directory ``path``; returns it."""
    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    payload = {"params": _cpu(params), "batch_stats": _cpu(batch_stats)}
    if opt_state is not None:
        payload["opt_state"] = _cpu(opt_state)
    if step is not None:
        payload["step"] = int(step)
    if epoch is not None:
        payload["epoch"] = int(epoch)
    tmp = path / (_STATE + ".tmp")
    torch.save(payload, tmp)
    tmp.replace(path / _STATE)
    (path / _META).write_text(json.dumps(dataclasses.asdict(model_cfg), indent=2))
    return path


def load_checkpoint(path, device="cpu"):
    """-> (params, batch_stats, model_cfg)."""
    payload, model_cfg = load_checkpoint_full(path, device)
    return payload["params"], payload["batch_stats"], model_cfg


def load_checkpoint_full(path, device="cpu"):
    """-> (payload with "params", "batch_stats" and, where saved,
    "opt_state", "step" and "epoch"; model_cfg), tensors on ``device``."""
    path = Path(path).absolute()
    meta = json.loads((path / _META).read_text())
    model_cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in meta.items()})
    payload = torch.load(path / _STATE, map_location=device, weights_only=True)
    return payload, model_cfg
