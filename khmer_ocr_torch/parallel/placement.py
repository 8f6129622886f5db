"""Where each parameter lives on the tensor-parallel model axis (numpy only).

The JAX package's mesh has a ``data`` axis and a ``model`` axis, and places
each parameter by its pytree path. Sharded over the model axis:
  * attention q/k/v weights by output columns (by heads), the out-projection
    ``o`` by input rows;
  * FFN ``lin1`` by columns, ``lin2`` by rows;
  * the decoder's vocabulary projection ``dec.out.w`` by columns and the
    token embedding ``dec.tok_emb`` by vocabulary rows.
Everything else (convolutions, norms, positions, biases, the LSTM) is
replicated. ``spec_for_path`` is that table: a spec names, for each axis of
the leaf, ``MODEL_AXIS`` if it is split over the model axis, else None; ()
for a replicated leaf. ``shard_params`` cuts a rank's part of a tree in the
JAX package's layout; ``local_shape`` is a leaf's shape on one rank.
"""

from __future__ import annotations

import numpy as np

MODEL_AXIS = "model"


def spec_for_path(path: str, ndim: int) -> tuple:
    """The placement of the leaf at ``path`` (its keys joined by dots, list
    indices as numbers, e.g. "dec.layers.0.self.q.w") with ``ndim`` axes."""
    if ndim < 2:
        return ()
    if ".lin1.w" in path or ".q.w" in path or ".k.w" in path or ".v.w" in path:
        return (None, MODEL_AXIS)
    if ".lin2.w" in path or ".o.w" in path:
        return (MODEL_AXIS, None)
    if path.endswith("dec.out.w"):
        return (None, MODEL_AXIS)
    if path.endswith("dec.tok_emb"):
        return (MODEL_AXIS, None)
    return ()


def path_str(path) -> str:
    return ".".join(str(k) for k in path)


def _map(fn, tree, prefix=()):
    if isinstance(tree, dict):
        return {k: _map(fn, v, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v, prefix + (i,)) for i, v in enumerate(tree)]
    return fn(prefix, tree)


def param_sharding(params) -> dict:
    """The spec of every leaf of ``params``, in a tree of the same shape."""
    return _map(lambda p, leaf: spec_for_path(path_str(p), np.ndim(leaf)), params)


def local_shape(path: str, shape: tuple, n_model: int) -> tuple:
    """The leaf's shape on one of ``n_model`` ranks."""
    spec = spec_for_path(path, len(shape))
    out = list(shape)
    for axis, name in enumerate(spec):
        if name == MODEL_AXIS:
            if shape[axis] % n_model:
                raise ValueError(f"{path}: axis {axis} of {shape} does not split over {n_model} ranks")
            out[axis] = shape[axis] // n_model
    return tuple(out)


def shard_leaf(path: str, leaf, rank: int, n_model: int):
    """Rank ``rank``'s part of one leaf (the whole leaf if replicated)."""
    spec = spec_for_path(path, np.ndim(leaf))
    index = []
    for axis, name in enumerate(spec):
        if name == MODEL_AXIS:
            n = local_shape(path, np.shape(leaf), n_model)[axis]
            index.append(slice(rank * n, (rank + 1) * n))
        else:
            index.append(slice(None))
    return leaf[tuple(index)] if index else leaf


def shard_params(params, rank: int, n_model: int):
    """Rank ``rank``'s part of a params tree in the JAX package's layout
    (nested dicts and lists of arrays) on a model axis of ``n_model``
    ranks: every split leaf cut to its contiguous block, the rest whole."""
    return _map(lambda p, leaf: shard_leaf(path_str(p), leaf, rank, n_model), params)
