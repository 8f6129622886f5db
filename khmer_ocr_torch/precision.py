"""Float32 matmul precision scoped to a call.

``matmul_precision(p)`` is a context manager that sets torch's three
switches for float32 products and convolutions on entry and puts back, on
exit by any path, exactly the values it found:

  * "highest": full float32 (TF32 off for matmul and cuDNN,
    ``set_float32_matmul_precision("highest")``), the parity mode;
  * "high" and "default": TF32 on for both, ``"high"``.

The switches belong to the process, while the JAX package's
``default_matmul_precision`` belongs to a thread. So a process-wide gate
keeps two precisions from overlapping: any number of threads may be inside
scopes of one precision at once, a thread that asks for another waits until
they have all left, a scope nested in one of the same precision in the same
thread changes nothing, and one of another precision raises ValueError
(waiting would deadlock). Hold a scope only around compute: never across a
``yield`` or a queue's ``put``/``get``, where another thread's scope may be
what it waits for.
"""

from __future__ import annotations

import contextlib
import threading

import torch

PRECISIONS = ("highest", "high", "default")

_gate = threading.Condition()
_held = {"precision": None, "scopes": 0, "saved": None}  # under _gate: the open scopes of all threads
_local = threading.local()  # this thread's open precision


def switches() -> tuple[bool, bool, str]:
    """(cuda.matmul.allow_tf32, cudnn.allow_tf32, float32 matmul precision)."""
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())


def _set(matmul_tf32: bool, cudnn_tf32: bool, matmul_precision: str) -> None:
    # allow_tf32 rewrites the matmul precision ("medium" would read back as "high"), so the precision goes last
    torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    torch.set_float32_matmul_precision(matmul_precision)


def check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"matmul_precision {precision!r}: one of {PRECISIONS}")


def check_nesting(precision: str) -> None:
    """Raise ValueError where this thread holds a scope of another precision,
    as ``matmul_precision(precision)`` would here: for a caller whose scopes
    open on another thread, which would wait for this one's to close."""
    check_precision(precision)
    mine = getattr(_local, "precision", None)
    if mine is not None and mine != precision:
        raise ValueError(f"a matmul_precision({precision!r}) scope inside this thread's {mine!r} scope")


@contextlib.contextmanager
def matmul_precision(precision: str):
    check_nesting(precision)
    if getattr(_local, "precision", None) is not None:
        yield
        return
    with _gate:
        while _held["scopes"] and _held["precision"] != precision:
            _gate.wait()
        if not _held["scopes"]:
            tf32 = precision != "highest"
            _held.update(precision=precision, saved=switches())
            _set(tf32, tf32, "high" if tf32 else "highest")
        _held["scopes"] += 1
    _local.precision = precision
    try:
        yield
    finally:
        _local.precision = None
        with _gate:
            _held["scopes"] -= 1
            if not _held["scopes"]:
                _set(*_held["saved"])
                _held.update(precision=None, saved=None)
                _gate.notify_all()
