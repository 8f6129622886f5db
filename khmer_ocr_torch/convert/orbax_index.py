"""An Orbax checkpoint's leaves, read through an index, without tensorstore.

An Orbax PyTree checkpoint (OCDBT layout) keeps each leaf as one zarr v2
chunk, zstd-compressed: the large chunks as byte ranges of its data files,
the small ones inside its b-tree nodes. Reading the b-tree needs tensorstore.
An index, written once where tensorstore is installed, lists for every leaf
its tree path, dtype and shape, and either the data file, offset and length
of its chunk or the chunk's bytes themselves (base64), with the sha256 of
the chunk. ``load_index`` reads each chunk, checks the hash, decompresses it
with the system's zstd library through ctypes, and widens bfloat16 exactly to
float32. A directory holding ``index.json`` and ``model_config.json`` is a
weights directory that ``infer/predictor.py`` loads; ``index.json`` names
the checkpoint directory relative to itself.

Without the zstd library (``libzstd.so.1``) ``load_index`` raises.
"""

from __future__ import annotations

import base64
import ctypes
import ctypes.util
import hashlib
import json
from pathlib import Path

import numpy as np

from ..config import ModelConfig
from .from_jax import _unflatten, bf16_bits_to_f32

INDEX = "index.json"
META = "model_config.json"
_ZSTD: ctypes.CDLL | None = None


def _zstd() -> ctypes.CDLL:
    global _ZSTD
    if _ZSTD is None:
        name = ctypes.util.find_library("zstd") or "libzstd.so.1"
        try:
            lib = ctypes.CDLL(name)
        except OSError as e:
            raise RuntimeError(f"the zstd library ({name}) is not installed: the checkpoint's chunks are "
                               "zstd-compressed") from e
        lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t]
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
        lib.ZSTD_getErrorName.restype = ctypes.c_char_p
        _ZSTD = lib
    return _ZSTD


def zstd_decompress(data: bytes, size: int) -> bytes:
    """One zstd frame -> exactly ``size`` bytes; raises otherwise."""
    lib = _zstd()
    out = ctypes.create_string_buffer(size)
    got = lib.ZSTD_decompress(out, size, data, len(data))
    if lib.ZSTD_isError(got):
        raise ValueError(f"zstd: {lib.ZSTD_getErrorName(got).decode()}")
    if got != size:
        raise ValueError(f"zstd: {got} bytes decompressed, {size} expected")
    return out.raw


_DTYPES = {"bfloat16": 2, "<f4": 4}


def read_leaf(entry: dict, checkpoint: Path) -> np.ndarray:
    """One index entry -> its array, float32."""
    if "inline" in entry:
        chunk = base64.b64decode(entry["inline"])
    else:
        with open(checkpoint / entry["file"], "rb") as f:
            f.seek(entry["offset"])
            chunk = f.read(entry["length"])
    name = ".".join(map(str, entry["path"]))
    if hashlib.sha256(chunk).hexdigest() != entry["sha256"]:
        raise ValueError(f"leaf {name}: its chunk does not match the index's sha256")
    dtype, shape = entry["dtype"], tuple(entry["shape"])
    if dtype not in _DTYPES:
        raise ValueError(f"leaf {name}: dtype {dtype} (the index takes {sorted(_DTYPES)})")
    raw = zstd_decompress(chunk, int(np.prod(shape)) * _DTYPES[dtype])
    arr = bf16_bits_to_f32(np.frombuffer(raw, "<u2")) if dtype == "bfloat16" else np.frombuffer(raw, "<f4")
    return arr.astype(np.float32).reshape(shape)


def load_index(path: str | Path):
    """A weights directory (``index.json`` + ``model_config.json``) ->
    (params, batch_stats, ModelConfig), every leaf float32."""
    path = Path(path)
    index = json.loads((path / INDEX).read_text())
    checkpoint = (path / index["checkpoint"]).resolve()
    meta = json.loads((path / META).read_text())
    cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in meta.items()})
    trees: dict = {"params": {}, "batch_stats": {}}
    for entry in index["leaves"]:
        tree, *rest = entry["path"]
        trees[tree][tuple(rest)] = read_leaf(entry, checkpoint)
    return _unflatten(trees["params"]), _unflatten(trees["batch_stats"]), cfg
