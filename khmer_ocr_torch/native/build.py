"""First-use g++ builds of the host's native code, and the ctypes binding of
the batched edit distance.

Each source exposes plain C functions and compiles once with g++ into
``khmer_ocr_torch/_build/`` (``build_library``), named by a hash of the
source and the flags, so an edited source rebuilds and an unchanged one is
reused; a build writes to a name of its own process and renames it into
place, so processes that build at once never share a file. For
``levenshtein.cpp``, without g++ or when the build fails,
``load_native_library`` raises: nothing falls back to the numpy DP of
``metrics.levenshtein`` (the tests hold the two equal). The image loader
(imageio.py) builds through the same function.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "levenshtein.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def library_path(src: Path = _SRC, link: tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS + link).encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_library(src: Path, link: tuple[str, ...] = ()) -> Path:
    """The shared library of ``src`` (linked with ``link``), built with g++
    if it is not built yet; raises when g++ is missing or the build fails."""
    so_path = library_path(src, link)
    if so_path.exists():
        return so_path
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: native/{src.name} is built with g++ at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so_path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    done = subprocess.run([gxx, *GXX_FLAGS, str(src), *link, "-o", str(tmp)], capture_output=True, text=True,
                          timeout=300)
    if done.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {src.name} failed (g++ exit {done.returncode}):\n{done.stderr}")
    os.replace(tmp, so_path)
    return so_path


def load_native_library() -> ctypes.CDLL:
    """Build (once) and load the library; raises when g++ is missing or the
    build fails."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build_library(_SRC)))
        lib.levenshtein_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ]
        lib.levenshtein_batch.restype = None
        _LIB = lib
        return lib


def _pack(strings: list[str]) -> tuple[np.ndarray, np.ndarray]:
    offsets = np.zeros(len(strings) + 1, np.int64)
    arrays = []
    for i, s in enumerate(strings):
        a = np.frombuffer(s.encode("utf-32-le"), dtype=np.uint32)
        arrays.append(a)
        offsets[i + 1] = offsets[i] + a.size
    data = np.concatenate(arrays) if arrays else np.zeros(0, np.uint32)
    return np.ascontiguousarray(data), offsets


def levenshtein_batch(refs: list[str], hyps: list[str], num_threads: int = 0) -> np.ndarray:
    """Edit distances of each (ref, hyp) pair by the C++ kernel, over
    ``num_threads`` threads (0: one a core)."""
    if len(refs) != len(hyps):
        raise ValueError(f"{len(refs)} references against {len(hyps)} hypotheses")
    n = len(refs)
    if n == 0:
        return np.zeros(0, np.int64)
    lib = load_native_library()
    rdata, roff = _pack(refs)
    hdata, hoff = _pack(hyps)
    out = np.zeros(n, np.int64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.levenshtein_batch(
        rdata.ctypes.data_as(u32p), roff.ctypes.data_as(i64p),
        hdata.ctypes.data_as(u32p), hoff.ctypes.data_as(i64p),
        ctypes.c_int64(n), out.ctypes.data_as(i64p), ctypes.c_int64(num_threads),
    )
    return out
