"""First-use build of the CUDA kernels and their ctypes loader.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain ``extern "C"`` launcher (no PyTorch headers, so a
build takes seconds). The decoder kernels' sources build twice, once per
storage type: the ``*_bf16`` libraries with ``-DSTORAGE_BF16``, so each
nvcc instantiates half the templates and the two run in parallel.
Libraries land in ``khmer_ocr_torch/_build/``, named by a hash of the
source, the ``csrc/`` headers it includes and the flags, so an edited source
or header rebuilds and an unchanged one is reused. K2 has a second float
library, ``decoder_layer_step_two_ctas``, whose registers are bounded for
two CTAs an SM (``-DK2_F32_MIN_BLOCKS=2``; ``geometry.k2_two_ctas_an_sm``
picks it for launches with more clusters than one CTA an SM holds); its card
route, ``decoder_layer_card``, is float32 alone. ``build()`` starts one
``nvcc`` per missing library, all at once, and waits for them.

Every kernel wrapper counts its launches into the one registry here,
``launches``, by ``count_launch``. A launch on a stream that a CUDA graph
captures launches nothing: it counts to that capture (``capturing``),
whichever thread made it (the autograd engine runs a backward on a thread
of its own), and the graph's replays add it (cuda_graphs.py).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

SOURCES = {
    "lstm_recurrence": "lstm_recurrence.cu",
    "lstm_backward": "lstm_backward.cu",
    "decoder_layer_step": "decoder_layer_step.cu",
    "decoder_layer_step_bf16": "decoder_layer_step.cu",
    "decoder_layer_step_two_ctas": "decoder_layer_step.cu",
    "decoder_layer_card": "decoder_layer_card.cu",
    "decoder_block": "decoder_block.cu",
    "decoder_block_bf16": "decoder_block.cu",
    "decode_loop": "decode_loop.cu",
    "decode_loop_bf16": "decode_loop.cu",
    "beam_step": "beam_step.cu",
    "smem_probe": "smem_probe.cu",
}
_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# kernel launches since the last reset_launches(), by counter: "k1" (lstm), "k1b" (lstm_backward), "k2" (every
# decoder layer step, whichever route), of which "k2_bf16" in bfloat16, "k2_head" with the head fused and
# "k2_card" on the card route, "k2_block" (the tensor-parallel blocks), "k3" (decode_loop), "k4" (smem_probe),
# "k5" (beam_step)
launches: Counter = Counter()
_CAPTURES: dict[int, Counter] = {}  # the launches counted to each capturing stream's capture, by stream handle

_LIBS: dict[str, ctypes.CDLL] = {}
# compiler output (ptxas register and shared-memory report) of this process's builds
BUILD_LOGS: dict[str, str] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc, or PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.exists():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return found


def source_files(name: str) -> list[Path]:
    """The kernel's source and every ``csrc/`` header it includes, directly
    or through another header."""
    files, todo = [], [CSRC_DIR / SOURCES[name]]
    while todo:
        f = todo.pop()
        if f in files:
            continue
        files.append(f)
        todo += [CSRC_DIR / inc for inc in _LOCAL_INCLUDE.findall(f.read_text())]
    return files


def extra_flags(name: str) -> tuple[str, ...]:
    if name.endswith("_bf16"):
        return ("-DSTORAGE_BF16",)
    return ("-DK2_F32_MIN_BLOCKS=2",) if name.endswith("_two_ctas") else ()


def library_name(name: str, dtype, two_ctas: bool = False) -> str:
    """The library of kernel ``name`` for tensors of ``dtype`` (a torch
    dtype): the ``_bf16`` build for bfloat16, else the float one, or with
    ``two_ctas`` K2's float build bounded for two CTAs an SM."""
    if str(dtype) == "torch.bfloat16":
        return f"{name}_bf16"
    return f"{name}_two_ctas" if two_ctas else name


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + extra_flags(name)).encode())
    for f in source_files(name):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, float]:
    """Build the named kernels (all by default) that are not built yet, one
    nvcc process each, in parallel. Returns seconds per kernel built; raises
    with the compiler's output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *extra_flags(name), "-o", str(tmp), str(CSRC_DIR / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    seconds, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def reset_launches() -> None:
    launches.clear()


def count_launch(stream: int, **counts: int) -> None:
    """Add ``counts`` (counter: launches) of launches on the stream handle
    ``stream`` to the registry, or to the capture of that stream."""
    capture = _CAPTURES.get(stream)
    (launches if capture is None else capture).update(counts)


@contextlib.contextmanager
def capturing(stream: int):
    """Within: launches on the stream handle ``stream`` (a capture's) count
    to the Counter yielded, not to the registry."""
    _CAPTURES[stream] = counts = Counter()
    try:
        yield counts
    finally:
        del _CAPTURES[stream]


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
