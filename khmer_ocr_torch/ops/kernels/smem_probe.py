"""The dynamic-shared-memory probe: CUDA kernel K4 (``csrc/smem_probe.cu``),
its plain version and the bisection.

``smem_probe(x, nbytes)``: x (8, 128) float32 -> out (8, 128) with row 0 =
x[0] + 2 x[0], computed through a buffer of ``nbytes`` of dynamic shared
memory whose first and last rows the kernel writes; rows 1-7 are zero (the
TPU kernel leaves them unset; the CUDA kernel writes them, so its output needs
no fill). A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.

``try_bytes(nbytes)`` launches on the card and says whether the card took the
size: False only for a refused configuration (cudaErrorInvalidValue); any
other error, or a wrong row 0 at a size that ran, raises.
``probe_max_bytes()`` climbs a ladder of sizes and bisects to 1 KB, as the
JAX package's examples/probe_vmem.py bisects VMEM to 4 MB.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

ROW_BYTES = 128 * 4  # one row of the probe's buffer
STEP = 1024  # the bisection stops within this many bytes
LADDER_KB = (16, 32, 64, 96, 128, 160, 192, 224, 256, 1024)
CUDA_ERROR_INVALID_VALUE = 1


def smem_probe_plain(x: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(x)
    out[0] = x[0] + x[0] * 2.0
    return out


def smem_probe(x: torch.Tensor, nbytes: int) -> torch.Tensor:
    if x.device.type == "cpu":
        return smem_probe_plain(x)
    out, err = _run(x, nbytes)
    build.check(err, "smem_probe")
    return out


@functools.cache
def _launcher():
    """The kernel's ctypes launcher, bound once: a probe's time is the host's
    work around one launch."""
    fn = build.load("smem_probe").smem_probe_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _run(x: torch.Tensor, nbytes: int) -> tuple[torch.Tensor, int]:
    """Launch and synchronise; returns (out, the launcher's cudaError_t)."""
    if not x.is_cuda or x.dtype != torch.float32 or tuple(x.shape) != (8, 128) or not x.is_contiguous():
        raise RuntimeError(f"smem_probe: x must be a contiguous (8, 128) float32 CUDA tensor, got "
                           f"{tuple(x.shape)} {x.dtype} on {x.device}")
    if nbytes < 2 * ROW_BYTES or nbytes % ROW_BYTES:
        raise ValueError(f"smem_probe: {nbytes} bytes is not a multiple of {ROW_BYTES} of at least two rows")
    out = torch.empty_like(x)  # the kernel writes every row
    # the current stream's handle; torch.cuda.current_stream() builds a Stream object for it, which costs
    # more host time than the launch itself
    stream = torch._C._cuda_getCurrentRawStream(x.get_device())
    err = _launcher()(x.data_ptr(), out.data_ptr(), nbytes, stream)
    if err == 0:
        build.count_launch(stream, k4=1)
    return out, err


def probe_input(device="cuda") -> torch.Tensor:
    return (torch.arange(8 * 128, dtype=torch.float32, device=device).reshape(8, 128) - 500.0) / 64.0


def try_bytes(nbytes: int, x: torch.Tensor | None = None) -> bool:
    x = probe_input() if x is None else x
    out, err = _run(x, nbytes)
    if err == CUDA_ERROR_INVALID_VALUE:
        return False
    build.check(err, "smem_probe")
    if not torch.equal(out[0], smem_probe_plain(x)[0]):
        raise RuntimeError(f"smem_probe: wrong row 0 at {nbytes} bytes")
    return True


def max_optin_bytes(device: int = 0) -> int:
    """cudaDevAttrMaxSharedMemoryPerBlockOptin: what the probe should find."""
    fn = build.load("smem_probe").smem_probe_max_optin
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    v = fn(device)
    if v < 0:
        build.check(-v, "smem_probe")
    return v


def bisect_max(try_fn, lo: int, hi: int, step: int = STEP) -> tuple[int, int]:
    """With try_fn(lo) True and try_fn(hi) False: (largest size found to run,
    smallest found refused), at most ``step`` apart, on whole rows."""
    while hi - lo > step:
        mid = (lo + hi) // 2 // ROW_BYTES * ROW_BYTES
        if try_fn(mid):
            lo = mid
        else:
            hi = mid
    return lo, hi


def probe_max_bytes(try_fn=None, log=None) -> tuple[int, int]:
    """The ladder, then the bisection: (largest size that runs, within STEP
    of the smallest refused one; that refused size)."""
    try_fn = try_fn or try_bytes
    lo, hi = STEP, None
    if not try_fn(lo):
        raise RuntimeError(f"smem_probe: even {lo} bytes were refused")
    for kb in LADDER_KB:
        ok = try_fn(kb * 1024)
        if log:
            log(f"dynamic shared memory {kb} KB: {'OK' if ok else 'refused'}")
        if not ok:
            hi = kb * 1024
            break
        lo = kb * 1024
    if hi is None:
        raise RuntimeError(f"smem_probe: {LADDER_KB[-1]} KB still launched; no refused size found")
    return bisect_max(try_fn, lo, hi)
