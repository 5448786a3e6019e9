"""Build, load and call the port's CUDA kernels.

The kernel sources under ``csrc/`` have a plain C interface (no PyTorch
headers). At first use they are compiled for Hopper (``sm_90a``), one
``nvcc`` process per source, all started together, and linked into one
shared library under ``build/`` inside the package, in a directory keyed on
a hash of the sources and flags. The library is loaded with ``ctypes``:
pointers go in as ``c_void_p``, the stream is PyTorch's current stream, and
every entry point returns ``cudaGetLastError()``, which :func:`check` turns
into an exception.

Nothing here runs at import time, so the package imports on machines with
no CUDA toolkit (the CPU tests); there the kernel wrappers take their plain
PyTorch versions for CPU tensors and never reach this module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "build"
LIB_NAME = "libxfa_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# dtype codes of csrc/common.cuh; KV caches may also hold int8 / e4m3
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
CACHE_CODES = {**DTYPE_CODES, torch.int8: 2, torch.float8_e4m3fn: 3}

_c_void_p, _c_int, _c_int64, _c_float = (
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float)
# XFA_MASK_ARGS of csrc/common.cuh: FlashMask vectors, stats, mode, heads,
# padded length; block mask, batch and head strides, heads, columns, gq, gk;
# the row/key and position windows; the tokens' info (q, k), their stats
# (q, k) and the tile ranges, the info's padded lengths, the stats' tiles
# and the ranges' blocks per batch row
_MASK_ARGS = ([_c_void_p, _c_void_p, _c_int, _c_int, _c_int, _c_void_p,
               _c_int64, _c_int64] + [_c_int] * 4 + [_c_int] * 4
              + [_c_void_p] * 5 + [_c_int] * 5)
# XFA_BIAS_ARGS of csrc/common.cuh: the attention bias's pointer, batch,
# head and row strides and dtype code
_BIAS_ARGS = [_c_void_p] + [_c_int64] * 3 + [_c_int]
# XFA_DROPOUT_ARGS of csrc/common.cuh: on, the seed's 32 bits, the keep
# threshold and 1 / (1 - p) (ops common.py Dropout.c_args)
_DROPOUT_ARGS = [_c_int, ctypes.c_uint32, ctypes.c_uint32, _c_float]
# the backward's (and the forward's, after its own arguments): the mask
# arguments, then the FlashMask bands, the masked kernels' three counters,
# the bias, dropout and the stream
_BWD_ARGS = ([_c_void_p] * 9 + [_c_int64] * 21 + [_c_int] * 6
             + [_c_float, _c_float, _c_int] + _MASK_ARGS + [_c_void_p] * 2
             + _BIAS_ARGS + _DROPOUT_ARGS + [_c_void_p])
_SIGNATURES = {
    # the fused norm (#7 / #8): ..., rowscale, colscale (the backward also
    # x0, its dtype code and the dcolscale partials before them), dropout
    "xfa_ln_fwd": [_c_void_p, _c_int, _c_void_p, _c_int, _c_void_p,
                   _c_void_p, _c_void_p, _c_void_p, _c_int, _c_void_p,
                   _c_void_p, _c_int64, _c_int, _c_float, _c_int, _c_void_p,
                   _c_void_p] + _DROPOUT_ARGS + [_c_void_p],
    "xfa_ln_bwd": [_c_void_p, _c_int, _c_void_p, _c_int, _c_void_p, _c_int,
                   _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_int,
                   _c_void_p, _c_int, _c_void_p, _c_void_p, _c_int64, _c_int,
                   _c_int, _c_int, _c_void_p, _c_int, _c_void_p, _c_void_p,
                   _c_void_p] + _DROPOUT_ARGS + [_c_void_p],
    "xfa_flash_fwd": [_c_void_p] * 5 + [_c_int64] * 12 + [_c_int] * 6
    + [_c_float, _c_float, _c_int] + _MASK_ARGS + [_c_void_p] * 2
    + _BIAS_ARGS + _DROPOUT_ARGS + [_c_void_p],
    "xfa_flash_fwd_fp8": [_c_void_p] * 8 + [_c_int64] * 12 + [_c_int] * 6
    + [_c_float, _c_float, _c_int, _c_int, _c_void_p],
    "xfa_flash_bwd_prep": [_c_void_p] * 5 + [_c_int64] * 9 + [_c_int] * 4
    + [_c_float, _c_int, _c_void_p],
    # flash_fp32.cu: the forward (a page table and lengths for the paged
    # instantiation) and the backward (which kernel), each then with the
    # mask arguments, the FlashMask bands, the masked kernels' counters and
    # the bias; dbias as flash_bwd_dbias.cu's; the reduced scores (#12) as
    # reduced_scores.cu's
    "xfa_flash_fwd_fp32": [_c_void_p] * 5 + [_c_int64] * 12 + [_c_int] * 6
    + [_c_float, _c_float, _c_int, _c_int] + [_c_void_p] * 2 + [_c_int] * 3
    + _MASK_ARGS + [_c_void_p] * 2 + _BIAS_ARGS + [_c_void_p],
    "xfa_flash_bwd_fp32": [_c_void_p] * 9 + [_c_int64] * 21 + [_c_int] * 6
    + [_c_float, _c_float, _c_int, _c_int, _c_int] + _MASK_ARGS
    + [_c_void_p] * 2 + _BIAS_ARGS + [_c_void_p],
    "xfa_flash_bwd_dbias_fp32": [_c_void_p] * 7 + [_c_int64] * 15
    + [_c_int] * 8 + [_c_float, _c_int] + _MASK_ARGS + _BIAS_ARGS
    + [_c_void_p],
    "xfa_reduced_scores_fp32": [_c_void_p] * 4 + [_c_int64] * 6
    + [_c_int] * 6 + [_c_float, _c_int, _c_void_p],
    "xfa_flash_bwd_dkv": _BWD_ARGS,
    "xfa_flash_bwd_dq": _BWD_ARGS,
    "xfa_flash_bwd_dbias": [_c_void_p] * 7 + [_c_int64] * 15 + [_c_int] * 8
    + [_c_float, _c_int] + _MASK_ARGS + _BIAS_ARGS + [_c_void_p],
    "xfa_flash_decode": [_c_void_p] * 12 + [_c_int64, _c_int64, _c_int] * 2
    + [_c_int] * 11
    + [_c_float, _c_float, _c_int, _c_void_p],
    "xfa_flash_decode_max_clusters": [_c_int] * 6
    + [ctypes.POINTER(ctypes.c_int)],
    "xfa_paged_decode": [_c_void_p] * 6 + [_c_int] * 9
    + [_c_float, _c_float, _c_int, _c_int, _c_void_p],
    "xfa_reduced_scores": [_c_void_p] * 4 + [_c_int64] * 6 + [_c_int] * 6
    + [_c_float, _c_int, _c_void_p],
}


def sources():
    return sorted(CSRC.glob("*.cu"))


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (looked on PATH and in CUDA_HOME); the CUDA "
            "toolkit is needed to build the kernels")
    return str(path)


def _build_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / _build_key() / LIB_NAME


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless this exact build exists; return the .so.

    With ``verbose`` the compiler's report (``-Xptxas -v``: registers,
    shared memory and spills of every kernel) is printed.
    """
    target = library_path()
    if target.exists():
        if verbose:
            log = target.parent / "build.log"
            print(log.read_text() if log.exists() else f"cached: {target}")
        return target
    nvcc_path = nvcc()
    target.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        procs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc_path, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name} (rc {proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
        lib_tmp = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc_path, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(lib_tmp), *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        (Path(tmp) / "build.log").write_text(log)
        os.replace(Path(tmp) / "build.log", target.parent / "build.log")
        # atomic publish: a concurrent build process sees either no
        # library or a complete one
        os.replace(lib_tmp, target)
    if verbose:
        print(log)
    return target


@functools.lru_cache(maxsize=1)
def lib() -> ctypes.CDLL:
    handle = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    handle.xfa_error_string.argtypes = [ctypes.c_int]
    handle.xfa_error_string.restype = ctypes.c_char_p
    return handle


def check(code: int, what: str) -> None:
    if code != 0:
        msg = lib().xfa_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def ptr(t):
    """A tensor's device pointer, or None (a null pointer) for no tensor."""
    return t.data_ptr() if t is not None else None


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index``, read once: the launch plans
    ask for it on every call, and a step being captured in a CUDA graph
    should make no device query."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def dtype_code(t: torch.Tensor) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(
            f"the CUDA kernels take float32 or bfloat16, got {t.dtype}"
        ) from None


def cache_dtype_code(t: torch.Tensor) -> int:
    try:
        return CACHE_CODES[t.dtype]
    except KeyError:
        raise TypeError(
            "the CUDA decode kernels take float32, bfloat16, int8 or "
            f"float8_e4m3fn caches, got {t.dtype}") from None


def require_cuda(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one CUDA device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(
            f"expected tensors on one CUDA device, got {sorted(map(str, devices))}")


def require_aligned(t: torch.Tensor, elems: int, what: str) -> None:
    """Raise unless ``t``'s pointer and its strides (but the last, which
    must be 1) are multiples of ``elems`` elements."""
    if t.stride(-1) != 1:
        raise ValueError(f"{what}: the last axis must be contiguous")
    if t.data_ptr() % (elems * t.element_size()) != 0 or any(
            s % elems for s in t.stride()[:-1]):
        raise ValueError(
            f"{what}: pointer and strides must be multiples of {elems} "
            f"elements, got strides {t.stride()}")


def aligned(t: torch.Tensor, elems: int) -> torch.Tensor:
    """``t`` if :func:`require_aligned` accepts it, else a contiguous copy
    (autograd may hand a kernel an expanded or transposed gradient)."""
    if t.stride(-1) == 1 and t.data_ptr() % (elems * t.element_size()) == 0 \
            and not any(s % elems for s in t.stride()[:-1]):
        return t
    return t.contiguous()
