"""Language-modeling data (≙ xhy_flash_attention_tpu training/data.py).

A flat .bin of uint16/uint32 tokens serves fixed (seqlen + 1)-token windows
in a shuffled order that is a pure function of (seed, epoch, index), through
a 4-round Feistel permutation: exact resume needs only the integer step.
The serving hot path is the repository's native loader,
csrc/dataloader/dataloader.cpp, used as it is: g++ builds it at first use
into the port's build directory, and it is loaded with ctypes. A numpy
mirror of the permutation serves the same windows where no compiler is at
hand. The windows are identical to the JAX package's for the same file and
seed.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

from ..ops._cuda import BUILD_ROOT

__all__ = ["TokenDataset", "LMDataModule", "build_token_cache"]

_SRC = Path(__file__).resolve().parents[2] / "csrc" / "dataloader" / "dataloader.cpp"
_GXX = ("g++", "-O3", "-shared", "-fPIC", "-std=c++17")


@functools.lru_cache(maxsize=1)
def _lib() -> Optional[ctypes.CDLL]:
    """Compile the C++ loader into build/ (keyed on a hash of the source and
    flags) unless that build exists, and load it; None where it cannot be
    built."""
    if not _SRC.exists():
        return None
    key = hashlib.sha256(" ".join(_GXX).encode() + _SRC.read_bytes())
    so = BUILD_ROOT / f"dataloader-{key.hexdigest()[:16]}" / "libxfa_dataloader.so"
    try:
        if not so.exists():
            so.parent.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=so.parent) as tmp:
                out = Path(tmp) / so.name
                subprocess.run([*_GXX, str(_SRC), "-o", str(out), "-lpthread"],
                               check=True, capture_output=True)
                os.replace(out, so)  # atomic publish
        lib = ctypes.CDLL(str(so))
    except (OSError, subprocess.CalledProcessError):
        return None
    lib.dl_open.restype = ctypes.c_void_p
    lib.dl_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int64]
    lib.dl_num_sequences.restype = ctypes.c_int64
    lib.dl_num_sequences.argtypes = [ctypes.c_void_p]
    lib.dl_fetch.restype = ctypes.c_int
    lib.dl_fetch.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
    ]
    lib.dl_close.argtypes = [ctypes.c_void_p]
    return lib


_M64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finalizer on plain ints (mirrors the C++ mix())."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def _feistel_perm_np(i: int, n: int, seed: int) -> int:
    """Python mirror of the C++ permutation of [0, n)."""
    if n <= 1:
        return 0
    bits = 1
    while (1 << bits) < n:
        bits += 1
    half = (bits + 1) // 2
    mask = (1 << half) - 1
    x = i
    while True:
        l, r = x >> half, x & mask
        for rnd in range(4):
            f = _mix64(r ^ _mix64((seed + rnd) & _M64)) & mask
            l, r = r, l ^ f
        x = (l << half) | r
        if x < n:
            return x


class TokenDataset:
    """Fixed-window views over a flat token file, shuffled resumably."""

    def __init__(self, path: str | os.PathLike, seqlen: int,
                 dtype: np.dtype = np.uint16, seed: int = 0,
                 use_native: Optional[bool] = None):
        self.path = str(path)
        self.seqlen = int(seqlen)
        self.dtype = np.dtype(dtype)
        self.seed = int(seed)
        if self.dtype.itemsize not in (2, 4):
            raise ValueError(f"tokens are uint16 or uint32, got {self.dtype}")
        self._handle = None
        lib = _lib() if (use_native is None or use_native) else None
        if lib is not None:
            h = lib.dl_open(self.path.encode(), self.dtype.itemsize,
                            self.seqlen)
            if h:
                self._handle = h
                self._lib = lib
        if self._handle is None:
            if use_native:
                raise RuntimeError("native dataloader unavailable")
            self._tokens = np.memmap(self.path, dtype=self.dtype, mode="r")

    @property
    def num_sequences(self) -> int:
        if self._handle is not None:
            return int(self._lib.dl_num_sequences(self._handle))
        return len(self._tokens) // (self.seqlen + 1)

    def fetch(self, start: int, batch: int, threads: int = 0) -> np.ndarray:
        """Windows at global shuffled indices [start, start + batch):
        (batch, seqlen + 1) int32. A pure function of (seed, start)."""
        out = np.empty((batch, self.seqlen + 1), np.int32)
        if self._handle is not None:
            rc = self._lib.dl_fetch(
                self._handle, self.seed, start, batch,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), threads,
            )
            if rc != 0:
                raise RuntimeError("dl_fetch failed")
            return out
        n = self.num_sequences
        w = self.seqlen + 1
        for b in range(batch):
            epoch, idx = divmod(start + b, n)
            pos = _feistel_perm_np(idx, n, self.seed + 0x51ED2701 * epoch)
            out[b] = self._tokens[pos * w:(pos + 1) * w]
        return out

    def close(self):
        if self._handle is not None:
            self._lib.dl_close(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def build_token_cache(texts, tokenizer, out_path, dtype=np.uint16,
                      append_eos: bool = True) -> str:
    """Tokenize and concatenate into a flat binary cache."""
    eos = getattr(tokenizer, "eos_token_id", None)
    with open(out_path, "wb") as f:
        for text in texts:
            ids = tokenizer(text)["input_ids"] if callable(tokenizer) else \
                tokenizer.encode(text)
            if append_eos and eos is not None:
                ids = list(ids) + [eos]
            np.asarray(ids, dtype=dtype).tofile(f)
    return str(out_path)


@dataclasses.dataclass
class LMDataModule:
    """Batched iterator with exact-resume state: ``step`` batches served."""

    path: str
    seqlen: int
    batch_size: int
    seed: int = 0
    dtype: np.dtype = np.uint16
    step: int = 0

    def __post_init__(self):
        self.dataset = TokenDataset(self.path, self.seqlen, self.dtype,
                                    self.seed)

    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, state: dict):
        if int(state["seed"]) != self.seed:
            raise ValueError("seed mismatch on resume")
        self.step = int(state["step"])

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            batch = self.dataset.fetch(self.step * self.batch_size,
                                       self.batch_size)
            self.step += 1
            yield batch[:, :-1], batch[:, 1:]
