"""ctypes bindings for the native C++ runtime (csrc/collide2d_native.cpp).

A copy of ``collide2d_tpu/utils/native.py``. It builds the same source
on demand with g++, but into the port's own build directory
(``collide2d_tpu_torch/build/``), so the two packages never race on one
library; the library is written under a temporary name and published
with ``os.replace``. It exposes:

- `RefEngine` / `ref_uniform_table`: bit-compatible reproduction of the
  reference's host-side table sampling (std::default_random_engine +
  uniform_real_distribution<float>, generate_dataset.cu:279-330);
- `std_shuffle_perm`: the exact permutation of
  std::shuffle(..., std::default_random_engine(seed))
  (generate_dataset.cu:496);
- `AsyncNpyWriter`: background-thread batch writer so device compute
  overlaps file IO (the overlap the reference lacks, SURVEY.md P3); its
  submits and flushes are ``pipeline/write_submit`` (counting rows) and
  ``pipeline/write_flush`` spans (`utils.profiling.span`).

Everything degrades gracefully: `available()` is False when no compiler
exists, and callers fall back to numpy equivalents (deterministic, but
not bit-identical to libstdc++).
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from collide2d_tpu_torch.utils.profiling import span

_SRC = Path(__file__).resolve().parents[2] / "csrc" / "collide2d_native.cpp"
_LIB = Path(__file__).resolve().parents[1] / "build" / "libcollide2d_native.so"
_BUILD_LOCK = threading.Lock()


def _build() -> Path | None:
    if not _SRC.exists():
        return None
    with _BUILD_LOCK:
        if _LIB.exists() and _LIB.stat().st_mtime >= _SRC.stat().st_mtime:
            return _LIB
        _LIB.parent.mkdir(parents=True, exist_ok=True)
        tmp = _LIB.with_name(f"{_LIB.stem}.tmp{os.getpid()}.so")
        cmd = [
            "g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
            str(_SRC), "-o", str(tmp),
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
        os.replace(tmp, _LIB)
        return _LIB


@functools.cache
def _lib() -> ctypes.CDLL | None:
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    lib.c2_engine_new.restype = ctypes.c_void_p
    lib.c2_engine_new.argtypes = [ctypes.c_uint64, ctypes.c_int]
    lib.c2_engine_free.argtypes = [ctypes.c_void_p]
    lib.c2_uniform_table.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.c2_std_shuffle_perm.argtypes = [
        ctypes.c_int64,
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.c2_writer_new.restype = ctypes.c_void_p
    lib.c2_writer_free.argtypes = [ctypes.c_void_p]
    lib.c2_writer_submit.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32,
    ]
    lib.c2_writer_flush.restype = ctypes.c_int64
    lib.c2_writer_flush.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    return _lib() is not None


class RefEngine:
    """A std::default_random_engine living in the native library."""

    def __init__(self, seed: int | None = None):
        lib = _lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.c2_engine_new(
            ctypes.c_uint64(0 if seed is None else seed),
            ctypes.c_int(1 if seed is None else 0),
        )

    def uniform_table(self, n: int, mins, maxs) -> np.ndarray:
        """(n, dims) float32 table, bit-identical to the reference's loops."""
        mins = np.asarray(mins, np.float32)
        maxs = np.asarray(maxs, np.float32)
        dims = len(mins)
        out = np.empty((n, dims), np.float32)
        self._lib.c2_uniform_table(
            self._h,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_int64(n),
            ctypes.c_int32(dims),
            mins.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            maxs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return out

    def __del__(self):
        try:
            self._lib.c2_engine_free(self._h)
        except Exception:
            pass


def std_shuffle_perm(n: int, seed: int = 0) -> np.ndarray:
    """Permutation of std::shuffle with std::default_random_engine(seed).

    Falls back to numpy's Fisher-Yates (deterministic but not libstdc++-
    bit-identical) when the native library is unavailable.
    """
    lib = _lib()
    if lib is None or n == 0:
        return np.random.default_rng(seed).permutation(n)
    out = np.empty(n, np.int64)
    lib.c2_std_shuffle_perm(
        ctypes.c_int64(n),
        ctypes.c_uint64(seed),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out


class AsyncNpyWriter:
    """Background float32 .npy writer; numpy-synchronous fallback."""

    def __init__(self):
        self._lib = _lib()
        self._h = self._lib.c2_writer_new() if self._lib else None

    def submit(self, path: str | os.PathLike, rows: np.ndarray) -> None:
        with span("pipeline/write_submit", count=len(rows)):
            rows = np.ascontiguousarray(rows, np.float32)
            if self._h is None:
                # Atomic publish (mirrors the native writer): a run killed
                # mid-write must never leave a truncated batch file that
                # --resume would count as complete.
                path = Path(path)
                tmp = path.with_name(path.name + ".tmp")
                with open(tmp, "wb") as f:
                    np.save(f, rows)
                os.replace(tmp, path)
                return
            shape = np.asarray(rows.shape, np.int64)
            self._lib.c2_writer_submit(
                self._h,
                str(path).encode(),
                rows.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                shape.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                ctypes.c_int32(rows.ndim),
            )

    def flush(self) -> int:
        """Drain the queue; returns the number of failed writes."""
        if self._h is None:
            return 0
        with span("pipeline/write_flush"):
            return int(self._lib.c2_writer_flush(self._h))

    def close(self) -> None:
        if self._h is not None:
            self.flush()
            self._lib.c2_writer_free(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
