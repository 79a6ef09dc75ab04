"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``collide2d_tpu_torch/csrc/<name>.cu`` compiles with ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface, under
``collide2d_tpu_torch/build/`` (listed in .gitignore); a source may
include the shared ``csrc/*.cuh`` headers. The file name carries a hash of
the source, the headers and the flags, so an edited source or header
rebuilds and an unchanged one loads straight away. The library is written under a
temporary name and published with ``os.replace``, so processes that build
at the same time never load a half-written file. There is no fallback: a
missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC",
)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or
    ``/usr/local/cuda/bin/nvcc``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: hashed by the source, every
    ``csrc/*.cuh`` header (a source may include any of them) and the flags,
    so an edited header rebuilds every library too."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists."""
    src = CSRC_DIR / f"{name}.cu"
    lib = library_path(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.tmp{os.getpid()}.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) for {src.name}:\n{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library, once per
    process."""
    return ctypes.CDLL(str(build(name)))
