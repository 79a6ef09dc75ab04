"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``collide2d_tpu_torch/csrc/<name>.cu`` compiles with ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface, under
``collide2d_tpu_torch/build/`` (listed in .gitignore); a source may
include the shared ``csrc/*.cuh`` headers. A source specialised to a shape
builds once per shape: ``defines``, ``(name, value)`` pairs, become ``-D``
flags (kernels 7 and 14 take their polygon sizes this way, so their loops
unroll and their table offsets are constants). The file name carries a
hash of the source, the headers, the flags and the defines, so an edited
source or header or another shape builds anew and an unchanged one loads
straight away. The library is written under a
temporary name and published with ``os.replace``, so processes that build
at the same time never load a half-written file. There is no fallback: a
missing ``nvcc`` or a failed build raises. Every kernel's C launcher is
called through `launch`, on its tensors' device and current stream.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

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


Defines = tuple[tuple[str, int], ...]


def define_flags(defines: Defines = ()) -> list[str]:
    """``-DNAME=value`` for each pair of ``defines``."""
    return [f"-D{k}={int(v)}" for k, v in defines]


def library_path(name: str, defines: Defines = ()) -> Path:
    """Where ``csrc/<name>.cu`` builds to: hashed by the source, every
    ``csrc/*.cuh`` header (a source may include any of them), the flags and
    the defines, so an edited header rebuilds every library too and each
    shape has a library of its own."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join([*NVCC_FLAGS, *define_flags(defines)]).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str, defines: Defines = ()) -> Path:
    """Compile ``csrc/<name>.cu`` with ``defines`` unless its hashed
    library exists."""
    src = CSRC_DIR / f"{name}.cu"
    lib = library_path(name, defines)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.tmp{os.getpid()}.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, *define_flags(defines), "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) for {src.name}:\n{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


@functools.cache
def load(name: str, defines: Defines = ()) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library for
    ``defines``, once per process."""
    return ctypes.CDLL(str(build(name, defines)))


def launch(device: torch.device, fn, *args):
    """``fn(*args, stream)``, a C launcher, with ``device`` the current device
    and ``stream`` the raw handle of its current stream. The device is
    switched (and back) only when it is not the current one. Both reads
    are torch's own C calls (``torch._C``), of well under a microsecond,
    where ``torch.cuda.device`` and ``torch.cuda.current_stream`` cost 6-11
    us each on an H100's host: the adaptive driver launches twice a round,
    and a tail round's kernels take a few hundred microseconds."""
    idx = torch.cuda.current_device() if device.index is None else device.index
    if torch._C._cuda_getDevice() == idx:
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    with torch.cuda.device(idx):
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))
