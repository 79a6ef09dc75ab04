"""npy artifact IO + filesystem helpers (reference L0, utils.cu:18-56,217-224).

A copy of ``collide2d_tpu/utils/io_npy.py`` (the port imports no module of the JAX
package; tests/test_torch_host.py pins the copy to the original).

The `.npy` files ARE the framework's checkpoint/resume mechanism, exactly
as in the reference (SURVEY.md §5): pose/variance tables are re-feedable,
batch files are numbered and appendable, and `get_num_batches_in_dir`
implements the numeric-filename resume trick of utils.cu:36-56 that
compute_collision_probability.cu:157 uses to append output numbering
after existing batches.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np


def mkdirs(path: str | Path) -> Path:
    """Create a directory tree if absent (utils.cu:30-34)."""
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    return p


def get_num_batches_in_dir(directory: str | Path) -> int:
    """Count `.npy` files with PURELY NUMERIC stems in a directory.

    Mirrors utils.cu:36-56: files whose stem fails integer parsing
    (poses.npy, variances.npy, checkpoint*.npy, ...) are skipped, so the
    count is the number of batch files and doubles as the next batch
    index for append-style resume.
    """
    count = 0
    directory = Path(directory)
    if not directory.is_dir():
        return 0
    for entry in directory.iterdir():
        if entry.is_file() and entry.suffix == ".npy":
            try:
                int(entry.stem)
            except ValueError:
                continue
            count += 1
    return count


def save_npy(path: str | Path, array: np.ndarray) -> None:
    """Save an array atomically; parents are created on demand.

    Write-to-temp + rename so an interrupted run never leaves a truncated
    artifact that `get_num_batches_in_dir` / --resume would count as
    complete (same publish pattern as the native async writer and the
    estimator's checkpoint.npz). The temp name carries the PID: in a
    multi-process generate every process publishes the SAME shared
    tables (poses/variances/meta, identical bytes from the shared seed),
    and a shared temp name let one process's rename steal the other's
    file out from under its own os.replace (FileNotFoundError race seen
    in tests/test_multihost.py).
    """
    path = Path(path)
    mkdirs(path.parent)
    tmp = path.with_name(f"{path.name}.tmp.{os.getpid()}")
    with open(tmp, "wb") as f:
        np.save(f, np.ascontiguousarray(array))
    os.replace(tmp, path)


def load_npy(path: str | Path) -> np.ndarray:
    return np.load(Path(path))


def batch_path(directory: str | Path, index: int) -> Path:
    """The `{i}.npy` batch-file naming scheme (generate_dataset.cu:500)."""
    return Path(directory) / f"{index}.npy"
