"""On-disk `.npy` record schemas — field order IS the file format.

A copy of ``collide2d_tpu/data/schemas.py`` (the port imports no module of the JAX
package; tests/test_torch_host.py pins the copy to the original).

The reference's POD structs double as its file schemas via
reinterpret_cast loading (utils.cu:74-105, 217-224); these helpers pin
the same float32 layouts so datasets are file-level interchangeable:

  poses.npy            (P, 3)  [width, height, theta]         `Pose`
  variances.npy        (V, 5)  [x, y, theta, width, height]   `Variance`
  meta/accuracy_bins.npy (n_bins+1,)                           float
  meta/bin_accuracy.npy  (n_bins,)                             float
  batch {i}.npy        (B, 5)  [x, y, cp, var_idx, pose_idx]  `PoseCPVarAndPoseIdx`
  relabel input {i}.npy (N, 4) [x, y, var_idx, pose_idx]      `PositionWithVarAndPoseIdx`
  ztest --cps_only     (N,)    cp                              bare float vector

Index columns are stored as float32 (the reference stores them as float
struct fields), so round-tripping preserves bit-compat.
"""

from __future__ import annotations

import numpy as np

POSE_FIELDS = ("width", "height", "theta")
VARIANCE_FIELDS = ("x", "y", "theta", "width", "height")
DATASET_FIELDS = ("x", "y", "cp", "var_idx", "pose_idx")
RELABEL_INPUT_FIELDS = ("x", "y", "var_idx", "pose_idx")


def _as2d(a: np.ndarray, ncols: int, name: str) -> np.ndarray:
    a = np.asarray(a, np.float32)
    if a.ndim != 2 or a.shape[1] != ncols:
        raise ValueError(f"{name}: expected (N, {ncols}) float32, got {a.shape}")
    return np.ascontiguousarray(a)


def pack_dataset_rows(positions, cp, var_idx, pose_idx) -> np.ndarray:
    """(B, 5) rows in PoseCPVarAndPoseIdx order (utils.cu:96-99)."""
    positions = np.asarray(positions, np.float32)
    return np.stack(
        [
            positions[:, 0],
            positions[:, 1],
            np.asarray(cp, np.float32),
            np.asarray(var_idx, np.float32),
            np.asarray(pose_idx, np.float32),
        ],
        axis=1,
    )


def unpack_dataset_rows(rows: np.ndarray):
    """(B, 5) -> (positions (B,2), cp, var_idx, pose_idx)."""
    rows = _as2d(rows, 5, "dataset rows")
    return rows[:, 0:2], rows[:, 2], rows[:, 3], rows[:, 4]


def unpack_relabel_rows(rows: np.ndarray):
    """(N, 4) PositionWithVarAndPoseIdx -> (positions, var_idx, pose_idx).

    Field order per utils.cu:79-84: x, y, var_idx, pose_idx.
    """
    rows = _as2d(rows, 4, "relabel input rows")
    return rows[:, 0:2], rows[:, 2], rows[:, 3]


def validate_poses(poses: np.ndarray) -> np.ndarray:
    return _as2d(poses, 3, "poses")


def validate_variances(variances: np.ndarray) -> np.ndarray:
    return _as2d(variances, 5, "variances")
