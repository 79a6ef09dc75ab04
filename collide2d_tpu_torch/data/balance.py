"""Dataset balancing + label-distribution histogram.

A copy of ``collide2d_tpu/data/balance.py`` (the port imports no module of the JAX
package; tests/test_torch_balance.py pins the copy to the original).

Port of the reference's post-processing script (balance_datasets.py:1-60):
load all numeric batch files (skipping poses*/variance*/checkpoint*),
assign rows to collision-probability bins, truncate every bin to the
global minimum count across two datasets, and plot the cp histogram.
Pure NumPy — runs on host, consumes only the `.npy` artifacts.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

DEFAULT_BALANCE_BINS = np.array([0.0, 0.001, 0.01, 0.1, 1.0], np.float32)


def load_data(data_dir: str | Path) -> np.ndarray:
    """Concatenate all batch `.npy` files in a directory.

    Mirrors balance_datasets.py:6-13: skips files starting with "poses",
    "variance" or "checkpoint".
    """
    data = []
    for data_file in sorted(os.listdir(data_dir)):
        if (
            data_file.endswith(".npy")
            and not data_file.startswith("poses")
            and not data_file.startswith("variance")
            and not data_file.startswith("checkpoint")
        ):
            arr = np.load(Path(data_dir) / data_file)
            # Robustness beyond the reference: non-batch artifacts (e.g. a
            # 1-D ztest --cps_only vector) would crash the concatenate.
            if arr.ndim == 2 and arr.shape[1] == 5:
                data.append(arr)
    if not data:
        raise FileNotFoundError(f"no batch .npy files in {data_dir}")
    return np.concatenate(data)


def compute_bin_idx(y: np.ndarray, accuracy_bins) -> list[np.ndarray]:
    """Boolean row masks per cp bin (balance_datasets.py:15-20).

    Bins are [b_i, b_{i+1}) except the last, which is inclusive on both
    ends — the reference's exact edge convention.
    """
    accuracy_bins = np.asarray(accuracy_bins)
    bins = []
    for i in range(len(accuracy_bins))[0:-2]:
        bins.append((y >= accuracy_bins[i]) & (y < accuracy_bins[i + 1]))
    bins.append((y >= accuracy_bins[-2]) & (y <= accuracy_bins[-1]))
    return bins


def balance(data0, data1, bins0, bins1) -> tuple[np.ndarray, np.ndarray]:
    """Truncate every bin of both datasets to the global min bin count
    (balance_datasets.py:22-29)."""
    min_max0 = np.min([len(data0[b]) for b in bins0])
    min_max1 = np.min([len(data1[b]) for b in bins1])
    min_max = int(np.min([min_max0, min_max1]))
    data0_equal = np.concatenate([data0[b][:min_max] for b in bins0])
    data1_equal = np.concatenate([data1[b][:min_max] for b in bins1])
    return data0_equal, data1_equal


def balance_single(data: np.ndarray, bins) -> np.ndarray:
    """Single-dataset variant (the commented-out alternative at
    balance_datasets.py:31-33)."""
    min_max = int(np.min([len(data[b]) for b in bins]))
    return np.concatenate([data[b][:min_max] for b in bins])


def plot_histogram(data: np.ndarray, accuracy_bins=DEFAULT_BALANCE_BINS,
                   out_path: str | Path = "hist.svg") -> None:
    """cp histogram figure (balance_datasets.py:49-50). Matplotlib is
    imported lazily so environments without it still work."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure()
    plt.hist(data[:, 2], np.asarray(accuracy_bins))
    plt.savefig(str(out_path))
    plt.close()
