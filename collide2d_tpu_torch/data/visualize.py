"""Visualization of labeled datasets: cp(x, y) contour slices.

A copy of ``collide2d_tpu/data/visualize.py`` (the port imports no module of the JAX
package; tests/test_torch_balance.py pins the copy to the original).

Port of show_data.ipynb (cell 0): select the rows of one
(var_idx, pose_idx) pair and contour-plot the collision-probability
field via cubic interpolation on a 100x100 grid.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def get_data_for_specific_var_and_pos(data: np.ndarray, var_idx, pos_idx):
    """Rows matching one (var_idx, pose_idx) pair -> (x, y, cp) columns.

    Mirrors the notebook's selector: column 3 is var_idx, column 4 is
    pose_idx (schema #10).
    """
    sel = (data[:, 3] == var_idx) & (data[:, 4] == pos_idx)
    return data[sel][:, :3].T


def get_data_for_specific_var(data: np.ndarray, var_idx):
    return data[data[:, 3] == var_idx][:, :3].T


def plot_contour(x, y, z, out_path: str | Path = "contour.png"):
    """Cubic-interpolated contour plot of cp over robot positions
    (show_data.ipynb `plot_contour`). scipy/matplotlib imported lazily."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from scipy.interpolate import griddata

    xi = np.linspace(min(x), max(x), 100)
    yi = np.linspace(min(y), max(y), 100)
    XI, YI = np.meshgrid(xi, yi)
    zi = griddata((x, y), z, (XI, YI), method="cubic")

    fig, ax = plt.subplots(figsize=(20, 20))
    c = ax.contourf(XI, YI, zi)
    fig.colorbar(c)
    ax.set_xlabel("X")
    ax.set_ylabel("Y")
    ax.set_aspect(1)
    fig.savefig(str(out_path))
    plt.close(fig)
    return out_path
