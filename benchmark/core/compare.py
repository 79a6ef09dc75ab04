"""The comparison that decides ``correct``.

The timed path's labels, gathered by the cell's entry into `Labeled`, are
held to the guarantees the configuration states:

- ``rows_bad`` (exact, limit 0): rows missing from or malformed in what
  was written (the entry's count), plus labeled rows whose cp is not a
  count over its sample number (k / n for a whole k), lies outside
  [0, 1] or whose sample number is not in [1, cap].
- ``stop_faults`` (exact, limit 0): rows marked converged whose (n, k)
  fail the stopping rule, and rows that stopped short of the cap without
  meeting it (`reference.stopping`).
- ``miss_share``: of the compared rows whose label or exact probability
  is not certain (above 1e-6 and below 1 - 1e-6), the share whose label is
  farther from the exact probability than its bin's accuracy target.
- ``z2_mean``: over the compared rows whose exact p lies in
  [1e-4, 1 - 1e-4], the mean of z^2, z = (cp - p) / sqrt(p (1 - p) / n):
  about 1 for labels that are as accurate as their sample counts say.

The compared rows are the ``top_rows`` rows with the most samples and a
uniform draw from the seed, ``sample_rows`` in all; their exact
probabilities come from `reference.exact`, which works them out again from
the configurations the benchmark made.

A row's robot is the configuration's fixed robot (``robot_verts`` of
shape (K2, 2)), or, where the entry gives one per row ((N, K2', 2)), a
convex polygon of its own: for a robot that translates over [0, t_max]
the region it sweeps (`reference.exact.swept_robot`), so that the label is
judged as the probability that the motion collides and not as that of its
start.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from benchmark.gen.rows import sub_seed
from benchmark.reference import exact, stopping

CERTAIN = 1e-6
Z_BAND = 1e-4


@dataclass
class Labeled:
    """Every labeled row of a window, in one order."""

    cp: np.ndarray              # (N,)
    n: np.ndarray               # (N,) samples behind each label
    converged: np.ndarray       # (N,)
    rows_bad: int               # rows missing or malformed, found by the entry
    # (K2, 2), or (N, K2', 2) a robot per row (convex, CCW, robot frame)
    robot_verts: np.ndarray
    # rows -> (position (R, 2), robot_theta (R,), obstacle_verts (R, K, 2),
    # sd (R, 3) sigmas of x, y, theta), from the benchmark's own inputs
    geometry: Callable


def rows_bad(lab: Labeled, max_samples: int) -> int:
    cp = lab.cp.astype(np.float64)
    n = lab.n.astype(np.float64)
    kf = cp * n
    bad = (~np.isfinite(cp) | (cp < 0) | (cp > 1) | (n < 1) | (n > max_samples)
           | (np.abs(kf - np.round(kf)) > 0.25))
    return int(lab.rows_bad + bad.sum())


def stop_faults(lab: Labeled, bins, accuracy, max_samples: int) -> int:
    k = np.round(lab.cp.astype(np.float64) * lab.n)
    ok = stopping.meets_rule(lab.n, k, bins, accuracy)
    claimed = lab.converged.astype(bool)
    return int((claimed & ~ok).sum() + (~claimed & (lab.n < max_samples)).sum())


def sample(lab: Labeled, seed: int, sample_rows: int, top_rows: int) -> np.ndarray:
    """Row indices compared: the most-sampled rows and a seeded draw."""
    total = len(lab.cp)
    rng = np.random.default_rng(sub_seed(seed, "compare"))
    order = rng.permutation(total)
    top = order[np.argsort(-lab.n[order], kind="stable")[:top_rows]]
    rest = order[~np.isin(order, top)][: sample_rows - len(top)]
    return np.sort(np.concatenate([top, rest]))


def label_stats(cp, n, p, bins, accuracy) -> tuple[float, float]:
    """(miss_share, z2_mean) of labels ``cp`` over ``n`` samples against
    exact probabilities ``p``."""
    cp = np.asarray(cp, np.float64)
    uncertain = (np.maximum(p, cp) > CERTAIN) & (np.minimum(p, cp) < 1 - CERTAIN)
    miss = np.abs(cp - p) > stopping.bin_accuracy(cp, bins, accuracy)
    miss_share = float(miss[uncertain].mean()) if uncertain.any() else 0.0
    band = (p >= Z_BAND) & (p <= 1 - Z_BAND)
    z2 = (cp - p)[band] ** 2 / (p[band] * (1 - p[band]) / n[band])
    return miss_share, (float(z2.mean()) if z2.size else 0.0)


def compare(lab: Labeled, config: dict, seed: int, sample_rows: int,
            top_rows: int) -> dict[str, float]:
    bins, accuracy = config["accuracy_bins"], config["bin_accuracy"]
    cap = config["max_samples"]
    out = {"rows_bad": rows_bad(lab, cap),
           "stop_faults": stop_faults(lab, bins, accuracy, cap)}
    idx = sample(lab, seed, sample_rows, top_rows)
    position, robot_theta, obstacle, sd = lab.geometry(idx)
    robot = lab.robot_verts if np.ndim(lab.robot_verts) == 2 else lab.robot_verts[idx]
    p = exact.collision_probability(position, robot_theta, robot, obstacle, sd)
    out["miss_share"], out["z2_mean"] = label_stats(
        lab.cp[idx], lab.n[idx], p, bins, accuracy)
    out["rows_compared"] = int(len(idx))
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and each compared number beside its limit."""
    checks = {name: {"value": numbers[name], "limit": limit}
              for name, limit in limits.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
