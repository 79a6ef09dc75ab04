"""Label-agreement report: the comparison half of the z-test workflow.

A copy of ``collide2d_tpu/data/validate.py`` (the port imports no module of the JAX
package; tests/test_torch_host.py pins the copy to the original).

The reference re-estimates labels at high sample counts (ztest.cu) but
the actual comparison "happens outside the repo" (SURVEY.md §4.2). This
module closes the loop: compare two labelings of the same configurations
and report agreement against the ±0.005 criterion (BASELINE.json) and a
per-configuration z-test.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class AgreementReport:
    n: int
    mean_abs_diff: float
    max_abs_diff: float
    frac_within_tolerance: float
    tolerance: float
    frac_z_ok: float
    z_threshold: float

    def __str__(self) -> str:
        return (
            f"n={self.n}  mean|d|={self.mean_abs_diff:.5f}  "
            f"max|d|={self.max_abs_diff:.5f}  "
            f"within +-{self.tolerance}: {self.frac_within_tolerance:.2%}  "
            f"z<= {self.z_threshold}: {self.frac_z_ok:.2%}"
        )


def _extract_cp(arr: np.ndarray) -> np.ndarray:
    """Accept either (N,5) dataset rows (cp = column 2) or bare (N,) cps."""
    arr = np.asarray(arr)
    if arr.ndim == 2 and arr.shape[1] == 5:
        return arr[:, 2].astype(np.float64)
    if arr.ndim == 1:
        return arr.astype(np.float64)
    raise ValueError(f"expected (N,5) rows or (N,) cps, got {arr.shape}")


def compare_labels(
    a,
    b,
    *,
    n_samples_a: float = 4_000_000,
    n_samples_b: float = 4_000_000,
    tolerance: float = 0.005,
    z_threshold: float = 3.0,
) -> AgreementReport:
    """Agreement between two labelings of the SAME configurations, in the
    same row order (run ztest with shuffle off, the default).

    The z statistic per row uses the pooled binomial standard error at
    the given sample counts; `frac_z_ok` is the fraction of rows whose
    difference is within ``z_threshold`` standard errors (the z-test the
    reference's workflow implies).
    """
    cp_a = _extract_cp(a)
    cp_b = _extract_cp(b)
    if cp_a.shape != cp_b.shape:
        raise ValueError(f"row count mismatch: {cp_a.shape} vs {cp_b.shape}")
    d = np.abs(cp_a - cp_b)
    p_pool = np.clip((cp_a + cp_b) / 2, 0.0, 1.0)
    se = np.sqrt(
        np.maximum(p_pool * (1 - p_pool), 1e-12)
        * (1.0 / n_samples_a + 1.0 / n_samples_b)
    )
    z = d / np.maximum(se, 1e-12)
    return AgreementReport(
        n=len(d),
        mean_abs_diff=float(d.mean()),
        max_abs_diff=float(d.max()),
        frac_within_tolerance=float((d <= tolerance).mean()),
        tolerance=tolerance,
        frac_z_ok=float((z <= z_threshold).mean()),
        z_threshold=z_threshold,
    )
