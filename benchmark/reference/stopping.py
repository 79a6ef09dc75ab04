"""The labels' stopping rule, in float64 (generate_dataset.cu:243-252 with
utils.cu:186-207): a row is done once the half-width of its 95% interval,
z / n * sqrt(k - k^2 / n) with z = 1.96 (or the rule of three, ln(40) / n,
when k is 0 or n), is at most the accuracy of its bin. The bin of p is the
last i with bins[i] <= p <= bins[i + 1]."""

from __future__ import annotations

import math

import numpy as np

Z_SCORE = 1.96
RULE_OF_THREE = math.log(40.0)
# Room for the float32 rounding of the labeler's own test of the rule.
RULE_ROOM = 1e-5


def slack(n, k) -> np.ndarray:
    n = np.asarray(n, np.float64)
    k = np.asarray(k, np.float64)
    safe = np.maximum(n, 1.0)
    wald = Z_SCORE / safe * np.sqrt(np.maximum(k - k * k / safe, 0.0))
    return np.where((k == 0) | (k == n), RULE_OF_THREE / safe, wald)


def bin_accuracy(p, accuracy_bins, bin_accuracy_) -> np.ndarray:
    """The accuracy target of each p's bin (bin 0 where none matches)."""
    p = np.asarray(p, np.float64)
    idx = np.zeros(p.shape, np.int64)
    for i in range(len(accuracy_bins) - 1):
        idx = np.where((p >= accuracy_bins[i]) & (p <= accuracy_bins[i + 1]), i, idx)
    return np.asarray(bin_accuracy_, np.float64)[idx]


def meets_rule(n, k, accuracy_bins, bin_accuracy_) -> np.ndarray:
    """True where (n samples, k hits) satisfies the stopping rule."""
    n = np.asarray(n, np.float64)
    p = np.asarray(k, np.float64) / np.maximum(n, 1.0)
    target = bin_accuracy(p, accuracy_bins, bin_accuracy_)
    return (n > 0) & (slack(n, k) <= target * (1.0 + RULE_ROOM))
