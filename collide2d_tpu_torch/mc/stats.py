"""Adaptive-stop statistics: Wald CI slack and accuracy-bin lookup.

Counterpart of ``collide2d_tpu/mc/stats.py`` (the reference's `calcSlack`
and `getBin`, utils.cu:186-207). Everything is float32 in the same
operation order as the JAX package — k^2 included, which the reference
computes in int32 and overflows past k = 46340 — so the done flags agree
bitwise. Constants enter as float32 tensors made with ``full_like``:
``python_float / tensor`` would run as a reciprocal-multiply in torch and
round differently, and a tensor built from a Python value on a GPU would
cost a blocking host-to-device copy in every round.
"""

from __future__ import annotations

import numpy as np
import torch

from collide2d_tpu_torch.mc.prng import sqrt_rn

# Reference constants (utils.cu:188-189).
Z_SCORE = 1.96
ALPHA = 0.025
_LOG_INV_ALPHA = float(np.log(1.0 / ALPHA))  # ln(40), rule-of-three numerator


def _f32(x: float) -> float:
    """A Python number rounded to float32 (the JAX package's constants)."""
    return float(np.float32(x))


def _pair_f32(n_samples, n_true) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, k) as float32 tensors; a Python number takes the other's shape
    and device."""
    if isinstance(n_true, torch.Tensor):
        k = n_true.to(torch.float32)
        n = (n_samples.to(torch.float32) if isinstance(n_samples, torch.Tensor)
             else torch.full_like(k, _f32(n_samples)))
    else:
        n = n_samples.to(torch.float32)
        k = torch.full_like(n, _f32(n_true))
    return n, k


def calc_slack(n_samples, n_true) -> torch.Tensor:
    """Wald half-width z/n * sqrt(k - k^2/n), or the rule-of-three bound
    ln(1/alpha)/n when k == 0 or k == n. Float32, broadcasting."""
    n, k = _pair_f32(n_samples, n_true)
    degenerate = (k == n) | (k == 0)
    rule_of_three = torch.full_like(n, _f32(_LOG_INV_ALPHA)) / n
    wald = torch.full_like(n, _f32(Z_SCORE)) / n * sqrt_rn(
        torch.clamp(k - k * k / n, min=0.0)
    )
    return torch.where(degenerate, rule_of_three, wald)


def get_bin(p: torch.Tensor, accuracy_bins) -> torch.Tensor:
    """LAST i with bins[i] <= p <= bins[i+1] (inclusive both ends, as the
    reference's last-match-wins scan); 0 when nothing matches. int64."""
    p = p.to(torch.float32)
    bins = [_f32(b) for b in accuracy_bins]
    last = torch.zeros_like(p, dtype=torch.int64)
    for i in range(len(bins) - 1):
        last = torch.where((p >= bins[i]) & (p <= bins[i + 1]), i, last)
    return last


def is_converged(n_samples, n_true, accuracy_bins, bin_accuracy) -> torch.Tensor:
    """Done flag: calc_slack(n, k) <= bin_accuracy[get_bin(k/n)]
    (generate_dataset.cu:243-252)."""
    n, k = _pair_f32(n_samples, n_true)
    slack = calc_slack(n, k)
    b = get_bin(k / n, accuracy_bins)
    target = torch.full_like(slack, _f32(bin_accuracy[0]))
    for i in range(1, len(bin_accuracy)):
        target = torch.where(b == i, _f32(bin_accuracy[i]), target)
    return slack <= target
