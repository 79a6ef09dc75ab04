"""`mc.schedule_sim.stopping_counts` against the driver's own counts.

chip_smoke.py phase 4 predicts the agreement of two independent labelings
from each row's sample count, which neither the batch files nor ``ztest
--cps_only`` keep: it recovers them from the labels and the stopping rule.
Here the driver runs on the CPU (kernel 1's plain version, the card's
round plan) and reports its counts: the recovered ones are never above
them (the driver's count is always a candidate) and equal them on at
least 95% of rows, for generate's cadence and for a fixed per-round budget
as ztest's.
"""

import numpy as np
import pytest
import torch

from collide2d_tpu_torch import example_configs
from collide2d_tpu_torch.mc import prng
from collide2d_tpu_torch.mc.driver import adaptive_collision_probabilities
from collide2d_tpu_torch.mc.estimator import AdaptiveConfig
from collide2d_tpu_torch.mc.schedule_sim import stopping_counts

torch.set_num_threads(1)


@pytest.mark.parametrize("fixed_batch", [None, 4000])
def test_recovered_counts_match_the_driver(fixed_batch):
    cfg = AdaptiveConfig(max_samples=40_000, fixed_batch=fixed_batch, impl="cuda")
    cp, n_used, _ = adaptive_collision_probabilities(
        prng.PRNGKey(5), example_configs(256, seed=3, device="cpu"), (4.07, 1.74), cfg)
    got = stopping_counts(cp, cfg)
    assert (got <= n_used).all()
    assert (got == n_used).mean() >= 0.95
    assert 0.2 < (cp == 0).mean() < 0.9 and len(np.unique(n_used)) >= 3
