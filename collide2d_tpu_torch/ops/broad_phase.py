"""Broad phase: AABB overlap and the noise-aware pruning mask.

Counterpart of ``collide2d_tpu/ops/broad_phase.py`` for rectangle
configurations (the k-gon and trajectory branches of
`possible_collision_mask` and the compacted polygon narrow phase come
with their slices). Same float32 operation order as the JAX functions.
"""

from __future__ import annotations

import torch


def aabb_overlap(lo1: torch.Tensor, hi1: torch.Tensor, lo2: torch.Tensor,
                 hi2: torch.Tensor) -> torch.Tensor:
    """Elementwise AABB overlap test. ``lo/hi``: ``B + (2,)``. Bool ``B``.
    Touching boxes overlap (``<=``), as touching rectangles collide."""
    return ((lo1 <= hi2) & (lo2 <= hi1)).all(dim=-1)


def possible_collision_mask(configs, robot_wh,
                            sigma_margin: float = 6.0) -> torch.Tensor:
    """Conservative noise-aware broad phase for rectangle `Configs`.

    True where the robot and the noisy obstacle could touch with every
    Gaussian draw within ``sigma_margin`` standard deviations: the
    circumscribed circles, the obstacle's inflated by the shape noise and
    the centre's reach by the position noise. False implies P(collide) <=
    ~5 * P(|z| > sigma_margin) (~1e-8 at 6), far below every accuracy bin,
    so pruned rows may be labeled cp = 0 without sampling. ``robot_wh``:
    (2,) width/height. Returns bool (C,) on the configs' device."""
    robot = torch.as_tensor(robot_wh, dtype=torch.float32,
                            device=configs.position.device)
    sd = configs.std_dev
    r_rob = 0.5 * torch.hypot(robot[..., 0], robot[..., 1])
    ow = configs.obstacle_wh[:, 0].abs() + sigma_margin * sd[:, 3]
    oh = configs.obstacle_wh[:, 1].abs() + sigma_margin * sd[:, 4]
    r_obs = 0.5 * torch.hypot(ow, oh)
    reach = sigma_margin * torch.hypot(sd[:, 0], sd[:, 1])
    dist = torch.hypot(configs.position[:, 0], configs.position[:, 1])
    return dist <= r_rob + r_obs + reach


def bucket_for(count: int, n: int, min_bucket: int = 1024) -> int:
    """Smallest power-of-two bucket >= count (>= min_bucket), capped at n."""
    b = min_bucket
    while b < count:
        b *= 2
    return min(b, n)
