"""Broad phase: AABB overlap, the noise-aware pruning mask, and the
compacted k-gon narrow phase.

Counterpart of ``collide2d_tpu/ops/broad_phase.py``. Same float32
operation order as the JAX functions:

- `candidate_mask` — AABB overlap of polygon pairs, a necessary condition
  for convex overlap, so pruning with it is exact;
- `collide_polygons_pruned` — gather the candidates into a power-of-two
  bucket, run the narrow phase on the bucket only, scatter the labels
  back: bit for bit the unpruned labels. On a CUDA tensor the narrow
  phase is kernel 6 (`ops.polygon_cuda`), unless ``impl='torch'``.
"""

from __future__ import annotations

import torch

from collide2d_tpu_torch.ops import polygon_cuda
from collide2d_tpu_torch.ops.geometry import polygon_aabb
from collide2d_tpu_torch.ops.sat import _normalize_padding, sat_polygons


def aabb_overlap(lo1: torch.Tensor, hi1: torch.Tensor, lo2: torch.Tensor,
                 hi2: torch.Tensor) -> torch.Tensor:
    """Elementwise AABB overlap test. ``lo/hi``: ``B + (2,)``. Bool ``B``.
    Touching boxes overlap (``<=``), as touching rectangles collide."""
    return ((lo1 <= hi2) & (lo2 <= hi1)).all(dim=-1)


def candidate_mask(p1: torch.Tensor, p2: torch.Tensor,
                   mask1: torch.Tensor | None = None,
                   mask2: torch.Tensor | None = None) -> torch.Tensor:
    """Broad-phase candidates of ``B + (k, 2)`` polygon pairs (optional
    vertex masks): bool ``B``, True where the AABBs overlap and the narrow
    phase must run. A superset of the true collisions."""
    lo1, hi1 = polygon_aabb(p1, mask1)
    lo2, hi2 = polygon_aabb(p2, mask2)
    return aabb_overlap(lo1, hi1, lo2, hi2)


def _narrow(p1, p2, mask1, mask2, impl: str) -> torch.Tensor:
    """The k-gon narrow phase: kernel 6's drop-in (its plain version on a
    CPU tensor) or, with ``impl='torch'``, `ops.sat.sat_polygons`."""
    if impl == "torch":
        return sat_polygons(p1, p2, mask1, mask2)
    return polygon_cuda.sat_polygons_cuda(_normalize_padding(p1, mask1),
                                          _normalize_padding(p2, mask2))


def collide_candidates(p1: torch.Tensor, p2: torch.Tensor, cand: torch.Tensor,
                       mask1: torch.Tensor | None = None,
                       mask2: torch.Tensor | None = None, *, bucket: int,
                       impl: str = "cuda") -> torch.Tensor:
    """Narrow phase on a compacted candidate bucket, scattered back: int32
    (N,). Gathers the first ``bucket`` candidates (callers guarantee they
    fit), runs the narrow phase on them, and scatters their labels into a
    zero (N,) output. Fill slots point at row 0 with label 0, and the
    scatter keeps the maximum, so row 0's real label survives. No host
    synchronisation."""
    n = cand.shape[0]
    order = torch.argsort((~cand).to(torch.int8), stable=True)[:bucket]
    slot_valid = torch.arange(bucket, device=cand.device) < cand.sum(dtype=torch.int64)
    idx = torch.where(slot_valid, order, 0)
    sub = _narrow(p1[idx], p2[idx], None if mask1 is None else mask1[idx],
                  None if mask2 is None else mask2[idx], impl)
    sub = torch.where(slot_valid, sub, 0)
    out = torch.zeros((n,), dtype=torch.int32, device=cand.device)
    return out.scatter_reduce(0, idx, sub, reduce="amax")


def collide_polygons_pruned(p1: torch.Tensor, p2: torch.Tensor,
                            mask1: torch.Tensor | None = None,
                            mask2: torch.Tensor | None = None, *,
                            min_bucket: int = 1024,
                            impl: str = "cuda") -> torch.Tensor:
    """AABB broad phase -> compacted narrow phase -> scattered labels:
    int32 (N,), bit for bit the unpruned narrow phase's (AABB-disjoint
    pairs cannot collide, and candidates see identical arithmetic). One
    host readback of the candidate count; when the bucket would hold half
    the pairs or more, the full narrow phase runs instead."""
    n = p1.shape[0]
    cand = candidate_mask(p1, p2, mask1, mask2)
    n_cand = int(cand.sum(dtype=torch.int64))
    bucket = bucket_for(n_cand, n, min_bucket)
    if 2 * bucket >= n:
        return _narrow(p1, p2, mask1, mask2, impl)
    return collide_candidates(p1, p2, cand, mask1, mask2, bucket=bucket, impl=impl)


def possible_collision_mask(configs, robot_wh,
                            sigma_margin: float = 6.0) -> torch.Tensor:
    """Conservative noise-aware broad phase for Monte Carlo configurations.

    True where the robot and the noisy obstacle could touch with every
    Gaussian draw within ``sigma_margin`` standard deviations: the
    circumscribed circles, the obstacle's inflated by the shape noise and
    the centre's reach by the position noise. False implies P(collide) <=
    ~5 * P(|z| > sigma_margin) (~1e-8 at 6), far below every accuracy bin,
    so pruned rows may be labeled cp = 0 without sampling.

    ``configs``: rectangle `Configs` (``robot_wh`` = (2,) width/height) or
    `PolygonConfigs` (``robot_wh`` = (K2, 2) robot vertices; the
    circumscribed radii are the largest vertex norms, exact for rotation
    about the origin, which is how the noise model rotates both bodies).
    Trajectory batches (`mc.moving`, with ``velocity`` and ``t_max``) add
    the distance the robot's centre travels, |v| t_max; rotation about its
    own centre never grows its circumscribed ball. Returns bool (C,) on
    the configs' device."""
    robot = torch.as_tensor(robot_wh, dtype=torch.float32,
                            device=configs.position.device)
    sd = configs.std_dev
    if hasattr(configs, "obstacle_verts"):
        r_rob = torch.hypot(robot[..., 0], robot[..., 1]).amax(dim=-1)
        v = configs.obstacle_verts
        r_obs = torch.hypot(v[..., 0], v[..., 1]).amax(dim=-1)
    else:
        r_rob = 0.5 * torch.hypot(robot[..., 0], robot[..., 1])
        ow = configs.obstacle_wh[:, 0].abs() + sigma_margin * sd[:, 3]
        oh = configs.obstacle_wh[:, 1].abs() + sigma_margin * sd[:, 4]
        r_obs = 0.5 * torch.hypot(ow, oh)
    reach = sigma_margin * torch.hypot(sd[:, 0], sd[:, 1])
    if hasattr(configs, "velocity"):
        reach = reach + (torch.hypot(configs.velocity[:, 0], configs.velocity[:, 1])
                         * configs.t_max.abs())
    dist = torch.hypot(configs.position[:, 0], configs.position[:, 1])
    return dist <= r_rob + r_obs + reach


def bucket_for(count: int, n: int, min_bucket: int = 1024) -> int:
    """Smallest power-of-two bucket >= count (>= min_bucket), capped at n."""
    b = min_bucket
    while b < count:
        b *= 2
    return min(b, n)
