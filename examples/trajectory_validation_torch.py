"""Trajectory validation under uncertainty on PyTorch — continuous
collision + Monte Carlo, end to end.

Runs on the card by default (the time-of-impact kernel, and the fused
trajectory Monte Carlo kernels or the rotating cascade's screen kernel
under the adaptive labeler); ``--device cpu`` runs on the host:

    python examples/trajectory_validation_torch.py [--device cpu]

The PyTorch counterpart of ``examples/trajectory_validation.py``. A planner
wants to drive the reference's 4.07 x 1.74 robot along a straight edge past
an obstacle whose pose is only known up to Gaussian noise. Three tools,
layered:

1. deterministic time of impact (`model.time_of_impact`) — WHEN a given
   motion first hits a given obstacle (conservative advancement over the
   signed distance);
2. trajectory collision probability (`MovingConfigs` +
   `model.trajectory_probability`) — P(the motion collides) under the
   dataset noise model, fixed sample budget;
3. adaptive labeling (`model.label`) — the same probability driven to the
   reference's per-bin CI accuracy targets, with motion-aware 6-sigma
   pruning skipping edges that provably cannot collide.
"""

import argparse

import numpy as np
import torch

from collide2d_tpu_torch import (
    AdaptiveConfig,
    CollisionProbabilityModel,
    PolygonCollisionProbabilityModel,
    example_polygon_configs,
    moving_configs,
    moving_polygon_configs,
)
from collide2d_tpu_torch.mc import prng


def device_arg(device: str) -> torch.device:
    """The card unless ``cpu`` is asked for; a card that is not there raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the examples run on the card by default and no CUDA device "
                           "is available; pass --device cpu to run them on the host")
    return dev


def main(device: str = "cuda", n_samples: int = 20_000, edges: int = 256,
         max_samples: int = 200_000, kgon_rows: int = 64,
         kgon_max_samples: int = 50_000) -> dict:
    dev = device_arg(device)
    model = CollisionProbabilityModel(robot_wh=(4.07, 1.74))
    key = prng.PRNGKey(0)

    # --- 1. deterministic continuous collision ----------------------------
    # Robot starts at x = 10 heading toward a 2 x 2 obstacle at the origin
    # at unit speed, three lateral offsets: head-on, grazing lane, clear lane.
    starts = torch.tensor([[10.0, 0.0], [10.0, 1.6], [10.0, 6.0]], device=dev)
    vel = torch.tensor([[-1.0, 0.0]] * 3, device=dev)
    toi = model.time_of_impact(starts, torch.zeros(3, device=dev),
                               torch.tensor([2.0, 2.0], device=dev), vel, t_max=20.0,
                               impl="auto")
    print("time of impact:", toi.cpu().numpy())  # ~[6.965 6.965 inf]

    # --- 2. probability the motion collides, under pose noise -------------
    # Same three edges, but the obstacle pose wobbles (sigma 0.15 in x/y,
    # 0.1 rad). The grazing lane turns from "hits late" into "hits with
    # some probability"; the clear lane stays safe.
    cfgs = moving_configs(
        position=starts,
        pose_theta=0.0,
        obstacle_wh=np.array([2.0, 2.0], np.float32),
        std_dev=np.array([0.15, 0.15, 0.1, 0.0, 0.0], np.float32),
        velocity=vel,
        omega=0.0,
        t_max=8.0,  # the edge ends BEFORE the nominal 6.965 impact...
    )
    cp_fixed = model.trajectory_probability(key, cfgs, n_samples=n_samples)
    print("P(collide within t_max=8):", cp_fixed.cpu().numpy())

    # --- 3. adaptive labels with motion-aware pruning ---------------------
    # Label a batch of candidate edges to CI accuracy; edges whose motion
    # cannot reach the obstacle within 6 sigma are emitted cp=0 unsampled.
    rng = np.random.default_rng(7)
    pos = rng.uniform(-12, 12, (edges, 2)).astype(np.float32)
    vel_e = rng.uniform(-1, 1, (edges, 2)).astype(np.float32)
    batch = moving_configs(
        pos, 0.0, np.array([2.0, 2.0], np.float32),
        np.array([0.15, 0.15, 0.1, 0.0, 0.0], np.float32),
        vel_e, 0.0, 4.0, device=dev,
    )
    cfg = AdaptiveConfig(max_samples=max_samples, prune_sigma=6.0,
                         bin_accuracy=(0.005, 0.005, 0.01))
    cp, n_used, done = model.label(key, batch, cfg)
    pruned = int((n_used == 0).sum())
    print(f"labeled {edges} edges: {done.mean():.0%} converged, {pruned} pruned "
          f"without sampling, mean P(collide) {cp.mean():.3f}")

    # --- 4. the same, with convex k-gon shapes ----------------------------
    # Trajectories are not rectangle-only: `MovingPolygonConfigs` runs a
    # k-gon robot past k-gon obstacles through the same adaptive machinery
    # (pose noise (x, y, theta); rotating rows take the screened cascade).
    hexes = example_polygon_configs(n=kgon_rows, k=6, seed=3, device=dev)
    pbatch = moving_polygon_configs(
        hexes.position, hexes.pose_theta, hexes.obstacle_verts, hexes.std_dev,
        velocity=rng.uniform(-1, 1, (kgon_rows, 2)).astype(np.float32),
        omega=0.3, t_max=2.0,
    )
    pmodel = PolygonCollisionProbabilityModel(
        np.array([[-2.035, -0.87], [2.035, -0.87],
                  [2.035, 0.87], [-2.035, 0.87]], np.float32))
    cp_p, _, done_p = pmodel.label(
        key, pbatch, AdaptiveConfig(max_samples=kgon_max_samples, ca_iters=32,
                                    bin_accuracy=(0.01, 0.01, 0.02)))
    print(f"k-gon trajectories: {done_p.mean():.0%} converged, "
          f"mean P(collide) {cp_p.mean():.3f}")
    return dict(toi=toi.cpu().numpy(), cp_fixed=cp_fixed.cpu().numpy(),
                cp=np.asarray(cp), n_used=np.asarray(n_used), converged=np.asarray(done),
                pruned=pruned, cp_kgon=np.asarray(cp_p), converged_kgon=np.asarray(done_p))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=parser.parse_args().device)
