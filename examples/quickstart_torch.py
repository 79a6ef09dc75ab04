"""collide2d_tpu_torch quickstart — the public API in one file, on PyTorch.

Runs on the card by default; ``--device cpu`` runs the kernels' plain
PyTorch versions on the host instead:

    python examples/quickstart_torch.py [--device cpu]

The PyTorch counterpart of ``examples/quickstart.py``: deterministic SAT
labels, fixed-budget Monte Carlo probabilities, adaptive labeling to the
reference's per-bin CI targets, broad-phase pruning, and multi-card
sharding. The dataset pipeline (generate/relabel/ztest/balance/show/train)
is the ``collide2d-torch`` CLI — see README.
"""

import argparse

import numpy as np
import torch

from collide2d_tpu_torch import (
    AdaptiveConfig,
    CollisionProbabilityModel,
    adaptive_collision_probabilities,
    collision_probability_pruned,
    rects_from_params,
    sat_polygons,
    sat_rects,
)
from collide2d_tpu_torch.mc import prng
from collide2d_tpu_torch.mc.estimator import Configs


def device_arg(device: str) -> torch.device:
    """The examples' device: the card unless ``cpu`` is asked for; a card
    that is not there raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the examples run on the card by default and no CUDA device "
                           "is available; pass --device cpu to run them on the host")
    return dev


def main(device: str = "cuda", max_samples: int = 200_000, n_samples: int = 10_000) -> dict:
    dev = device_arg(device)

    # --- deterministic narrow phase ---------------------------------------
    # Rectangles as (center, width/height, angle); the reference's 4.07 x
    # 1.74 robot vs a 2 x 3 obstacle at the origin (generate_dataset.cu:60-61).
    model = CollisionProbabilityModel(robot_wh=(4.07, 1.74))
    positions = torch.tensor([[0.0, 0.0], [1.5, 0.5], [8.0, 8.0]], device=dev)
    thetas = torch.tensor([0.0, 0.7, 0.3], device=dev)
    obstacle_wh = torch.tensor([2.0, 3.0], device=dev).expand(3, 2)
    labels = model.collide(positions, thetas, obstacle_wh)
    print("SAT labels:", labels.cpu().numpy())  # [1 1 0]

    # Raw vertex-level SAT over arbitrary batches (utils.cu:159-184
    # semantics: touching collides, fixed runtime, no early exit):
    robot_wh = torch.tensor(model.robot_wh, device=dev).expand(3, 2)
    r1 = rects_from_params(positions, robot_wh, thetas)
    r2 = rects_from_params(torch.zeros(3, 2, device=dev), obstacle_wh,
                           torch.zeros(3, device=dev))
    assert torch.equal(sat_rects(r1, r2), labels)

    # Convex k-gons with true perpendicular normals (the extension the
    # reference README names but never implements):
    tri = torch.tensor([[[0, 0], [2, 0], [1, 2]]], dtype=torch.float32, device=dev)
    hexa = torch.tensor(
        [[[1.5, 0.5], [2.5, 0.5], [3.0, 1.4], [2.5, 2.3], [1.5, 2.3], [1.0, 1.4]]],
        device=dev)
    kgon_label = int(sat_polygons(tri, hexa)[0])
    print("k-gon label:", kgon_label)

    # --- Monte Carlo under Gaussian pose/shape noise -----------------------
    cfgs = Configs(
        position=positions,
        pose_theta=thetas,
        obstacle_wh=obstacle_wh.contiguous(),
        std_dev=torch.full((3, 5), 0.2, device=dev),  # sigma x,y,theta,w,h
    )
    key = prng.PRNGKey(0)
    cp_fixed = model.forward(key, cfgs, n_samples=n_samples)  # fixed budget
    print(f"MC cp @{n_samples}:", np.round(cp_fixed.cpu().numpy(), 3))

    # Adaptive labeling to the reference's per-bin CI targets
    # (generate_dataset.cu:58-59; stops each row as soon as its Wald /
    # rule-of-three half-width is under its bin's target; on the card the
    # fused Monte Carlo kernel draws the samples):
    cp, n_used, converged = adaptive_collision_probabilities(
        key, cfgs, model.robot_wh,
        AdaptiveConfig(max_samples=max_samples, schedule="tuned"),
    )
    print("adaptive cp:", np.round(cp, 4), "samples used:", n_used)

    # Broad-phase pruning: rows that cannot touch within 6 sigma are
    # labeled 0 without sampling (row 2 here):
    cp_pruned = collision_probability_pruned(key, cfgs, model.robot_wh, n_samples)
    print("pruned cp:", np.round(cp_pruned, 3))

    # --- multi-card ---------------------------------------------------------
    # Shard the config axis (data parallel) and/or the per-config sample
    # budget across a mesh; both axes leave the labels bit-identical. On a
    # host with several cards:
    #
    #   from collide2d_tpu_torch.parallel import make_mesh
    #   mesh = make_mesh(sample_axis=2)  # every visible card
    #   cp, n, ok = adaptive_collision_probabilities(
    #       key, cfgs, model.robot_wh, AdaptiveConfig(), mesh=mesh)
    #
    # Several hosts: see collide2d_tpu_torch.parallel.distributed.
    print("ok")
    return dict(labels=labels.cpu().numpy(), kgon_label=kgon_label,
                cp_fixed=cp_fixed.cpu().numpy(), cp_adaptive=np.asarray(cp),
                n_used=np.asarray(n_used), converged=np.asarray(converged),
                cp_pruned=np.asarray(cp_pruned))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=parser.parse_args().device)
