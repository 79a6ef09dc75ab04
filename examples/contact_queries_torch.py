"""The contact-query stack in one file, on PyTorch: boolean SAT -> signed
distance -> witness points -> contact manifolds -> time of impact -> scene
queries -> ray casting.

Runs on the card by default (each query that has a kernel runs it there);
``--device cpu`` runs the kernels' plain PyTorch versions on the host:

    python examples/contact_queries_torch.py [--device cpu]

The PyTorch counterpart of ``examples/contact_queries.py``. Every query is
batched and fixed-shape. The boolean label is the only query the CUDA
reference has (utils.cu:159-184); everything after it is surface a planner
or contact solver consumes on top of the same geometry.
"""

import argparse

import numpy as np
import torch

from collide2d_tpu_torch import (
    CollisionProbabilityModel,
    polygon_contact_manifold,
    rect_time_of_impact,
    scene_collision_matrix,
    scene_contact_manifolds,
    scene_raycast,
)


def device_arg(device: str) -> torch.device:
    """The card unless ``cpu`` is asked for; a card that is not there raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the examples run on the card by default and no CUDA device "
                           "is available; pass --device cpu to run them on the host")
    return dev


def hexagon_scene(n: int, seed: int = 0) -> np.ndarray:
    """``n`` unit-ish hexagons scattered in an 8 x 8 box: (n, 6, 2) float32
    (the JAX example's scene)."""
    rng = np.random.default_rng(seed)
    angles = np.linspace(0, 2 * np.pi, 7)[:6]
    return np.stack([
        (0.8 * np.stack([np.cos(angles + r), np.sin(angles + r)], -1)
         + rng.uniform(-4, 4, 2)).astype(np.float32)
        for r in rng.uniform(0, 1, n)
    ])


def main(device: str = "cuda", scene_shapes: int = 32) -> dict:
    dev = device_arg(device)
    model = CollisionProbabilityModel(robot_wh=(4.07, 1.74))
    positions = torch.tensor([[0.5, 0.2], [3.5, 0.0], [9.0, 9.0]], device=dev)
    thetas = torch.tensor([0.3, 0.0, 1.0], device=dev)
    obstacle_wh = torch.tensor([2.0, 3.0], device=dev)

    # 1. Boolean narrow phase + how-far (signed distance: negative = depth).
    labels = model.collide(positions, thetas, obstacle_wh)
    dist = model.distance(positions, thetas, obstacle_wh, impl="auto")
    print("labels:", labels.cpu().numpy(), " signed distance:", dist.cpu().numpy())

    # 2. Witness points and the full contact manifold (up to 2 points).
    d, pa, pb, normal = model.closest_points(positions, thetas, obstacle_wh)
    count, points, depths, nrm = model.contact_manifold(positions, thetas, obstacle_wh)
    for i in range(3):
        c = int(count[i])
        print(f"config {i}: {c} contact point(s)",
              points[i][:c].cpu().numpy().round(3).tolist(),
              "depths", depths[i][:c].cpu().numpy().round(3).tolist())

    # 3. WHEN does a motion first hit: conservative advancement over the
    #    signed distance (translation and rotation); the model's
    #    `time_of_impact` runs the time-of-impact kernel on the card.
    robot_wh = torch.tensor(model.robot_wh, device=dev).expand(3, 2)
    zeros2 = torch.zeros((3, 2), device=dev)
    toi = rect_time_of_impact(
        positions, robot_wh, thetas,
        torch.tensor([[-0.5, 0.0], [-2.0, 0.0], [-4.0, -4.0]], device=dev),
        torch.tensor([0.0, 0.3, 0.0], device=dev),          # robot spins in #1
        zeros2, obstacle_wh.expand(3, 2), torch.zeros(3, device=dev), zeros2,
        torch.zeros(3, device=dev), t_max=2.0,
    )
    print("time of impact:", toi.cpu().numpy().round(4))
    toi_model = model.time_of_impact(
        positions, thetas, obstacle_wh,
        torch.tensor([[-0.5, 0.0], [-2.0, 0.0], [-4.0, -4.0]], device=dev),
        torch.tensor([0.0, 0.3, 0.0], device=dev), t_max=2.0, impl="auto")

    # 4. Scene queries: all colliding pairs among ONE set of N shapes.
    scene = torch.from_numpy(hexagon_scene(scene_shapes)).to(dev)
    n = scene.shape[0]
    matrix = scene_collision_matrix(scene)
    pairs, n_pairs, n_contacts, pts, deps, normals, _ = scene_contact_manifolds(
        scene, capacity=128)
    print(f"scene: {int(n_pairs)} colliding pairs of {n * (n - 1) // 2}")
    r = 0
    i, j = (int(v) for v in pairs[r])
    print(f"  e.g. shapes {i}-{j}: {int(n_contacts[r])} contacts, "
          f"depth {float(deps[r].max()):.3f}, "
          f"normal {normals[r].cpu().numpy().round(3).tolist()}")

    # The manifold of any single pair directly:
    c, p, dpt, nv = polygon_contact_manifold(scene[i], scene[j])
    assert int(c) == int(n_contacts[r])

    # 5. Ray casting: where does a ray first hit? (per-shape or whole-scene)
    t_hit, hit_idx, hit_normal = scene_raycast(
        torch.tensor([-6.0, 0.0], device=dev), torch.tensor([1.0, 0.0], device=dev), scene)
    print(f"ray from (-6,0) along +x: hits shape {int(hit_idx)} at t="
          f"{float(t_hit):.3f}, normal {hit_normal.cpu().numpy().round(3).tolist()}")
    print("done.")
    host = lambda x: x.cpu().numpy()  # noqa: E731
    return dict(labels=host(labels), distance=host(dist), closest=host(d),
                manifold_counts=host(count), manifold_depths=host(depths),
                toi=host(toi), toi_model=host(toi_model), matrix=host(matrix),
                pairs=host(pairs), n_pairs=int(n_pairs), n_contacts=host(n_contacts),
                ray=(float(t_hit), int(hit_idx), host(hit_normal)))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=parser.parse_args().device)
