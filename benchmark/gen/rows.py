"""The benchmark's inputs, made from ``--seed`` with ``torch.Generator``s on
the run's device, in the types the program takes (float32).

- `tables`: the generator's pose and variance tables in the ranges of
  generate_dataset.cu:44-64 (uniform, widths and heights of the obstacle,
  the robot's angle; variances with the width and height columns zero when
  the configuration has no shape variance, generate_dataset.cu:285-290).
- `annulus`: the generator's configuration draw around an obstacle
  (generate_dataset.cu:207-219), a frozen copy of the program's
  ``mc.noise.sample_configuration_batch`` without the program's PRNG.
- `kgon_file`: one file of k-gon configurations, the rows of the port's
  ``utils.benchmarks.bench_e2e_polygons`` (annulus positions, obstacles
  with k vertices at sorted uniform angles on an ellipse with U(0.5, 2.5)
  semi-axes), again without the program's PRNG.

Every draw takes its own generator, seeded from (seed, purpose), so one
purpose's draws never shift another's.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

RADIUS_PADDING = 2.35  # generate_dataset.cu:215-216


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose of one run."""
    digest = hashlib.sha256(f"{int(seed)}/{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def generator(seed: int, purpose: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, purpose))
    return g


def _uniform(g, shape, lo, hi, device) -> torch.Tensor:
    lo = torch.as_tensor(lo, dtype=torch.float32, device=device)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=device)
    return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo


def tables(config: dict, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(poses (P, 3), variances (V, 5)) float32 on ``device``."""
    g = generator(seed, "tables", device)
    lo_v = list(config["min_variance"])
    hi_v = list(config["max_variance"])
    if not config["shape_variance"]:
        lo_v[3:5] = [0.0, 0.0]
        hi_v[3:5] = [0.0, 0.0]
    poses = _uniform(g, (config["num_poses"], 3), config["min_pose"],
                     config["max_pose"], device)
    variances = _uniform(g, (config["num_variances"], 5), lo_v, hi_v, device)
    return poses, variances


def annulus(g, wh: torch.Tensor, sd_xy: torch.Tensor, r_offset: float,
            spread: float) -> torch.Tensor:
    """Positions (N, 2) on each row's sigma-scaled ring around an obstacle
    of extents ``wh`` (N, 2): angle ~ U[0, 2 pi), shift ~ N(0, 1) *
    (s_x + s_y) / 2 * spread, radii w/2 + r_offset + 2.35 + s + shift."""
    n = wh.shape[0]
    dev = wh.device
    theta = torch.rand(n, generator=g, device=dev) * (2.0 * math.pi)
    shift = (torch.randn(n, generator=g, device=dev)
             * ((sd_xy[:, 0] + sd_xy[:, 1]) * 0.5) * spread)
    rx = wh[:, 0] * 0.5 + r_offset + RADIUS_PADDING + sd_xy[:, 0] + shift
    ry = wh[:, 1] * 0.5 + r_offset + RADIUS_PADDING + sd_xy[:, 1] + shift
    return torch.stack([torch.cos(theta) * rx, torch.sin(theta) * ry], dim=-1)


def r_offset(config: dict) -> float:
    return (config["robot_width"] + config["robot_height"]) / 4.0  # generate_dataset.cu:398


def robot_vertices(config: dict) -> np.ndarray:
    """The robot rectangle as 4 CCW vertices from its bottom-left corner."""
    hw, hh = config["robot_width"] / 2.0, config["robot_height"] / 2.0
    return np.array([[-hw, -hh], [hw, -hh], [hw, hh], [-hw, hh]], np.float32)


def rect_rows(config: dict, seed: int, purpose: str, n: int, poses, variances):
    """``n`` rectangle configurations drawn as the generator draws them:
    (positions (N, 2), pose_idx (N,), var_idx (N,)) on the tables' device."""
    dev = poses.device
    g = generator(seed, purpose, dev)
    pose_idx = torch.randint(0, poses.shape[0], (n,), generator=g, device=dev)
    var_idx = torch.randint(0, variances.shape[0], (n,), generator=g, device=dev)
    pose = poses[pose_idx]
    sd = torch.sqrt(variances[var_idx])
    pos = annulus(g, pose[:, :2], sd[:, :2], r_offset(config), config["spread"])
    return pos, pose_idx, var_idx


def kgon_file(config: dict, seed: int, index: int, device) -> dict:
    """File ``index`` of the k-gon traffic: host float32 arrays position
    (C, 2), pose_theta (C,), obstacle_verts (C, K, 2), std_dev (C, 3) and
    robot_verts (4, 2)."""
    g = generator(seed, f"kgon/{index}", device)
    c, k = config["rows_per_file"], config["k"]
    pose = _uniform(g, (c, 3), config["min_pose"], config["max_pose"], device)
    var = _uniform(g, (c, 3), config["min_variance"][:3], config["max_variance"][:3],
                   device)
    sd = torch.sqrt(var)
    pos = annulus(g, pose[:, :2], sd[:, :2], r_offset(config), config["spread"])
    ang = (torch.rand((c, k), generator=g, device=device) * (2.0 * math.pi)
           ).sort(dim=-1).values
    lo, hi = config["semi_axes"]
    ab = _uniform(g, (c, 1, 2), lo, hi, device)
    verts = torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1) * ab
    host = lambda t: t.cpu().numpy().astype(np.float32)  # noqa: E731
    return dict(position=host(pos), pose_theta=host(pose[:, 2]),
                obstacle_verts=host(verts), std_dev=host(sd),
                robot_verts=robot_vertices(config))
