"""Gaussian pose/shape noise and the annulus configuration sampler.

Counterpart of ``collide2d_tpu/mc/noise.py`` (the reference's
`sample_rectangle`, utils.cu:144-157, and the generator's iteration-0
branch, generate_dataset.cu:207-219). Draws use the port's threefry
(`mc.prng`), so the same key gives the JAX package's configurations.

Noise semantics: dx, dy, dtheta, dwidth, dheight ~ N(0, sigma_i^2); the
sampled obstacle is rect(w + dw, h + dh) rotated by dtheta about the
origin and translated by (dx, dy), i.e. an oriented box with centre
(dx, dy), full extents (w + dw, h + dh) and angle dtheta.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from collide2d_tpu_torch.mc import prng
from collide2d_tpu_torch.ops.geometry import rect_vertices, transform_vertices

# The annulus-radius padding of the reference's position sampler
# (generate_dataset.cu:215-216).
RADIUS_PADDING = 2.35


class NoiseParams(NamedTuple):
    """One draw of the 5-dim Gaussian noise: (dx, dy, dtheta, dw, dh)."""

    dx: torch.Tensor
    dy: torch.Tensor
    dtheta: torch.Tensor
    dw: torch.Tensor
    dh: torch.Tensor


def sample_noise(key, std_dev: torch.Tensor, shape=()) -> NoiseParams:
    """``shape``-many 5-dim noise vectors scaled by ``std_dev`` (..., 5)
    (x, y, theta, width, height sigmas). Arrays of shape
    ``std_dev.shape[:-1] + shape``."""
    std_dev = std_dev.to(torch.float32)
    draw_shape = tuple(std_dev.shape[:-1]) + tuple(shape) + (5,)
    z = prng.normal(key, draw_shape, std_dev.device)
    extra = len(tuple(shape))
    sigma = std_dev.reshape(tuple(std_dev.shape[:-1]) + (1,) * extra + (5,))
    d = z * sigma
    return NoiseParams(d[..., 0], d[..., 1], d[..., 2], d[..., 3], d[..., 4])


def sampled_obstacle_vertices(base_wh: torch.Tensor, noise: NoiseParams) -> torch.Tensor:
    """Vertex-path noisy obstacle (utils.cu:144-157): base rect plus
    additive rect(dw, dh), rotated by dtheta, translated by (dx, dy).
    Returns (..., 4, 2)."""
    base = rect_vertices(base_wh[..., 0], base_wh[..., 1])
    delta = rect_vertices(noise.dw, noise.dh)
    return transform_vertices(base + delta, noise.dx, noise.dy, noise.dtheta)


def sample_configuration_batch(
    key,
    poses: torch.Tensor,
    std_devs: torch.Tensor,
    *,
    num_configs: int,
    r_offset: float,
    spread: float,
):
    """The generator's per-batch configuration draw, on the tables' device.

    Picks a pose and a variance row per configuration and places the robot
    on a sigma-scaled elliptical ring around the obstacle::

        theta ~ U[0, 2*pi);  shift ~ N(0, 1) * (sigma_x + sigma_y)/2 * spread
        x = cos(theta) * (w/2 + r_offset + 2.35 + sigma_x + shift)
        y = sin(theta) * (h/2 + r_offset + 2.35 + sigma_y + shift)

    Returns ``(positions (N,2) f32, pose_idx (N,) i32, var_idx (N,) i32,
    pose (N,3), sd (N,5))``, all on the tables' device.
    """
    dev = poses.device
    k_pose, k_var, k_theta, k_shift = prng.split(key, 4)
    pose_idx = prng.randint(k_pose, (num_configs,), 0, poses.shape[0], dev)
    var_idx = prng.randint(k_var, (num_configs,), 0, std_devs.shape[0], dev)
    theta = prng.uniform(k_theta, (num_configs,), 0.0, 2.0 * torch.pi, dev)
    sd = std_devs[var_idx]
    shift = (
        prng.normal(k_shift, (num_configs,), dev)
        * ((sd[:, 1] + sd[:, 0]) * 0.5)
        * spread
    )
    pose = poses[pose_idx]
    rx = pose[:, 0] * 0.5 + r_offset + RADIUS_PADDING + sd[:, 0] + shift
    ry = pose[:, 1] * 0.5 + r_offset + RADIUS_PADDING + sd[:, 1] + shift
    positions = torch.stack([torch.cos(theta) * rx, torch.sin(theta) * ry], dim=-1)
    return positions, pose_idx, var_idx, pose, sd
