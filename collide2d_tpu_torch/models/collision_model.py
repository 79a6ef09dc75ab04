"""The collision models: labels and probabilities in one object.

Counterpart of ``collide2d_tpu/models/collision_model.py``:

- `CollisionProbabilityModel`, a rectangular robot: the deterministic SAT
  label (`collide`, the reference's ``convex_collide``, utils.cu:159-184),
  convex k-gon pairs (`collide_polygons`), the geometry queries
  (`distance`, `closest_points`, `contact_manifold`, `time_of_impact`) and
  the Monte Carlo entry points (`forward`, `forward_pruned`, `label`,
  `trajectory_probability`);
- `PolygonCollisionProbabilityModel`, a convex k-gon robot against
  `PolygonConfigs` obstacles: `collide`, `distance`, `closest_points`,
  `contact_manifold` and the same Monte Carlo entry points.

`label` takes static batches and trajectory batches (`mc.moving`'s
`MovingConfigs` / `MovingPolygonConfigs`) alike; on the card the trajectory
rounds run kernels 13-15 (``csrc/mc_toi_kernel.cu``,
``csrc/mc_moving_polygon_kernel.cu``, ``csrc/screen_kernel.cu``) as
`mc.driver` resolves them.

Inputs and outputs are torch tensors on one device; on a CUDA device the
labels run the kernels of ``csrc/sat_kernel.cu`` and
``csrc/polygon_kernel.cu``, and the queries those of
``csrc/distance_kernel.cu``, ``csrc/manifold_kernel.cu`` and
``csrc/toi_kernel.cu``. The queries' ``impl``: 'auto' and 'cuda' run the
kernel on CUDA tensors and its plain version on CPU tensors; 'torch' runs
`ops.distance` / `ops.manifold` / `ops.toi` (the JAX package's ``jnp``
path), the only differentiable one: the kernels have no backward and
raise on inputs that require grad.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from collide2d_tpu_torch.mc import prng
from collide2d_tpu_torch.mc.driver import adaptive_collision_probabilities
from collide2d_tpu_torch.mc.estimator import (
    AdaptiveConfig,
    Configs,
    PolygonConfigs,
    collision_probability,
    collision_probability_pruned,
)
from collide2d_tpu_torch.mc.moving import trajectory_collision_probability
from collide2d_tpu_torch.ops import (
    distance,
    distance_cuda,
    manifold,
    manifold_cuda,
    polygon_cuda,
    sat_cuda,
    toi,
    toi_cuda,
)
from collide2d_tpu_torch.ops.broad_phase import candidate_mask, collide_polygons_pruned
from collide2d_tpu_torch.ops.geometry import rects_from_params, transform_vertices
from collide2d_tpu_torch.ops.sat import (
    _normalize_padding,
    obb_collide,
    sat_polygons,
    sat_rects,
)

COLLIDE_IMPLS = ("auto", "cuda", "torch")


def _check_impl(impl: str, precision: str = "f32") -> None:
    if precision not in ("f32", "bf16"):
        raise ValueError(f"precision must be 'f32' or 'bf16', got {precision!r}")
    if impl not in COLLIDE_IMPLS:
        raise ValueError(f"impl must be one of {COLLIDE_IMPLS}, got {impl!r}")


def _collide_polygons(p1, p2, mask1, mask2, *, broad_phase, precision: str,
                      impl: str) -> torch.Tensor:
    """Convex k-gon pair labels, int32 (N,): the JAX model's
    `collide_polygons` on kernel 6 ('auto'/'cuda': the kernel on CUDA
    tensors, its plain version on CPU tensors) or on `ops.sat`
    ('torch')."""
    _check_impl(impl, precision)
    if broad_phase not in (False, True, "prune"):
        raise ValueError(f"broad_phase must be False, True or 'prune', got "
                         f"{broad_phase!r}")
    if precision == "bf16" and broad_phase:
        raise ValueError("precision='bf16' composes only with the plain "
                         "narrow phase (broad_phase=False)")
    p1 = torch.as_tensor(p1, dtype=torch.float32)
    p2 = torch.as_tensor(p2, dtype=torch.float32, device=p1.device)
    narrow_impl = "torch" if impl == "torch" else "cuda"
    if broad_phase == "prune":
        return collide_polygons_pruned(p1, p2, mask1, mask2, impl=narrow_impl)
    if impl == "torch":
        if precision == "bf16":
            p1 = p1.to(torch.bfloat16).to(torch.float32)
            p2 = p2.to(torch.bfloat16).to(torch.float32)
        narrow = sat_polygons(p1, p2, mask1, mask2)
    else:
        narrow = polygon_cuda.sat_polygons_cuda(
            _normalize_padding(p1, mask1), _normalize_padding(p2, mask2),
            precision=precision)
    if not broad_phase:
        return narrow
    return torch.where(candidate_mask(p1, p2, mask1, mask2), narrow, 0)


class CollisionProbabilityModel:
    """Collision labels and probabilities for a rectangular robot.

    ``robot_wh`` defaults to the reference's 4.07 x 1.74 vehicle
    (generate_dataset.cu:60-61); it is the model's only state, kept as a
    float32 numpy array and moved to the data's device per call."""

    def __init__(self, robot_wh: Sequence[float] = (4.07, 1.74)):
        self.robot_wh = np.asarray(robot_wh, np.float32)

    def _robot_ext(self, position: torch.Tensor) -> torch.Tensor:
        """The robot's (w, h) broadcast to ``position``'s shape, built on
        its device without a host-to-device copy."""
        w, h = (float(v) for v in self.robot_wh)
        col = position[..., 0]
        return torch.stack([torch.full_like(col, w), torch.full_like(col, h)], -1)

    # ---- deterministic narrow phase -------------------------------------
    def collide(self, position: torch.Tensor, pose_theta: torch.Tensor,
                obstacle_wh: torch.Tensor, *, precision: str = "f32",
                impl: str = "auto", method: str = "vertex") -> torch.Tensor:
        """SAT label of the robot at (position, pose_theta) against an
        axis-aligned obstacle at the origin: int32 (C,), 1 = collide.

        ``precision='bf16'`` rounds the vertex coordinates to bfloat16
        before the float32 test: labels of pairs within ~0.4% of touching
        can differ from the f32 path (coarse labeling only).
        ``method='obb'`` skips the vertices: the closed-form oriented-box
        test on the parameters (f32 only); labels equal the vertex path
        except on exactly-touching roundings. ``impl``: 'auto' and 'cuda'
        run the kernel on CUDA tensors and its plain version on CPU
        tensors (`ops.sat_cuda`); 'torch' runs `ops.sat` (the JAX
        package's ``jnp`` path)."""
        _check_impl(impl, precision)
        if method not in ("vertex", "obb"):
            raise ValueError(f"method must be 'vertex' or 'obb', got "
                             f"{method!r}")
        position = torch.as_tensor(position, dtype=torch.float32)
        dev = position.device
        pose_theta = torch.broadcast_to(
            torch.as_tensor(pose_theta, dtype=torch.float32, device=dev),
            position.shape[:-1])
        obstacle_wh = torch.broadcast_to(
            torch.as_tensor(obstacle_wh, dtype=torch.float32, device=dev),
            position.shape)
        robot_ext = self._robot_ext(position)
        if method == "obb":
            if precision != "f32":
                raise ValueError("method='obb' supports precision='f32' "
                                 "only (the bf16 contract is about vertex "
                                 "coordinate rounding)")
            args = (position, robot_ext, pose_theta, torch.zeros_like(position),
                    obstacle_wh, torch.zeros_like(pose_theta))
            if impl == "torch":
                return obb_collide(*args)
            return sat_cuda.obb_collide_cuda(*args)
        robot = rects_from_params(position, robot_ext, pose_theta)
        obstacle = rects_from_params(torch.zeros_like(position), obstacle_wh,
                                     torch.zeros_like(pose_theta))
        if impl != "torch":
            return sat_cuda.sat_rects_cuda(robot, obstacle, precision=precision)
        if precision == "bf16":
            robot = robot.to(torch.bfloat16).to(torch.float32)
            obstacle = obstacle.to(torch.bfloat16).to(torch.float32)
        return sat_rects(robot, obstacle)

    def collide_polygons(self, p1, p2, mask1=None, mask2=None, *,
                         broad_phase=False, precision: str = "f32",
                         impl: str = "auto") -> torch.Tensor:
        """Convex k-gon pairs (BASELINE.json config #4): int32 (N,).

        ``p1``/``p2``: ``(N, k, 2)`` CCW vertices, repeat-padded or with
        ``(N, k)`` bool masks. ``broad_phase``: False, the narrow phase on
        every pair; True, ANDed with the AABB candidate mask (a
        necessary-condition cross-check, not a speedup); 'prune', the
        compacted path (`ops.broad_phase.collide_polygons_pruned`: the
        same labels, one host readback). ``precision='bf16'`` (plain
        narrow phase only) rounds the coordinates to bfloat16 before the
        float32 test. ``impl``: 'auto'/'cuda' run kernel 6 on CUDA tensors
        and its plain version on CPU tensors; 'torch' runs `ops.sat`."""
        return _collide_polygons(p1, p2, mask1, mask2, broad_phase=broad_phase,
                                 precision=precision, impl=impl)

    # ---- geometry queries -------------------------------------------------
    def _scene(self, position, pose_theta, obstacle_wh):
        """The `collide` scene in param form: (robot centre, extents, angle,
        obstacle centre, extents, angle), broadcast on the data's device."""
        position = torch.as_tensor(position, dtype=torch.float32)
        dev = position.device
        pose_theta = torch.broadcast_to(
            torch.as_tensor(pose_theta, dtype=torch.float32, device=dev),
            position.shape[:-1])
        obstacle_wh = torch.broadcast_to(
            torch.as_tensor(obstacle_wh, dtype=torch.float32, device=dev),
            position.shape)
        return (position, self._robot_ext(position), pose_theta,
                torch.zeros_like(position), obstacle_wh,
                torch.zeros_like(pose_theta))

    def distance(self, position, pose_theta, obstacle_wh, *,
                 impl: str = "torch") -> torch.Tensor:
        """Signed distance of the `collide` scene: float32 (C,), positive =
        clearance, negative = -(penetration depth), zero = touching.
        'torch' (default) is differentiable (`ops.distance`): the gradient
        through ``position`` gives the contact normal. 'auto'/'cuda' run
        kernel 8 (`ops.distance_cuda.rect_distance_cuda`): values to f32
        rounding, sign bitwise `collide(method='obb')`'s."""
        _check_impl(impl)
        scene = self._scene(position, pose_theta, obstacle_wh)
        if impl == "torch":
            return distance.rect_signed_distance(*scene)
        return distance_cuda.rect_distance_cuda(*scene)

    def closest_points(self, position, pose_theta, obstacle_wh):
        """Witness points and contact normal of the `distance` scene:
        ``(dist, pa, pb, normal)``, ``pa`` on the robot, ``pb`` on the
        obstacle, ``pb - pa = dist * normal``
        (`ops.distance.polygon_closest_points`)."""
        return distance.rect_closest_points(
            *self._scene(position, pose_theta, obstacle_wh))

    def contact_manifold(self, position, pose_theta, obstacle_wh, *,
                         margin: float = 0.0, impl: str = "auto"):
        """Contact manifold of the `distance` scene (robot = body 1, obstacle
        = body 2): ``(count, points, depths, normal)``
        (`ops.manifold.polygon_contact_manifold`). ``margin > 0`` keeps
        speculative contacts. 'auto'/'cuda' run kernel 10 on the boxes'
        vertices (values to f32 rounding; face choices at exact separation
        ties may differ); 'torch' runs `ops.manifold`."""
        _check_impl(impl)
        scene = self._scene(position, pose_theta, obstacle_wh)
        if impl == "torch":
            return manifold.rect_contact_manifold(*scene, margin=margin)
        c1, ext1, th1, c2, ext2, th2 = scene
        return manifold_cuda.polygon_manifold_cuda(
            rects_from_params(c1, ext1, th1), rects_from_params(c2, ext2.abs(), th2),
            margin=margin)

    def time_of_impact(self, position, pose_theta, obstacle_wh, velocity,
                       omega=0.0, *, t_max: float = 1.0, iters: int = 64,
                       tol: float = 1e-4, impl: str = "torch") -> torch.Tensor:
        """First time the robot, starting at (position, pose_theta) and
        moving rigidly with ``velocity`` (B+(2,)) and angular rate
        ``omega`` about its centre, hits the static obstacle: t in
        [0, t_max] (a certified impact, d(t) <= tol) or +inf
        (`ops.toi.rect_time_of_impact`). 'auto'/'cuda' run kernel 12
        (`ops.toi_cuda.rect_toi_cuda`); 'torch' runs `ops.toi`."""
        _check_impl(impl)
        c1, ext1, th1, c2, ext2, th2 = self._scene(position, pose_theta,
                                                    obstacle_wh)
        args = (c1, ext1, th1, velocity, omega, c2, ext2, th2,
                torch.zeros_like(c1), 0.0)
        kw = dict(t_max=t_max, iters=iters, tol=tol)
        if impl == "torch":
            return toi.rect_time_of_impact(*args, **kw)
        return toi_cuda.rect_toi_cuda(*args, **kw)

    # ---- Monte Carlo -----------------------------------------------------
    def forward(self, key, configs: Configs, n_samples: int) -> torch.Tensor:
        """Fixed-budget Monte Carlo probabilities on the threefry path (the
        JAX model's ``jnp`` streams): float32 (C,)."""
        return collision_probability(key, configs, self.robot_wh, n_samples)

    def forward_pruned(self, key, configs: Configs, n_samples: int, *,
                       sigma_margin: float = 6.0, impl: str = "auto") -> np.ndarray:
        """Fixed-budget Monte Carlo with noise-aware pruning: rows that
        cannot touch within ``sigma_margin`` standard deviations get 0
        without sampling (`mc.estimator.collision_probability_pruned`).
        Host float32 (C,)."""
        return collision_probability_pruned(
            key, configs, self.robot_wh, n_samples,
            sigma_margin=sigma_margin, impl=impl)

    def label(self, key, configs: Configs,
              cfg: AdaptiveConfig = AdaptiveConfig()):
        """Adaptive labeling to each bin's CI accuracy of `Configs` (static
        labels) or `MovingConfigs` (trajectory labels). Returns (cp,
        n_samples, converged) as host numpy arrays in row order."""
        return adaptive_collision_probabilities(key, configs, self.robot_wh, cfg)

    def trajectory_probability(self, key, configs, n_samples: int, *,
                               ca_iters: int = 48, tol: float = 1e-4) -> torch.Tensor:
        """Fixed-budget P(the motion collides) of a `MovingConfigs` batch: the
        robot starts at each row's (position, pose_theta) and moves with
        (velocity, omega) for t_max. The threefry path with `forward`'s
        noise model and streams: at zero motion and ``tol=0`` the estimates
        are bitwise `forward`'s. float32 (C,)."""
        return trajectory_collision_probability(key, configs, self.robot_wh,
                                                n_samples, ca_iters=ca_iters, tol=tol)


class PolygonCollisionProbabilityModel:
    """Collision labels and probabilities for a convex k-gon robot against
    `PolygonConfigs` obstacles.

    ``robot_verts``: (K2, 2) CCW convex vertices in the robot frame, kept
    as a float32 numpy array and moved to the data's device per call."""

    def __init__(self, robot_verts):
        self.robot_verts = np.asarray(robot_verts, np.float32)

    def _placed_robot(self, configs: PolygonConfigs) -> torch.Tensor:
        """The robot's world vertices per configuration: (C, K2, 2)."""
        rv = torch.as_tensor(self.robot_verts, device=configs.position.device)
        return transform_vertices(rv[None], configs.position[:, 0],
                                  configs.position[:, 1], configs.pose_theta)

    def collide(self, configs: PolygonConfigs, *, broad_phase=False,
                precision: str = "f32", impl: str = "auto") -> torch.Tensor:
        """Deterministic true-normal SAT label at zero noise: int32 (C,).
        ``broad_phase``, ``precision`` and ``impl`` as
        `CollisionProbabilityModel.collide_polygons`."""
        return _collide_polygons(self._placed_robot(configs),
                                 configs.obstacle_verts, None, None,
                                 broad_phase=broad_phase, precision=precision,
                                 impl=impl)

    def distance(self, configs: PolygonConfigs, *, impl: str = "torch") -> torch.Tensor:
        """Signed distance at zero noise per configuration: float32 (C,),
        positive = clearance, negative = -(penetration depth). 'torch'
        (default) is differentiable (`ops.distance`); 'auto'/'cuda' run
        kernel 9 (values to f32 rounding, sign bitwise `collide`'s)."""
        _check_impl(impl)
        robot = self._placed_robot(configs)
        if impl == "torch":
            return distance.polygon_signed_distance(robot, configs.obstacle_verts)
        return distance_cuda.polygon_distance_cuda(robot, configs.obstacle_verts)

    def closest_points(self, configs: PolygonConfigs):
        """Witness points and contact normal per configuration: ``(dist, pa,
        pb, normal)``, ``pa`` on the placed robot, ``pb`` on the obstacle
        (`ops.distance.polygon_closest_points`)."""
        return distance.polygon_closest_points(self._placed_robot(configs),
                                               configs.obstacle_verts)

    def contact_manifold(self, configs: PolygonConfigs, *, margin: float = 0.0,
                         impl: str = "auto"):
        """Contact manifold per configuration, the placed robot as body 1 and
        the obstacle as body 2: ``(count, points, depths, normal)``.
        'auto'/'cuda' run kernel 10; 'torch' runs `ops.manifold`."""
        _check_impl(impl)
        robot = self._placed_robot(configs)
        if impl == "torch":
            return manifold.polygon_contact_manifold(robot, configs.obstacle_verts,
                                                     margin=margin)
        return manifold_cuda.polygon_manifold_cuda(robot, configs.obstacle_verts,
                                                   margin=margin)

    def forward(self, key, configs: PolygonConfigs, n_samples: int) -> torch.Tensor:
        """Fixed-budget Monte Carlo probabilities on the threefry path (the
        JAX model's ``jnp`` streams): float32 (C,)."""
        return collision_probability(key, configs, self.robot_verts, n_samples)

    def forward_pruned(self, key, configs: PolygonConfigs, n_samples: int, *,
                       sigma_margin: float = 6.0) -> np.ndarray:
        """Fixed-budget Monte Carlo with noise-aware pruning on the threefry
        path (circumscribed-circle reach on the vertex norms): host
        float32 (C,)."""
        return collision_probability_pruned(
            key, configs, self.robot_verts, n_samples,
            sigma_margin=sigma_margin, impl="threefry")

    def label(self, key, configs: PolygonConfigs,
              cfg: AdaptiveConfig = AdaptiveConfig()):
        """Adaptive labeling to each bin's CI accuracy of `PolygonConfigs`
        (static labels) or `MovingPolygonConfigs` (trajectory labels).
        Returns (cp, n_samples, converged) as host numpy arrays in row
        order."""
        return adaptive_collision_probabilities(key, configs, self.robot_verts, cfg)

    def trajectory_probability(self, key, configs, n_samples: int, *,
                               ca_iters: int = 48, tol: float = 1e-4) -> torch.Tensor:
        """Fixed-budget P(the motion collides) of a `MovingPolygonConfigs`
        batch, on the threefry path with `forward`'s noise model and
        streams (at zero motion the per-sample decisions are `forward`'s).
        float32 (C,)."""
        return trajectory_collision_probability(key, configs, self.robot_verts,
                                                n_samples, ca_iters=ca_iters, tol=tol)


def _example_device(device) -> torch.device:
    """The device the example builders draw on: the card unless the caller
    asks for another; a card that is not there raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the example builders run on the card by default and "
                           "no CUDA device is available; pass device='cpu' to build "
                           "the rows on the host")
    return dev


def example_polygon_configs(n: int = 8, k: int = 6, seed: int = 0,
                            device="cuda") -> PolygonConfigs:
    """Small deterministic `PolygonConfigs` batch, convex by construction
    (vertices on per-configuration ellipses at sorted angles): the JAX
    package's `example_polygon_configs` draws (threefry), so both give the
    same rows. On the card unless ``device`` says otherwise."""
    device = _example_device(device)
    k1, k2, k3, k4, k5 = prng.split(prng.PRNGKey(seed), 5)
    ang = prng.uniform(k1, (n, k), 0.0, 2.0 * math.pi, device).sort(dim=-1).values
    ab = prng.uniform(k2, (n, 1, 2), 0.5, 3.0, device)
    verts = torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1) * ab
    return PolygonConfigs(
        position=prng.uniform(k3, (n, 2), -6.0, 6.0, device),
        pose_theta=prng.uniform(k4, (n,), 0.0, 2.0 * math.pi, device),
        obstacle_verts=verts,
        std_dev=prng.uniform(k5, (n, 3), 0.0, 0.55, device),
    )


def example_configs(n: int = 8, seed: int = 0, device="cuda") -> Configs:
    """Small deterministic `Configs` batch: the JAX package's
    `example_configs` draws (threefry), so both give the same rows. On the
    card unless ``device`` says otherwise."""
    device = _example_device(device)
    k1, k2, k3, k4 = prng.split(prng.PRNGKey(seed), 4)
    std_dev = prng.uniform(k4, (n, 5), 0.0, 0.55, device)
    std_dev[:, 3:] = 0.0
    return Configs(
        position=prng.uniform(k1, (n, 2), -6.0, 6.0, device),
        pose_theta=prng.uniform(k2, (n,), 0.0, 2.0 * math.pi, device),
        obstacle_wh=prng.uniform(k3, (n, 2), 0.1, 5.0, device),
        std_dev=std_dev,
    )
