"""Monte Carlo collision-probability estimator with adaptive stopping.

Counterpart of ``collide2d_tpu/mc/estimator.py`` for rectangle `Configs`,
convex k-gon `PolygonConfigs` and their trajectory forms (`mc.moving`'s
`MovingConfigs`, `MovingPolygonConfigs`). Two ways to draw a round's counts:

- ``'cuda'`` — the fused kernel (`ops.mc_cuda` for rectangles,
  `ops.mc_polygon_cuda` for k-gons, `ops.mc_toi_cuda` and
  `ops.mc_moving_polygon_cuda` for trajectories): Philox streams keyed by
  (round seed, row uid, sample index). On CUDA tensors the kernel runs; on
  CPU tensors its plain version gives the same counts.
- ``'threefry'`` — the per-draw reference: the JAX package's ``jnp`` path
  (`_counts_chunk` through `_threefry_counts`) with the same threefry
  draws, so it reproduces that path's counts up to the rare sample within
  an ulp of a separation boundary.

``'auto'`` resolves to ``'cuda'`` on every device (trajectory batches:
see `mc_round` and `mc.driver._resolve_trajectory`). `_fused_round` runs a
run of same-plan rounds, the `mc.stats` convergence test and label
freezing, as its JAX namesake does inside one program: on CUDA tensors
without a mesh a round is the fused kernel of any of the four classes,
counting from a table packed once a buffer (`pack_round_table`) straight
into the running counts, and one round epilogue kernel
(`ops.round_epilogue_cuda`) for the rest.

Under a `parallel.Mesh` a round's counts run over the mesh's config
blocks and sample shards (`_cuda_sharded_counts`, `_sample_sharded_counts`)
and come back to the rows' device; both paths give counts bitwise equal
to the unsharded round's.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np
import torch

from collide2d_tpu_torch.mc import prng, stats
from collide2d_tpu_torch.mc.moving import (
    MovingConfigs,
    MovingPolygonConfigs,
    counts_chunk_moving,
    counts_chunk_moving_polygons,
)
from collide2d_tpu_torch.mc.noise import NoiseParams, sampled_obstacle_vertices
from collide2d_tpu_torch.ops import (
    mc_cuda,
    mc_moving_polygon_cuda,
    mc_polygon_cuda,
    mc_toi_cuda,
    round_epilogue_cuda,
)
from collide2d_tpu_torch.ops.geometry import rects_from_params, transform_vertices
from collide2d_tpu_torch.ops.sat import (
    _normalize_padding,
    obb_collide,
    sat_polygons,
    sat_rects,
)
from collide2d_tpu_torch.utils.profiling import span

IMPLS = ("cuda", "threefry")
# Samples per kernel sub-tile on the TPU path; the round plan keeps this
# granule so round plans match the JAX runs (estimator.py:209-210).
KERNEL_GRANULE = 64


class Configs(NamedTuple):
    """A batch of C dataset configurations, as tensors on one device.

    position:    (C, 2) robot centre in the obstacle frame
    pose_theta:  (C,)   robot orientation
    obstacle_wh: (C, 2) obstacle width/height (obstacle at the origin)
    std_dev:     (C, 5) noise sigmas (x, y, theta, width, height)
    """

    position: torch.Tensor
    pose_theta: torch.Tensor
    obstacle_wh: torch.Tensor
    std_dev: torch.Tensor

    @property
    def num(self) -> int:
        return self.position.shape[0]


class PolygonConfigs(NamedTuple):
    """A batch of C convex k-gon configurations, as tensors on one device.

    Noise is pose noise (x, y, theta) on the obstacle: the rectangle
    model's width/height noise has no k-gon analogue, so std_dev has 3
    columns. The robot is passed where rectangle calls pass ``robot_wh``:
    a (K2, 2) vertex array in the robot frame.

    position:       (C, 2)    robot centre in the obstacle frame
    pose_theta:     (C,)      robot orientation
    obstacle_verts: (C, K, 2) CCW convex vertices in the obstacle frame,
                              rotated about the origin by the theta noise;
                              short polygons repeat their last vertex (or
                              build with `from_padded` and a mask)
    std_dev:        (C, 3)    noise sigmas (x, y, theta)
    """

    position: torch.Tensor
    pose_theta: torch.Tensor
    obstacle_verts: torch.Tensor
    std_dev: torch.Tensor

    @property
    def num(self) -> int:
        return self.position.shape[0]

    @classmethod
    def from_padded(cls, position, pose_theta, obstacle_verts, std_dev,
                    mask=None, *, device=None) -> "PolygonConfigs":
        """Build configs from arbitrarily padded fixed-K vertices (arrays or
        tensors, as float32 on ``device``): with a ``mask`` ((C, K) bool,
        True = real vertex) padded slots become the last real vertex, the
        repeat-padding the SAT contract needs."""
        def f32(a):
            return torch.as_tensor(a, dtype=torch.float32, device=device)

        position, pose_theta = f32(position), f32(pose_theta)
        obstacle_verts, std_dev = f32(obstacle_verts), f32(std_dev)
        if mask is not None:
            mask = torch.as_tensor(mask, dtype=torch.bool, device=device)
        c = position.shape[0] if position.dim() else -1
        ok = (
            position.dim() == 2 and tuple(position.shape) == (c, 2)
            and tuple(pose_theta.shape) == (c,)
            and obstacle_verts.dim() == 3
            and obstacle_verts.shape[0] == c and obstacle_verts.shape[2] == 2
            and tuple(std_dev.shape) == (c, 3)
            and (mask is None or mask.shape == obstacle_verts.shape[:2])
        )
        if not ok:
            raise ValueError(
                "PolygonConfigs.from_padded: expected position (C, 2), "
                "pose_theta (C,), obstacle_verts (C, K, 2), std_dev (C, 3) "
                "[pose-noise sigmas x/y/theta], optional mask (C, K); got "
                f"position {tuple(position.shape)}, pose_theta "
                f"{tuple(pose_theta.shape)}, obstacle_verts "
                f"{tuple(obstacle_verts.shape)}, std_dev {tuple(std_dev.shape)}"
                + ("" if mask is None else f", mask {tuple(mask.shape)}")
            )
        return cls(position, pose_theta,
                   _normalize_padding(obstacle_verts, mask), std_dev)


def configs_from_numpy(configs, device) -> Configs:
    """The JAX package's `Configs` (or any 4-field tuple of arrays), taken
    as numpy arrays, as the port's float32 tensors on ``device``."""
    return Configs(*(
        torch.as_tensor(np.asarray(a, np.float32), device=device)
        for a in configs
    ))


def polygon_configs_from_numpy(configs, device) -> PolygonConfigs:
    """The JAX package's `PolygonConfigs` (or any 4-field tuple of arrays),
    taken as numpy arrays, as the port's float32 tensors on ``device``."""
    return PolygonConfigs(*(
        torch.as_tensor(np.asarray(a, np.float32), device=device)
        for a in configs
    ))


def resolve_impl(impl: str) -> str:
    """'auto' -> the fused kernel ('cuda'); names are validated."""
    if impl == "auto":
        return "cuda"
    if impl not in IMPLS:
        raise ValueError(f"impl must be 'auto' or one of {IMPLS}, got {impl!r}")
    return impl


def _largest_divisor_leq(n: int, cap: int) -> int:
    for s in range(min(cap, n), 0, -1):
        if n % s == 0:
            return s
    return 1


@functools.lru_cache(maxsize=None)
def _canonical_step(nb: int) -> int:
    """The threefry path's step for an ``nb``-sample round: the largest
    divisor <= 512 whose step count is a multiple of 8, else the largest
    divisor (the JAX package's shard-invariant choice, kept so step tags
    match)."""
    fallback = 1
    for s in range(min(512, nb), 0, -1):
        if nb % s:
            continue
        if fallback == 1:
            fallback = s
        if (nb // s) % 8 == 0:
            return s
    return fallback


def _plan_round(cfg, sim_n: int, n_sample: int, impl: str) -> tuple[int, int]:
    """(n_batch, step_samples) for the round starting at ``sim_n`` samples.

    The kernel path rounds n_batch up to the 64-sample granule and uses
    step 64, which only advances the round tag; the threefry path keeps
    the JAX ``jnp`` plan. Extra samples count in n_samples, so the CI
    criterion is evaluated at the true draw count. The plan does not
    depend on the sample axis ``n_sample``, so a sharded run plans the
    rounds of an unsharded one at every axis: `_sample_sharded_counts`
    round-robins any step count. (JAX's plan falls back to a shard-specific
    plan when the steps do not divide by the axis, estimator.py:225-240,
    because its shard_map needs equal steps a shard; the port does not.)
    An explicit ``step_samples`` keeps JAX's rule that ``step * n_sample``
    divides n_batch."""
    nb = cfg.batch_for(sim_n)
    if impl == "cuda":
        nb = -(-nb // KERNEL_GRANULE) * KERNEL_GRANULE
    if cfg.step_samples:
        step = cfg.step_samples
        if impl == "cuda":
            return nb, min(step, nb)
        if nb % (step * n_sample):
            raise ValueError(
                f"step_samples={step} x sample axis {n_sample} must divide "
                f"n_batch={nb}"
            )
        return nb, step
    if impl == "cuda":
        return nb, KERNEL_GRANULE
    step = _canonical_step(nb)
    if step < 64 and nb >= 4096:
        nb = -(-nb // 4096) * 4096
        step = 512
    return nb, step


def _per_config_keys(key, uids: torch.Tensor):
    """Stable per-configuration keys: fold each uid into the base key, so
    streams do not change under compaction or reordering."""
    return prng.fold_in_many(key, uids)


def _counts_chunk_polygons(keys, configs: PolygonConfigs,
                           robot_verts: torch.Tensor, n_lanes: int) -> torch.Tensor:
    """`_counts_chunk` for k-gons: the obstacle is rotated about the origin
    by the theta draw and translated by the (x, y) draw, then tested
    against the placed robot k-gon with true-normal SAT."""
    z = prng.normal(keys, (n_lanes, 3))
    d = z * configs.std_dev[:, None, :]  # (C, S, 3)
    robot = transform_vertices(
        robot_verts[None], configs.position[:, 0], configs.position[:, 1],
        configs.pose_theta,
    )[:, None]  # (C, 1, K2, 2)
    obstacle = transform_vertices(
        configs.obstacle_verts[:, None], d[..., 0], d[..., 1], d[..., 2]
    )  # (C, S, K, 2)
    hit = sat_polygons(robot.expand(-1, obstacle.shape[1], -1, -1), obstacle)
    return hit.sum(dim=-1, dtype=torch.int32)


def _counts_chunk(keys, configs: Configs, robot_wh: torch.Tensor,
                  n_lanes: int, use_vertices: bool, ca_iters: int = 48,
                  ca_tol: float = 1e-4, screen_impl: str = "auto") -> torch.Tensor:
    """Collision count over ``n_lanes`` threefry samples per configuration
    (``keys``: a batched key pair, one key per configuration).
    ``ca_iters``/``ca_tol`` (the advancement budget and contact tolerance)
    and ``screen_impl`` (stage A of the rectangle cascade,
    `mc.moving.counts_chunk_moving`) apply to trajectory batches only."""
    if isinstance(configs, MovingConfigs):
        return counts_chunk_moving(keys, configs, robot_wh, n_lanes,
                                   ca_iters=ca_iters, tol=ca_tol,
                                   screen_impl=screen_impl)
    if isinstance(configs, MovingPolygonConfigs):
        return counts_chunk_moving_polygons(keys, configs, robot_wh, n_lanes,
                                            ca_iters=ca_iters, tol=ca_tol)
    if isinstance(configs, PolygonConfigs):
        return _counts_chunk_polygons(keys, configs, robot_wh, n_lanes)
    z = prng.normal(keys, (n_lanes, 5))
    d = z * configs.std_dev[:, None, :]
    if use_vertices:
        # Vertex path: sample_rectangle + convex_collide (utils.cu:144-184).
        noise = NoiseParams(d[..., 0], d[..., 1], d[..., 2], d[..., 3], d[..., 4])
        obstacle = sampled_obstacle_vertices(configs.obstacle_wh[:, None, :], noise)
        robot = rects_from_params(
            configs.position,
            torch.broadcast_to(robot_wh, configs.position.shape),
            configs.pose_theta,
        )
        hit = sat_rects(torch.broadcast_to(robot[:, None], obstacle.shape), obstacle)
    else:
        hit = obb_collide(
            configs.position[:, None, :],
            torch.broadcast_to(robot_wh, (1, 1, 2)),
            configs.pose_theta[:, None],
            d[..., 0:2],
            configs.obstacle_wh[:, None, :] + d[..., 3:5],
            d[..., 2],
        )
    return hit.sum(dim=-1, dtype=torch.int32)


def _threefry_counts(key, uids, configs: Configs, robot_wh, tags, *,
                     step_samples: int, use_vertices: bool = False,
                     ca_iters: int = 48, ca_tol: float = 1e-4,
                     screen_impl: str = "auto") -> torch.Tensor:
    """Threefry counts summed over the steps ``tags``: step tag t draws
    ``step_samples`` lanes with t folded into each uid's key. A round's
    step i has tag ``chunk_offset + i``, so a row's stream is continuous
    across rounds whatever the compaction."""
    k0, k1 = _per_config_keys(key, uids)
    robot_wh = torch.as_tensor(robot_wh, dtype=torch.float32,
                               device=configs.position.device)
    counts = torch.zeros((configs.num,), dtype=torch.int32,
                         device=configs.position.device)
    for tag in tags:
        step_keys = prng.fold_in_pair(k0, k1, int(tag))
        counts += _counts_chunk(step_keys, configs, robot_wh, step_samples,
                                use_vertices, ca_iters, ca_tol, screen_impl)
    return counts


def _mesh_axis(mesh, name: str) -> int:
    return 1 if mesh is None else dict(mesh.shape).get(name, 1)


def _mesh_counts(configs, uids: torch.Tensor, mesh, prepare, shard_fn) -> torch.Tensor:
    """Round counts over a ``(config, sample)`` mesh, on ``configs``' device.

    Config block i (`parallel.sharding.config_blocks`) goes to its mesh
    row's first device, where ``prepare(block, uids, devices)`` returns
    one input for each sample shard, on that shard's device (``devices``:
    the row's); ``shard_fn(input, j)`` gives shard j's partial counts on
    its device; the partials are summed on the row's first device. Every
    input is in place before the first launch: a copy between cards runs
    on the source card's stream, so one made after a kernel there would
    wait for it and the cards would take turns. Entries of other processes
    are skipped, and when the mesh spans processes the (C,) counts are
    summed over the group with one ``all_reduce``, so every process holds
    every row's counts. The host's three phases are the spans
    ``round/stage``, ``round/launch`` (one for each shard) and
    ``round/reduce``."""
    from collide2d_tpu_torch.parallel.sharding import config_blocks

    out_dev = configs.position.device
    staged = []
    with span("round/stage"):
        for i, (lo, hi) in enumerate(config_blocks(configs.num, mesh)):
            if hi == lo or not mesh.is_local(i):
                continue
            lead = mesh.devices[i, 0]
            block = type(configs)(*(a[lo:hi].to(lead) for a in configs))
            staged.append((lo, hi, lead, prepare(block, uids[lo:hi].to(lead),
                                                 list(mesh.devices[i]))))
    launched = []
    for lo, hi, lead, inputs in staged:
        parts = []
        for j, x in enumerate(inputs):
            with span("round/launch"):
                parts.append(shard_fn(x, j))
        launched.append((lo, hi, lead, parts))
    with span("round/reduce"):
        counts = torch.zeros((configs.num,), dtype=torch.int32, device=out_dev)
        for lo, hi, lead, parts in launched:
            total = parts[0].to(lead)
            for part in parts[1:]:
                total = total + part.to(lead)
            counts[lo:hi] = total.to(out_dev)
        if mesh.spans_processes:
            import torch.distributed as dist

            host = counts.cpu()
            dist.all_reduce(host)
            counts = host.to(out_dev)
    return counts


def _replicas(block, uids, devices, *, robot_wh):
    """`_mesh_counts`' ``prepare`` of both paths: the config block, its
    uids and the robot, one copy on each sample shard's device."""
    return [(type(block)(*(a.to(d) for a in block)), uids.to(d),
             torch.as_tensor(robot_wh, dtype=torch.float32, device=d))
            for d in devices]


def _sample_sharded_counts(key, uids, configs: Configs, robot_wh,
                           chunk_offset: int, n_steps: int, *,
                           step_samples: int, use_vertices: bool, mesh,
                           ca_iters: int = 48, ca_tol: float = 1e-4,
                           screen_impl: str = "auto") -> torch.Tensor:
    """Threefry round counts with STEPS round-robined over the ``sample``
    mesh axis: shard s runs the steps ``i = s + j * n_sample`` of the
    single-device stream with its tags ``chunk_offset + i`` (JAX
    estimator.py:519-575), config blocks run their own rows, and int32
    sums are exact and order-free, so the counts equal the unsharded
    round's bit for bit. Every step runs once at any ``n_steps``."""
    n_sample = _mesh_axis(mesh, "sample")
    first = int(chunk_offset)
    last = first + int(n_steps)

    def shard(inputs, j):
        block, bu, robot = inputs
        return _threefry_counts(
            key, bu, block, robot, range(first + j, last, n_sample),
            step_samples=step_samples, use_vertices=use_vertices,
            ca_iters=ca_iters, ca_tol=ca_tol, screen_impl=screen_impl)

    return _mesh_counts(configs, uids, mesh, functools.partial(
        _replicas, robot_wh=robot_wh), shard)


def _a_keep(robot_wh, poly_a_keep):
    """The k-gon kernels' robot-axis subset: ``poly_a_keep``, or worked out
    from the robot (a readback when it is on the card)."""
    if poly_a_keep is not None:
        return poly_a_keep
    return mc_polygon_cuda.dedup_robot_axes(
        torch.as_tensor(robot_wh, dtype=torch.float32).cpu().numpy())


def _round_table(configs, robot_wh, a_keep) -> torch.Tensor:
    """The parameter table of the fused kernel of ``configs``' class, one
    row per configuration, packed in a ``driver/table`` span (k-gon
    classes: robot-axis subset ``a_keep``)."""
    with span("driver/table", count=1):
        if isinstance(configs, (PolygonConfigs, MovingPolygonConfigs)):
            rv = torch.as_tensor(robot_wh, dtype=torch.float32,
                                 device=configs.position.device)
            pack = (mc_moving_polygon_cuda.pack_moving_polygon_mc_params
                    if isinstance(configs, MovingPolygonConfigs)
                    else mc_polygon_cuda.pack_polygon_mc_params)
            return pack(configs, rv, a_keep)
        if isinstance(configs, MovingConfigs):
            return mc_toi_cuda.pack_mc_toi_params(configs, robot_wh)
        return mc_cuda.pack_mc_params(configs, robot_wh)


def pack_round_table(configs, robot_wh, *, impl: str, mesh=None,
                     poly_a_keep: tuple[int, ...] | None = None):
    """``configs``' fused-kernel table for `_fused_round`'s ``table``, where
    rounds count from a table packed once a buffer: on impl 'cuda' without
    a ``mesh``, kernel 1's (`Configs`), 7's (`PolygonConfigs`), 13's
    (`MovingConfigs`) or 14's (`MovingPolygonConfigs`). None wherever each
    round packs its own: the threefry path and a mesh (its shards'
    copies). A row's table depends on that row alone, so the table of a
    gathered buffer is this table gathered (`mc.driver._pack_active`)."""
    if resolve_impl(impl) != "cuda" or mesh is not None:
        return None
    poly = isinstance(configs, (PolygonConfigs, MovingPolygonConfigs))
    a_keep = _a_keep(robot_wh, poly_a_keep) if poly else None
    return _round_table(configs, robot_wh, a_keep)


def _kernel_round(key, uids, configs, robot_wh, round_tag: int, n: int, *,
                  offset: int = 0, shape_noise: bool = True,
                  poly_a_keep: tuple[int, ...] | None = None,
                  ca_iters: int = 48, ca_tol: float = 1e-4,
                  table: torch.Tensor | None = None,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """(C,) counts of the round's samples ``offset`` to ``offset + n`` on
    the fused kernel of ``configs``' class: kernel 1 (`Configs`), 7
    (`PolygonConfigs`), 13 (`MovingConfigs`) or 14 (`MovingPolygonConfigs`,
    translation-only); its plain version on CPU tensors. ``table``: the
    kernel's table from `pack_round_table`; None = packed here. ``out``:
    int32 (C,) counts the round's are added into and which is returned;
    None = new ones."""
    poly = isinstance(configs, (PolygonConfigs, MovingPolygonConfigs))
    a_keep = _a_keep(robot_wh, poly_a_keep) if poly else None
    if table is None:
        table = _round_table(configs, robot_wh, a_keep)
    uids = uids.to(torch.int32).contiguous()
    seed = mc_cuda.round_seed(key, round_tag)
    if poly:
        shape = dict(k=configs.obstacle_verts.shape[1], k2=len(robot_wh),
                     k2a=len(a_keep), offset=offset)
        if isinstance(configs, MovingPolygonConfigs):
            return mc_moving_polygon_cuda.mc_moving_poly_counts(
                table, uids, seed, n, out=out, **shape)
        return mc_polygon_cuda.mc_poly_counts(table, uids, seed, n, out=out, **shape)
    if isinstance(configs, MovingConfigs):
        return mc_toi_cuda.mc_toi_counts(table, uids, seed, n, offset=offset,
                                         shape_noise=shape_noise,
                                         ca_iters=ca_iters, tol=ca_tol, out=out)
    return mc_cuda.mc_counts(table, uids, seed, n, offset=offset,
                             shape_noise=shape_noise, out=out)


def _granule_ranges(n: int, n_shards: int) -> list[tuple[int, int]]:
    """(offset, count) of each sample shard of an ``n``-sample round: the
    round's 64-sample granules split as JAX splits steps (``g // S``, one
    more for the first ``g % S`` shards), the last shard also taking a
    sub-granule tail, so the shards cover [0, n) exactly once."""
    g, tail = divmod(int(n), KERNEL_GRANULE)
    per, extra = divmod(g, n_shards)
    out, lo = [], 0
    for j in range(n_shards):
        cnt = (per + (1 if j < extra else 0)) * KERNEL_GRANULE
        if j == n_shards - 1:
            cnt += tail
        out.append((lo, cnt))
        lo += cnt
    return out


def _cuda_sharded_counts(key, uids, configs, robot_wh, round_tag: int, *,
                         n_batch: int, mesh, shape_noise: bool = True,
                         poly_a_keep: tuple[int, ...] | None = None,
                         ca_iters: int = 48, ca_tol: float = 1e-4) -> torch.Tensor:
    """The fused kernels (1, 7, 13, 14 by configuration class) under a
    ``(config, sample)`` mesh: counterpart of JAX's
    ``_pallas_sharded_counts`` (estimator.py:578). Sample shard j of a
    config block runs the kernel's round on its own device over its
    contiguous range of sample indices (`_granule_ranges`, through the
    wrappers' ``offset``). The streams are keyed by (round seed, uid,
    sample index), so the summed counts equal the unsharded launch's bit
    for bit — a stronger contract than JAX's, whose kernel streams are
    tied to block position."""
    ranges = _granule_ranges(n_batch, _mesh_axis(mesh, "sample"))
    if isinstance(configs, (PolygonConfigs, MovingPolygonConfigs)):
        poly_a_keep = _a_keep(robot_wh, poly_a_keep)

    def shard(inputs, j):
        block, bu, robot = inputs
        offset, n = ranges[j]
        return _kernel_round(key, bu, block, robot, round_tag, n, offset=offset,
                             shape_noise=shape_noise, poly_a_keep=poly_a_keep,
                             ca_iters=ca_iters, ca_tol=ca_tol)

    return _mesh_counts(configs, uids, mesh, functools.partial(
        _replicas, robot_wh=robot_wh), shard)


def mc_round(key, uids, configs: Configs, robot_wh, chunk_offset: int, *,
             n_batch: int, step_samples: int = 0, use_vertices: bool = False,
             impl: str = "threefry", shape_noise: bool = True,
             poly_a_keep: tuple[int, ...] | None = None, ca_iters: int = 48,
             ca_tol: float = 1e-4, screen_impl: str = "auto",
             mesh=None) -> torch.Tensor:
    """One round: int32 (C,) collision counts of ``n_batch`` samples.
    `PolygonConfigs` batches take ``robot_wh`` as (K2, 2) robot vertices;
    ``poly_a_keep`` is their kernel's robot-axis subset
    (`ops.mc_polygon_cuda.dedup_robot_axes`; None = worked out here).

    Trajectory batches: `MovingConfigs` run kernel 13 on 'cuda' (its
    advancement loop on rotating rows unless ``ca_iters == 0``).
    `MovingPolygonConfigs` run kernel 14 on 'cuda', which has no
    advancement loop: it needs ``ca_iters == 0``, the caller's assertion
    that the batch is translation-only (the adaptive driver checks omega
    once); 'auto' resolves to kernel 14 only then, else to the threefry
    path.

    ``mesh`` (`parallel.make_mesh`): the round runs sharded over its
    config and sample axes (`_cuda_sharded_counts`,
    `_sample_sharded_counts`) with counts bitwise the unsharded round's,
    returned on ``configs``' device."""
    if isinstance(configs, MovingPolygonConfigs):
        if impl == "auto":
            impl = "cuda" if ca_iters == 0 else "threefry"
        elif impl == "cuda" and ca_iters > 0:
            raise ValueError(
                "impl='cuda' supports only TRANSLATION-ONLY MovingPolygonConfigs "
                "batches (pass ca_iters=0 after verifying omega == 0 everywhere, "
                "as the adaptive driver does; rotating trajectory k-gons run the "
                "threefry CA path — use 'threefry' or 'auto')")
    impl = resolve_impl(impl)
    if impl == "cuda":
        if mesh is not None:
            return _cuda_sharded_counts(
                key, uids, configs, robot_wh, chunk_offset, n_batch=n_batch,
                mesh=mesh, shape_noise=shape_noise, poly_a_keep=poly_a_keep,
                ca_iters=ca_iters, ca_tol=ca_tol)
        return _kernel_round(key, uids, configs, robot_wh, chunk_offset,
                             n_batch, shape_noise=shape_noise,
                             poly_a_keep=poly_a_keep, ca_iters=ca_iters,
                             ca_tol=ca_tol)
    if step_samples <= 0:
        step_samples = _largest_divisor_leq(n_batch, 512)
    if n_batch % step_samples:
        raise ValueError(f"step_samples={step_samples} must divide "
                         f"n_batch={n_batch}")
    if mesh is not None:
        return _sample_sharded_counts(
            key, uids, configs, robot_wh, chunk_offset, n_batch // step_samples,
            step_samples=step_samples, use_vertices=use_vertices, mesh=mesh,
            ca_iters=ca_iters, ca_tol=ca_tol, screen_impl=screen_impl)
    first = int(chunk_offset)
    return _threefry_counts(key, uids, configs, robot_wh,
                            range(first, first + n_batch // step_samples),
                            step_samples=step_samples, use_vertices=use_vertices,
                            ca_iters=ca_iters, ca_tol=ca_tol,
                            screen_impl=screen_impl)


def collision_probability(key, configs: Configs, robot_wh, n_samples: int, *,
                          step_samples: int = 0, use_vertices: bool = False,
                          impl: str = "threefry", ca_iters: int = 48,
                          ca_tol: float = 1e-4) -> torch.Tensor:
    """Fixed-sample-count Monte Carlo collision probability: float32 (C,).
    ``ca_iters``/``ca_tol`` apply to trajectory batches."""
    uids = torch.arange(configs.num, dtype=torch.int32,
                        device=configs.position.device)
    counts = mc_round(key, uids, configs, robot_wh, 0, n_batch=int(n_samples),
                      step_samples=step_samples, use_vertices=use_vertices,
                      impl=impl, ca_iters=ca_iters, ca_tol=ca_tol)
    return counts.to(torch.float32) / torch.tensor(
        float(n_samples), dtype=torch.float32, device=counts.device)


def collision_probability_pruned(key, configs: Configs, robot_wh, n_samples: int,
                                 *, sigma_margin: float = 6.0,
                                 step_samples: int = 0,
                                 use_vertices: bool = False,
                                 impl: str = "threefry") -> np.ndarray:
    """Fixed-budget probabilities with noise-aware broad-phase pruning.

    Rows that cannot touch within ``sigma_margin`` standard deviations
    (`ops.broad_phase.possible_collision_mask`) get 0 without sampling;
    the candidates are gathered into a ladder bucket (padded with the
    first candidate) and sampled with their ORIGINAL row ids as uids, so
    each candidate's estimate equals the unpruned `collision_probability`
    bit for bit on every impl (streams are keyed by uid). One host
    readback of the mask; returns a host float32 (C,) array."""
    from collide2d_tpu_torch.mc.driver import _round_up_bucket
    from collide2d_tpu_torch.ops.broad_phase import possible_collision_mask

    c = configs.num
    dev = configs.position.device
    robot = torch.as_tensor(robot_wh, dtype=torch.float32, device=dev)
    mask = possible_collision_mask(configs, robot, sigma_margin).cpu().numpy()
    out = np.zeros((c,), np.float32)
    idx = np.flatnonzero(mask)
    if idx.size == 0:
        return out
    bucket = min(_round_up_bucket(idx.size, 256), c)
    padded = np.concatenate([idx, np.full(bucket - idx.size, idx[0])])
    gather = torch.as_tensor(padded, dtype=torch.int64, device=dev)
    sub = type(configs)(*(a.index_select(0, gather) for a in configs))
    counts = mc_round(key, gather.to(torch.int32), sub, robot, 0,
                      n_batch=int(n_samples), step_samples=step_samples,
                      use_vertices=use_vertices, impl=impl)
    out[idx] = counts.cpu().numpy().astype(np.float32)[: idx.size] / np.float32(
        n_samples)
    return out


@dataclass(frozen=True)
class AdaptiveConfig:
    """Adaptive-stop schedule and accuracy targets (reference defaults:
    bins {0, .01, .1, 1} with targets {1e-4, 1e-3, 1e-2}, 1000 samples a
    round until 20k then 100000 a round, cap 4e6 —
    generate_dataset.cu:53-59, 427-430). ``fixed_batch`` overrides the
    two-phase schedule (ztest.cu:332 uses 10000). ``schedule`` is None,
    explicit cumulative checkpoints, or "tuned" (one extra checkpoint at
    the rule-of-three point, where zero-probability rows can first
    converge); the pipeline resolves "opt" into explicit checkpoints
    (`mc.schedule_sim.optimize_checkpoints`) before it builds this."""

    accuracy_bins: Sequence[float] = (0.0, 0.01, 0.1, 1.0)
    bin_accuracy: Sequence[float] = (0.0001, 0.001, 0.01)
    max_samples: int = 4_000_000
    initial_batch: int = 1_000
    initial_phase_samples: int = 20_000
    later_batch: int = 100_000
    fixed_batch: int | None = None
    step_samples: int = 0
    min_active: int = 256  # smallest compaction bucket
    use_vertices: bool = False
    impl: str = "auto"  # 'auto' | 'cuda' | 'threefry'
    schedule: Sequence[int] | str | None = None
    ladder: str = "eighth"  # repack bucket ladder (driver._round_up_bucket)
    # Noise-aware broad phase (0 = off, the reference's behaviour): rows
    # that cannot touch within this many standard deviations are emitted
    # as cp = 0 with zero samples and never enter the loop
    # (ops.broad_phase.possible_collision_mask).
    prune_sigma: float = 0.0
    # Trajectory batches (mc.moving): the advancement budget and contact
    # tolerance of rotating samples, and the rectangle cascade's stage A
    # ('auto' = kernel 15 on CUDA tensors, 'torch' = the torch screen).
    ca_iters: int = 48
    ca_tol: float = 1e-4
    screen_impl: str = "auto"

    def __post_init__(self):
        if self.ladder not in ("half", "quarter", "eighth", "sixteenth"):
            raise ValueError(f"ladder must be 'half', 'quarter', 'eighth' "
                             f"or 'sixteenth', got {self.ladder!r}")
        if len(self.bin_accuracy) != len(self.accuracy_bins) - 1:
            raise ValueError(
                f"bin_accuracy must have len(accuracy_bins) - 1 = "
                f"{len(self.accuracy_bins) - 1} entries, got "
                f"{len(self.bin_accuracy)}"
            )

    def checkpoints(self) -> tuple[int, ...] | None:
        if self.schedule is None:
            return None
        if self.schedule == "tuned":
            pts = [self.initial_batch * i
                   for i in range(1, self.initial_phase_samples // self.initial_batch + 1)]
            acc0 = float(self.bin_accuracy[0])
            if acc0 > 0:
                n3 = -(-int(np.ceil(stats._LOG_INV_ALPHA / acc0)) // 64) * 64
                if (not pts or n3 > pts[-1]) and n3 < self.max_samples:
                    pts.append(n3)
            return tuple(pts)
        return tuple(int(x) for x in self.schedule)

    def batch_for(self, n_samples_so_far: int) -> int:
        if self.fixed_batch is not None:
            return self.fixed_batch
        pts = self.checkpoints()
        if pts is not None:
            for p in pts:
                if p > n_samples_so_far:
                    return p - n_samples_so_far
            return self.later_batch
        if n_samples_so_far < self.initial_phase_samples:
            return self.initial_batch
        return self.later_batch


class _LoopState(NamedTuple):
    """Device-resident adaptive-loop state (one row per buffer slot)."""

    uids: torch.Tensor      # int32 original row id; -1 marks padding slots
    active: Configs
    n_true: torch.Tensor    # int32 running collision count
    done: torch.Tensor      # bool: has the stop criterion EVER held
    k_frozen: torch.Tensor  # int32 n_true at the first round it held
    n_frozen: torch.Tensor  # int32 n_samples at that round


def _fused_round(key, state: _LoopState, robot_wh, chunk_offset: int,
                 n_samples_after: int, n_rounds: int, nb: int,
                 chunk_step: int, *, step_samples: int, impl: str,
                 accuracy_bins, bin_accuracy, use_vertices: bool = False,
                 shape_noise: bool = True,
                 poly_a_keep: tuple[int, ...] | None = None,
                 ca_iters: int = 48, ca_tol: float = 1e-4,
                 screen_impl: str = "auto", mesh=None,
                 table: torch.Tensor | None = None,
                 ) -> tuple[_LoopState, torch.Tensor]:
    """``n_rounds`` same-plan rounds with convergence and label freezing.

    Round r draws with tag ``chunk_offset + r * chunk_step`` and tests
    convergence at ``n_samples_after + r * nb``; labels freeze at the
    first round the criterion holds (generate_dataset.cu:455-464). Returns
    the new state and the device-resident count of done real rows. Under a
    ``mesh`` only the round counts are sharded (`mc_round`); the state
    stays on its device.

    ``table``: ``state.active``'s table from `pack_round_table`: no round
    packs it, and the fused kernel adds its counts straight into
    ``n_true``; None = each round packs its own (`mc_round`). Each round's
    update is `ops.round_epilogue_cuda.round_update` (one epilogue launch on
    CUDA tensors), which updates the state's tensors IN PLACE: the returned
    state is ``state``. ``n_rounds`` is at least 1."""
    if int(n_rounds) < 1:
        raise ValueError(f"n_rounds must be at least 1, got {n_rounds}")
    for r in range(int(n_rounds)):
        tag = int(chunk_offset) + r * int(chunk_step)
        if table is None:
            counts = mc_round(key, state.uids, state.active, robot_wh, tag,
                              n_batch=nb, step_samples=step_samples,
                              use_vertices=use_vertices, impl=impl,
                              shape_noise=shape_noise, poly_a_keep=poly_a_keep,
                              ca_iters=ca_iters, ca_tol=ca_tol,
                              screen_impl=screen_impl, mesh=mesh)
        else:  # the counts land in n_true
            counts = None
            _kernel_round(key, state.uids, state.active, robot_wh, tag, nb,
                          shape_noise=shape_noise, poly_a_keep=poly_a_keep,
                          ca_iters=ca_iters, ca_tol=ca_tol, table=table,
                          out=state.n_true)
        *_, num_done = round_epilogue_cuda.round_update(
            state.n_true, state.done, state.k_frozen, state.n_frozen, counts,
            int(n_samples_after) + r * int(nb), accuracy_bins, bin_accuracy,
            uids=state.uids if r == int(n_rounds) - 1 else None)
    return state, num_done
