"""Trajectory collision probability: Monte Carlo over moving robots.

Counterpart of ``collide2d_tpu/mc/moving.py``. A planner validating an
edge needs P(the MOTION collides): the robot starts at a configuration's
(position, pose_theta), translates with ``velocity`` and rotates with
``omega`` about its own origin for ``t in [0, t_max]``, and the noisy
obstacle (the dataset's noise model, static during the motion) is hit at
any time along the way. The per-sample predicate:

- non-rotating samples (omega == 0) are decided EXACTLY by the
  first-contact window of the SAT axes (`ops.toi.obb_translation_toi_parts`
  for boxes, `polygon_translation_toi_parts` for k-gons); at zero motion
  it is the static test, so zero-motion batches reproduce the static
  counts bit for bit;
- rotating samples keep the certified-hit contract of `ops.toi`: a hit is
  a time with d(t) <= tol. They run the certified screening cascade: a
  paired inflated/eroded proxy screen over ``N_SCREEN_COARSE`` horizon
  segments (stage A) decides most lanes in closed form; only rows holding
  an ambiguous lane run ``ca_iters`` steps of conservative advancement,
  warm-started at the screen's certified no-contact-before bound
  (stage C). ``ca_screen=False`` keeps the pure advancement loop.

Per-config ``t_max`` folds into the motion (v t_max, omega t_max on a
unit horizon). The JAX package's stage-B rescreen is not ported: it is
dead code at ``N_SCREEN_FINE = 0``.

Ambiguous rows are gathered all at once (one ``nonzero``, one
``index_select`` per array) where JAX walks fixed-size chunks in a device
``while_loop``: every row's result is independent of its position, so the
two are the same function, and the host reads the row count once per
threefry step. On a CUDA tensor stage A of the rectangle cascade is
kernel 15 (`ops.screen_cuda`, ``screen_impl='cuda'``, the default there);
``screen_impl='torch'`` keeps the torch screen.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from collide2d_tpu_torch.mc import prng
from collide2d_tpu_torch.ops.distance import polygon_signed_distance
from collide2d_tpu_torch.ops.distance_cuda import obb_signed_distance_tile
from collide2d_tpu_torch.ops.geometry import (
    edge_normals,
    polygon_edges,
    transform_vertices,
)
from collide2d_tpu_torch.ops.sat import _project_all, sat_polygons
from collide2d_tpu_torch.ops.toi import (
    _advance,
    obb_translation_toi_parts,
    polygon_translation_toi_parts,
)

CA_ITERS = 48   # default advancement budget per rotating sample
# Default contact tolerance; positive for moving samples (advancement
# approaches a transversal contact from below and never crosses it). tol
# = 0 is meaningful only at zero motion, where the predicate is the static
# sign test d(0) <= 0.
CA_TOL = 1e-4
N_SCREEN_COARSE = 8   # stage-A horizon segments
# The k-gon screen's (rows, K2, K, S) projection tables are built for at
# most this many float32 elements at a time: larger steps run the
# configuration axis in chunks (results do not depend on a row's position).
POLY_SCREEN_ELEMS = 1 << 28
SCREEN_IMPLS = ("auto", "cuda", "torch")
_f32 = prng._f32  # a Python float rounded to float32 (a JAX f32(...) constant)


class MovingConfigs(NamedTuple):
    """A batch of C trajectory configurations for the rectangle model.

    The first four fields are `estimator.Configs`' (so compaction and
    pruning treat the type generically); the motion extends each row:

    position:    (C, 2) robot centre at t = 0, obstacle frame
    pose_theta:  (C,)   robot orientation at t = 0
    obstacle_wh: (C, 2) obstacle width/height (obstacle at the origin)
    std_dev:     (C, 5) noise sigmas (x, y, theta, width, height)
    velocity:    (C, 2) robot centre velocity (units / unit time)
    omega:       (C,)   robot angular rate about its centre (rad / time)
    t_max:       (C,)   motion horizon
    """

    position: torch.Tensor
    pose_theta: torch.Tensor
    obstacle_wh: torch.Tensor
    std_dev: torch.Tensor
    velocity: torch.Tensor
    omega: torch.Tensor
    t_max: torch.Tensor

    @property
    def num(self) -> int:
        return self.position.shape[0]


class MovingPolygonConfigs(NamedTuple):
    """A batch of C trajectory configurations with convex k-gon shapes.

    Noise is `PolygonConfigs`' pose noise (std_dev (C, 3)); the motion is
    `MovingConfigs`'. The robot is passed where rectangle calls pass
    ``robot_wh``: a (K2, 2) CCW vertex array in the robot frame, rotating
    about its origin.

    position:       (C, 2)    robot origin at t = 0, obstacle frame
    pose_theta:     (C,)      robot orientation at t = 0
    obstacle_verts: (C, K, 2) CCW convex vertices (repeat-padded)
    std_dev:        (C, 3)    noise sigmas (x, y, theta)
    velocity:       (C, 2)    robot origin velocity
    omega:          (C,)      robot angular rate about its origin
    t_max:          (C,)      motion horizon
    """

    position: torch.Tensor
    pose_theta: torch.Tensor
    obstacle_verts: torch.Tensor
    std_dev: torch.Tensor
    velocity: torch.Tensor
    omega: torch.Tensor
    t_max: torch.Tensor

    @property
    def num(self) -> int:
        return self.position.shape[0]


def _as_f32(x, device=None) -> torch.Tensor:
    """A float32 tensor of ``x`` (a tensor keeps its device unless one is
    given; arrays and numbers are copied)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=torch.float32, device=device)
    return torch.tensor(np.array(x, np.float32), device=device)


def _broadcast(x, shape, device) -> torch.Tensor:
    return torch.broadcast_to(_as_f32(x, device), shape).contiguous()


def moving_configs(position, pose_theta, obstacle_wh, std_dev, velocity,
                   omega=0.0, t_max=1.0, *, device=None) -> MovingConfigs:
    """Broadcasting constructor: scalars and row vectors expand to
    (C, ...) float32 tensors on ``device`` (default: ``position``'s)."""
    position = _as_f32(position, device)
    dev = position.device
    c = position.shape[0]
    return MovingConfigs(
        position=position,
        pose_theta=_broadcast(pose_theta, (c,), dev),
        obstacle_wh=_broadcast(obstacle_wh, (c, 2), dev),
        std_dev=_broadcast(std_dev, (c, 5), dev),
        velocity=_broadcast(velocity, (c, 2), dev),
        omega=_broadcast(omega, (c,), dev),
        t_max=_broadcast(t_max, (c,), dev),
    )


def moving_polygon_configs(position, pose_theta, obstacle_verts, std_dev,
                           velocity, omega=0.0, t_max=1.0, *,
                           device=None) -> MovingPolygonConfigs:
    """Broadcasting constructor: scalars and row vectors expand to
    (C, ...) float32 tensors on ``device`` (default: ``position``'s)."""
    position = _as_f32(position, device)
    dev = position.device
    c = position.shape[0]
    verts = _as_f32(obstacle_verts, dev)
    if verts.dim() != 3 or verts.shape[0] != c or verts.shape[2] != 2:
        raise ValueError("moving_polygon_configs: obstacle_verts must be "
                         f"(C, K, 2) with C={c}, got {tuple(verts.shape)}")
    return MovingPolygonConfigs(
        position=position,
        pose_theta=_broadcast(pose_theta, (c,), dev),
        obstacle_verts=verts,
        std_dev=_broadcast(std_dev, (c, 3), dev),
        velocity=_broadcast(velocity, (c, 2), dev),
        omega=_broadcast(omega, (c,), dev),
        t_max=_broadcast(t_max, (c,), dev),
    )


def moving_configs_from_numpy(configs, device) -> MovingConfigs:
    """The JAX package's `MovingConfigs` (or any 7-field tuple of arrays),
    taken as numpy arrays, as the port's float32 tensors on ``device``."""
    return MovingConfigs(*(_as_f32(a, device) for a in configs))


def moving_polygon_configs_from_numpy(configs, device) -> MovingPolygonConfigs:
    """The JAX package's `MovingPolygonConfigs` (or any 7-field tuple of
    arrays), as the port's float32 tensors on ``device``."""
    return MovingPolygonConfigs(*(_as_f32(a, device) for a in configs))


def _rows_where(mask_rows: torch.Tensor) -> torch.Tensor:
    """int64 ids of the rows where ``mask_rows`` holds (one host sync)."""
    return torch.nonzero(mask_rows).reshape(-1)


def _resolve_screen(screen_impl: str, x: torch.Tensor) -> str:
    if screen_impl not in SCREEN_IMPLS:
        raise ValueError(f"screen_impl must be one of {SCREEN_IMPLS}, got "
                         f"{screen_impl!r}")
    if screen_impl == "auto":
        return "cuda" if x.is_cuda else "torch"
    return screen_impl


def _paired_segment_screen(ox, oy, c2, s2, hx2, hy2, px, py, vx, vy, th0, w,
                           hx1, hy1, r_rob, tol, n_seg):
    """Certified screening pass over (C, S) lanes: paired inflated/eroded
    proxy-box tests on ``n_seg`` horizon segments.

    Per segment the robot is frozen at its midpoint angle; every vertex of
    the truly rotating robot stays within delta = 2 r sin(min(|w| /
    (2 n_seg), pi) / 2) of that proxy (r the robot circumradius). A SAT
    axis separating the (delta + tol)-inflated proxy from the obstacle over
    the whole segment proves d(t) > tol there (a MISS certificate); the
    proxy eroded by delta (or, when delta exceeds an extent, the inscribed
    square of the robot's in-circle) overlapping the obstacle at the
    segment midpoint proves penetration (a certified HIT). Per axis the
    minimum of |p0 + t s| over [a, b] is 0 on a sign change, else the
    nearer endpoint (no division). All trigonometry is per configuration
    ((C, n_seg) segment angles).

    Per-lane arguments are (C, S), per-config ones (C, 1). Returns
    ``(maybe, hit_cert, t_first)``: any possibly-colliding segment, any
    certified-hit segment, and the start of the earliest maybe-segment (a
    certified no-contact-before time; +inf where no segment may collide).
    """
    dev = ox.device
    ii = torch.arange(n_seg, dtype=torch.float32, device=dev)
    a_ = ii * (1.0 / n_seg)
    b_ = a_ + (1.0 / n_seg)
    tm_ = a_ + (0.5 / n_seg)
    thm = th0 + (ii + 0.5) * (w * (1.0 / n_seg))  # (C, n_seg)
    cm, sm = torch.cos(thm), torch.sin(thm)
    delta = 2.0 * r_rob * torch.sin(
        torch.clamp(w.abs() * (0.5 / n_seg), max=_f32(math.pi)) * 0.5)
    d_in = delta + _f32(tol)
    q = torch.minimum(hx1, hy1) * _f32(0.7071067)  # inscribed-square half
    valid_er = delta < torch.minimum(hx1, hy1)
    ex_er = torch.where(valid_er, hx1 - delta, q)
    ey_er = torch.where(valid_er, hy1 - delta, q)
    ex_in, ey_in = hx1 + d_in, hy1 + d_in

    dx, dy = ox - px, oy - py
    vrx, vry = -vx, -vy  # obstacle velocity relative to the robot

    def E(lane):  # lanes (C, S) or per-config (C, 1) -> (C, 1, S)
        return lane[:, None, :]

    def G(seg_):  # segments (C, n_seg) -> (C, n_seg, 1)
        return seg_[..., None]

    a_, b_, tm_ = a_[:, None], b_[:, None], tm_[:, None]
    cmG, smG = G(cm), G(sm)
    cd = (cmG * E(c2) + smG * E(s2)).abs()
    sd = (smG * E(c2) - cmG * E(s2)).abs()
    # 4 SAT axes: (offset, speed, shared radius, inflated and eroded robot
    # radius), so the two tests reuse every projection
    axes = (
        (E(dx) * cmG + E(dy) * smG, E(vrx) * cmG + E(vry) * smG,
         E(hx2) * cd + E(hy2) * sd, E(ex_in), E(ex_er)),
        (-E(dx) * smG + E(dy) * cmG, -E(vrx) * smG + E(vry) * cmG,
         E(hx2) * sd + E(hy2) * cd, E(ey_in), E(ey_er)),
        (E(dx * c2 + dy * s2), E(vrx * c2 + vry * s2), E(hx2),
         E(ex_in) * cd + E(ey_in) * sd, E(ex_er) * cd + E(ey_er) * sd),
        (E(-dx * s2 + dy * c2), E(-vrx * s2 + vry * c2), E(hy2),
         E(ex_in) * sd + E(ey_in) * cd, E(ex_er) * sd + E(ey_er) * cd),
    )
    seg_maybe = seg_hit = None
    for p0, s_, r_sh, r_add_i, r_add_e in axes:
        pa = p0 + a_ * s_
        pb = p0 + b_ * s_
        mn = torch.where(pa * pb <= 0, 0.0, torch.minimum(pa.abs(), pb.abs()))
        ok_i = mn <= r_sh + r_add_i
        ok_e = (p0 + tm_ * s_).abs() <= r_sh + r_add_e
        seg_maybe = ok_i if seg_maybe is None else seg_maybe & ok_i
        seg_hit = ok_e if seg_hit is None else seg_hit & ok_e
    maybe = seg_maybe.any(dim=-2)
    hit_cert = seg_hit.any(dim=-2)
    t_first = torch.where(seg_maybe, a_, math.inf).amin(dim=-2)
    return maybe, hit_cert, t_first


def warm_start(t_first: torch.Tensor) -> torch.Tensor:
    """The advancement's warm start from a screen's first-maybe time:
    clip(where(isfinite(t), t, 2), 0, 2)."""
    return torch.clamp(torch.where(torch.isfinite(t_first), t_first, 2.0), 0.0, 2.0)


def _rect_advancement(amb, t0, bound, ox, oy, c2, s2, hx2, hy2, px, py, vx, vy,
                      th0, w, hx1, hy1, ca_iters, tol) -> torch.Tensor:
    """Stage C of the rectangle cascade on gathered rows (lanes (r, S),
    per-config (r, 1)): the warm-started advancement; returns the certified
    hits of the ambiguous lanes, (r, S)."""
    def dist_g(t):
        a1 = th0 + t * w
        return obb_signed_distance_tile(
            ox - (px + t * vx), oy - (py + t * vy), torch.cos(a1),
            torch.sin(a1), hx1, hy1, c2, s2, hx2, hy2)

    toi = _advance(dist_g, bound, 1.0, ca_iters, _f32(tol), t0=t0)
    return amb & torch.isfinite(toi)


def _screened_rotating_hits(ox, oy, c2, s2, hx2, hy2, px, py, vx, vy, th0, w,
                            hx1, hy1, r_rob, bound, rotating, hit_at_0,
                            ca_iters, tol):
    """The certified screening cascade for rotating samples: stage A
    (`_paired_segment_screen` plus the caller's t = 0 overlap test) on
    every lane, then stage C (warm-started advancement, full ``ca_iters``
    budget) on the rows holding an ambiguous lane. A stage-A-decided lane
    keeps its verdict wherever its row lands, so counts do not depend on
    compaction. Returns ``(hits, (maybe, hit_cert, ambiguous))``."""
    maybe_a, hit_a, t_first_a = _paired_segment_screen(
        ox, oy, c2, s2, hx2, hy2, px, py, vx, vy, th0, w, hx1, hy1, r_rob,
        tol, N_SCREEN_COARSE)
    hit_a = hit_a | hit_at_0
    amb_a = rotating & maybe_a & ~hit_a
    rows = _rows_where(amb_a.any(dim=1))
    ca_hits = torch.zeros_like(amb_a)
    if rows.numel():
        g = lambda a: a.index_select(0, rows)  # noqa: E731
        ca_hits.index_copy_(0, rows, _rect_advancement(
            *map(g, (amb_a, warm_start(t_first_a), bound, ox, oy, c2, s2, hx2,
                     hy2, px, py, vx, vy, th0, w, hx1, hy1)), ca_iters, tol))
    return hit_a | ca_hits, (maybe_a, hit_a, amb_a)


def _robot_wh(robot_wh, configs) -> torch.Tensor:
    rw = torch.as_tensor(robot_wh, dtype=torch.float32,
                         device=configs.position.device)
    return torch.broadcast_to(rw, configs.position.shape)


def _motion(configs, rw):
    """Per-config motion on the unit horizon: (v_eff (C, 2), w_eff (C,),
    r_rob (C,), bound (C,))."""
    v_eff = configs.velocity * configs.t_max[:, None]
    w_eff = configs.omega * configs.t_max
    r_rob = 0.5 * torch.hypot(rw[:, 0], rw[:, 1])
    bound = torch.hypot(v_eff[:, 0], v_eff[:, 1]) + w_eff.abs() * r_rob
    return v_eff, w_eff, r_rob, bound


def counts_chunk_moving(keys, configs: MovingConfigs, robot_wh, n_lanes: int, *,
                        ca_iters: int = CA_ITERS, tol: float = CA_TOL,
                        ca_screen: bool = True, return_screen_masks: bool = False,
                        screen_impl: str = "auto"):
    """Motion-collision count over ``n_lanes`` threefry samples per
    configuration: int32 (C,). The drop-in for `estimator._counts_chunk`'s
    rectangle path, with the same keys and the same (n_lanes, 5) normal
    draws, so a zero-motion batch reproduces the static counts bitwise.

    ``ca_screen`` (default on) runs rotating samples through the certified
    cascade (`_screened_rotating_hits`); False keeps the pure advancement.
    ``return_screen_masks`` also returns the stage-A (maybe, hit_cert,
    ambiguous) (C, S) masks. ``screen_impl``: 'cuda' fuses stage A into
    kernel 15 (`_counts_chunk_fused_screen`; its plain version on a CPU
    tensor), 'torch' keeps the torch screen, 'auto' (default) is 'cuda' on
    CUDA tensors. ``ca_iters == 0`` asserts a translation-only batch."""
    z = prng.normal(keys, (n_lanes, 5))
    if _resolve_screen(screen_impl, z) == "cuda" and ca_screen and ca_iters > 0:
        return _counts_chunk_fused_screen(z, configs, robot_wh, ca_iters, tol,
                                          return_screen_masks)
    d = z * configs.std_dev[:, None, :]  # (C, S, 5)
    rw = _robot_wh(robot_wh, configs)
    hx1 = rw[:, 0:1].abs() * 0.5  # (C, 1)
    hy1 = rw[:, 1:2].abs() * 0.5
    # the noisy obstacle, static during the motion (the static chunk's
    # obb_collide expressions)
    ext2 = configs.obstacle_wh[:, None, :] + d[..., 3:5]
    hx2 = ext2[..., 0].abs() * 0.5
    hy2 = ext2[..., 1].abs() * 0.5
    c2_, s2_ = torch.cos(d[..., 2]), torch.sin(d[..., 2])
    ox, oy = d[..., 0], d[..., 1]

    v_eff, w_eff, r_rob, bound = _motion(configs, rw)
    bound = bound[:, None].expand_as(ox)
    px, py = configs.position[:, 0:1], configs.position[:, 1:2]
    vx, vy = v_eff[:, 0:1], v_eff[:, 1:2]
    th0 = configs.pose_theta[:, None]
    w = w_eff[:, None]

    # non-rotating lanes: the exact first-contact window
    c1_, s1_ = torch.cos(th0), torch.sin(th0)
    entry, exit_ = obb_translation_toi_parts(
        ox - px, oy - py, c1_, s1_, hx1, hy1, c2_, s2_, hx2, hy2, -vx, -vy)
    hit_exact = (entry <= exit_) & (entry <= 1.0) & (exit_ >= 0)

    masks = None
    if ca_iters > 0:
        rotating = w != 0  # (C, 1)
        if ca_screen:
            # certified t = 0 penetration: the 4-axis SAT gap test
            cd0 = (c1_ * c2_ + s1_ * s2_).abs()
            sd0 = (s1_ * c2_ - c1_ * s2_).abs()
            dx0, dy0 = ox - px, oy - py
            hit_at_0 = (
                ((dx0 * c1_ + dy0 * s1_).abs() <= hx1 + hx2 * cd0 + hy2 * sd0)
                & ((-dx0 * s1_ + dy0 * c1_).abs() <= hy1 + hx2 * sd0 + hy2 * cd0)
                & ((dx0 * c2_ + dy0 * s2_).abs() <= hx2 + hx1 * cd0 + hy1 * sd0)
                & ((-dx0 * s2_ + dy0 * c2_).abs() <= hy2 + hx1 * sd0 + hy1 * cd0))
            hit_rot, masks = _screened_rotating_hits(
                ox, oy, c2_, s2_, hx2, hy2, px, py, vx, vy, th0, w, hx1, hy1,
                r_rob[:, None], bound, rotating, hit_at_0, ca_iters, tol)
        else:
            def dist_of_t(t):
                a1 = th0 + t * w
                return obb_signed_distance_tile(
                    ox - (px + t * vx), oy - (py + t * vy), torch.cos(a1),
                    torch.sin(a1), hx1, hy1, c2_, s2_, hx2, hy2)

            hit_rot = torch.isfinite(_advance(dist_of_t, bound, 1.0, ca_iters,
                                              _f32(tol)))
        hit = torch.where(rotating, hit_rot, hit_exact)
    else:
        hit = hit_exact
    counts = hit.sum(dim=-1, dtype=torch.int32)
    if return_screen_masks:
        if masks is None:
            raise ValueError("return_screen_masks requires ca_screen=True and "
                             "ca_iters > 0")
        return counts, masks
    return counts


def _counts_chunk_fused_screen(z, configs: MovingConfigs, robot_wh, ca_iters,
                               tol, return_screen_masks):
    """The rotating cascade with stage A fused into kernel 15
    (`ops.screen_cuda.rotating_screen`): one pass over the draws z (C, S,
    5) and 16 per-config scalars writes the per-lane {maybe, certified hit,
    window verdict} flags and the warm start; only the rows holding
    ambiguity rebuild their obstacles (from the same z rows) for the
    advancement. Same lane verdicts as the torch cascade where the screen's
    arithmetic agrees."""
    from collide2d_tpu_torch.ops import screen_cuda

    rw = _robot_wh(robot_wh, configs)
    flags, t0_full = screen_cuda.rotating_screen(
        z, screen_cuda.pack_screen_params(configs, rw), n_seg=N_SCREEN_COARSE,
        tol=tol)
    maybe_a = (flags & 1) != 0
    hit_a = (flags & 2) != 0
    hit_exact = (flags & 4) != 0

    v_eff, w_eff, _, bound = _motion(configs, rw)
    rotating = (w_eff != 0)[:, None]
    amb_a = rotating & maybe_a & ~hit_a
    rows = _rows_where(amb_a.any(dim=1))
    ca_hits = torch.zeros_like(amb_a)
    if rows.numel():
        # rebuild only the gathered rows' obstacles from their draws
        g = lambda a: a.index_select(0, rows)  # noqa: E731
        col = lambda a: g(a)[:, None]  # noqa: E731
        dg = g(z) * g(configs.std_dev)[:, None, :]
        ext = g(configs.obstacle_wh)[:, None, :] + dg[..., 3:5]
        ca_hits.index_copy_(0, rows, _rect_advancement(
            g(amb_a), g(t0_full), col(bound).expand(-1, z.shape[1]),
            dg[..., 0], dg[..., 1], torch.cos(dg[..., 2]), torch.sin(dg[..., 2]),
            ext[..., 0].abs() * 0.5, ext[..., 1].abs() * 0.5,
            col(configs.position[:, 0]), col(configs.position[:, 1]),
            col(v_eff[:, 0]), col(v_eff[:, 1]), col(configs.pose_theta),
            col(w_eff), col(rw[:, 0].abs() * 0.5), col(rw[:, 1].abs() * 0.5),
            ca_iters, tol))
    hit = torch.where(rotating, hit_a | ca_hits, hit_exact)
    counts = hit.sum(dim=-1, dtype=torch.int32)
    if return_screen_masks:
        return counts, (maybe_a, hit_a, amb_a)
    return counts


def _polygon_segment_screen(obstacle, obs_axes, obs_alen, m2o, M2o, s2o, rv,
                            rv_len, lam, er_valid, r_rob, px, py, vx, vy, th0,
                            w, tol, n_seg):
    """The certified screening pass for rotating k-gon lanes, the polygon
    analogue of `_paired_segment_screen`.

    MISS: the rotating robot lies inside the frozen proxy inflated by
    delta, which widens its support interval on an axis ``a`` by delta |a|;
    if a true edge normal of either polygon separates the inflated proxy
    from the obstacle across a segment (endpoint tests of the linear-in-t
    overlap conditions), then d(t) > tol there. HIT: the robot scaled by
    ``lam`` = 1 - delta / r_in about its origin lies inside the true
    rotating robot through the segment, so its exact SAT overlap with the
    obstacle at the segment midpoint proves penetration (off per config
    where delta >= r_in, ``er_valid``).

    A rotation inside a dot product is a cos/sin blend of segment-invariant
    projections, so the four (C, kA, kV, S) projection tables are built
    once and a segment costs one blend per entry (a Python loop over the
    segments frees each segment's 4-D transient before the next). Returns
    ``(maybe, hit_cert, t_first)`` as the rectangle screen."""
    dev = obstacle.device
    ii = torch.arange(n_seg, dtype=torch.float32, device=dev)
    thm = th0 + (ii[None, :] + 0.5) * (w * (1.0 / n_seg))  # (C, seg)
    cm, sm = torch.cos(thm), torch.sin(thm)
    delta = 2.0 * r_rob * torch.sin(
        torch.clamp(w.abs() * (0.5 / n_seg), max=_f32(math.pi)) * 0.5) + _f32(tol)

    # segment-invariant tables, the sample axis last
    rn = edge_normals(rv)                               # (K2, 2) robot axes
    oxT = obstacle[..., 0].transpose(1, 2)              # (C, K, S)
    oyT = obstacle[..., 1].transpose(1, 2)
    A = (rn[:, 0][:, None, None] * oxT[:, None]
         + rn[:, 1][:, None, None] * oyT[:, None])      # (C, K2, K, S)
    B = (-rn[:, 1][:, None, None] * oxT[:, None]
         + rn[:, 0][:, None, None] * oyT[:, None])
    sp = rn[:, 0][:, None] * rv[None, :, 0] + rn[:, 1][:, None] * rv[None, :, 1]
    m1b, M1b = sp.amin(dim=-1), sp.amax(dim=-1)         # (K2,)
    np_ = rn[None, :, 0] * px + rn[None, :, 1] * py     # (C, K2)
    npp = -rn[None, :, 1] * px + rn[None, :, 0] * py
    nv = rn[None, :, 0] * (-vx) + rn[None, :, 1] * (-vy)
    nvp = -rn[None, :, 1] * (-vx) + rn[None, :, 0] * (-vy)
    axT = obs_axes[..., 0].transpose(1, 2)              # (C, K, S)
    ayT = obs_axes[..., 1].transpose(1, 2)
    U = (axT[:, :, None] * rv[None, None, :, 0, None]
         + ayT[:, :, None] * rv[None, None, :, 1, None])  # (C, K, K2, S)
    V = (axT[:, :, None] * (-rv[None, None, :, 1, None])
         + ayT[:, :, None] * rv[None, None, :, 0, None])
    pxE, pyE = px[:, 0][:, None, None], py[:, 0][:, None, None]
    W = axT * pxE + ayT * pyE                           # (C, K, S): a.p
    m2oT, M2oT, s2oT = (a.transpose(1, 2) for a in (m2o, M2o, s2o))

    cmC, smC = cm[:, None, :], sm[:, None, :]
    off = cmC * np_[..., None] + smC * npp[..., None]   # (C, K2, seg)
    s1 = cmC * nv[..., None] + smC * nvp[..., None]
    dl1 = (delta[:, 0][:, None] * rv_len[0, 0][None])[..., None]  # (C, K2, 1)
    dL2 = (delta * obs_alen)[..., None]                 # (C, K, 1)
    lamE = lam[:, 0][:, None, None]
    erv = er_valid[:, 0][:, None]
    inv_n = 1.0 / n_seg

    def axis_maybe(m1, M1, m2, M2, s, dL, a, b):
        # overlap(t): m2 + t s <= M1 + dL and m1 - dL <= M2 + t s, each
        # linear in t: the endpoint minimum over [a, b]
        f1a = m2 + _f32(a) * s - (M1 + dL)
        f1b = m2 + _f32(b) * s - (M1 + dL)
        f2a = (m1 - dL) - (M2 + _f32(a) * s)
        f2b = (m1 - dL) - (M2 + _f32(b) * s)
        return (torch.minimum(f1a, f1b) <= 0) & (torch.minimum(f2a, f2b) <= 0)

    maybe = hit_cert = t_first = None
    for i in range(n_seg):
        a, b, tm = i * inv_n, (i + 1) * inv_n, (i + 0.5) * inv_n
        cmi = cm[:, i][:, None, None, None]
        smi = sm[:, i][:, None, None, None]
        prj = cmi * A + smi * B                         # (C, K2, K, S)
        m2r, M2r = prj.amin(dim=-2), prj.amax(dim=-2)   # (C, K2, S)
        offi = off[:, :, i][..., None]
        s1i = s1[:, :, i][..., None]
        m1r = m1b[None, :, None] + offi
        M1r = M1b[None, :, None] + offi
        okR = axis_maybe(m1r, M1r, m2r, M2r, s1i, dl1, a, b).all(dim=1)
        pro = cmi * U + smi * V                         # (C, K, K2, S)
        mro, Mro = pro.amin(dim=-2), pro.amax(dim=-2)   # (C, K, S)
        okO = axis_maybe(W + mro, W + Mro, m2oT, M2oT, s2oT, dL2, a, b).all(dim=1)
        seg_maybe = okR & okO
        # the lam-scaled robot at the segment midpoint, exact overlap
        offmi = offi - _f32(tm) * s1i
        okjR = ((lamE * M1b[None, :, None] + offmi >= m2r)
                & (lamE * m1b[None, :, None] + offmi <= M2r))
        shift = W - _f32(tm) * s2oT
        okjO = (lamE * Mro + shift >= m2oT) & (lamE * mro + shift <= M2oT)
        seg_hit = okjR.all(dim=1) & okjO.all(dim=1) & erv
        first = torch.where(seg_maybe, _f32(a), math.inf)
        maybe = seg_maybe if maybe is None else maybe | seg_maybe
        hit_cert = seg_hit if hit_cert is None else hit_cert | seg_hit
        t_first = first if t_first is None else torch.minimum(t_first, first)
    return maybe, hit_cert, t_first


def _polygon_hits(z, configs: MovingPolygonConfigs, rv, ca_iters, tol,
                  ca_screen):
    """(hits (C, S), stage-A masks or None) of one chunk of k-gon lanes."""
    d = z * configs.std_dev[:, None, :]  # (C, S, 3)
    robot0 = transform_vertices(rv[None], configs.position[:, 0],
                                configs.position[:, 1], configs.pose_theta)[:, None]
    obstacle = transform_vertices(configs.obstacle_verts[:, None], d[..., 0],
                                  d[..., 1], d[..., 2])  # (C, S, K, 2)
    s_ = obstacle.shape[1]
    robot0_b = robot0.expand(-1, s_, -1, -1)
    v_eff = configs.velocity * configs.t_max[:, None]
    w_eff = configs.omega * configs.t_max

    # non-rotating lanes: the exact window over both polygons' normals
    v_obs = (-v_eff[:, None, :]).expand(-1, s_, -1)
    entry, exit_ = polygon_translation_toi_parts(robot0_b, obstacle, v_obs)
    hit_exact = (entry <= exit_) & (entry <= 1.0) & (exit_ >= 0)
    if ca_iters <= 0:
        return hit_exact, None

    rotating = (w_eff != 0)[:, None]
    r_rob = torch.hypot(rv[..., 0], rv[..., 1]).amax()
    bound = torch.clamp(torch.hypot(v_eff[:, 0], v_eff[:, 1]) + w_eff.abs() * r_rob,
                        min=1e-30)[:, None].expand(-1, s_)
    px, py = configs.position[:, 0:1], configs.position[:, 1:2]
    th0, w = configs.pose_theta[:, None], w_eff[:, None]
    vx, vy = v_eff[:, 0:1], v_eff[:, 1:2]
    if not ca_screen:
        def dist_of_t(t):
            robot_t = transform_vertices(rv[None, None], px + t * vx, py + t * vy,
                                         th0 + t * w)
            return polygon_signed_distance(robot_t, obstacle)

        hit_rot = torch.isfinite(_advance(dist_of_t, bound, 1.0, ca_iters,
                                          _f32(tol)))
        return torch.where(rotating, hit_rot, hit_exact), None

    # segment-invariant obstacle quantities, once
    obs_axes = edge_normals(obstacle)  # (C, S, K, 2)
    pr2o = _project_all(obs_axes, obstacle)
    m2o, M2o = pr2o.amin(dim=-1), pr2o.amax(dim=-1)
    s2o = obs_axes[..., 0] * (-vx[..., None]) + obs_axes[..., 1] * (-vy[..., None])
    base_edges = polygon_edges(configs.obstacle_verts)
    obs_alen = torch.hypot(base_edges[..., 0], base_edges[..., 1])
    rv_edges = polygon_edges(rv)
    rv_len = torch.hypot(rv_edges[..., 0], rv_edges[..., 1])[None, None]
    rv_n = edge_normals(rv)
    r_in0 = ((rv[..., 0] * rv_n[..., 0] + rv[..., 1] * rv_n[..., 1])
             / torch.clamp(torch.hypot(rv_n[..., 0], rv_n[..., 1]), min=1e-30)).amin()
    delta_cfg = 2.0 * r_rob * torch.sin(
        torch.clamp(w.abs() * (0.5 / N_SCREEN_COARSE), max=_f32(math.pi)) * 0.5
    ) + _f32(tol)
    er_valid = (r_in0 > 0) & (delta_cfg < r_in0)
    lam = torch.clamp(1.0 - delta_cfg / torch.clamp(r_in0, min=1e-30), 0.0, 1.0)

    hit0 = sat_polygons(robot0_b, obstacle) == 1
    maybe_a, hit_a, t_first_a = _polygon_segment_screen(
        obstacle, obs_axes, obs_alen, m2o, M2o, s2o, rv, rv_len, lam, er_valid,
        r_rob, px, py, vx, vy, th0, w, tol, N_SCREEN_COARSE)
    hit_a = hit_a | hit0
    amb_a = rotating & maybe_a & ~hit_a
    t0_full = warm_start(t_first_a)
    rows = _rows_where(amb_a.any(dim=1))
    ca_hits = torch.zeros_like(amb_a)
    if rows.numel():
        def g(a):
            return a.index_select(0, rows)

        obst_g = g(obstacle)
        pxg, pyg, vxg, vyg, thg, wg = map(g, (px, py, vx, vy, th0, w))

        def dist_g(t):
            robot_t = transform_vertices(rv[None, None], pxg + t * vxg,
                                         pyg + t * vyg, thg + t * wg)
            return polygon_signed_distance(robot_t, obst_g)

        toi = _advance(dist_g, g(bound), 1.0, ca_iters, _f32(tol), t0=g(t0_full))
        ca_hits.index_copy_(0, rows, g(amb_a) & torch.isfinite(toi))
    hit = torch.where(rotating, hit_a | ca_hits, hit_exact)
    return hit, (maybe_a, hit_a, amb_a)


def counts_chunk_moving_polygons(keys, configs: MovingPolygonConfigs, robot_verts,
                                 n_lanes: int, *, ca_iters: int = CA_ITERS,
                                 tol: float = CA_TOL, ca_screen: bool = True,
                                 return_screen_masks: bool = False):
    """Motion-collision count over ``n_lanes`` threefry samples per
    configuration for k-gon pairs: int32 (C,). The drop-in for
    `estimator._counts_chunk_polygons`, with the same keys and (n_lanes, 3)
    draws, so a zero-motion batch reproduces the static counts bitwise.
    Rotating lanes run the k-gon screening cascade (`ca_screen`, default)
    or the pure advancement loop; ``ca_iters == 0`` asserts a
    translation-only batch. With the screen on, the configuration axis
    runs in chunks of at most `POLY_SCREEN_ELEMS` table elements (results
    do not depend on the chunking)."""
    z = prng.normal(keys, (n_lanes, 3))
    rv = torch.as_tensor(robot_verts, dtype=torch.float32, device=z.device)
    c, k, k2 = z.shape[0], configs.obstacle_verts.shape[1], rv.shape[0]
    rows = c
    if ca_iters > 0 and ca_screen:
        rows = max(1, POLY_SCREEN_ELEMS // max(1, k * k2 * n_lanes))
    hits, masks = [], []
    for r0 in range(0, c, rows):
        part = type(configs)(*(a[r0:r0 + rows] for a in configs))
        hit, m = _polygon_hits(z[r0:r0 + rows], part, rv, ca_iters, tol, ca_screen)
        hits.append(hit.sum(dim=-1, dtype=torch.int32))
        masks.append(m)
    counts = torch.cat(hits) if hits else torch.zeros((0,), dtype=torch.int32,
                                                      device=z.device)
    if return_screen_masks:
        if not masks or masks[0] is None:
            raise ValueError("return_screen_masks requires ca_screen=True and "
                             "ca_iters > 0")
        return counts, tuple(torch.cat(parts) for parts in zip(*masks))
    return counts


def trajectory_collision_probability(key, configs, robot, n_samples: int, *,
                                     step_samples: int = 0,
                                     ca_iters: int = CA_ITERS,
                                     tol: float = CA_TOL) -> torch.Tensor:
    """Fixed-budget Monte Carlo estimate of P(the motion collides): float32
    (C,), on the threefry path (the JAX package's uid-keyed streams).
    ``configs``: `MovingConfigs` (``robot`` = (2,) width/height) or
    `MovingPolygonConfigs` (``robot`` = (K2, 2) robot vertices)."""
    from collide2d_tpu_torch.mc import estimator

    return estimator.collision_probability(
        key, configs, robot, n_samples, step_samples=step_samples,
        impl="threefry", ca_iters=ca_iters, ca_tol=tol)
