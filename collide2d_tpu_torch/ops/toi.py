"""Time of impact of moving convex shapes on torch tensors.

Counterpart of ``collide2d_tpu/ops/toi.py``. Conservative advancement (CA)
turns the signed distance (`ops.distance`) into a continuous-collision
query: the distance changes at most ``bound = |v_rel| + |w1| r1 + |w2| r2``
per unit time (each body's angular speed times its circumradius), so from
a time t with distance d(t) > 0 the shapes cannot touch before
t + d(t)/bound. ``t <- t + max(d(t), 0)/bound`` never overshoots the true
first contact; the loop has a fixed trip count (JAX's ``fori_loop``
becomes a Python loop of the same length).

Pure relative translation is solved EXACTLY: the colliding-time set of
each SAT axis is a linear window, and the first contact is their
intersection (`rect_translation_toi`, `polygon_time_of_impact`).

CA contract: ``t`` in ``[0, t_max]`` with ``d(t) <= tol`` for an impact
(overlapping pairs give exactly 0), ``+inf`` when the pair cannot touch
within ``t_max`` or the budget ran out before certifying an impact (a
grazing trajectory may be reported safe, never a colliding one reported
at the wrong time).
"""

from __future__ import annotations

import torch

from collide2d_tpu_torch.ops.distance import _f32, rect_signed_distance
from collide2d_tpu_torch.ops.geometry import edge_normals
from collide2d_tpu_torch.ops.sat import _normalize_padding, _project_all

_INF = float("inf")


def _advance(dist_of_t, bound: torch.Tensor, t_max: float, iters: int,
             tol: float, t0=None) -> torch.Tensor:
    """The CA loop on a batch of times; a lane stops once converged or past
    the horizon. ``t0`` (per lane) warm-starts the advancement at a time the
    caller certifies contact-free before; every finite result is
    re-checked (``d(t) <= tol``) after the loop."""
    bound = torch.clamp(bound, min=1e-30)
    t = (torch.zeros_like(bound) if t0 is None
         else torch.broadcast_to(_f32(t0, bound.device), bound.shape))
    for _ in range(iters):
        d = dist_of_t(t)
        done = (d <= tol) | (t > t_max)
        t = torch.where(done, t, t + torch.clamp(d, min=0.0) / bound)
    hit = (dist_of_t(t) <= tol) & (t <= t_max)
    return torch.where(hit, t, _INF)


def _axis_interval(p0, s, r):
    """Hit window ``(lo, hi)`` of ``|p0 + t s| <= r`` on one axis. ``s == 0``
    gives all t (|p0| <= r) or the empty window ``(+inf, -inf)``."""
    zero = s == 0
    inv = 1.0 / torch.where(zero, 1.0, s)
    t1 = (-r - p0) * inv
    t2 = (r - p0) * inv
    inside = p0.abs() <= r
    lo = torch.where(zero, torch.where(inside, -_INF, _INF), torch.minimum(t1, t2))
    hi = torch.where(zero, torch.where(inside, _INF, -_INF), torch.maximum(t1, t2))
    return lo, hi


def obb_translation_toi_parts(dx, dy, c1, s1, hx1, hy1, c2, s2, hx2, hy2, vx, vy):
    """(entry, exit) hit window of two oriented boxes under pure relative
    translation, elementwise: ``(dx, dy)`` = centre 2 - centre 1 at t = 0,
    ``(vx, vy)`` the relative velocity (of box 2), cos/sin each box's fixed
    angle, ``hxi``/``hyi`` HALF extents. Exact: the 4 unit SAT axes are the
    Minkowski sum's edge normals, so the hit set is the intersection of 4
    linear windows. At v = 0 the test is `ops.sat.obb_overlap`'s."""
    cd = (c1 * c2 + s1 * s2).abs()
    sd = (s1 * c2 - c1 * s2).abs()
    lo, hi = _axis_interval(dx * c1 + dy * s1, vx * c1 + vy * s1,
                            hx1 + hx2 * cd + hy2 * sd)
    l2, h2 = _axis_interval(-dx * s1 + dy * c1, -vx * s1 + vy * c1,
                            hy1 + hx2 * sd + hy2 * cd)
    lo, hi = torch.maximum(lo, l2), torch.minimum(hi, h2)
    l3, h3 = _axis_interval(dx * c2 + dy * s2, vx * c2 + vy * s2,
                            hx2 + hx1 * cd + hy1 * sd)
    lo, hi = torch.maximum(lo, l3), torch.minimum(hi, h3)
    l4, h4 = _axis_interval(-dx * s2 + dy * c2, -vx * s2 + vy * c2,
                            hy2 + hx1 * sd + hy1 * cd)
    return torch.maximum(lo, l4), torch.minimum(hi, h4)


def _first_contact(entry, exit_, t_max: float) -> torch.Tensor:
    hit = (entry <= exit_) & (entry <= t_max) & (exit_ >= 0)
    return torch.where(hit, torch.clamp(entry, min=0.0), _INF)


def rect_translation_toi(c1, ext1, th1, c2, ext2, th2, v_rel, *,
                         t_max: float = 1.0) -> torch.Tensor:
    """EXACT first contact time of two oriented boxes when box 2 moves by
    ``t * v_rel`` relative to box 1: float32 ``B``, t in [0, t_max] or
    +inf. Parameters as `ops.sat.obb_collide`."""
    c1 = _f32(c1)
    dev = c1.device
    c2 = _f32(c2, dev)
    ext1 = _f32(ext1, dev).abs()
    ext2 = _f32(ext2, dev).abs()
    th1 = _f32(th1, dev)
    th2 = _f32(th2, dev)
    v = torch.broadcast_to(_f32(v_rel, dev), c2.shape)
    entry, exit_ = obb_translation_toi_parts(
        c2[..., 0] - c1[..., 0], c2[..., 1] - c1[..., 1],
        torch.cos(th1), torch.sin(th1), 0.5 * ext1[..., 0], 0.5 * ext1[..., 1],
        torch.cos(th2), torch.sin(th2), 0.5 * ext2[..., 0], 0.5 * ext2[..., 1],
        v[..., 0], v[..., 1])
    return _first_contact(entry, exit_, t_max)


def rect_time_of_impact(c1, ext1, th1, v1, w1, c2, ext2, th2, v2, w2, *,
                        t_max: float = 1.0, iters: int = 64,
                        tol: float = 1e-4) -> torch.Tensor:
    """First impact time of two moving oriented boxes: float32 ``B``.

    Box i starts at (``ci``, ``thi``) with FULL extents ``exti`` and moves
    rigidly: centre ``ci + t vi``, angle ``thi + t wi``. ``vi``:
    ``B+(2,)``; ``wi``: ``B`` (broadcastable). Lanes with w1 == w2 == 0 take
    the exact translation window; rotating lanes run conservative
    advancement on `ops.distance.rect_signed_distance` (module contract)."""
    c1 = _f32(c1)
    dev = c1.device
    c2 = _f32(c2, dev)
    ext1 = _f32(ext1, dev).abs()
    ext2 = _f32(ext2, dev).abs()
    th1 = _f32(th1, dev)
    th2 = _f32(th2, dev)
    v1 = torch.broadcast_to(_f32(v1, dev), c1.shape)
    v2 = torch.broadcast_to(_f32(v2, dev), c2.shape)
    batch = torch.broadcast_shapes(c1.shape[:-1], th1.shape)
    w1 = torch.broadcast_to(_f32(w1, dev), batch)
    w2 = torch.broadcast_to(_f32(w2, dev), batch)

    v_rel = v2 - v1
    r1 = 0.5 * torch.sqrt((ext1 * ext1).sum(dim=-1))  # circumradius
    r2 = 0.5 * torch.sqrt((ext2 * ext2).sum(dim=-1))
    bound = (torch.sqrt((v_rel * v_rel).sum(dim=-1)) + w1.abs() * r1
             + w2.abs() * r2)

    def dist_of_t(t):
        te = t[..., None]
        return rect_signed_distance(c1 + te * v1, ext1, th1 + t * w1,
                                    c2 + te * v2, ext2, th2 + t * w2)

    t_ca = _advance(dist_of_t, bound, t_max, iters, tol)
    t_exact = rect_translation_toi(c1, ext1, th1, c2, ext2, th2, v_rel,
                                   t_max=t_max)
    return torch.where((w1 == 0) & (w2 == 0), t_exact, t_ca)


def polygon_time_of_impact(p1, p2, v_rel, *, t_max: float = 1.0,
                           iters: int = 64, tol: float = 1e-4, mask1=None,
                           mask2=None) -> torch.Tensor:
    """EXACT first contact time of convex k-gon pairs when shape 2 moves by
    ``t * v_rel`` relative to shape 1 (``v_rel``: ``B+(2,)``): float32
    ``B``, t in [0, t_max] or +inf. ``iters`` and ``tol`` are accepted for
    compatibility with the conservative-advancement form and ignored: the
    window intersection has no iteration and no tolerance band. Padding as
    `ops.sat.sat_polygons`."""
    del iters, tol  # superseded by the exact window intersection
    p1 = _normalize_padding(_f32(p1), mask1)
    p2 = _normalize_padding(_f32(p2, p1.device), mask2)
    v = torch.broadcast_to(_f32(v_rel, p1.device), p1.shape[:-2] + (2,))
    entry, exit_ = polygon_translation_toi_parts(p1, p2, v)
    return _first_contact(entry, exit_, t_max)


def polygon_translation_toi_parts(p1: torch.Tensor, p2: torch.Tensor,
                                  v: torch.Tensor):
    """(entry, exit) hit window of convex k-gon pairs under pure relative
    translation (shape 2 moves by ``t * v``): ``p1``/``p2`` ``B+(k,2)``
    float32 CCW, repeat-padded, ``v`` ``B+(2,)``. Projections are the
    separately rounded products and sums of `ops.sat.sat_polygons`, so at
    ``v = 0`` every window degenerates to its overlap test bit for bit."""
    axes = torch.cat([edge_normals(p1), edge_normals(p2)], dim=-2)
    proj1 = _project_all(axes, p1)  # (..., A, K1)
    proj2 = _project_all(axes, p2)
    m1, big1 = proj1.amin(dim=-1), proj1.amax(dim=-1)
    m2, big2 = proj2.amin(dim=-1), proj2.amax(dim=-1)
    s = axes[..., 0] * v[..., None, 0] + axes[..., 1] * v[..., None, 1]
    # overlap on an axis at time t: m2 + t s <= big1 and m1 <= big2 + t s
    zero = s == 0
    inv = 1.0 / torch.where(zero, 1.0, s)
    ta = (big1 - m2) * inv
    tb = (m1 - big2) * inv
    inside = (m2 <= big1) & (m1 <= big2)  # also the zero padded axis
    lo = torch.where(zero, torch.where(inside, -_INF, _INF), torch.minimum(ta, tb))
    hi = torch.where(zero, torch.where(inside, _INF, -_INF), torch.maximum(ta, tb))
    return lo.amax(dim=-1), hi.amin(dim=-1)
