"""Signed distance between convex shapes on torch tensors.

Counterpart of ``collide2d_tpu/ops/distance.py``. For convex sets the
clearance and the penetration depth are one number, the signed distance

    d(A, B) = max_{|u|=1} ( min_{b in B} u.b  -  max_{a in A} u.a )

positive = separation distance, negative = -(penetration depth), zero =
touching. For convex polygons the maximiser is known in closed form:

- overlapping (every gap negative): an edge normal of A or B, the SAT axis
  set (the minimum-translation-vector theorem);
- disjoint: a vertex of one against an edge segment of the other, so the
  distance is the minimum over all (vertex, segment) distances.

Both sides are fixed-shape O(k^2) tensor work with no data-dependent
control flow, and differentiable wherever the distance is smooth (min and
max spread the gradient over ties, as JAX's do), so `torch.autograd`
gives the contact normal direction. Padding follows `ops.sat.sat_polygons`'
repeat-last convention (or a ``mask``): a repeated vertex adds a zero axis
(masked out of the overlap side) and a zero-length segment whose distance
is the duplicate vertex's, never below the true minimum.

Projections stay a separate multiply and add (`ops.sat._project_all`), and
ties in `argmin`/`argmax` take the first index, as JAX's do.
"""

from __future__ import annotations

import torch

from collide2d_tpu_torch.ops.geometry import edge_normals, rects_from_params
from collide2d_tpu_torch.ops.sat import _normalize_padding, _project_all

_INF = float("inf")


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _support_gap_over_normals(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """max over +-(edge normals of both) of the normalised support gap:
    -(penetration depth) when negative, a lower bound on the separation
    when not. ``B+(k,2) x B+(k,2) -> B``."""
    axes = torch.cat([edge_normals(p1), edge_normals(p2)], dim=-2)
    nrm = torch.sqrt((axes * axes).sum(dim=-1))  # B+(a,)
    proj1 = _project_all(axes, p1)  # B+(a,k1)
    proj2 = _project_all(axes, p2)
    min1, max1 = proj1.amin(dim=-1), proj1.amax(dim=-1)
    min2, max2 = proj2.amin(dim=-1), proj2.amax(dim=-1)
    # a zero axis (padding edge) separates nothing and carries no direction
    gap = torch.maximum(min2 - max1, min1 - max2) / torch.where(nrm > 0, nrm, 1.0)
    gap = torch.where(nrm > 0, gap, -_INF)
    return gap.amax(dim=-1)


def _vertex_segment_candidates(p: torch.Tensor, q: torch.Tensor):
    """Squared distances of each (vertex of p, closed edge segment of q)
    and the closest point on q's segment: ``B+(k1,2) x B+(k2,2) ->
    (B+(k1,k2), B+(k1,k2,2))``. A zero-length segment falls back to the
    point distance through the clamped parameter."""
    e = torch.roll(q, shifts=-1, dims=-2) - q  # segment vectors B+(k2,2)
    d = p[..., :, None, :] - q[..., None, :, :]  # v - a: B+(k1,k2,2)
    ee = (e * e).sum(dim=-1)[..., None, :]  # B+(1,k2)
    t = (d * e[..., None, :, :]).sum(dim=-1) / torch.where(ee > 0, ee, 1.0)
    t = t.clamp(0.0, 1.0) * (ee > 0)
    c = d - t[..., None] * e[..., None, :, :]
    dist2 = (c * c).sum(dim=-1)
    return dist2, p[..., :, None, :] - c


def _vertex_segment_min(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """min over (vertex of p, closed edge segment of q) distances: ``B``."""
    return torch.sqrt(_vertex_segment_candidates(p, q)[0].amin(dim=(-2, -1)))


def polygon_signed_distance(p1, p2, mask1=None, mask2=None) -> torch.Tensor:
    """Signed distance between convex k-gon pairs: float32 ``B``.

    ``p1``/``p2``: ``B+(k,2)`` CCW convex vertices, repeat-padded or with
    ``B+(k,)`` bool masks. Positive: the separation distance; negative:
    -(penetration depth); zero: touching. The sign agrees with
    `ops.sat.sat_polygons` away from the touching set."""
    p1 = _normalize_padding(_f32(p1), mask1)
    p2 = _normalize_padding(_f32(p2), mask2)
    gap = _support_gap_over_normals(p1, p2)
    sep = torch.minimum(_vertex_segment_min(p1, p2), _vertex_segment_min(p2, p1))
    return torch.where(gap < 0, gap, sep)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """One row along axis -2: ``B+(n,c), B -> B+(c,)``."""
    index = idx[..., None, None].expand(*idx.shape, 1, x.shape[-1])
    return torch.gather(x, -2, index)[..., 0, :]


def polygon_closest_points(p1, p2, mask1=None, mask2=None):
    """Witness points and contact normal of convex k-gon pairs.

    Returns ``(dist, pa, pb, normal)``: ``dist`` float32 ``B`` (the value
    of `polygon_signed_distance`, same formulas), the others float32
    ``B+(2,)``, with ``pb - pa = dist * normal`` in both regimes:

    - disjoint: ``pa``/``pb`` the closest boundary points of A and B, and
      ``normal`` the unit direction from A's witness toward B's;
    - overlapping: ``normal`` the minimum-translation direction, ``pb``
      B's deepest vertex along ``-normal`` and ``pa = pb - dist * normal``;
    - touching: the overlap witness at about zero depth.

    Translating B by ``-dist * normal`` brings the pair into touching
    contact. The witnesses come from argmin/argmax gathers (piecewise
    constant): differentiate `polygon_signed_distance` for smooth normals.
    """
    p1 = _normalize_padding(_f32(p1), mask1)
    p2 = _normalize_padding(_f32(p2), mask2)
    k1, k2 = p1.shape[-2], p2.shape[-2]

    # The distance, as `polygon_signed_distance` computes it, with the
    # candidate tables kept for the witness gathers.
    axes = torch.cat([edge_normals(p1), edge_normals(p2)], dim=-2)
    nrm = torch.sqrt((axes * axes).sum(dim=-1))
    proj1 = _project_all(axes, p1)
    proj2 = _project_all(axes, p2)
    g_pos = proj2.amin(dim=-1) - proj1.amax(dim=-1)  # gap along +axis
    g_neg = proj1.amin(dim=-1) - proj2.amax(dim=-1)  # gap along -axis
    g = torch.maximum(g_pos, g_neg) / torch.where(nrm > 0, nrm, 1.0)
    g = torch.where(nrm > 0, g, -_INF)
    gap = g.amax(dim=-1)
    d2_12, on2 = _vertex_segment_candidates(p1, p2)  # A-vertex vs B-edge
    d2_21, on1 = _vertex_segment_candidates(p2, p1)  # B-vertex vs A-edge
    s12 = torch.sqrt(d2_12.amin(dim=(-2, -1)))
    s21 = torch.sqrt(d2_21.amin(dim=(-2, -1)))
    sep = torch.minimum(s12, s21)
    dist = torch.where(gap < 0, gap, sep)

    # Disjoint witness: argmin over both candidate sides.
    batch = d2_12.shape[:-2]
    i12 = d2_12.reshape(*batch, k1 * k2).argmin(dim=-1)
    i21 = d2_21.reshape(*batch, k2 * k1).argmin(dim=-1)
    pa_12 = _gather_rows(p1, i12 // k2)  # vertex of A
    pb_12 = _gather_rows(on2.reshape(*batch, k1 * k2, 2), i12)
    pb_21 = _gather_rows(p2, i21 // k1)  # vertex of B
    pa_21 = _gather_rows(on1.reshape(*batch, k2 * k1, 2), i21)
    use12 = (s12 <= s21)[..., None]
    pa_dis = torch.where(use12, pa_12, pa_21)
    pb_dis = torch.where(use12, pb_12, pb_21)
    n_dis = (pb_dis - pa_dis) / torch.where(sep > 0, sep, 1.0)[..., None]

    # Overlap witness: the maximising SAT axis (the MTV direction) and B's
    # support vertex along its negation.
    ia = g.argmax(dim=-1)

    def at_ia(x):
        return torch.gather(x, -1, ia[..., None])[..., 0]

    sign = torch.where(at_ia(g_pos) >= at_ia(g_neg), 1.0, -1.0)
    axis_w = _gather_rows(axes, ia)
    nrm_w = torch.where(at_ia(nrm) > 0, at_ia(nrm), 1.0)
    u = sign[..., None] * axis_w / nrm_w[..., None]
    proj2_w = _gather_rows(proj2, ia)
    jb = (sign[..., None] * proj2_w).argmin(dim=-1)
    pb_ov = _gather_rows(p2, jb)
    pa_ov = pb_ov - gap[..., None] * u

    overlap = (gap < 0)[..., None]
    pa = torch.where(overlap, pa_ov, pa_dis)
    pb = torch.where(overlap, pb_ov, pb_dis)
    # At an exact touch the disjoint normal is 0/eps; the MTV axis is the
    # meaningful contact normal there.
    normal = torch.where((gap <= 0)[..., None], u, n_dis)
    return dist, pa, pb, normal


def _rect_pair(c1, ext1, th1, c2, ext2, th2):
    """Both boxes' vertices from param form (centres, FULL extents rectified
    through abs(), angles)."""
    c1 = _f32(c1)
    dev = c1.device
    r1 = rects_from_params(c1, _f32(ext1, dev).abs(), _f32(th1, dev))
    r2 = rects_from_params(_f32(c2, dev), _f32(ext2, dev).abs(), _f32(th2, dev))
    return r1, r2


def rect_closest_points(c1, ext1, th1, c2, ext2, th2):
    """`polygon_closest_points` for oriented boxes in param form (as
    `ops.sat.obb_collide`: centres, FULL extents, angles)."""
    return polygon_closest_points(*_rect_pair(c1, ext1, th1, c2, ext2, th2))


def rect_signed_distance(c1, ext1, th1, c2, ext2, th2) -> torch.Tensor:
    """Signed distance between oriented boxes in param form: float32 ``B``,
    through the polygon path on the k = 4 vertices."""
    return polygon_signed_distance(*_rect_pair(c1, ext1, th1, c2, ext2, th2))
