"""Contact manifolds of convex pairs: reference/incident face clipping.

Counterpart of ``collide2d_tpu/ops/manifold.py``. A contact consumer needs
up to two contact points with their penetration depths and one shared
normal (face-face contact between polygons is a segment). The
construction is the classic reference/incident face clip, written without
data-dependent control flow:

1. every face of each body gets its separation: the gap between the face's
   supporting line and the other body's support point along the face
   normal; the face with the largest separation over both bodies picks
   the contact axis (for overlapping pairs the MTV axis of `ops.distance`);
2. its owner is the REFERENCE body; the other body's face most
   anti-parallel to the reference normal is the INCIDENT face;
3. the incident segment is clipped against the reference face's two side
   planes, and points above the reference face by more than ``margin`` are
   dropped.

Outputs are fixed-capacity (2 slots and a count). Padding follows
`ops.sat.sat_polygons`: repeat-last padded slots (or a ``mask``) add
zero-length edges whose zero normals never win the reference argmax or the
incident argmin. Ties take the first index, as JAX's argmax/argmin do.
"""

from __future__ import annotations

import torch

from collide2d_tpu_torch.ops.distance import _gather_rows, _rect_pair
from collide2d_tpu_torch.ops.geometry import edge_normals
from collide2d_tpu_torch.ops.sat import _normalize_padding

_INF = float("inf")


def _unit_outward_normals(p: torch.Tensor):
    """Unit outward edge normals of a CCW polygon and their validity:
    ``B+(k,2) -> (B+(k,2), B+(k,) bool)``; zero-length edges get a zero
    normal and ``valid=False``."""
    n = edge_normals(p)  # (ey, -ex): outward for CCW
    nrm = torch.sqrt((n * n).sum(dim=-1, keepdim=True))
    return n / torch.where(nrm > 0, nrm, 1.0), nrm[..., 0] > 0


def _face_separations(p_ref: torch.Tensor, p_inc: torch.Tensor):
    """Separation of ``p_inc`` from each face of ``p_ref``: ``min_j n_i.v_j
    - n_i.p_i`` (negative = the incident body crosses the face's line).
    Returns ``(sep B+(k,), normals B+(k,2), valid B+(k,))``, padded faces
    at ``-inf``."""
    n, valid = _unit_outward_normals(p_ref)
    off = (n * p_ref).sum(dim=-1)
    proj = (n[..., :, None, 0] * p_inc[..., None, :, 0]
            + n[..., :, None, 1] * p_inc[..., None, :, 1])
    sep = proj.amin(dim=-1) - off
    return torch.where(valid, sep, -_INF), n, valid


def _clip_segment(v1, v2, n, off):
    """Clip segment [v1, v2] (``B+(2,)``) to the half-plane ``n.x <= off``
    (``off``: ``B``). A segment entirely outside collapses to its less
    violating endpoint, which the caller's depth filter then drops."""
    d1 = (n * v1).sum(dim=-1) - off
    d2 = (n * v2).sum(dim=-1) - off
    denom = d1 - d2
    t = (d1 / torch.where(denom == 0, 1.0, denom)).clamp(0.0, 1.0)
    crossing = (d1 > 0) != (d2 > 0)
    mid = v1 + t[..., None] * (v2 - v1)
    v1c = torch.where(((d1 > 0) & crossing)[..., None], mid, v1)
    v2c = torch.where(((d2 > 0) & crossing)[..., None], mid, v2)
    both_out = ((d1 > 0) & (d2 > 0))[..., None]
    closer = torch.where((d1 <= d2)[..., None], v1, v2)
    return torch.where(both_out, closer, v1c), torch.where(both_out, closer, v2c)


def _pad_to(p: torch.Tensor, k: int) -> torch.Tensor:
    """Repeat the last vertex up to ``k`` slots (the padding convention)."""
    short = k - p.shape[-2]
    if short == 0:
        return p
    return torch.cat([p, p[..., -1:, :].expand(*p.shape[:-2], short, 2)], dim=-2)


def polygon_contact_manifold(p1, p2, mask1=None, mask2=None, *,
                             margin: float = 0.0):
    """Contact manifold of convex CCW k-gon pairs, fixed capacity.

    Returns ``(count, points, depths, normal)``:

    - ``count``: int32 ``B``, valid contact points (0..2); 0 when the best
      face separation exceeds ``margin`` or no clipped point is within it;
    - ``points``: float32 ``B+(2,2)``, on the incident face, clipped to the
      reference face's side planes; slots past ``count`` hold the nearest
      clipped candidate;
    - ``depths``: float32 ``B+(2,)``, penetration along ``normal``
      (positive = penetrating, ``-margin`` at the margin);
    - ``normal``: float32 ``B+(2,)``, unit, from body 1 into body 2.

    ``margin > 0`` keeps speculative contacts. When neither body has a
    valid face (all edges zero-length) the manifold is empty."""
    p1 = _normalize_padding(torch.as_tensor(p1, dtype=torch.float32), mask1)
    p2 = _normalize_padding(torch.as_tensor(p2, dtype=torch.float32), mask2)
    k = max(p1.shape[-2], p2.shape[-2])
    p1, p2 = _pad_to(p1, k), _pad_to(p2, k)

    sep1, n1, _ = _face_separations(p1, p2)  # faces of 1 vs vertices of 2
    sep2, n2, _ = _face_separations(p2, p1)
    i1 = sep1.argmax(dim=-1)  # best (least penetrating) face of 1
    i2 = sep2.argmax(dim=-1)
    s1 = torch.gather(sep1, -1, i1[..., None])[..., 0]
    s2 = torch.gather(sep2, -1, i2[..., None])[..., 0]
    # Reference = the body whose best face penetrates least, with a small
    # relative bias toward body 1 for equal separations.
    ref_is_1 = s1 >= s2 - 1e-6 * torch.clamp(s2.abs(), min=1.0)
    best_sep = torch.where(ref_is_1, s1, s2)
    ref1 = ref_is_1[..., None]
    ref1_rows = ref_is_1[..., None, None]

    i_ref = torch.where(ref_is_1, i1, i2)
    n_ref = torch.where(ref1, _gather_rows(n1, i1), _gather_rows(n2, i2))
    p_ref = torch.where(ref1_rows, p1, p2)
    p_inc = torch.where(ref1_rows, p2, p1)
    n_inc_all = torch.where(ref1_rows, n2, n1)

    # Incident face: the most anti-parallel VALID face of the other body.
    inc_valid = (n_inc_all * n_inc_all).sum(dim=-1) > 0
    align = (n_inc_all * n_ref[..., None, :]).sum(dim=-1)
    j = torch.where(inc_valid, align, _INF).argmin(dim=-1)
    v1 = _gather_rows(p_inc, j)
    v2 = _gather_rows(p_inc, (j + 1) % k)

    # Reference face endpoints and side planes (face tangent +- t).
    r1 = _gather_rows(p_ref, i_ref)
    r2 = _gather_rows(p_ref, (i_ref + 1) % k)
    t = torch.stack([-n_ref[..., 1], n_ref[..., 0]], dim=-1)
    v1, v2 = _clip_segment(v1, v2, -t, -(t * r1).sum(dim=-1))
    v1, v2 = _clip_segment(v1, v2, t, (t * r2).sum(dim=-1))

    off = (n_ref * r1).sum(dim=-1)
    d1 = off - (n_ref * v1).sum(dim=-1)  # depth: + = below the reference face
    d2 = off - (n_ref * v2).sum(dim=-1)
    # best_sep == -inf: no valid face on either body, an empty manifold
    pair_ok = (best_sep <= margin) & torch.isfinite(best_sep)
    keep1 = (d1 >= -margin) & pair_ok
    keep2 = (d2 >= -margin) & pair_ok
    # valid points first
    swap = ~keep1 & keep2
    pa = torch.where(swap[..., None], v2, v1)
    pb = torch.where(swap[..., None], v1, v2)
    da = torch.where(swap, d2, d1)
    db = torch.where(swap, d1, d2)
    count = keep1.to(torch.int32) + keep2.to(torch.int32)
    # The reference normal points out of the reference body: flip it when
    # that body is body 2.
    normal = torch.where(ref1, n_ref, -n_ref)
    return (count, torch.stack([pa, pb], dim=-2), torch.stack([da, db], dim=-1),
            normal)


def rect_contact_manifold(c1, ext1, th1, c2, ext2, th2, *, margin: float = 0.0):
    """`polygon_contact_manifold` for oriented boxes in param form (as
    `ops.sat.obb_collide`: centres, FULL extents, angles)."""
    return polygon_contact_manifold(*_rect_pair(c1, ext1, th1, c2, ext2, th2),
                                    margin=margin)
