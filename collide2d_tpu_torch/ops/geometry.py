"""Core 2D geometry primitives on torch tensors.

Counterpart of ``collide2d_tpu/ops/geometry.py``. Vertex layout contract
(the reference's ``create_rect``, utils.cu:119-130): a rectangle of width
``w`` and height ``h`` centred at the origin is the 4 counter-clockwise
vertices starting at the bottom-left corner::

    (-w/2, -h/2), (w/2, -h/2), (w/2, h/2), (-w/2, h/2)

Every function broadcasts over leading batch dimensions and evaluates
each coordinate with the same separately rounded float32 operations, in
the same order, as the JAX package, so results agree bitwise on the CPU
(cos/sin excepted, which may differ by an ulp between libraries).
"""

from __future__ import annotations

import torch

_CORNER_SIGNS = ((-0.5, -0.5), (0.5, -0.5), (0.5, 0.5), (-0.5, 0.5))


def _as_f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def rect_vertices(width, height) -> torch.Tensor:
    """Axis-aligned rectangle centred at the origin as 4 CCW vertices.

    ``width``/``height``: broadcastable batch shape ``B``; returns
    ``B + (4, 2)`` float32."""
    width = _as_f32(width)
    height = _as_f32(height, width.device)
    wh = torch.stack(torch.broadcast_tensors(width, height), dim=-1)
    signs = torch.tensor(_CORNER_SIGNS, dtype=torch.float32, device=wh.device)
    return wh[..., None, :] * signs


def transform_vertices(vertices: torch.Tensor, dx, dy, theta) -> torch.Tensor:
    """Rotate vertices by ``theta`` about the origin, then translate
    (rotate-then-translate, utils.cu:132-142):
    x' = c*x - s*y + dx ;  y' = s*x + c*y + dy."""
    dev = vertices.device
    theta = _as_f32(theta, dev)
    c = torch.cos(theta)[..., None]
    s = torch.sin(theta)[..., None]
    x = vertices[..., 0]
    y = vertices[..., 1]
    xt = c * x - s * y + _as_f32(dx, dev)[..., None]
    yt = s * x + c * y + _as_f32(dy, dev)[..., None]
    return torch.stack([xt, yt], dim=-1)


def rects_from_params(center, extents, angle) -> torch.Tensor:
    """Rectangles from (center ``B+(2,)``, extents ``B+(2,)`` = (w, h),
    angle ``B``) as vertices ``B + (4, 2)``."""
    base = rect_vertices(extents[..., 0], extents[..., 1])
    return transform_vertices(base, center[..., 0], center[..., 1], angle)


def polygon_aabb(vertices: torch.Tensor,
                 mask: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Axis-aligned bounding box ``(lo, hi)``, each ``B + (2,)``, of
    ``B + (k, 2)`` vertices; an optional ``B + (k,)`` bool ``mask`` (True
    = real vertex) keeps padded slots out of the box."""
    if mask is None:
        return vertices.amin(dim=-2), vertices.amax(dim=-2)
    m = mask[..., None]
    inf = float("inf")
    lo = torch.where(m, vertices, inf).amin(dim=-2)
    hi = torch.where(m, vertices, -inf).amax(dim=-2)
    return lo, hi


def polygon_edges(vertices: torch.Tensor) -> torch.Tensor:
    """Cyclic edge vectors v[i+1] - v[i]: ``B+(k,2)`` -> ``B+(k,2)``."""
    return torch.roll(vertices, shifts=-1, dims=-2) - vertices


def edge_normals(vertices: torch.Tensor) -> torch.Tensor:
    """Perpendicular edge normals (ey, -ex), unnormalised."""
    e = polygon_edges(vertices)
    return torch.stack([e[..., 1], -e[..., 0]], dim=-1)


def _take_point(p: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``p[..., idx, :]`` for a ``B`` index into ``B + (n, 2)``."""
    return torch.gather(p, -2, idx[..., None, None].expand(*idx.shape, 1, 2))[..., 0, :]


def convex_hull(points, k_out: int | None = None,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """Batched convex hull by gift wrapping (Jarvis march), branch-free.

    ``points``: ``B + (n, 2)``. Returns ``B + (k_out, 2)`` float32 CCW hull
    vertices starting from the lowest point (ties toward smaller x),
    repeat-last padded when the hull has fewer than ``k_out`` vertices: the
    padding convention of `ops.sat.sat_polygons`. ``k_out`` defaults to
    ``n``; ``mask`` (``B + (n,)`` bool) keeps padding points out of the set.

    ``k_out`` fixed steps of one angular first-index argmin over the n
    candidates, the turn angle from ``atan2`` in [0, 2 pi). Duplicates are
    fine; exactly collinear hull points may appear as collinear vertices;
    a ``k_out`` below the hull size returns the first ``k_out`` vertices.
    torch's and XLA's ``atan2`` may differ by an ulp, so near-collinear
    candidates can be chosen in another order than the JAX package's."""
    p = _as_f32(points)
    n = p.shape[-2]
    if k_out is None:
        k_out = n
    batch = p.shape[:-2]
    valid_in = (torch.ones(p.shape[:-1], dtype=torch.bool, device=p.device)
                if mask is None else torch.broadcast_to(
                    torch.as_tensor(mask, device=p.device), p.shape[:-1]))
    inf = float("inf")
    x, y = p[..., 0], p[..., 1]
    ymin = torch.where(valid_in, y, inf).amin(dim=-1, keepdim=True)
    i0 = torch.where(valid_in & (y == ymin), x, inf).argmin(dim=-1)
    c = _take_point(p, i0)
    dref = torch.tensor([1.0, 0.0], dtype=torch.float32,
                        device=p.device).expand_as(c)
    done = torch.zeros(batch, dtype=torch.bool, device=p.device)
    two_pi = float(torch.tensor(2.0 * torch.pi, dtype=torch.float32))
    out = []
    for _ in range(k_out):
        out.append(c)
        v = p - c[..., None, :]
        vv = v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
        cand = valid_in & (vv > 0)
        rx, ry = dref[..., 0:1], dref[..., 1:2]
        ang = torch.atan2(rx * v[..., 1] - ry * v[..., 0],
                          rx * v[..., 0] + ry * v[..., 1])
        ang = torch.where(ang < 0, ang + two_pi, ang)
        j = torch.where(cand, ang, inf).argmin(dim=-1)
        nxt = _take_point(p, j)
        # wrap: back at the start, or no candidate left (all duplicates)
        done = done | (j == i0) | ~cand.any(dim=-1)
        keep = done[..., None]
        dref = torch.where(keep, dref, nxt - c)
        c = torch.where(keep, c, nxt)
    if not out:
        return torch.zeros(batch + (0, 2), dtype=torch.float32, device=p.device)
    return torch.stack(out, dim=-2)
