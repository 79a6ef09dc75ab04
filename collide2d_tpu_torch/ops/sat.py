"""Separating-Axis-Theorem narrow phase on torch tensors.

Counterpart of ``collide2d_tpu/ops/sat.py``:

- `sat_rects_reference` reproduces the reference's ``convex_collide``
  (utils.cu:159-184) bit for bit: edge vectors as axes, all 8 axes, strict
  ``<`` separation, so touching rectangles collide;
- `sat_rects` tests the 4 unique axes, column by column;
- `obb_collide` is the closed-form oriented-box test the Monte Carlo
  threefry path uses;
- `sat_polygons` is the convex k-gon test on true edge normals, with
  repeat-last padding (or a vertex mask);
- `rect_columns_collide`, `polygon_columns_collide` and `obb_overlap` are
  the tests on coordinate columns, shared with the SAT kernels' plain
  versions (`ops.sat_cuda`, `ops.polygon_cuda`).

Projections stay an explicit ``ax*x + ay*y`` of separately rounded
float32 operations: a contraction (matmul, einsum) may fuse them into an
FMA and break bitwise parity with the reference's scalar projections.
"""

from __future__ import annotations

import torch

from collide2d_tpu_torch.ops.geometry import edge_normals, polygon_edges


def _project_all(axes: torch.Tensor, verts: torch.Tensor) -> torch.Tensor:
    """Project vertices onto axes: ``B+(a,2) x B+(k,2) -> B+(a,k)``, as a
    separate multiply and add (never a contraction)."""
    ax = axes[..., 0][..., None]
    ay = axes[..., 1][..., None]
    x = verts[..., None, :, 0]
    y = verts[..., None, :, 1]
    return ax * x + ay * y


def sat_rects_reference(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Bit-compatible rectangle SAT (reference semantics). ``r1``/``r2``:
    ``B + (4, 2)`` vertices. Returns int32 ``B`` (1 = collide)."""
    axes = torch.cat([polygon_edges(r1), polygon_edges(r2)], dim=-2)
    p1 = _project_all(axes, r1)
    p2 = _project_all(axes, r2)
    min1, max1 = p1.amin(dim=-1), p1.amax(dim=-1)
    min2, max2 = p2.amin(dim=-1), p2.amax(dim=-1)
    separated = (max1 < min2) | (max2 < min1)
    return (~separated.any(dim=-1)).to(torch.int32)


def sat_rects(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Rectangle SAT over the 4 unique axes, unrolled over coordinate
    columns (labels equal `sat_rects_reference` except on measure-zero
    inputs whose interval ends round differently; see the JAX docstring)."""
    x1 = [r1[..., k, 0] for k in range(4)]
    y1 = [r1[..., k, 1] for k in range(4)]
    x2 = [r2[..., k, 0] for k in range(4)]
    y2 = [r2[..., k, 1] for k in range(4)]
    return rect_columns_collide(x1, y1, x2, y2).to(torch.int32)


def rect_columns_collide(x1, y1, x2, y2) -> torch.Tensor:
    """The 4-axis test on coordinate columns: ``x1``..``y2`` are lists of
    the 4 vertex columns of each rectangle (same shapes). Boolean, True =
    collide. The axes are the first two edges of each rectangle (edges 2
    and 3 are exact negations); each projection is a separate multiply
    and add, in `sat_pallas._sat_body`'s order."""
    axes = [
        (x1[1] - x1[0], y1[1] - y1[0]),
        (x1[2] - x1[1], y1[2] - y1[1]),
        (x2[1] - x2[0], y2[1] - y2[0]),
        (x2[2] - x2[1], y2[2] - y2[1]),
    ]
    separated = None
    for ax, ay in axes:
        mn1 = mx1 = ax * x1[0] + ay * y1[0]
        for k in range(1, 4):
            p = ax * x1[k] + ay * y1[k]
            mn1 = torch.minimum(mn1, p)
            mx1 = torch.maximum(mx1, p)
        mn2 = mx2 = ax * x2[0] + ay * y2[0]
        for k in range(1, 4):
            p = ax * x2[k] + ay * y2[k]
            mn2 = torch.minimum(mn2, p)
            mx2 = torch.maximum(mx2, p)
        sep = (mx1 < mn2) | (mx2 < mn1)
        separated = sep if separated is None else separated | sep
    return ~separated


def sat_polygons(p1: torch.Tensor, p2: torch.Tensor,
                 mask1: torch.Tensor | None = None,
                 mask2: torch.Tensor | None = None) -> torch.Tensor:
    """Convex k-gon pairs, SAT on true perpendicular edge normals.

    ``p1``/``p2``: ``B + (k, 2)`` CCW convex vertices, padded to a fixed k
    by REPEATING the last real vertex, or with ``B + (k,)`` bool masks
    (True = real vertex) whose padded slots are first rewritten to the
    last real vertex. Repeat-padding needs no masks in the test: a
    duplicate never moves an interval, the edge between duplicates is the
    zero axis (never separating), and the edge from the last slot back to
    vertex 0 is the real closing edge. Touching polygons collide (strict
    ``<`` separation). Returns int32 ``B``.

    ``k1 + k2 <= 32`` runs the test unrolled over coordinate columns; a
    larger pair projects all axes at once (the same labels: the same
    separately rounded projections, exact min/max)."""
    p1 = _normalize_padding(p1, mask1)
    p2 = _normalize_padding(p2, mask2)
    k1, k2 = p1.shape[-2], p2.shape[-2]
    if k1 + k2 > 32:
        axes = torch.cat([edge_normals(p1), edge_normals(p2)], dim=-2)
        proj1 = _project_all(axes, p1)
        proj2 = _project_all(axes, p2)
        separated = ((proj1.amax(dim=-1) < proj2.amin(dim=-1))
                     | (proj2.amax(dim=-1) < proj1.amin(dim=-1)))
        return (~separated.any(dim=-1)).to(torch.int32)
    return polygon_columns_collide(
        [p1[..., i, 0] for i in range(k1)], [p1[..., i, 1] for i in range(k1)],
        [p2[..., i, 0] for i in range(k2)], [p2[..., i, 1] for i in range(k2)],
    ).to(torch.int32)


def polygon_columns_collide(x1, y1, x2, y2) -> torch.Tensor:
    """The k-gon test on coordinate columns: ``x1``/``y1`` the k1 vertex
    columns of the first polygon, ``x2``/``y2`` the k2 of the second (same
    shapes). Boolean, True = collide. Axis of edge i -> i+1 is
    ``(y[i+1] - y[i], x[i] - x[i+1])``; each projection is a separate
    multiply and add, in `polygon_pallas._polygon_sat_body`'s order."""
    separated = None
    for xs, ys in ((x1, y1), (x2, y2)):
        k = len(xs)
        for i in range(k):
            j = (i + 1) % k
            ax = ys[j] - ys[i]
            ay = xs[i] - xs[j]
            mn1 = mx1 = ax * x1[0] + ay * y1[0]
            for x, y in zip(x1[1:], y1[1:]):
                p = ax * x + ay * y
                mn1 = torch.minimum(mn1, p)
                mx1 = torch.maximum(mx1, p)
            mn2 = mx2 = ax * x2[0] + ay * y2[0]
            for x, y in zip(x2[1:], y2[1:]):
                p = ax * x + ay * y
                mn2 = torch.minimum(mn2, p)
                mx2 = torch.maximum(mx2, p)
            sep = (mx1 < mn2) | (mx2 < mn1)
            separated = sep if separated is None else separated | sep
    return ~separated


def _normalize_padding(p: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Rewrite masked-out (padded) slots to the last real vertex, making
    any padding equivalent to the repeat-last convention."""
    if mask is None:
        return p
    last_real = mask.to(torch.int64).sum(dim=-1, keepdim=True) - 1  # B+(1,)
    idx = last_real[..., None].expand(*last_real.shape, 2)  # B+(1, 2)
    last_vertex = torch.gather(p, -2, idx)
    return torch.where(mask[..., None], p, last_vertex)


def obb_collide(c1, ext1, th1, c2, ext2, th2) -> torch.Tensor:
    """Closed-form oriented-box overlap test (boolean-equal to vertex SAT
    except on measure-zero near-touching inputs).

    ``c1``/``c2``: ``B + (2,)`` centres; ``ext1``/``ext2``: ``B + (2,)``
    FULL widths/heights (negative extents handled through abs);
    ``th1``/``th2``: ``B`` angles. Returns int32 ``B``."""
    hx1 = ext1[..., 0].abs() * 0.5
    hy1 = ext1[..., 1].abs() * 0.5
    hx2 = ext2[..., 0].abs() * 0.5
    hy2 = ext2[..., 1].abs() * 0.5
    dx = c1[..., 0] - c2[..., 0]
    dy = c1[..., 1] - c2[..., 1]
    c1_, s1_ = torch.cos(th1), torch.sin(th1)
    c2_, s2_ = torch.cos(th2), torch.sin(th2)
    return obb_overlap(dx, dy, c1_, s1_, hx1, hy1, c2_, s2_, hx2, hy2).to(
        torch.int32)


def obb_overlap(dx, dy, c1_, s1_, hx1, hy1, c2_, s2_, hx2, hy2) -> torch.Tensor:
    """The closed-form test on the centre offset ``(dx, dy)`` = c1 - c2,
    each box's cos/sin and half extents. Boolean, True = collide. Same
    float operation order as `sat_pallas._obb_body`."""
    cd = (c1_ * c2_ + s1_ * s2_).abs()
    sd = (s1_ * c2_ - c1_ * s2_).abs()
    d_a1 = (dx * c1_ + dy * s1_).abs()
    d_a2 = (-dx * s1_ + dy * c1_).abs()
    d_b1 = (dx * c2_ + dy * s2_).abs()
    d_b2 = (-dx * s2_ + dy * c2_).abs()
    sep = d_a1 > hx1 + hx2 * cd + hy2 * sd
    sep = sep | (d_a2 > hy1 + hx2 * sd + hy2 * cd)
    sep = sep | (d_b1 > hx2 + hx1 * cd + hy1 * sd)
    sep = sep | (d_b2 > hy2 + hx1 * sd + hy1 * cd)
    return ~sep
