"""N-body scene queries: all colliding pairs among N convex shapes.

Counterpart of ``collide2d_tpu/ops/scene.py``. The models test PAIRED
batches (row i of body 1 against row i of body 2); a scene query asks of
ONE set of N shapes which pairs collide:

- `scene_collision_matrix`: the (N, N) boolean matrix, computed in row
  tiles so that peak memory stays O(tile * N * k);
- `scene_colliding_pairs`: the fixed-capacity (i, j) pair list (``capacity``
  slots, a count and an overflow flag), streamed over row tiles without the
  (N, N) matrix and without a host readback;
- `scene_colliding_pairs_swept`: sweep and prune: sort by AABB x-min and
  test each shape against a fixed window of sorted successors, with the
  exactness certificate ``window_exceeded``;
- `scene_contact_manifolds`: a broad phase ('dense' or 'swept'), then the
  contact manifold of every pair slot.

The functions route on the device of ``polys``: on CUDA tensors every SAT
test is kernel 6 (`ops.polygon_cuda`) and the manifolds kernel 10
(`ops.manifold_cuda`); on CPU tensors they are `ops.sat.sat_polygons` and
`ops.manifold.polygon_contact_manifold`. Kernel 6 is bitwise
`sat_polygons`, so the matrix and both pair lists are bitwise the JAX
package's on either device. A ``k`` above `polygon_cuda.MAX_K` on a CUDA
tensor raises.

Padding follows `sat.sat_polygons` (repeat-last or a per-shape ``mask``).
Indices are int64 inside and int32 out.
"""

from __future__ import annotations

import torch

from collide2d_tpu_torch.ops import manifold, polygon_cuda
from collide2d_tpu_torch.ops.sat import _normalize_padding, sat_polygons

def _on_card(p: torch.Tensor) -> bool:
    """Whether ``p``'s queries run the kernels (kernel 6 and 10): on CUDA
    tensors. (The kernels' wrappers take their plain versions on CPU
    tensors, so the tests can run this route on the CPU too.)"""
    return p.device.type == "cuda"


def _prepare(polys, mask) -> torch.Tensor:
    p = _normalize_padding(torch.as_tensor(polys, dtype=torch.float32), mask)
    if p.dim() != 3 or p.shape[-1] != 2:
        raise ValueError(f"polys must be (N, k, 2), got {tuple(p.shape)}")
    if _on_card(p) and p.shape[1] > polygon_cuda.MAX_K:
        raise ValueError(f"kernel 6 takes k <= {polygon_cuda.MAX_K}, got "
                         f"{p.shape[1]}; run the scene on CPU tensors")
    return p


def _row_tile_hits(polys: torch.Tensor, soa, r0: int, r1: int) -> torch.Tensor:
    """SAT labels of rows r0..r1-1 against every shape: bool (r1 - r0, N)."""
    n, k = polys.shape[0], polys.shape[1]
    if soa is None:
        return sat_polygons(polys[r0:r1, None], polys[None]) == 1
    t = r1 - r0
    rows = soa[:, r0:r1, None].expand(2 * k, t, n).reshape(2 * k, t * n)
    cols = soa[:, None, :].expand(2 * k, t, n).reshape(2 * k, t * n)
    return (polygon_cuda.sat_columns_cuda(rows, cols, k1=k, k2=k) > 0).reshape(t, n)


def scene_collision_matrix(polys, mask=None, *, row_tile: int = 64) -> torch.Tensor:
    """All-pairs collision matrix of one set of convex shapes.

    ``polys``: ``(N, k, 2)`` CCW convex vertices (repeat-last padded, or
    pass ``mask`` ``(N, k)`` bool). Returns bool ``(N, N)``, symmetric,
    diagonal False; (i, j) True iff shapes i and j overlap (touching
    counts). ``row_tile`` bounds peak memory and changes no result."""
    p = _prepare(polys, mask)
    n = p.shape[0]
    tile = max(1, min(row_tile, n))
    soa = polygon_cuda.soa_columns(p) if _on_card(p) else None
    hit = torch.cat([_row_tile_hits(p, soa, r0, min(r0 + tile, n))
                     for r0 in range(0, n, tile)]) if n else p.new_zeros((0, 0), dtype=torch.bool)
    return hit & ~torch.eye(n, dtype=torch.bool, device=p.device)


def _first_hits(flat: torch.Tensor, base: torch.Tensor, capacity: int):
    """The buffer row of every position p of ``flat`` (bool (P,)): ``base +
    rank`` for a hit (``base`` hits came before) within the capacity, else
    ``capacity + p``. A scatter into a (capacity + P)-row buffer then keeps
    the first hits in its first rows, and no two positions share a row (a
    shared drop row would serialise the stores on the card)."""
    pos = torch.arange(flat.numel(), dtype=torch.int64, device=flat.device)
    slot = base + torch.cumsum(flat, dim=0) - 1
    return torch.where(flat & (slot < capacity), slot, capacity + pos), pos


def scene_colliding_pairs(polys, mask=None, *, capacity: int,
                          row_tile: int = 64):
    """Fixed-capacity list of colliding index pairs in one shape set.

    Returns ``(pairs, count, overflow)``: ``pairs`` int32 ``(capacity, 2)``,
    rows ``(i, j)`` with ``i < j`` in row-major order, zero-filled past
    ``count``; ``count`` int32 = pairs found, clamped to ``capacity``;
    ``overflow`` bool = the true count exceeds ``capacity`` (the list is
    then the first ``capacity`` pairs in row-major order).

    Row tiles stream through a Python loop that never reads back: each
    tile's cumsum over its flat upper-triangle hits gives each hit the slot
    ``count so far + rank``, the slots are scattered into the buffer and the
    count stays on the device. The (N, N) matrix is never built."""
    p = _prepare(polys, mask)
    n, dev = p.shape[0], p.device
    tile = max(1, min(row_tile, n))
    soa = polygon_cuda.soa_columns(p) if _on_card(p) else None
    buf = torch.zeros((capacity + tile * n, 2), dtype=torch.int64, device=dev)
    cnt = torch.zeros((), dtype=torch.int64, device=dev)
    col = torch.arange(n, dtype=torch.int64, device=dev)
    for r0 in range(0, n, tile):
        r1 = min(r0 + tile, n)
        row = torch.arange(r0, r1, dtype=torch.int64, device=dev)
        flat = (_row_tile_hits(p, soa, r0, r1) & (row[:, None] < col[None, :])).reshape(-1)
        dst, pos = _first_hits(flat, cnt, capacity)
        buf.index_put_((dst,), torch.stack([r0 + pos // n, pos % n], dim=-1))
        cnt = cnt + flat.sum()
    return (buf[:capacity].to(torch.int32),
            torch.clamp(cnt, max=capacity).to(torch.int32), cnt > capacity)


def scene_colliding_pairs_swept(polys, mask=None, *, capacity: int,
                                window: int = 64):
    """Sweep-and-prune colliding pairs: an O(N * window) narrow phase.

    Sorts shapes by AABB x-min (stable) and tests each against its next
    ``window`` successors in sorted order. Returns ``(pairs, count,
    overflow, window_exceeded)``; the first three as
    `scene_colliding_pairs` (row-major, ``i < j`` in ORIGINAL indices), except
    that on overflow the kept ``capacity`` pairs are a row-major-sorted
    subset, not necessarily the prefix. ``window_exceeded`` False certifies
    that every pair whose x intervals overlap fell inside the window (the
    result equals the dense query's); True means pairs may be missing.

    The successor at offset d is a shift of the sorted table: the table is
    packed once (on the card: padded once to kernel 6's multiple) and each
    offset rolls the packed columns; no (N, window, k, 2) gather. The hits
    form one (window, N) plane, extracted by the same cumsum as the dense
    query, and two stable argsorts restore row-major order."""
    p = _prepare(polys, mask)
    n, k, dev = p.shape[0], p.shape[1], p.device
    w = min(window, max(n - 1, 1))
    xs = p[..., 0]
    xmin, xmax = xs.amin(dim=-1), xs.amax(dim=-1)
    order = torch.argsort(xmin, stable=True)
    sx_min, sx_max = xmin[order], xmax[order]
    sp = p[order]
    # The certificate: the farthest sorted successor whose x-min is still
    # <= this row's x-max. Beyond-window successors can only collide if they
    # also x-overlap, so this bounds everything the window could miss.
    reach = torch.searchsorted(sx_min, sx_max, right=True) - 1
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    window_exceeded = (reach - pos > w).any()

    if _on_card(p):
        soa = polygon_cuda.pad_columns(polygon_cuda.soa_columns(sp))
        hits = [polygon_cuda.sat_columns_cuda(soa, torch.roll(soa, -d, dims=1),
                                              k1=k, k2=k)[:n] > 0 for d in range(1, w + 1)]
    else:
        hits = [sat_polygons(sp, torch.roll(sp, -d, dims=0)) == 1 for d in range(1, w + 1)]
    plane = torch.stack(hits) & (pos[None, :] + torch.arange(
        1, w + 1, dtype=torch.int64, device=dev)[:, None] < n)  # (w, N)

    flat = plane.reshape(-1)
    total = flat.sum()
    dst, fpos = _first_hits(flat, torch.zeros((), dtype=torch.int64, device=dev), capacity)
    idx = torch.zeros((capacity + flat.numel(),), dtype=torch.int64, device=dev)
    idx = idx.index_put_((dst,), fpos)[:capacity]
    d = idx // n + 1
    q = idx % n
    oi = order[q]
    oj = order[torch.clamp(q + d, max=n - 1)]
    count = torch.clamp(total, max=capacity)
    valid = torch.arange(capacity, dtype=torch.int64, device=dev) < count
    # Row-major (i, j) by two stable argsorts (no i * n + j key); invalid
    # slots sort last through the n sentinel, then zero-fill.
    pi = torch.where(valid, torch.minimum(oi, oj), n)
    pj = torch.where(valid, torch.maximum(oi, oj), n)
    o1 = torch.argsort(pj, stable=True)
    pi, pj = pi[o1], pj[o1]
    o2 = torch.argsort(pi, stable=True)
    pi, pj = pi[o2], pj[o2]
    pairs = torch.where((pi < n)[:, None], torch.stack([pi, pj], dim=-1), 0)
    return (pairs.to(torch.int32), count.to(torch.int32), total > capacity,
            window_exceeded)


def scene_contact_manifolds(polys, mask=None, *, capacity: int, row_tile: int = 64,
                            broad_phase: str = "dense", window: int = 64):
    """Contact manifolds for every colliding pair in one shape set.

    A broad phase finds the pairs (``'dense'``: `scene_colliding_pairs` with
    ``row_tile``; ``'swept'``: `scene_colliding_pairs_swept` with
    ``window``), then the manifold runs on all ``capacity`` pair slots (rows
    past ``count`` are shape 0 against itself: filter by ``count``).
    Returns ``(pairs, count, n_contacts, points, depths, normals,
    window_exceeded)``: ``n_contacts`` int32 ``(capacity,)``, ``points``
    ``(capacity, 2, 2)``, ``depths`` ``(capacity, 2)``, ``normals``
    ``(capacity, 2)`` from shape ``pairs[r, 0]`` into ``pairs[r, 1]``.

    When the swept certificate fires the sweep may have missed pairs, so the
    call fails closed: ``count`` is 0 and ``pairs`` zero-filled, and the flag
    tells "window too small" from "no contacts"."""
    if broad_phase not in ("dense", "swept"):
        raise ValueError(f"broad_phase must be 'dense' or 'swept', got {broad_phase!r}")
    p = _prepare(polys, mask)
    if broad_phase == "swept":
        pairs, count, _, window_exceeded = scene_colliding_pairs_swept(
            p, capacity=capacity, window=window)
        count = torch.where(window_exceeded, 0, count)
        pairs = torch.where(window_exceeded, 0, pairs)
    else:
        pairs, count, _ = scene_colliding_pairs(p, capacity=capacity, row_tile=row_tile)
        window_exceeded = torch.zeros((), dtype=torch.bool, device=p.device)
    p1 = p.index_select(0, pairs[:, 0].to(torch.int64))
    p2 = p.index_select(0, pairs[:, 1].to(torch.int64))
    if _on_card(p):
        from collide2d_tpu_torch.ops.manifold_cuda import polygon_manifold_cuda

        n_contacts, points, depths, normals = polygon_manifold_cuda(p1, p2)
    else:
        n_contacts, points, depths, normals = manifold.polygon_contact_manifold(p1, p2)
    return pairs, count, n_contacts, points, depths, normals, window_exceeded
