"""Ray casting against convex polygons: half-plane clipping, exact.

Counterpart of ``collide2d_tpu/ops/raycast.py``. A convex polygon is the
intersection of its face half-planes ``n_i . x <= o_i``; a ray ``x(t) =
origin + t * direction`` lies in face i's half-plane on a t-interval given
by one linear inequality, ``n_i . origin + t (n_i . direction) <= o_i``, so
the hit set is the intersection of k half-lines: an (entry, exit) window.

Conventions (as the JAX package):

- ``(t, normal)``: ``t`` in ``[0, t_max]`` is the first-contact parameter
  in units of ``|direction|``, ``+inf`` = no hit; ``normal`` is the unit
  outward normal of the entry face (the first face at the maximum entry),
  zero when there is no hit;
- a ray starting inside the polygon returns ``t = 0`` and a zero normal;
- padding follows `sat.sat_polygons` (repeat-last or ``mask``): a
  zero-length edge is the constraint ``0 <= 0`` and never clips;
- a polygon with no valid face (a point) is never hit.

`polygon_raycast` and `rect_raycast` are torch operations (differentiable).
`scene_raycast` takes one scene of N shapes and a batch of rays; its
``impl`` picks the broadcast + argmin in torch (``'torch'``, the JAX ``jnp``
path) or kernel 11 (``'auto'``/``'cuda'``, `ops.raycast_cuda`).
"""

from __future__ import annotations

import torch

from collide2d_tpu_torch.ops.geometry import edge_normals, rects_from_params
from collide2d_tpu_torch.ops.sat import _normalize_padding

_INF = float("inf")
IMPLS = ("auto", "cuda", "torch")


def _device(*xs) -> torch.device:
    """The device of the torch tensors among ``xs``: numpy arrays and Python
    numbers follow them (the CPU when there are none). Tensors on two
    devices raise; nothing is moved between them."""
    devs = {x.device for x in xs if isinstance(x, torch.Tensor)}
    if len(devs) > 1:
        raise ValueError(f"inputs on more than one device: {sorted(map(str, devs))}")
    return devs.pop() if devs else torch.device("cpu")


def _as_f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _as_mask(mask, device) -> torch.Tensor | None:
    return None if mask is None else torch.as_tensor(mask, dtype=torch.bool, device=device)


def polygon_raycast(origin, direction, polys, mask=None, *,
                    t_max: float = _INF) -> tuple[torch.Tensor, torch.Tensor]:
    """First hit of rays against convex CCW k-gons (elementwise pairs).

    ``origin``/``direction``: ``B + (2,)`` (direction need not be unit);
    ``polys``: ``B + (k, 2)``. Returns ``(t, normal)`` float32, ``B`` and
    ``B + (2,)``, under the module's conventions. Numpy or Python inputs
    go to the device of the torch tensors among the inputs."""
    dev = _device(origin, direction, polys, mask)
    origin = _as_f32(origin, dev)
    direction = _as_f32(direction, dev)
    p = _normalize_padding(_as_f32(polys, dev), _as_mask(mask, dev))

    n = edge_normals(p)  # B+(k,2), outward, unnormalised
    nx, ny = n[..., 0], n[..., 1]
    off = nx * p[..., 0] + ny * p[..., 1]
    no = nx * origin[..., None, 0] + ny * origin[..., None, 1]
    nd = nx * direction[..., None, 0] + ny * direction[..., None, 1]
    num = off - no  # constraint: t * nd <= num

    ratio = num / torch.where(nd == 0, 1.0, nd)
    # Parallel faces (nd == 0): satisfied for all t when num >= 0, violated
    # for all t when num < 0 (an empty window). A zero (padding) normal has
    # num == 0: trivially satisfied.
    parallel_miss = (nd == 0) & (num < 0)
    lo_i = torch.where(nd < 0, ratio, torch.where(parallel_miss, _INF, -_INF))
    hi_i = torch.where(nd > 0, ratio, torch.where(parallel_miss, -_INF, _INF))
    entry = lo_i.amax(dim=-1)
    exit_ = hi_i.amin(dim=-1)

    any_face = (nx * nx + ny * ny > 0).any(dim=-1)
    hit = (entry <= exit_) & (entry <= t_max) & (exit_ >= 0) & any_face
    inside = hit & (entry < 0)
    t = torch.where(hit, torch.clamp(entry, min=0.0), _INF)

    # Entry-face normal: the first face whose lower bound is the entry.
    ia = lo_i.argmax(dim=-1)
    nb = torch.broadcast_to(n, lo_i.shape + (2,))
    nw = torch.gather(nb, -2, ia[..., None, None].expand(*ia.shape, 1, 2))[..., 0, :]
    nn = torch.sqrt(nw[..., 0] * nw[..., 0] + nw[..., 1] * nw[..., 1])[..., None]
    unit = nw / torch.where(nn > 0, nn, 1.0)
    normal = torch.where((hit & ~inside)[..., None], unit, torch.zeros_like(unit))
    return t, normal


def rect_raycast(origin, direction, center, extents, angle, *,
                 t_max: float = _INF) -> tuple[torch.Tensor, torch.Tensor]:
    """`polygon_raycast` against oriented boxes in param form (centres, FULL
    extents (negative ones rectified), angles)."""
    dev = _device(origin, direction, center, extents, angle)
    rect = rects_from_params(_as_f32(center, dev), _as_f32(extents, dev).abs(),
                             _as_f32(angle, dev))
    return polygon_raycast(origin, direction, rect, t_max=t_max)


def scene_raycast(origin, direction, polys, mask=None, *, t_max: float = _INF,
                  impl: str = "auto") -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """First hit of rays against one scene of N convex shapes.

    ``origin``/``direction``: ``(2,)`` or any ``B + (2,)`` (broadcast
    together); ``polys``: ``(N, k, 2)`` with an optional ``(N, k)`` bool
    ``mask``. Returns ``(t, index, normal)``, ``B``, ``B`` int32 and ``B +
    (2,)``: the earliest hit (``+inf`` = nothing hit), the index of the hit
    shape (the first at the minimum; 0 when nothing is hit, so check ``t``)
    and its entry normal. The call runs on the device of the torch tensors
    among the inputs: a scene given as numpy goes to the rays' card (and
    rays given as numpy to the scene's); torch tensors on two devices raise.

    ``impl``:

    - ``'auto'`` (the default) and ``'cuda'``: kernel 11
      (`ops.raycast_cuda`), the scene's unit-normal face tables staged in
      shared memory and one thread a ray, on CUDA tensors; on CPU tensors
      its plain version on the same tables. Every leading ray shape is
      flattened to (R, 2), so a single ray reaches the kernel too. No
      backward: inputs that require grad raise.
    - ``'torch'``: the broadcast of `polygon_raycast` over the shapes and a
      first-index argmin (the JAX ``jnp`` path), differentiable.

    The JAX package defaults to its ``jnp`` path; the port defaults to
    ``'auto'`` so that nothing on the card's path runs a plain version. The
    kernel works on unit normals (the JAX Pallas tables) where ``'torch'``
    keeps them unnormalised: the two agree on hits and indices away from
    razor ties, and on t and normals to float32 rounding."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    dev = _device(origin, direction, polys, mask)
    p = _as_f32(polys, dev)
    mask = _as_mask(mask, dev)
    origin = _as_f32(origin, dev)
    direction = _as_f32(direction, dev)
    if impl == "torch":
        ts, normals = polygon_raycast(origin[..., None, :], direction[..., None, :],
                                      p, mask, t_max=t_max)  # (..., N), (..., N, 2)
        idx = ts.argmin(dim=-1)
        t = torch.gather(ts, -1, idx[..., None])[..., 0]
        normal = torch.gather(normals, -2,
                              idx[..., None, None].expand(*idx.shape, 1, 2))[..., 0, :]
        return t, idx.to(torch.int32), normal

    from collide2d_tpu_torch.ops import raycast_cuda

    if p.dim() != 3:
        raise ValueError(f"impl={impl!r} takes one scene (N, k, 2), got "
                         f"{tuple(p.shape)}; use impl='torch' for batched scenes")
    origin, direction = torch.broadcast_tensors(origin, direction)
    lead = origin.shape[:-1]
    table = raycast_cuda.pack_scene_tables(p, mask)
    t, idx, normal = raycast_cuda.scene_raycast_cuda_t(
        origin.reshape(-1, 2).contiguous(), direction.reshape(-1, 2).contiguous(),
        table, t_max=t_max)
    return t.reshape(lead), idx.reshape(lead), normal.reshape(lead + (2,))
