"""Contact manifolds of convex k-gon pairs: kernel 10 and its plain version.

Counterpart of ``collide2d_tpu/ops/manifold_pallas.py``, on the (2K, 8, M)
SoA of `polygon_cuda.pack_polygons`, with its output: float32 (9, 8, M),
rows [count, p0x, p0y, p1x, p1y, d0, d1, nx, ny].

`polygon_manifold_plain` is the kernel's arithmetic in torch operations
(`manifold_pallas._manifold_body`: per-face separations, the reference face
as the first max, the incident face as the first min of the normal
alignment, two side clips and the depth filter), with the winners carried
as select-updated tensors and polygons padded to the kernel's K bucket. The
unit normals are ``n * (1 / sqrt(|n|^2))`` in two IEEE operations, as the
kernel computes them, so both choose the same faces.

`polygon_manifold_cuda_t` routes on the device of its inputs: a CUDA tensor
launches ``csrc/manifold_kernel.cu`` (built at first use; k-gons above 16
vertices in the library of their bucket pair,
`polygon_cuda.kernel_defines`) and counts the launch in ``LAUNCHES``; a
failed build or launch raises; a CPU tensor runs the plain version. Inputs
that require grad raise (the kernel has no backward).
`polygon_manifold_cuda` is the drop-in for
`ops.manifold.polygon_contact_manifold` on repeat-padded (N, K, 2) inputs.
"""

from __future__ import annotations

import ctypes

import torch

from collide2d_tpu_torch.ops import polygon_cuda, sat_cuda
from collide2d_tpu_torch.ops.distance_cuda import (
    POLY_LANE_BLOCK,
    _inv_norm,
    _padded_columns,
    check_polygons,
    pad_pairs,
    refuse_grad,
)

_KERNEL = "manifold_kernel"
# Launches of the CUDA kernel in this process (never the plain version).
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _best_face(xs, ys, oxs, oys):
    """The max-separation face of (xs, ys) (K, 8, M) against the other
    body's vertices: (sep, nx, ny, ax, ay, bx, by), strict first max."""
    neg_inf = torch.full_like(xs[0], -float("inf"))
    zero = torch.zeros_like(xs[0])
    best, bnx, bny, bax, bay, bbx, bby = neg_inf, zero, zero, zero, zero, zero, zero
    k = xs.shape[0]
    for i in range(k):
        j = (i + 1) % k
        ax = ys[j] - ys[i]  # outward normal of edge i -> j (CCW)
        ay = xs[i] - xs[j]
        nn = ax * ax + ay * ay
        r = _inv_norm(torch.where(nn > 0, nn, 1.0))
        ux = ax * r
        uy = ay * r
        off = ux * xs[i] + uy * ys[i]
        m = (ux * oxs + uy * oys).amin(0)
        s = torch.where(nn > 0, m - off, -float("inf"))
        upd = s > best
        best = torch.where(upd, s, best)
        bnx = torch.where(upd, ux, bnx)
        bny = torch.where(upd, uy, bny)
        bax = torch.where(upd, xs[i], bax)
        bay = torch.where(upd, ys[i], bay)
        bbx = torch.where(upd, xs[j], bbx)
        bby = torch.where(upd, ys[j], bby)
    return best, bnx, bny, bax, bay, bbx, bby


def _clip_halfplane(w1x, w1y, w2x, w2y, pnx, pny, off):
    """`ops.manifold._clip_segment` on coordinate tensors."""
    d1 = w1x * pnx + w1y * pny - off
    d2 = w2x * pnx + w2y * pny - off
    denom = d1 - d2
    t = torch.clamp(d1 / torch.where(denom == 0, 1.0, denom), 0.0, 1.0)
    crossing = (d1 > 0) != (d2 > 0)
    mx = w1x + t * (w2x - w1x)
    my = w1y + t * (w2y - w1y)
    c1 = (d1 > 0) & crossing
    c2 = (d2 > 0) & crossing
    both_out = (d1 > 0) & (d2 > 0)
    use1 = d1 <= d2
    cx = torch.where(use1, w1x, w2x)
    cy = torch.where(use1, w1y, w2y)
    return (torch.where(both_out, cx, torch.where(c1, mx, w1x)),
            torch.where(both_out, cy, torch.where(c1, my, w1y)),
            torch.where(both_out, cx, torch.where(c2, mx, w2x)),
            torch.where(both_out, cy, torch.where(c2, my, w2y)))


def polygon_manifold_plain(p1t: torch.Tensor, p2t: torch.Tensor, k1: int,
                           k2: int, margin: float = 0.0) -> torch.Tensor:
    """Kernel 10 in torch operations: float32 (9, 8, M) manifolds of packed
    k-gon pairs, rows [count, p0x, p0y, p1x, p1y, d0, d1, nx, ny]."""
    x1, y1 = _padded_columns(p1t, k1)
    x2, y2 = _padded_columns(p2t, k2)
    s1, n1x, n1y, a1x, a1y, b1x, b1y = _best_face(x1, y1, x2, y2)
    s2, n2x, n2y, a2x, a2y, b2x, b2y = _best_face(x2, y2, x1, y1)
    ref1 = s1 >= s2 - 1e-6 * torch.clamp(s2.abs(), min=1.0)
    best_sep = torch.where(ref1, s1, s2)
    nx = torch.where(ref1, n1x, n2x)
    ny = torch.where(ref1, n1y, n2y)
    r1x = torch.where(ref1, a1x, a2x)
    r1y = torch.where(ref1, a1y, a2y)
    r2x = torch.where(ref1, b1x, b2x)
    r2y = torch.where(ref1, b1y, b2y)

    # Incident face over the common K: the most anti-parallel valid face.
    k = max(x1.shape[0], x2.shape[0])
    ix = [torch.where(ref1, x2[min(j, x2.shape[0] - 1)], x1[min(j, x1.shape[0] - 1)])
          for j in range(k)]
    iy = [torch.where(ref1, y2[min(j, y2.shape[0] - 1)], y1[min(j, y1.shape[0] - 1)])
          for j in range(k)]
    best_a = torch.full_like(nx, float("inf"))
    v1x = v1y = v2x = v2y = torch.zeros_like(nx)
    for j in range(k):
        jn = (j + 1) % k
        ax = iy[jn] - iy[j]
        ay = ix[j] - ix[jn]
        nn = ax * ax + ay * ay
        r = _inv_norm(torch.where(nn > 0, nn, 1.0))
        align = torch.where(nn > 0, (ax * nx + ay * ny) * r, float("inf"))
        upd = align < best_a
        best_a = torch.where(upd, align, best_a)
        v1x = torch.where(upd, ix[j], v1x)
        v1y = torch.where(upd, iy[j], v1y)
        v2x = torch.where(upd, ix[jn], v2x)
        v2y = torch.where(upd, iy[jn], v2y)

    tx, ty = -ny, nx
    v1x, v1y, v2x, v2y = _clip_halfplane(v1x, v1y, v2x, v2y, -tx, -ty,
                                         -(tx * r1x + ty * r1y))
    v1x, v1y, v2x, v2y = _clip_halfplane(v1x, v1y, v2x, v2y, tx, ty,
                                         tx * r2x + ty * r2y)
    off = nx * r1x + ny * r1y
    d1 = off - (nx * v1x + ny * v1y)
    d2 = off - (nx * v2x + ny * v2y)
    margin = sat_cuda._f32(margin)
    pair_ok = (best_sep <= margin) & (best_sep > -float("inf"))
    keep1 = (d1 >= -margin) & pair_ok
    keep2 = (d2 >= -margin) & pair_ok
    swap = ~keep1 & keep2
    return torch.stack([
        keep1.to(torch.float32) + keep2.to(torch.float32),
        torch.where(swap, v2x, v1x), torch.where(swap, v2y, v1y),
        torch.where(swap, v1x, v2x), torch.where(swap, v1y, v2y),
        torch.where(swap, d2, d1), torch.where(swap, d1, d2),
        torch.where(ref1, nx, -nx), torch.where(ref1, ny, -ny),
    ])


def _kernel_lib(k1: int, k2: int) -> ctypes.CDLL:
    from collide2d_tpu_torch.utils import cuda_build

    lib = cuda_build.load(_KERNEL, polygon_cuda.kernel_defines(k1, k2))
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.polygon_manifold_launch.restype = ctypes.c_int
    lib.polygon_manifold_launch.argtypes = [p, p, p, ll, i, i, ctypes.c_float, p]
    return lib


def polygon_manifold_cuda_t(p1t: torch.Tensor, p2t: torch.Tensor, *, k1: int,
                            k2: int, margin: float = 0.0,
                            block: int = POLY_LANE_BLOCK) -> torch.Tensor:
    """Manifolds over SoA k-gon pairs: (2K1, 8, M) x (2K2, 8, M) float32 ->
    float32 (9, 8, M). M must be a multiple of ``block``."""
    global LAUNCHES
    check_polygons(p1t, p2t, k1, k2, block)
    if p1t.device.type == "cpu":
        return polygon_manifold_plain(p1t, p2t, k1, k2, margin)
    out = torch.empty((9,) + tuple(p1t.shape[1:]), dtype=torch.float32,
                      device=p1t.device)
    n = p1t.shape[1] * p1t.shape[2]
    lib = _kernel_lib(k1, k2)
    # The launch goes to the current device: make it the tensors' one.
    with torch.cuda.device(p1t.device):
        err = lib.polygon_manifold_launch(
            p1t.data_ptr(), p2t.data_ptr(), out.data_ptr(), n, int(k1), int(k2),
            sat_cuda._f32(margin),
            torch.cuda.current_stream(p1t.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"polygon_manifold_launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def unpack_manifold(out: torch.Tensor, n: int):
    """(9, 8, M) rows -> ``(count int32 (n,), points (n, 2, 2), depths
    (n, 2), normal (n, 2))`` for the first ``n`` pairs."""
    flat = out.reshape(9, -1)[:, :n]
    points = torch.stack([torch.stack([flat[1], flat[2]], -1),
                          torch.stack([flat[3], flat[4]], -1)], dim=-2)
    return (flat[0].to(torch.int32), points,
            torch.stack([flat[5], flat[6]], -1), torch.stack([flat[7], flat[8]], -1))


def polygon_manifold_cuda(p1: torch.Tensor, p2: torch.Tensor, *,
                          margin: float = 0.0):
    """Drop-in for `ops.manifold.polygon_contact_manifold` on repeat-padded
    (N, K, 2) inputs (no masks): ``(count, points, depths, normal)`` with
    its shapes and contract. Values agree to f32 rounding; face choices at
    exact separation ties may differ."""
    refuse_grad(p1, p2)
    n, k1, k2 = p1.shape[0], p1.shape[1], p2.shape[1]
    a, b = pad_pairs(p1.to(torch.float32), p2.to(torch.float32),
                     8 * POLY_LANE_BLOCK)
    if n == 0:
        out = torch.zeros((9, 8, 0), dtype=torch.float32, device=p1.device)
    else:
        out = polygon_manifold_cuda_t(polygon_cuda.pack_polygons(a),
                                      polygon_cuda.pack_polygons(b), k1=k1,
                                      k2=k2, margin=margin)
    return unpack_manifold(out, n)
