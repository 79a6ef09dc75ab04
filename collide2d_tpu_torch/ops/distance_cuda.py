"""Signed distances of box and k-gon pairs: kernels 8 and 9 and their plain
versions.

Counterpart of ``collide2d_tpu/ops/distance_pallas.py``, on its layouts:
boxes are the (6, 8, M) SoA of `sat_cuda.pack_obbs` (cx, cy, cos, sin,
|w|/2, |h|/2), k-gons the (2K, 8, M) SoA of `polygon_cuda.pack_polygons`.

- `obb_signed_distance_tile` is the closed-form box signed distance on
  elementwise tensors (kernel 8's plain version, and the distance inside
  kernel 12's advancement loop). Its overlap side is `ops.sat.obb_overlap`'s
  gaps kept as signed values, so ``distance <= 0`` is bitwise the
  `obb_collide` label; its disjoint side is the vertex-to-box minimum over
  both boxes' vertices in the other's frame.
- `polygon_distance_plain` is kernel 9's arithmetic: support gaps over the
  true edge normals scaled by ``1 / sqrt(|n|^2)`` when overlapping, else the
  vertex-segment minimum, on polygons padded to their K bucket
  (`polygon_cuda.k_bucket`). It stays the definition above 16 vertices,
  where the kernel loops over the true K and takes the padding's point
  distances itself.

The ``*_cuda_t`` functions take packed batches and route on their device:
a CUDA tensor launches ``csrc/distance_kernel.cu`` (built at first use by
`utils.cuda_build`, one library for every K: kernel 9 pads k-gons to the
buckets 4, 8 and 16 in registers, and above 16 vertices in either polygon
runs a body over the true K1 and K2 with the pairs' vertices staged in
shared memory, ``csrc/polygon_big_k.cuh``) and counts the launch in
``LAUNCHES[name]``; a failed build or launch raises; a CPU tensor runs the
plain version. The kernels have no backward: inputs that
require grad raise (the differentiable path is `ops.distance`,
``impl='torch'`` on the models).
`polygon_distance_passes` runs kernel 9 through the library's build that
counts the pairs its passes take (every axis; the segment tests), in
either body.

`rect_distance_cuda` and `polygon_distance_cuda` are the drop-ins for
`ops.distance.rect_signed_distance` / `polygon_signed_distance`: they pad N,
pack and return float32 (N,).
"""

from __future__ import annotations

import ctypes

import torch

from collide2d_tpu_torch.ops import polygon_cuda, sat_cuda
from collide2d_tpu_torch.utils import cuda_build

LANE_BLOCK = sat_cuda.LANE_BLOCK  # boxes: the M % block contract of pack_obbs
POLY_LANE_BLOCK = polygon_cuda.LANE_BLOCK
_KERNEL = "distance_kernel"
# Launches of each CUDA kernel in this process (never the plain versions).
LAUNCHES = {"obb_distance": 0, "polygon_distance": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def refuse_grad(*tensors) -> None:
    """The kernels have no backward: raise rather than return a result
    without a gradient."""
    if any(isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise ValueError("the CUDA kernels have no backward; use impl='torch' "
                         "for gradients")


def obb_signed_distance_tile(dx, dy, c1, s1, hx1, hy1, c2, s2, hx2, hy2):
    """The closed-form box signed distance on elementwise tensors.

    ``(dx, dy)`` is centre 2 - centre 1, ``(ci, si)`` each box's cos/sin,
    ``hxi, hyi`` HALF extents. Every product and sum is its own torch
    operation, in `distance_pallas.obb_signed_distance_tile`'s order."""
    # overlap side: signed gaps along the 4 unit SAT axes (obb_overlap's)
    cd = (c1 * c2 + s1 * s2).abs()
    sd = (s1 * c2 - c1 * s2).abs()
    da1 = (dx * c1 + dy * s1).abs()
    da2 = (-dx * s1 + dy * c1).abs()
    db1 = (dx * c2 + dy * s2).abs()
    db2 = (-dx * s2 + dy * c2).abs()
    gap = torch.maximum(da1 - (hx1 + hx2 * cd + hy2 * sd),
                        da2 - (hy1 + hx2 * sd + hy2 * cd))
    gap = torch.maximum(gap, db1 - (hx2 + hx1 * cd + hy1 * sd))
    gap = torch.maximum(gap, db2 - (hy2 + hx1 * sd + hy1 * cd))

    # disjoint side: vertex-to-box minima in each local frame
    cb = c1 * c2 + s1 * s2  # B's axes in A's frame (relative rotation)
    sb = c1 * s2 - s1 * c2
    pax = dx * c1 + dy * s1  # B's centre in A's frame
    pay = -dx * s1 + dy * c1
    pbx = -(dx * c2 + dy * s2)  # A's centre in B's frame
    pby = -(-dx * s2 + dy * c2)

    def point_box_d2(px, py, hx, hy):
        qx = torch.clamp(px.abs() - hx, min=0.0)
        qy = torch.clamp(py.abs() - hy, min=0.0)
        return qx * qx + qy * qy

    d2 = None
    for sx in (1.0, -1.0):
        for sy in (1.0, -1.0):
            vx = pax + sx * hx2 * cb - sy * hy2 * sb
            vy = pay + sx * hx2 * sb + sy * hy2 * cb
            t = point_box_d2(vx, vy, hx1, hy1)
            wx = pbx + sx * hx1 * cb + sy * hy1 * sb
            wy = pby - sx * hx1 * sb + sy * hy1 * cb
            t = torch.minimum(t, point_box_d2(wx, wy, hx2, hy2))
            d2 = t if d2 is None else torch.minimum(d2, t)
    return torch.where(gap < 0, gap, torch.sqrt(d2))


def obb_distance_plain(b1t: torch.Tensor, b2t: torch.Tensor,
                       shift: float = 0.0) -> torch.Tensor:
    """Kernel 8 in torch operations: float32 (8, M) signed distances of
    packed boxes, ``shift`` added to every second-box centre."""
    shift = sat_cuda._f32(shift)
    dx = (b2t[0] + shift) - b1t[0]
    dy = (b2t[1] + shift) - b1t[1]
    return obb_signed_distance_tile(dx, dy, b1t[2], b1t[3], b1t[4], b1t[5],
                                    b2t[2], b2t[3], b2t[4], b2t[5])


def distance_defines(count: bool = False) -> tuple[tuple[str, int], ...]:
    """The ``-D`` defines of the kernels' library: ``count`` builds the
    variant that counts kernel 9's pairs through each pass
    (`polygon_distance_passes`)."""
    return (("POLYDIST_COUNT", 1),) if count else ()


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the launch functions' C signatures on a loaded library (the
    counting one where it has it)."""
    p, ll, f, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float, ctypes.c_int
    lib.obb_distance_launch.restype = ctypes.c_int
    lib.obb_distance_launch.argtypes = [p, p, p, ll, f, p]
    lib.polygon_distance_launch.restype = ctypes.c_int
    lib.polygon_distance_launch.argtypes = [p, p, p, ll, i, i, p]
    if hasattr(lib, "polygon_distance_counts"):
        lib.polygon_distance_counts.restype = ctypes.c_int
        lib.polygon_distance_counts.argtypes = [p]
    return lib


def _kernel_lib(count: bool = False) -> ctypes.CDLL:
    return bind(cuda_build.load(_KERNEL, distance_defines(count)))


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}_launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def obb_distance_cuda_t(b1t: torch.Tensor, b2t: torch.Tensor, shift: float = 0.0,
                        *, block: int = LANE_BLOCK) -> torch.Tensor:
    """Signed distance over SoA param boxes: (6, 8, M) x (6, 8, M) float32
    -> float32 (8M,). M must be a multiple of ``block``."""
    refuse_grad(b1t, b2t)
    sat_cuda._check(b1t, b2t, 6, (torch.float32,), block)
    if b1t.device.type == "cpu":
        return obb_distance_plain(b1t, b2t, shift).reshape(-1)
    if not (b1t.is_contiguous() and b2t.is_contiguous()):
        raise ValueError("packed inputs must be contiguous")
    n = b1t.shape[1] * b1t.shape[2]
    out = torch.empty((n,), dtype=torch.float32, device=b1t.device)
    lib = _kernel_lib()
    _launched("obb_distance", cuda_build.launch(
        b1t.device, lib.obb_distance_launch, b1t.data_ptr(), b2t.data_ptr(),
        out.data_ptr(), n, sat_cuda._f32(shift)))
    return out


def rect_distance_cuda(c1, ext1, th1, c2, ext2, th2, *,
                       block: int = LANE_BLOCK) -> torch.Tensor:
    """Drop-in for `ops.distance.rect_signed_distance` on param boxes
    (centres and FULL extents (N, 2), angles (N,); negative extents
    rectified by `pack_obbs`): float32 (N,). Values agree with the polygon
    path to f32 rounding; ``distance <= 0`` is bitwise `obb_collide`'s label."""
    refuse_grad(c1, ext1, th1, c2, ext2, th2)
    n = c1.shape[0]
    padded = -(-n // (8 * block)) * (8 * block)
    args = [sat_cuda._pad_rows(a.to(torch.float32), padded)
            for a in (c1, ext1, th1, c2, ext2, th2)]
    out = obb_distance_cuda_t(sat_cuda.pack_obbs(*args[:3]),
                              sat_cuda.pack_obbs(*args[3:]), block=block)
    return out[:n]


def _padded_columns(pt: torch.Tensor, k: int):
    """The x and y rows of a packed (2k, 8, M) batch, each padded to its K
    bucket (`polygon_cuda.k_bucket`) by repeating row k-1: two (K, 8, M)
    tensors."""
    kb = polygon_cuda.k_bucket(k)
    x, y = pt[:k], pt[k:]
    if kb > k:
        x = torch.cat([x, x[k - 1:k].expand(kb - k, *x.shape[1:])])
        y = torch.cat([y, y[k - 1:k].expand(kb - k, *y.shape[1:])])
    return x, y


def _inv_norm(nn: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(nn) in two IEEE-rounded operations (the kernels' inv_norm)."""
    return torch.reciprocal(torch.sqrt(nn))


def polygon_distance_plain(p1t: torch.Tensor, p2t: torch.Tensor, k1: int,
                           k2: int) -> torch.Tensor:
    """Kernel 9 in torch operations: float32 (8, M) signed distances of
    packed k-gon pairs, each polygon padded to its K bucket (the kernel's
    registers up to 16 vertices; above, its body over the true K gives the
    same bits)."""
    x1, y1 = _padded_columns(p1t, k1)
    x2, y2 = _padded_columns(p2t, k2)
    gap = None
    for xs, ys in ((x1, y1), (x2, y2)):
        for i in range(xs.shape[0]):
            j = (i + 1) % xs.shape[0]
            ax = ys[j] - ys[i]  # true normal of edge i -> j
            ay = xs[i] - xs[j]
            nn = ax * ax + ay * ay
            proj1 = ax * x1 + ay * y1  # (K1, 8, M)
            proj2 = ax * x2 + ay * y2
            g = (torch.maximum(proj2.amin(0) - proj1.amax(0),
                               proj1.amin(0) - proj2.amax(0))
                 * _inv_norm(torch.where(nn > 0, nn, 1.0)))
            g = torch.where(nn > 0, g, -float("inf"))
            gap = g if gap is None else torch.maximum(gap, g)
    d2 = None
    for (px, py), (qx, qy) in (((x1, y1), (x2, y2)), ((x2, y2), (x1, y1))):
        for j in range(qx.shape[0]):
            j2 = (j + 1) % qx.shape[0]
            ex = qx[j2] - qx[j]
            ey = qy[j2] - qy[j]
            ee = ex * ex + ey * ey
            live = ee > 0
            inv = torch.reciprocal(torch.where(live, ee, 1.0))
            dx = px - qx[j]  # every vertex of p: (KP, 8, M)
            dy = py - qy[j]
            t = torch.clamp((dx * ex + dy * ey) * inv, 0.0, 1.0) * live
            cx = dx - t * ex
            cy = dy - t * ey
            dd = (cx * cx + cy * cy).amin(0)
            d2 = dd if d2 is None else torch.minimum(d2, dd)
    return torch.where(gap < 0, gap, torch.sqrt(d2))


def check_polygons(p1t: torch.Tensor, p2t: torch.Tensor, k1: int, k2: int,
                   block: int) -> None:
    """Validate a packed float32 k-gon pair batch for kernels 9 and 10:
    (2K1, 8, M) and (2K2, 8, M) with M a multiple of ``block``."""
    refuse_grad(p1t, p2t)
    if p1t.dtype != torch.float32 or p2t.dtype != torch.float32:
        raise ValueError(f"packed inputs must be float32, got {p1t.dtype} and "
                         f"{p2t.dtype}")
    if k1 < 1 or k2 < 1:
        raise ValueError(f"K1 and K2 must be >= 1, got {k1} and {k2}")
    if (p1t.dim() != 3 or p1t.shape[:2] != (2 * k1, 8) or p2t.dim() != 3
            or p2t.shape[:2] != (2 * k2, 8) or p2t.shape[2] != p1t.shape[2]):
        raise ValueError(f"packed inputs must be (2*{k1}, 8, M) and (2*{k2}, 8, M), "
                         f"got {tuple(p1t.shape)} and {tuple(p2t.shape)}")
    if p1t.device != p2t.device:
        raise ValueError(f"inputs on {p1t.device} and {p2t.device}")
    if p1t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {p1t.device}")
    if p1t.shape[2] % block:
        raise ValueError(f"M={p1t.shape[2]} must be a multiple of block={block}")
    if not (p1t.is_contiguous() and p2t.is_contiguous()):
        raise ValueError("packed inputs must be contiguous")


def polygon_distance_cuda_t(p1t: torch.Tensor, p2t: torch.Tensor, *, k1: int,
                            k2: int, block: int = POLY_LANE_BLOCK) -> torch.Tensor:
    """Signed distance over SoA k-gon pairs: (2K1, 8, M) x (2K2, 8, M)
    float32 -> float32 (8M,). M must be a multiple of ``block``."""
    return _polygon_distance(p1t, p2t, k1, k2, block, None)


def polygon_distance_passes(p1t: torch.Tensor, p2t: torch.Tensor, *, k1: int,
                            k2: int, block: int = POLY_LANE_BLOCK):
    """`polygon_distance_cuda_t` on the card through the library that counts
    its work: ``(result, pairs through every axis, pairs through the
    segment tests)``. It synchronises the card to read the counts."""
    if p1t.device.type != "cuda":
        raise ValueError(f"counts the kernel's work on a card, got {p1t.device}")
    counts = (ctypes.c_ulonglong * 2)()
    out = _polygon_distance(p1t, p2t, k1, k2, block, counts)
    return out, int(counts[0]), int(counts[1])


def _polygon_distance(p1t, p2t, k1, k2, block, counts):
    check_polygons(p1t, p2t, k1, k2, block)
    if p1t.device.type == "cpu":
        return polygon_distance_plain(p1t, p2t, k1, k2).reshape(-1)
    n = p1t.shape[1] * p1t.shape[2]
    out = torch.empty((n,), dtype=torch.float32, device=p1t.device)
    lib = _kernel_lib(counts is not None)
    _launched("polygon_distance", cuda_build.launch(
        p1t.device, lib.polygon_distance_launch, p1t.data_ptr(), p2t.data_ptr(),
        out.data_ptr(), n, int(k1), int(k2)))
    if counts is not None:
        # the counters live on the launch's device
        with torch.cuda.device(p1t.device):
            err = lib.polygon_distance_counts(counts)
            if err != 0:
                raise RuntimeError(
                    f"polygon_distance_counts failed: CUDA error {err}")
    return out


def pad_pairs(p1: torch.Tensor, p2: torch.Tensor, align: int):
    """Pad (N, K1, 2) and (N, K2, 2) batches to a multiple of ``align``
    rows with copies of the last pair (sliced away by the caller)."""
    n = p1.shape[0]
    padded = -(-n // align) * align
    if padded != n:
        p1 = torch.cat([p1, p1[-1:].expand(padded - n, *p1.shape[1:])])
        p2 = torch.cat([p2, p2[-1:].expand(padded - n, *p2.shape[1:])])
    return p1, p2


def polygon_distance_cuda(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Drop-in for `ops.distance.polygon_signed_distance` on repeat-padded
    (N, K, 2) inputs (no masks): float32 (N,). ``distance <= 0`` is bitwise
    `sat_polygons`' label."""
    refuse_grad(p1, p2)
    n, k1, k2 = p1.shape[0], p1.shape[1], p2.shape[1]
    if n == 0:
        return torch.zeros((0,), dtype=torch.float32, device=p1.device)
    a, b = pad_pairs(p1.to(torch.float32), p2.to(torch.float32),
                     8 * POLY_LANE_BLOCK)
    out = polygon_distance_cuda_t(polygon_cuda.pack_polygons(a),
                                  polygon_cuda.pack_polygons(b), k1=k1, k2=k2)
    return out[:n]
