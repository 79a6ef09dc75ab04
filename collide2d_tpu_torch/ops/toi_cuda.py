"""Time of impact of moving boxes: kernel 12 and its plain version.

Counterpart of ``collide2d_tpu/ops/toi_pallas.py``, on its layout: a
moving-box batch is the (8, 8, M) SoA of `pack_moving_obbs`, rows cx, cy,
theta, |w|/2, |h|/2, vx, vy, omega, pair ``p = s * M + l`` at ``[:, s, l]``.

`moving_obb_toi_plain` is the kernel's function in torch operations: lanes
with both angular rates 0 take the exact translation window
(`ops.toi.obb_translation_toi_parts`); rotating lanes run the
fixed-trip conservative-advancement loop of `ops.toi._advance` on the
closed-form box distance (`distance_cuda.obb_signed_distance_tile`) at the
advanced centres and angles. It can also return each lane's count of
advancement steps (what the work of the kernel depends on).

`moving_obb_toi_cuda_t` routes on the device of its inputs: a CUDA tensor
launches ``csrc/toi_kernel.cu`` (built at first use) and counts the launch
in ``LAUNCHES``; a failed build or launch raises; a CPU tensor runs the
plain version. Inputs that require grad raise (no backward).
`rect_toi_cuda` is the drop-in for `ops.toi.rect_time_of_impact`.
"""

from __future__ import annotations

import ctypes

import torch

from collide2d_tpu_torch.ops import sat_cuda
from collide2d_tpu_torch.ops.distance_cuda import obb_signed_distance_tile, refuse_grad
from collide2d_tpu_torch.ops.toi import obb_translation_toi_parts
from collide2d_tpu_torch.utils import cuda_build

LANE_BLOCK = 1024  # lanes per block of the TPU grid; kept for the M % block contract
_KERNEL = "toi_kernel"
# Launches of the CUDA kernel in this process (never the plain version).
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def pack_moving_obbs(c: torch.Tensor, ext: torch.Tensor, th, v: torch.Tensor,
                     w) -> torch.Tensor:
    """(N,2) centres + (N,2) FULL extents + (N,) angles + (N,2) velocities
    + (N,) angular rates -> (8, 8, N/8): cx, cy, theta, |w|/2, |h|/2, vx,
    vy, omega. Angles and rates may be scalars. N % 8 == 0."""
    n = c.shape[0]
    if n % 8:
        raise ValueError(f"pack_moving_obbs needs N % 8 == 0, got N={n}")
    f32 = lambda x: torch.broadcast_to(  # noqa: E731
        torch.as_tensor(x, dtype=torch.float32, device=c.device), (n,))
    rows = torch.stack([c[:, 0], c[:, 1], f32(th), ext[:, 0].abs() * 0.5,
                        ext[:, 1].abs() * 0.5, v[:, 0], v[:, 1], f32(w)])
    return rows.reshape(8, 8, n // 8)


def moving_obb_toi_plain(b1t: torch.Tensor, b2t: torch.Tensor, *, t_max: float,
                         iters: int, tol: float, return_steps: bool = False):
    """Kernel 12 in torch operations: float32 (8, M) first impact times of
    packed moving boxes (+inf for none). With ``return_steps``, also the
    int32 (8, M) advancement steps each lane took (0 for translation)."""
    cx1, cy1, th1, hx1, hy1, vx1, vy1, w1 = b1t
    cx2, cy2, th2, hx2, hy2, vx2, vy2, w2 = b2t
    t_max, tol = sat_cuda._f32(t_max), sat_cuda._f32(tol)
    rvx = vx2 - vx1
    rvy = vy2 - vy1
    r1 = torch.sqrt(hx1 * hx1 + hy1 * hy1)  # circumradius (half extents)
    r2 = torch.sqrt(hx2 * hx2 + hy2 * hy2)
    bound = torch.clamp(torch.sqrt(rvx * rvx + rvy * rvy) + w1.abs() * r1
                        + w2.abs() * r2, min=1e-30)

    def dist_at(t):
        a1 = th1 + t * w1
        a2 = th2 + t * w2
        dx = (cx2 + t * vx2) - (cx1 + t * vx1)
        dy = (cy2 + t * vy2) - (cy1 + t * vy1)
        return obb_signed_distance_tile(dx, dy, torch.cos(a1), torch.sin(a1),
                                        hx1, hy1, torch.cos(a2), torch.sin(a2),
                                        hx2, hy2)

    rotating = (w1 != 0) | (w2 != 0)
    entry, exit_ = obb_translation_toi_parts(
        cx2 - cx1, cy2 - cy1, torch.cos(th1), torch.sin(th1), hx1, hy1,
        torch.cos(th2), torch.sin(th2), hx2, hy2, rvx, rvy)
    hit_w = (entry <= exit_) & (entry <= t_max) & (exit_ >= 0)
    t_exact = torch.where(hit_w, torch.clamp(entry, min=0.0), float("inf"))

    t = torch.zeros_like(bound)
    steps = torch.zeros(t.shape, dtype=torch.int32, device=t.device)
    for _ in range(iters):
        d = dist_at(t)
        live = rotating & ~((d <= tol) | (t > t_max))
        if not bool(live.any()):  # every lane frozen: the rest are no-ops
            break
        t = torch.where(live, t + torch.clamp(d, min=0.0) / bound, t)
        steps += live.to(torch.int32)
    hit = (dist_at(t) <= tol) & (t <= t_max)
    out = torch.where(rotating, torch.where(hit, t, float("inf")), t_exact)
    return (out, steps) if return_steps else out


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare ``moving_obb_toi_launch``'s C signature on a loaded library."""
    p, f = ctypes.c_void_p, ctypes.c_float
    lib.moving_obb_toi_launch.restype = ctypes.c_int
    lib.moving_obb_toi_launch.argtypes = [p, p, p, ctypes.c_longlong, f,
                                          ctypes.c_int, f, p]
    return lib


def _kernel_lib() -> ctypes.CDLL:
    return bind(cuda_build.load(_KERNEL))


def moving_obb_toi_cuda_t(b1t: torch.Tensor, b2t: torch.Tensor, *,
                          t_max: float = 1.0, iters: int = 64,
                          tol: float = 1e-4, block: int = LANE_BLOCK) -> torch.Tensor:
    """Time of impact over SoA moving boxes: (8, 8, M) x (8, 8, M) float32
    -> float32 (8M,). M must be a multiple of ``block``."""
    global LAUNCHES
    refuse_grad(b1t, b2t)
    sat_cuda._check(b1t, b2t, 8, (torch.float32,), block)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if b1t.device.type == "cpu":
        return moving_obb_toi_plain(b1t, b2t, t_max=t_max, iters=iters,
                                    tol=tol).reshape(-1)
    if not (b1t.is_contiguous() and b2t.is_contiguous()):
        raise ValueError("packed inputs must be contiguous")
    n = b1t.shape[1] * b1t.shape[2]
    out = torch.empty((n,), dtype=torch.float32, device=b1t.device)
    lib = _kernel_lib()
    err = cuda_build.launch(
        b1t.device, lib.moving_obb_toi_launch, b1t.data_ptr(), b2t.data_ptr(),
        out.data_ptr(), n, sat_cuda._f32(t_max), int(iters), sat_cuda._f32(tol))
    if err != 0:
        raise RuntimeError(f"moving_obb_toi_launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def rect_toi_cuda(c1, ext1, th1, v1, w1, c2, ext2, th2, v2, w2, *,
                  t_max: float = 1.0, iters: int = 64, tol: float = 1e-4,
                  block: int = LANE_BLOCK) -> torch.Tensor:
    """Drop-in for `ops.toi.rect_time_of_impact` on moving param boxes:
    centres (N, 2); extents and velocities (N, 2) or broadcastable; angles
    and rates (N,) or scalars. float32 (N,). Padding lanes (zero extents,
    no motion) converge on the first step."""
    refuse_grad(c1, ext1, th1, v1, w1, c2, ext2, th2, v2, w2)
    n = c1.shape[0]
    dev = c1.device
    padded = -(-n // (8 * block)) * (8 * block)

    def prep(c, ext, th, v, w):
        f32 = lambda x, shape: torch.broadcast_to(  # noqa: E731
            torch.as_tensor(x, dtype=torch.float32, device=dev), shape)
        rows = [f32(c, (n, 2)), f32(ext, (n, 2)), f32(th, (n,)), f32(v, (n, 2)),
                f32(w, (n,))]
        return pack_moving_obbs(*(sat_cuda._pad_rows(r, padded) for r in rows))

    return moving_obb_toi_cuda_t(prep(c1, ext1, th1, v1, w1),
                                 prep(c2, ext2, th2, v2, w2), t_max=t_max,
                                 iters=iters, tol=tol, block=block)[:n]
