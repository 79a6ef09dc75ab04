"""Stage A of the rotating rectangle cascade: kernel 15 and its plain version.

Counterpart of ``collide2d_tpu/ops/screen_pallas.py``. For each lane
(configuration, sample) of a threefry step it reads the sample's five raw
normals z and its configuration's 16 scalars (`pack_screen_params`) and
computes, in one pass: the noisy obstacle, the exact t = 0 SAT test, the
exact translation window, and the 8-segment paired inflated/eroded screen
of `mc.moving._paired_segment_screen`. Output: int32 flags (bit 0 = some
segment may collide, bit 1 = certified hit, bit 2 = the translation
window's verdict) and the float32 warm start ``clip(where(isfinite(t_first),
t_first, 2), 0, 2)``.

Layout: z is the port's (C, S, 5) draw tensor as `prng.normal` returns it
(the TPU kernel reads its (5, C, S) transpose); params (C, 16); flags and
t0 (C, S).

`rotating_screen_plain` is the port's own stage-A composition in torch
operations on the same z (the function `mc.moving.counts_chunk_moving`
runs with ``screen_impl='torch'``). `rotating_screen` routes on the device:
a CUDA tensor launches ``csrc/screen_kernel.cu`` (built at first use, one
library per segment count: `screen_defines`) and counts the launch in
``LAUNCHES``; a failed build or launch raises; a CPU tensor runs the plain
version.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from collide2d_tpu_torch.mc import prng
from collide2d_tpu_torch.ops.toi import obb_translation_toi_parts
from collide2d_tpu_torch.utils import cuda_build

N_PARAMS = 16
MAX_SEG = 32  # segments the kernel stages per configuration
_KERNEL = "screen_kernel"
# Launches of the CUDA kernel in this process (never the plain version).
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def pack_screen_params(configs, robot_wh) -> torch.Tensor:
    """`MovingConfigs` + robot -> (C, 16) float32, one configuration a row:
    sd0..sd4, wh_x, wh_y, px, py, vx t_max, vy t_max, theta0, omega t_max,
    |rw|/2, |rh|/2, r_rob (the TPU kernel's `pack_screen_params`)."""
    rw = torch.broadcast_to(torch.as_tensor(robot_wh, dtype=torch.float32,
                                            device=configs.position.device),
                            configs.position.shape)
    v_eff = configs.velocity * configs.t_max[:, None]
    w_eff = configs.omega * configs.t_max
    cols = [configs.std_dev[:, i] for i in range(5)] + [
        configs.obstacle_wh[:, 0], configs.obstacle_wh[:, 1],
        configs.position[:, 0], configs.position[:, 1], v_eff[:, 0], v_eff[:, 1],
        configs.pose_theta, w_eff, rw[:, 0].abs() * 0.5, rw[:, 1].abs() * 0.5,
        0.5 * torch.hypot(rw[:, 0], rw[:, 1])]
    return torch.stack(cols, dim=-1).to(torch.float32).contiguous()


def rotating_screen_plain(z: torch.Tensor, params: torch.Tensor, *,
                          n_seg: int = 8, tol: float = 1e-4):
    """Kernel 15 in torch operations: (flags (C, S) int32, t0 (C, S)
    float32) of draws z (C, S, 5) against params (C, 16)."""
    from collide2d_tpu_torch.mc.moving import _paired_segment_screen, warm_start

    def col(i):
        return params[:, i:i + 1]

    ox = z[..., 0] * col(0)
    oy = z[..., 1] * col(1)
    d2 = z[..., 2] * col(2)
    c2, s2 = torch.cos(d2), torch.sin(d2)
    hx2 = (col(5) + z[..., 3] * col(3)).abs() * 0.5
    hy2 = (col(6) + z[..., 4] * col(4)).abs() * 0.5
    px, py, vx, vy = col(7), col(8), col(9), col(10)
    th0, w, hx1, hy1, r_rob = col(11), col(12), col(13), col(14), col(15)

    # the exact t = 0 SAT test (the cascade's certified overlap)
    c1, s1 = torch.cos(th0), torch.sin(th0)
    cd0 = (c1 * c2 + s1 * s2).abs()
    sd0 = (s1 * c2 - c1 * s2).abs()
    dx0, dy0 = ox - px, oy - py
    hit_at_0 = (
        ((dx0 * c1 + dy0 * s1).abs() <= hx1 + hx2 * cd0 + hy2 * sd0)
        & ((-dx0 * s1 + dy0 * c1).abs() <= hy1 + hx2 * sd0 + hy2 * cd0)
        & ((dx0 * c2 + dy0 * s2).abs() <= hx2 + hx1 * cd0 + hy1 * sd0)
        & ((-dx0 * s2 + dy0 * c2).abs() <= hy2 + hx1 * sd0 + hy1 * cd0))
    entry, exit_ = obb_translation_toi_parts(dx0, dy0, c1, s1, hx1, hy1, c2, s2,
                                             hx2, hy2, -vx, -vy)
    hit_exact = (entry <= exit_) & (entry <= 1.0) & (exit_ >= 0)
    maybe, hit_cert, t_first = _paired_segment_screen(
        ox, oy, c2, s2, hx2, hy2, px, py, vx, vy, th0, w, hx1, hy1, r_rob, tol,
        n_seg)
    flags = (maybe.to(torch.int32) | ((hit_cert | hit_at_0).to(torch.int32) << 1)
             | (hit_exact.to(torch.int32) << 2))
    return flags, warm_start(t_first)


def _check(z: torch.Tensor, params: torch.Tensor, n_seg: int) -> None:
    if z.dtype != torch.float32 or z.dim() != 3 or z.shape[2] != 5:
        raise ValueError(f"z must be float32 (C, S, 5), got {z.dtype} "
                         f"{tuple(z.shape)}")
    if params.dtype != torch.float32 or tuple(params.shape) != (z.shape[0], N_PARAMS):
        raise ValueError(f"params must be float32 ({z.shape[0]}, {N_PARAMS}), "
                         f"got {params.dtype} {tuple(params.shape)}")
    if params.device != z.device:
        raise ValueError(f"params on {params.device}, z on {z.device}")
    if not 1 <= int(n_seg) <= MAX_SEG:
        raise ValueError(f"n_seg must be in [1, {MAX_SEG}], got {n_seg}")


def screen_defines(n_seg: int) -> tuple[tuple[str, int], ...]:
    """The ``-D`` defines of kernel 15's library for ``n_seg`` segments (its
    segment loop unrolls)."""
    return (("SCREEN_NSEG", int(n_seg)),)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare ``rotating_screen_launch``'s C signature on a loaded library."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rotating_screen_launch.restype = ctypes.c_int
    lib.rotating_screen_launch.argtypes = [p, p, p, p, i, i, i, f, f, f, f, p]
    return lib


def _kernel_lib(n_seg: int) -> ctypes.CDLL:
    return bind(cuda_build.load(_KERNEL, screen_defines(n_seg)))


def rotating_screen(z: torch.Tensor, params: torch.Tensor, *, n_seg: int = 8,
                    tol: float = 1e-4):
    """Fused stage-A screen: draws z (C, S, 5) + params (C, 16) -> (flags
    (C, S) int32, t0 (C, S) float32). CUDA tensors launch the kernel, CPU
    tensors run the plain version."""
    global LAUNCHES
    _check(z, params, n_seg)
    if z.device.type == "cpu":
        return rotating_screen_plain(z, params, n_seg=n_seg, tol=tol)
    if z.device.type != "cuda":
        raise ValueError(f"unsupported device {z.device}")
    z, params = z.contiguous(), params.contiguous()
    c, s = z.shape[0], z.shape[1]
    flags = torch.empty((c, s), dtype=torch.int32, device=z.device)
    t0 = torch.empty((c, s), dtype=torch.float32, device=z.device)
    if c == 0 or s == 0:
        return flags, t0
    f32 = prng._f32
    lib = _kernel_lib(int(n_seg))
    err = cuda_build.launch(
        z.device, lib.rotating_screen_launch, z.data_ptr(), params.data_ptr(),
        flags.data_ptr(), t0.data_ptr(), c, s, int(n_seg), f32(1.0 / n_seg),
        f32(0.5 / n_seg), f32(tol), f32(np.pi))
    if err != 0:
        raise RuntimeError(f"rotating_screen_launch failed: CUDA error {err}")
    LAUNCHES += 1
    return flags, t0
