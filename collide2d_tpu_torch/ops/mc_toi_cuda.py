"""Fused trajectory Monte Carlo counts for rectangles: kernel 13 and its
plain version.

Counterpart of ``collide2d_tpu/ops/mc_toi_pallas.py``. `mc_toi_counts`
returns, for each configuration row of `pack_mc_toi_params`, the int32
number of samples among ``n`` whose noisy obstacle the moving robot hits
over the unit horizon:

- per sample, 5 standard normals (3 without shape noise) on kernel 1's
  Philox stream (`ops.mc_cuda`: counter (sample index low, high, row uid,
  draw block), words dx, dy, dtheta, dw, then dh), so counts are a pure
  function of (key, uid, round tag, sample index);
- the noisy static obstacle (offset z sigma, angle z sigma_theta, half
  extents |w/2 + z sigma_w/2|);
- a non-rotating row (omega == 0, or ``ca_iters == 0``) takes the exact
  translation window (`ops.toi.obb_translation_toi_parts`);
- a rotating row runs at most ``ca_iters`` steps of conservative
  advancement on the closed-form box distance, t <- t + max(d, 0) / bound
  until d(t) <= tol or t > 1; a hit is d(t) <= tol and t <= 1
  (`_toi_hits_tile`, mc_toi_pallas.py:105-167).

On a CUDA tensor `mc_toi_counts` launches ``csrc/mc_toi_kernel.cu`` (built
at first use) and counts the launch in ``LAUNCHES``; a failed build or
launch raises. On a CPU tensor it runs `mc_toi_counts_plain`, the same
function in torch operations (the fixed-trip advancement loop, which can
also count each lane's steps).
"""

from __future__ import annotations

import ctypes

import torch

from collide2d_tpu_torch.mc import prng
from collide2d_tpu_torch.ops import mc_cuda
from collide2d_tpu_torch.ops.distance_cuda import obb_signed_distance_tile
from collide2d_tpu_torch.ops.toi import obb_translation_toi_parts
from collide2d_tpu_torch.utils import cuda_build

PARAM_COLS = 16
_KERNEL = "mc_toi_kernel"
# Launches of the CUDA kernel in this process (never the plain version).
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def pack_mc_toi_params(configs, robot_wh) -> torch.Tensor:
    """`MovingConfigs` + robot -> (C, 16) float32 rows, one configuration
    a row (the TPU kernel's (19, C) rows 0-15, transposed): 0 px, 1 py,
    2 theta, 3 rw/2, 4 rh/2, 5 ow/2, 6 oh/2, 7 sigma_x, 8 sigma_y,
    9 sigma_theta, 10 sigma_w/2, 11 sigma_h/2, 12 vx t_max, 13 vy t_max,
    14 omega t_max, 15 the advancement bound |v t_max| + |omega t_max| r
    (at least 1e-30)."""
    from collide2d_tpu_torch.mc.moving import _motion, _robot_wh

    pos = configs.position
    rw = _robot_wh(robot_wh, configs)
    v_eff, w_eff, _, bound = _motion(configs, rw)
    cols = [
        pos[:, 0], pos[:, 1], configs.pose_theta,
        rw[:, 0].abs() * 0.5, rw[:, 1].abs() * 0.5,
        configs.obstacle_wh[:, 0] * 0.5, configs.obstacle_wh[:, 1] * 0.5,
        configs.std_dev[:, 0], configs.std_dev[:, 1], configs.std_dev[:, 2],
        configs.std_dev[:, 3] * 0.5, configs.std_dev[:, 4] * 0.5,
        v_eff[:, 0], v_eff[:, 1], w_eff, torch.clamp(bound, min=1e-30),
    ]
    return torch.stack(cols, dim=1).to(torch.float32).contiguous()


def _toi_hits(p: torch.Tensor, z_dx, z_dy, z_th, z_dw, z_dh, ca_iters: int,
              tol: float):
    """Trajectory-hit mask (C, S) of one draw per sample against (C, 16)
    params, and each lane's advancement steps (int32 (C, S), 0 where the
    window decides). ``z_dw``/``z_dh`` None = no shape noise."""
    col = lambda i: p[:, i:i + 1]  # noqa: E731 — (C, 1), broadcasts over S
    px, py, theta, hx1, hy1 = col(0), col(1), col(2), col(3), col(4)
    ow_h, oh_h, sx, sy, sth, swh, shh = (col(i) for i in range(5, 12))
    vx, vy, w, bound = col(12), col(13), col(14), col(15)
    ox = z_dx * sx
    oy = z_dy * sy
    phi = z_th * sth
    if z_dw is None:
        a = ow_h.abs().expand_as(ox)
        b = oh_h.abs().expand_as(ox)
    else:
        a = (ow_h + z_dw * swh).abs()
        b = (oh_h + z_dh * shh).abs()
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    c1, s1 = torch.cos(theta), torch.sin(theta)
    entry, exit_ = obb_translation_toi_parts(ox - px, oy - py, c1, s1, hx1, hy1,
                                             cphi, sphi, a, b, -vx, -vy)
    hit_exact = (entry <= exit_) & (entry <= 1.0) & (exit_ >= 0)
    steps = torch.zeros(ox.shape, dtype=torch.int32, device=ox.device)
    rotating = w != 0
    if ca_iters <= 0 or not bool(rotating.any()):
        return hit_exact, steps
    tol = prng._f32(tol)

    def dist_at(t):
        a1 = theta + t * w
        return obb_signed_distance_tile(ox - (px + t * vx), oy - (py + t * vy),
                                        torch.cos(a1), torch.sin(a1), hx1, hy1,
                                        cphi, sphi, a, b)

    t = torch.zeros_like(ox)
    for _ in range(int(ca_iters)):
        d = dist_at(t)
        live = rotating & ~((d <= tol) | (t > 1.0))
        if not bool(live.any()):  # every lane frozen: the rest are no-ops
            break
        t = torch.where(live, t + torch.clamp(d, min=0.0) / bound, t)
        steps += live.to(torch.int32)
    hit_ca = (dist_at(t) <= tol) & (t <= 1.0)
    return torch.where(rotating, hit_ca, hit_exact), steps


def mc_toi_counts_plain(params: torch.Tensor, uids: torch.Tensor, seed, n: int,
                        *, offset: int = 0, shape_noise: bool = True,
                        ca_iters: int = 48, tol: float = 1e-4,
                        uniforms: torch.Tensor | None = None,
                        max_elems: int = 1 << 16, return_steps: bool = False):
    """The kernel's function in torch operations, on any device.

    ``uniforms``: optional (C, n, 3 or 5) floats in (0, 1] that replace
    Philox (the TPU kernel's ``_TEST_UNIFORM_FN`` hook, as
    `mc_cuda.mc_counts_plain` takes them). Returns int32 (C,); with
    ``return_steps`` also the int64 (C,) sums of the lanes' advancement
    steps and of each 32-sample warp's largest step count (the kernel's
    warps hold 32 consecutive samples of one row)."""
    c = params.shape[0]
    n = int(n)
    dev = params.device
    counts = torch.zeros((c,), dtype=torch.int32, device=dev)
    steps_sum = torch.zeros((c,), dtype=torch.int64, device=dev)
    warp_sum = torch.zeros((c,), dtype=torch.int64, device=dev)
    step = max(32, max_elems // max(c, 1) // 32 * 32)
    for z in mc_cuda.normal_chunks(uids, seed, n, offset, 5 if shape_noise else 3,
                                   "erfinv", uniforms, step):
        extra = (z[..., 3], z[..., 4]) if shape_noise else (None, None)
        hit, steps = _toi_hits(params, z[..., 0], z[..., 1], z[..., 2], *extra,
                               ca_iters, tol)
        counts += hit.sum(dim=1, dtype=torch.int32)
        if return_steps:
            steps_sum += steps.sum(dim=1, dtype=torch.int64)
            pad = -steps.shape[1] % 32
            warps = torch.nn.functional.pad(steps, (0, pad)).reshape(c, -1, 32)
            warp_sum += warps.amax(dim=2).sum(dim=1, dtype=torch.int64)
    return (counts, steps_sum, warp_sum) if return_steps else counts


def _check_inputs(params: torch.Tensor, uids: torch.Tensor, n: int,
                  ca_iters: int) -> None:
    if params.dtype != torch.float32 or params.dim() != 2 or (
            params.shape[1] != PARAM_COLS):
        raise ValueError(f"params must be float32 (C, {PARAM_COLS}), got "
                         f"{params.dtype} {tuple(params.shape)}")
    if uids.dtype != torch.int32 or uids.shape != (params.shape[0],):
        raise ValueError(f"uids must be int32 ({params.shape[0]},), got "
                         f"{uids.dtype} {tuple(uids.shape)}")
    if uids.device != params.device:
        raise ValueError(f"uids on {uids.device}, params on {params.device}")
    if not (params.is_contiguous() and uids.is_contiguous()):
        raise ValueError("params and uids must be contiguous")
    if int(n) < 0 or int(ca_iters) < 0:
        raise ValueError(f"n and ca_iters must be >= 0, got {n}, {ca_iters}")


def _kernel_lib() -> ctypes.CDLL:
    lib = cuda_build.load(_KERNEL)
    p, i, ll, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint32
    lib.mc_toi_counts_launch.restype = ctypes.c_int
    lib.mc_toi_counts_launch.argtypes = [p, p, p, i, ll, ll, u, u, i, i,
                                         ctypes.c_float, p]
    lib.mc_toi_max_samples_per_round.restype = ctypes.c_longlong
    lib.mc_toi_max_samples_per_round.argtypes = []
    return lib


def mc_toi_counts(params: torch.Tensor, uids: torch.Tensor, seed, n: int, *,
                  offset: int = 0, shape_noise: bool = True, ca_iters: int = 48,
                  tol: float = 1e-4, out: torch.Tensor | None = None) -> torch.Tensor:
    """Trajectory-collision counts out of ``n`` samples per configuration:
    int32 (C,). ``params`` (C, 16) from `pack_mc_toi_params`; ``uids`` int32
    (C,) (the stream key); ``seed`` the round's two uint32 words;
    ``offset`` the first sample's index. CUDA tensors launch the kernel,
    CPU tensors run the plain version. ``out`` as `mc_cuda.mc_counts`': the
    counts are added into it."""
    global LAUNCHES
    _check_inputs(params, uids, n, ca_iters)
    mc_cuda.check_out(out, params)
    if params.device.type == "cpu":
        counts = mc_toi_counts_plain(params, uids, seed, n, offset=offset,
                                     shape_noise=shape_noise, ca_iters=ca_iters,
                                     tol=tol)
        return counts if out is None else out.add_(counts)
    if params.device.type != "cuda":
        raise ValueError(f"unsupported device {params.device}")
    counts = out if out is not None else torch.zeros(
        (params.shape[0],), dtype=torch.int32, device=params.device)
    if int(n) == 0 or params.shape[0] == 0:
        return counts
    lib = _kernel_lib()
    if int(n) > lib.mc_toi_max_samples_per_round():
        raise ValueError(f"n={n} exceeds the kernel's "
                         f"{lib.mc_toi_max_samples_per_round()} samples per call; "
                         "split the round with `offset`")
    err = cuda_build.launch(
        params.device, lib.mc_toi_counts_launch, params.data_ptr(), uids.data_ptr(),
        counts.data_ptr(), int(params.shape[0]), int(n), int(offset),
        int(seed[0]) & prng.MASK32, int(seed[1]) & prng.MASK32,
        int(bool(shape_noise)), int(ca_iters), prng._f32(tol))
    if err != 0:
        raise RuntimeError(f"mc_toi_counts_launch failed: CUDA error {err}")
    LAUNCHES += 1
    return counts


def mc_round_moving_cuda(key, uids: torch.Tensor, configs, robot_wh,
                         round_tag: int, *, n_batch: int, offset: int = 0,
                         shape_noise: bool = True, ca_iters: int = 48,
                         tol: float = 1e-4) -> torch.Tensor:
    """One round of a `MovingConfigs` batch on kernel 13: int32 (C,) counts
    of ``n_batch`` samples per configuration, the round's sample indices
    ``offset`` on, seeded by ``fold_in(key, round_tag)`` as kernel 1's
    rounds."""
    params = pack_mc_toi_params(configs, robot_wh)
    return mc_toi_counts(params, uids.to(torch.int32).contiguous(),
                         mc_cuda.round_seed(key, round_tag), n_batch,
                         offset=offset, shape_noise=shape_noise,
                         ca_iters=ca_iters, tol=tol)
