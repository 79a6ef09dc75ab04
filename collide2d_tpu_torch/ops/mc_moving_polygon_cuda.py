"""Fused trajectory Monte Carlo counts for translation-only k-gons: kernel
14 and its plain version.

Counterpart of ``collide2d_tpu/ops/mc_moving_polygon_pallas.py``. The
tables are kernel 7's (`ops.mc_polygon_cuda.pack_polygon_mc_params`: the
placed robot's kept axes and intervals, the obstacle's normals and
intervals, the cos/sin blend tables) plus two rows, the obstacle's
displacement relative to the robot over the unit horizon, ``v_rel =
-velocity * t_max``. Per sample, kernel 7's 3 normals and blends, then the
EXACT first-contact window per axis (`_axis_window`, the formulas of
`ops.toi.polygon_translation_toi_parts`):

    s = axis . v_rel;  ta, tb = (M1 - m2) / s, (m1 - M2) / s
    s == 0: (-inf, inf) if the static intervals overlap, else (inf, -inf)
    hit = max(lo) <= min(hi), max(lo) <= 1, min(hi) >= 0.

On a robot axis the speed is sample-invariant; on a rotated obstacle
normal it is ``n . R(dtheta)^T v_rel``. At zero velocity every window is
the static interval test on the same tables and the same stream, so the
counts equal kernel 7's bit for bit. Translation-only by contract: the
caller guarantees omega == 0 (the adaptive driver reads it back once).

`mc_moving_poly_counts` routes on the device: a CUDA tensor launches
``csrc/mc_moving_polygon_kernel.cu`` (built at first use once per shape,
as kernel 7: `mc_polygon_cuda.shape_defines`) and counts the launch in
``LAUNCHES``; a failed build or launch raises; a CPU tensor runs
`mc_moving_poly_counts_plain`. Stream: kernel 7's (Philox keyed by the
round's seed words, counter (sample index, uid, 0), words 0-2 through
erf_inv, or with ``normal_method="box_muller"``, a build of its own, words
0-3 as two Box-Muller pairs).
"""

from __future__ import annotations

import ctypes

import torch

from collide2d_tpu_torch.mc import prng
from collide2d_tpu_torch.ops import mc_cuda, mc_polygon_cuda
from collide2d_tpu_torch.utils import cuda_build

_KERNEL = "mc_moving_polygon_kernel"
_INF = float("inf")
# Launches of the CUDA kernel in this process (never the plain version):
# its erf_inv builds, and its Box-Muller builds (``normal_method``).
LAUNCHES = 0
BOX_MULLER_LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES, BOX_MULLER_LAUNCHES
    LAUNCHES = 0
    BOX_MULLER_LAUNCHES = 0


def _static_rows(k: int, k2: int, k2a: int) -> int:
    """Unpadded width of kernel 7's table."""
    return 3 + 4 * k2a + 4 * k + 2 * k2a * k + 2 * k * k2


def _num_rows(k: int, k2: int, k2a: int) -> int:
    """Kernel 7's rows + the two relative-velocity rows, padded to 8."""
    return -(-(_static_rows(k, k2, k2a) + 2) // 8) * 8


def pack_moving_polygon_mc_params(configs, robot_verts,
                                  a_keep: tuple[int, ...] | None = None
                                  ) -> torch.Tensor:
    """`MovingPolygonConfigs` + (K2, 2) robot -> (C, ROWS) float32 tables:
    kernel 7's layout, then ``v_rel = -velocity * t_max`` (x, y), then zero
    padding. ``a_keep``: the kept robot axes (None = all)."""
    rv = torch.as_tensor(robot_verts, dtype=torch.float32,
                         device=configs.position.device)
    k, k2 = configs.obstacle_verts.shape[1], rv.shape[0]
    k2a = k2 if a_keep is None else len(a_keep)
    base = mc_polygon_cuda.pack_polygon_mc_params(configs, rv, a_keep)
    v_rel = -(configs.velocity * configs.t_max[:, None])
    table = torch.cat([base[:, :_static_rows(k, k2, k2a)], v_rel], dim=1)
    pad = _num_rows(k, k2, k2a) - table.shape[1]
    if pad:
        table = torch.cat([table, table.new_zeros((table.shape[0], pad))], dim=1)
    return table.to(torch.float32).contiguous()


def _axis_window(m1, big_m1, m2, big_m2, s):
    """(lo, hi) hit window on one axis: body 1's interval [m1, M1] static,
    body 2's [m2, M2] moving by t s."""
    zero = s == 0
    inv = 1.0 / torch.where(zero, 1.0, s)
    ta = (big_m1 - m2) * inv
    tb = (m1 - big_m2) * inv
    inside = (m2 <= big_m1) & (m1 <= big_m2)
    lo = torch.where(zero, torch.where(inside, -_INF, _INF), torch.minimum(ta, tb))
    hi = torch.where(zero, torch.where(inside, _INF, -_INF), torch.maximum(ta, tb))
    return lo, hi


def _poly_window_hit(t: torch.Tensor, k: int, k2: int, k2a: int, z_dx, z_dy,
                     z_th) -> torch.Tensor:
    """Trajectory-hit mask (C, S) of one 3-normal draw per sample against
    the (C, ROWS) tables: `mc_moving_polygon_pallas._poly_window_hit`'s
    operations in its order."""
    o = mc_polygon_cuda._offsets(k, k2, k2a)
    o_v = _static_rows(k, k2, k2a)

    def rows(name, m):  # (C, 1, m): one block of the table
        return t[:, None, o[name]:o[name] + m]

    dx = z_dx * t[:, 0:1]
    dy = z_dy * t[:, 1:2]
    th = z_th * t[:, 2:3]
    ct = torch.cos(th)
    st = torch.sin(th)
    u1 = ct * dx + st * dy   # (R^T d)_x
    u2 = ct * dy - st * dx   # (R^T d)_y
    vx, vy = t[:, o_v:o_v + 1], t[:, o_v + 1:o_v + 2]  # (C, 1)
    w1 = ct * vx + st * vy   # (R^T v_rel)_x
    w2 = ct * vy - st * vx
    ct3, st3 = ct[..., None], st[..., None]
    entry = torch.full_like(dx, -_INF)
    exit_ = torch.full_like(dx, _INF)
    if k2a:  # robot axes: fixed interval against the blended obstacle
        at = rows("ax", k2a) * dx[..., None] + rows("ay", k2a) * dy[..., None]
        p = (ct3 * rows("p1", k2a * k) + st3 * rows("p2", k2a * k)).unflatten(
            -1, (k2a, k))
        mn, mx = p.amin(dim=-1), p.amax(dim=-1)
        s = rows("ax", k2a) * vx[..., None] + rows("ay", k2a) * vy[..., None]
        lo, hi = _axis_window(rows("rmin", k2a), rows("rmax", k2a), mn + at,
                              mx + at, s)
        entry = torch.maximum(entry, lo.amax(dim=-1))
        exit_ = torch.minimum(exit_, hi.amin(dim=-1))
    # obstacle axes: the robot's blended interval against the translated
    # obstacle interval
    bt = rows("nx", k) * u1[..., None] + rows("ny", k) * u2[..., None]
    q = (ct3 * rows("q1", k * k2) + st3 * rows("q2", k * k2)).unflatten(-1, (k, k2))
    mn, mx = q.amin(dim=-1), q.amax(dim=-1)
    s = rows("nx", k) * w1[..., None] + rows("ny", k) * w2[..., None]
    lo, hi = _axis_window(mn, mx, rows("nmin", k) + bt, rows("nmax", k) + bt, s)
    entry = torch.maximum(entry, lo.amax(dim=-1))
    exit_ = torch.minimum(exit_, hi.amin(dim=-1))
    return (entry <= exit_) & (entry <= 1.0) & (exit_ >= 0.0)


def mc_moving_poly_counts_plain(params: torch.Tensor, uids: torch.Tensor, seed,
                                n: int, *, k: int, k2: int, k2a: int,
                                offset: int = 0, normal_method: str = "erfinv",
                                uniforms: torch.Tensor | None = None,
                                max_elems: int = 1 << 14) -> torch.Tensor:
    """The kernel's function in torch operations, on any device.
    ``uniforms``: optional (C, n, 3) floats in (0, 1] that replace Philox
    (the TPU kernel's ``_TEST_UNIFORM_FN`` hook, `mc_cuda.uniform_normals`).
    Returns int32 (C,)."""
    c = params.shape[0]
    n = int(n)
    counts = torch.zeros((c,), dtype=torch.int32, device=params.device)
    step = max(1, max_elems // max(c, 1))
    for z in mc_cuda.normal_chunks(uids, seed, n, offset, 3, normal_method,
                                   uniforms, step):
        hit = _poly_window_hit(params, k, k2, k2a, z[..., 0], z[..., 1], z[..., 2])
        counts += hit.sum(dim=1, dtype=torch.int32)
    return counts


def _check_inputs(params, uids, n, k, k2, k2a) -> None:
    if k < 1 or k2 < 1 or not 0 <= k2a <= k2:
        raise ValueError(f"need K >= 1, K2 >= 1 and 0 <= K2A <= K2, got "
                         f"{k}, {k2}, {k2a}")
    rows = _num_rows(k, k2, k2a)
    if params.dtype != torch.float32 or params.dim() != 2 or params.shape[1] != rows:
        raise ValueError(f"params must be float32 (C, {rows}) for K={k}, K2={k2}, "
                         f"K2A={k2a}, got {params.dtype} {tuple(params.shape)}")
    if uids.dtype != torch.int32 or uids.shape != (params.shape[0],):
        raise ValueError(f"uids must be int32 ({params.shape[0]},), got "
                         f"{uids.dtype} {tuple(uids.shape)}")
    if uids.device != params.device:
        raise ValueError(f"uids on {uids.device}, params on {params.device}")
    if not (params.is_contiguous() and uids.is_contiguous()):
        raise ValueError("params and uids must be contiguous")
    if int(n) < 0:
        raise ValueError(f"n must be >= 0, got {n}")


def _kernel_lib(k: int, k2: int, k2a: int, normal_method: str = "erfinv"
                ) -> ctypes.CDLL:
    lib = cuda_build.load(_KERNEL, mc_polygon_cuda.shape_defines(k, k2, k2a)
                          + mc_cuda.normal_defines(normal_method))
    p, i, ll, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint32
    lib.mc_moving_poly_counts_launch.restype = ctypes.c_int
    lib.mc_moving_poly_counts_launch.argtypes = [p, p, p, i, i, i, i, i, ll, ll,
                                                 u, u, p]
    lib.mc_moving_poly_max_samples_per_round.restype = ctypes.c_longlong
    lib.mc_moving_poly_max_samples_per_round.argtypes = []
    return lib


def mc_moving_poly_counts(params: torch.Tensor, uids: torch.Tensor, seed, n: int,
                          *, k: int, k2: int, k2a: int,
                          offset: int = 0, normal_method: str = "erfinv",
                          out: torch.Tensor | None = None) -> torch.Tensor:
    """Trajectory-collision counts out of ``n`` samples per configuration:
    int32 (C,). ``params`` (C, ROWS) from `pack_moving_polygon_mc_params`;
    ``uids`` int32 (C,); ``seed`` the round's two uint32 words;
    ``normal_method`` "erfinv" or "box_muller" (`ops.mc_cuda`). CUDA
    tensors launch the kernel's build for that shape and method, CPU
    tensors run the plain version. ``out`` as `mc_cuda.mc_counts`': the
    counts are added into it."""
    global LAUNCHES, BOX_MULLER_LAUNCHES
    _check_inputs(params, uids, n, k, k2, k2a)
    mc_cuda.check_out(out, params)
    mc_cuda.normal_defines(normal_method)
    if params.device.type == "cpu":
        counts = mc_moving_poly_counts_plain(params, uids, seed, n, k=k, k2=k2,
                                             k2a=k2a, offset=offset,
                                             normal_method=normal_method)
        return counts if out is None else out.add_(counts)
    if params.device.type != "cuda":
        raise ValueError(f"unsupported device {params.device}")
    counts = out if out is not None else torch.zeros(
        (params.shape[0],), dtype=torch.int32, device=params.device)
    if int(n) == 0 or params.shape[0] == 0:
        return counts
    lib = _kernel_lib(k, k2, k2a, normal_method)
    if int(n) > lib.mc_moving_poly_max_samples_per_round():
        raise ValueError(f"n={n} exceeds the kernel's "
                         f"{lib.mc_moving_poly_max_samples_per_round()} samples "
                         "per call; split the round with `offset`")
    err = cuda_build.launch(
        params.device, lib.mc_moving_poly_counts_launch, params.data_ptr(),
        uids.data_ptr(), counts.data_ptr(), int(params.shape[0]),
        int(params.shape[1]), int(k), int(k2), int(k2a), int(n), int(offset),
        int(seed[0]) & prng.MASK32, int(seed[1]) & prng.MASK32)
    if err != 0:
        raise RuntimeError(f"mc_moving_poly_counts_launch failed: CUDA error {err}")
    if normal_method == "box_muller":
        BOX_MULLER_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return counts


def mc_round_moving_polygons_cuda(key, uids: torch.Tensor, configs, robot_verts,
                                  round_tag: int, *, n_batch: int,
                                  offset: int = 0,
                                  a_keep: tuple[int, ...] | None = None,
                                  normal_method: str = "erfinv") -> torch.Tensor:
    """One round of a TRANSLATION-ONLY `MovingPolygonConfigs` batch on
    kernel 14: int32 (C,) counts of ``n_batch`` samples per configuration,
    the round's sample indices ``offset`` on. ``a_keep`` as
    `mc_polygon_cuda.mc_round_polygons_cuda`'s."""
    rv = torch.as_tensor(robot_verts, dtype=torch.float32,
                         device=configs.position.device)
    if a_keep is None:
        a_keep = mc_polygon_cuda.dedup_robot_axes(rv.cpu().numpy())
    params = pack_moving_polygon_mc_params(configs, rv, a_keep)
    return mc_moving_poly_counts(params, uids.to(torch.int32).contiguous(),
                                 mc_cuda.round_seed(key, round_tag), n_batch,
                                 k=configs.obstacle_verts.shape[1], k2=rv.shape[0],
                                 k2a=len(a_keep), offset=offset,
                                 normal_method=normal_method)
