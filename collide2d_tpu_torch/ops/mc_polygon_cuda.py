"""Fused Monte Carlo collision counts for convex k-gons: the CUDA kernel and
its plain version.

Counterpart of ``collide2d_tpu/ops/mc_polygon_pallas.py``. Everything that
does not depend on a sample's (dx, dy, dtheta) draw is packed into
per-configuration tables by `pack_polygon_mc_params` (once a round by
`mc_round_polygons_cuda`; once a buffer by the adaptive driver,
`mc.estimator.pack_round_table`):

- the placed robot's (kept) edge axes and its own projection intervals;
- the obstacle's edge normals and its own intervals on them, which rotate
  with it and so do not depend on the draw;
- blend tables: the obstacle vertices projected on a robot axis under a
  rotation t are ``cos(t) P1 + sin(t) P2``, the robot vertices on a
  rotated obstacle normal ``cos(t) Q1 + sin(t) Q2``.

A sample then costs one cos/sin pair, the blends, two min/max passes per
axis and a translation term per axis (`_poly_separated`).

`mc_poly_counts` returns, for each table row, the int32 number of
colliding samples among ``n`` draws:

- on a CUDA tensor it launches ``csrc/mc_polygon_kernel.cu``, built at
  first use by `utils.cuda_build` once per shape (K, K2, K2A), which
  `shape_defines` passes as ``-D`` defines so the kernel's loops unroll,
  and counts the launch in ``LAUNCHES``; anything the kernel does not take
  raises;
- on a CPU tensor it runs `mc_poly_counts_plain`, the same function in
  torch operations.

Stream: kernel 1's (`ops.mc_cuda`) with shape noise off: Philox4x32-10
keyed by the round's seed words, counter (sample index low, sample index
high, row uid, 0), words 0-2 as 23-bit codes through XLA's erf_inv, or,
with ``normal_method="box_muller"`` (a build of its own), words 0-3 as two
Box-Muller pairs. Counts are a pure function of (key, uid, round tag,
sample index).

Layout: the port stores a configuration's table contiguously, (C, ROWS);
the TPU kernel's is its transpose, (ROWS, C).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from collide2d_tpu_torch.mc import prng
from collide2d_tpu_torch.ops import mc_cuda
from collide2d_tpu_torch.ops.geometry import edge_normals, transform_vertices
from collide2d_tpu_torch.utils import cuda_build

_KERNEL = "mc_polygon_kernel"
# Launches of the CUDA kernel in this process (never the plain version):
# its erf_inv builds, and its Box-Muller builds (``normal_method``).
LAUNCHES = 0
BOX_MULLER_LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES, BOX_MULLER_LAUNCHES
    LAUNCHES = 0
    BOX_MULLER_LAUNCHES = 0


def dedup_robot_axes(robot_verts) -> tuple[int, ...]:
    """Indices of the robot's edge normals with duplicates removed (host
    numpy, a copy of the JAX package's function).

    A SAT verdict does not change when an axis (anti-)parallel to an
    earlier one is dropped: its intervals only scale or swap. Zero-length
    edges (repeat-padded vertices) have the zero normal, which never
    separates, and are dropped outright. Only exact-zero cross products
    count as parallel, so the axis set is never approximated."""
    v = np.asarray(robot_verts, np.float32)
    e = np.roll(v, -1, axis=0) - v
    axes = np.stack([e[:, 1], -e[:, 0]], axis=-1)
    keep = []
    for i in range(axes.shape[0]):
        if axes[i, 0] == 0.0 and axes[i, 1] == 0.0:
            continue
        dup = any(
            float(axes[i, 0] * axes[j, 1] - axes[i, 1] * axes[j, 0]) == 0.0
            for j in keep
        )
        if not dup:
            keep.append(i)
    return tuple(keep)


def _num_rows(k: int, k2: int, k2a: int) -> int:
    """Table rows: 3 sigmas + robot axes (2*K2A) + robot intervals (2*K2A)
    + obstacle normals (2*K) + obstacle intervals (2*K) + P1/P2 (2*K2A*K)
    + Q1/Q2 (2*K*K2), padded to a multiple of 8. K2A = kept robot axes."""
    n = 3 + 4 * k2a + 4 * k + 2 * k2a * k + 2 * k * k2
    return -(-n // 8) * 8


def _offsets(k: int, k2: int, k2a: int) -> dict[str, int]:
    """First row of each table block (`_poly_separated`'s layout)."""
    o = {"ax": 3, "ay": 3 + k2a, "rmin": 3 + 2 * k2a, "rmax": 3 + 3 * k2a,
         "nx": 3 + 4 * k2a, "ny": 3 + 4 * k2a + k,
         "nmin": 3 + 4 * k2a + 2 * k, "nmax": 3 + 4 * k2a + 3 * k,
         "p1": 3 + 4 * k2a + 4 * k}
    o["p2"] = o["p1"] + k2a * k
    o["q1"] = o["p2"] + k2a * k
    o["q2"] = o["q1"] + k * k2
    return o


def pack_polygon_mc_params(configs, robot_verts,
                           a_keep: tuple[int, ...] | None = None) -> torch.Tensor:
    """`PolygonConfigs` + (K2, 2) robot -> (C, ROWS) float32 tables, one
    configuration per row. ``a_keep``: the robot-axis subset of
    `dedup_robot_axes` (None = every axis).

    Every projection table is an explicit multiply and add over the two
    coordinates, never a contraction: a reduced-precision matrix product
    here (bf16 on the TPU, TF32 on the card) shifts the tables by ~0.4%
    and flips boundary verdicts."""
    ov = configs.obstacle_verts  # (C, K, 2)
    rv = torch.as_tensor(robot_verts, dtype=torch.float32, device=ov.device)
    c, k, k2 = ov.shape[0], ov.shape[1], rv.shape[0]
    if a_keep is None:
        a_keep = tuple(range(k2))
    k2a = len(a_keep)
    # The robot's world vertices: rotate-then-translate (utils.cu:132-142).
    r = transform_vertices(rv[None], configs.position[:, 0],
                           configs.position[:, 1], configs.pose_theta)  # (C, K2, 2)
    a = edge_normals(r)[:, list(a_keep)]  # (C, K2A, 2) kept robot axes
    nrm = edge_normals(ov)  # (C, K, 2) obstacle normals, obstacle frame

    def dot2(x, y):  # (C, I, 2) x (C, J, 2) -> (C, I, J)
        return (x[..., 0][:, :, None] * y[..., 0][:, None, :]
                + x[..., 1][:, :, None] * y[..., 1][:, None, :])

    pr = dot2(a, r)      # robot's own intervals on its kept axes
    po = dot2(nrm, ov)   # obstacle's own intervals: rotation-invariant
    p1 = dot2(a, ov)     # a_i . R(t) v_j = ct*P1 + st*P2
    p2 = (a[..., 1][:, :, None] * ov[..., 0][:, None, :]
          - a[..., 0][:, :, None] * ov[..., 1][:, None, :])
    q1 = dot2(nrm, r)    # (R n_j) . r_i = ct*Q1 + st*Q2
    q2 = (nrm[..., 0][:, :, None] * r[..., 1][:, None, :]
          - nrm[..., 1][:, :, None] * r[..., 0][:, None, :])
    cols = [
        configs.std_dev[:, :3],
        a[..., 0], a[..., 1], pr.amin(dim=-1), pr.amax(dim=-1),
        nrm[..., 0], nrm[..., 1], po.amin(dim=-1), po.amax(dim=-1),
        p1.reshape(c, k2a * k), p2.reshape(c, k2a * k),
        q1.reshape(c, k * k2), q2.reshape(c, k * k2),
    ]
    table = torch.cat(cols, dim=1).to(torch.float32)
    pad = _num_rows(k, k2, k2a) - table.shape[1]
    if pad:
        table = torch.cat([table, table.new_zeros((c, pad))], dim=1)
    return table.contiguous()


def _poly_separated(t: torch.Tensor, k: int, k2: int, k2a: int,
                    z_dx, z_dy, z_th) -> torch.Tensor:
    """Separation mask (C, S) of one 3-normal draw per sample against the
    (C, ROWS) tables: `mc_polygon_pallas._poly_separated`'s operations in
    its order (each product and sum rounded on its own; min/max exact)."""
    o = _offsets(k, k2, k2a)

    def rows(name, m):  # (C, 1, m): one block of the table
        return t[:, None, o[name]:o[name] + m]

    dx = z_dx * t[:, 0:1]
    dy = z_dy * t[:, 1:2]
    th = z_th * t[:, 2:3]
    ct = torch.cos(th)
    st = torch.sin(th)
    u1 = ct * dx + st * dy   # (R^T t)_x
    u2 = ct * dy - st * dx   # (R^T t)_y
    ct3, st3 = ct[..., None], st[..., None]
    sep = torch.zeros(dx.shape, dtype=torch.bool, device=t.device)
    if k2a:  # robot axes: fixed interval against the blended obstacle
        at = rows("ax", k2a) * dx[..., None] + rows("ay", k2a) * dy[..., None]
        p = (ct3 * rows("p1", k2a * k) + st3 * rows("p2", k2a * k)).unflatten(
            -1, (k2a, k))
        mn, mx = p.amin(dim=-1), p.amax(dim=-1)
        sep |= ((mx + at < rows("rmin", k2a))
                | (rows("rmax", k2a) < mn + at)).any(dim=-1)
    # obstacle axes: invariant interval plus the translation term
    bt = rows("nx", k) * u1[..., None] + rows("ny", k) * u2[..., None]
    q = (ct3 * rows("q1", k * k2) + st3 * rows("q2", k * k2)).unflatten(
        -1, (k, k2))
    mn, mx = q.amin(dim=-1), q.amax(dim=-1)
    sep |= ((mx < rows("nmin", k) + bt) | (rows("nmax", k) + bt < mn)).any(dim=-1)
    return sep


def mc_poly_counts_plain(params: torch.Tensor, uids: torch.Tensor, seed, n: int,
                         *, k: int, k2: int, k2a: int, offset: int = 0,
                         normal_method: str = "erfinv",
                         uniforms: torch.Tensor | None = None,
                         max_elems: int = 1 << 14) -> torch.Tensor:
    """The kernel's function in torch operations, on any device.

    ``seed``: the round's two uint32 words. ``uniforms``: optional
    pre-drawn (C, n, 3) floats in (0, 1] that replace Philox, turned into
    normals as the TPU kernel's ``_TEST_UNIFORM_FN`` hook does
    (`mc_cuda.uniform_normals`), so tests can replay that kernel's
    draws. ``max_elems``: rows x samples per chunk of the sample axis.
    Returns int32 (C,)."""
    c = params.shape[0]
    n = int(n)
    counts = torch.zeros((c,), dtype=torch.int32, device=params.device)
    step = max(1, max_elems // max(c, 1))
    for z in mc_cuda.normal_chunks(uids, seed, n, offset, 3, normal_method,
                                   uniforms, step):
        sep = _poly_separated(params, k, k2, k2a, z[..., 0], z[..., 1], z[..., 2])
        counts += (~sep).sum(dim=1, dtype=torch.int32)
    return counts


def _check_inputs(params: torch.Tensor, uids: torch.Tensor, n: int, k: int,
                  k2: int, k2a: int) -> None:
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


def shape_defines(k: int, k2: int, k2a: int) -> tuple[tuple[str, int], ...]:
    """The ``-D`` defines that specialise kernels 7 and 14 to one shape: K
    obstacle vertices, K2 robot vertices, K2A kept robot axes."""
    return (("MC_POLY_K", int(k)), ("MC_POLY_K2", int(k2)), ("MC_POLY_K2A", int(k2a)))


def _kernel_lib(k: int, k2: int, k2a: int, normal_method: str = "erfinv"
                ) -> ctypes.CDLL:
    lib = cuda_build.load(_KERNEL, shape_defines(k, k2, k2a)
                          + mc_cuda.normal_defines(normal_method))
    p, i, ll, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint32
    lib.mc_poly_counts_launch.restype = ctypes.c_int
    lib.mc_poly_counts_launch.argtypes = [p, p, p, i, i, i, i, i, ll, ll, u, u, p]
    lib.mc_poly_max_samples_per_round.restype = ctypes.c_longlong
    lib.mc_poly_max_samples_per_round.argtypes = []
    return lib


def mc_poly_counts(params: torch.Tensor, uids: torch.Tensor, seed, n: int, *,
                   k: int, k2: int, k2a: int, offset: int = 0,
                   normal_method: str = "erfinv",
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """Collision counts out of ``n`` samples per configuration: int32 (C,).

    ``params`` (C, ROWS) float32 from `pack_polygon_mc_params` for a
    K-gon obstacle, a K2-gon robot and K2A kept robot axes; ``uids`` int32
    (C,) row identities (the stream key); ``seed`` the round's two uint32
    words; ``offset`` the index of the first sample; ``normal_method``
    "erfinv" or "box_muller" (`ops.mc_cuda`). CUDA tensors launch the
    kernel's build for that shape and method, CPU tensors run the plain
    version. ``out`` as `mc_cuda.mc_counts`': the counts are added into it."""
    global LAUNCHES, BOX_MULLER_LAUNCHES
    _check_inputs(params, uids, n, k, k2, k2a)
    mc_cuda.check_out(out, params)
    mc_cuda.normal_defines(normal_method)
    if params.device.type == "cpu":
        counts = mc_poly_counts_plain(params, uids, seed, n, k=k, k2=k2, k2a=k2a,
                                      offset=offset, normal_method=normal_method)
        return counts if out is None else out.add_(counts)
    if params.device.type != "cuda":
        raise ValueError(f"unsupported device {params.device}")
    counts = out if out is not None else torch.zeros(
        (params.shape[0],), dtype=torch.int32, device=params.device)
    if int(n) == 0 or params.shape[0] == 0:
        return counts
    lib = _kernel_lib(k, k2, k2a, normal_method)
    if int(n) > lib.mc_poly_max_samples_per_round():
        raise ValueError(
            f"n={n} exceeds the kernel's {lib.mc_poly_max_samples_per_round()} "
            "samples per call; split the round with `offset`")
    err = cuda_build.launch(
        params.device, lib.mc_poly_counts_launch, params.data_ptr(), uids.data_ptr(),
        counts.data_ptr(), int(params.shape[0]), int(params.shape[1]), int(k),
        int(k2), int(k2a), int(n), int(offset), int(seed[0]) & prng.MASK32,
        int(seed[1]) & prng.MASK32)
    if err != 0:
        raise RuntimeError(f"mc_poly_counts_launch failed: CUDA error {err}")
    if normal_method == "box_muller":
        BOX_MULLER_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return counts


def mc_round_polygons_cuda(key, uids: torch.Tensor, configs, robot_verts,
                           round_tag: int, *, n_batch: int, offset: int = 0,
                           a_keep: tuple[int, ...] | None = None,
                           normal_method: str = "erfinv") -> torch.Tensor:
    """One round on the fused k-gon kernel: int32 (C,) counts of
    ``n_batch`` samples per configuration, the round's sample indices
    ``offset`` on (`mc_cuda.mc_round_cuda`). ``robot_verts``: the (K2, 2)
    robot. ``a_keep``: its kept axes (`dedup_robot_axes`); None works them
    out here, which reads a robot on the card back to the host, so the
    adaptive driver passes them. ``round_tag`` must differ across rounds."""
    rv = torch.as_tensor(robot_verts, dtype=torch.float32,
                         device=configs.position.device)
    if a_keep is None:
        a_keep = dedup_robot_axes(rv.cpu().numpy())
    params = pack_polygon_mc_params(configs, rv, a_keep)
    return mc_poly_counts(params, uids.to(torch.int32).contiguous(),
                          mc_cuda.round_seed(key, round_tag), n_batch,
                          k=configs.obstacle_verts.shape[1], k2=rv.shape[0],
                          k2a=len(a_keep), offset=offset,
                          normal_method=normal_method)
