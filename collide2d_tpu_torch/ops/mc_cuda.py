"""Fused Monte Carlo collision counts: the CUDA kernel and its plain version.

Counterpart of ``collide2d_tpu/ops/mc_pallas.py``. `mc_counts` returns,
for each configuration row, the int32 number of colliding samples among
``n`` noise draws:

- on a CUDA tensor it launches ``csrc/mc_kernel.cu`` (built at first use
  by `utils.cuda_build`) and counts the launch in ``LAUNCHES``; anything
  the kernel does not take raises;
- on a CPU tensor it runs `mc_counts_plain`, the same function in torch
  operations: the same Philox4x32-10 stream, the same 23-bit codes, the
  same XLA erf_inv polynomial and the same relative-angle oriented-box
  test, with the sample axis chunked.

Streams: Philox keyed by the round's two seed words (threefry
``fold_in(key, round_tag)``, as the TPU kernel's seeds), counter (sample
index low, sample index high, row uid, draw block). Per sample, block 0's
words are (dx, dy, dtheta, dw) and block 1's first word is dh; block 1 is
drawn only with shape noise. Counts are a pure function of (key, uid,
round tag, sample index), so they do not change with the grid, repacking,
row order or how one round's samples are split across calls (`offset`).

Normals (``normal_method``, as the TPU kernels'): ``"erfinv"`` (the
default) takes each word's top 23 bits through XLA's erf_inv;
``"box_muller"`` takes pairs of words, (0, 1), (2, 3) and with shape noise
block 1's (0, 1), each through one Box-Muller pair of 24-bit codes, and a
sample's normals are the pairs' outputs in order (c0, s0, c1, s1, c2).
Each method is its own build of the kernel (`normal_defines`), counted in
its own launch counter; kernels 7 and 14 take the same option.
"""

from __future__ import annotations

import ctypes

import torch

from collide2d_tpu_torch.mc import prng
from collide2d_tpu_torch.utils import cuda_build

PARAM_COLS = 16
_KERNEL = "mc_kernel"
NORMAL_METHODS = ("erfinv", "box_muller")
# Launches of the CUDA kernel in this process (never the plain version):
# its erf_inv build, and its Box-Muller build.
LAUNCHES = 0
BOX_MULLER_LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES, BOX_MULLER_LAUNCHES
    LAUNCHES = 0
    BOX_MULLER_LAUNCHES = 0


def normal_defines(normal_method: str) -> tuple[tuple[str, int], ...]:
    """The ``-D`` defines of a build of kernels 1, 7 and 14 that draws its
    normals by ``normal_method``: none for erf_inv, ``MC_BOX_MULLER=1`` for
    Box-Muller (its own library, `utils.cuda_build`)."""
    if normal_method not in NORMAL_METHODS:
        raise ValueError(f"normal_method must be one of {NORMAL_METHODS}, got "
                         f"{normal_method!r}")
    return (("MC_BOX_MULLER", 1),) if normal_method == "box_muller" else ()


def pack_mc_params(configs, robot_wh) -> torch.Tensor:
    """Configs + robot -> (C, 16) float32 rows, one configuration per row
    (64 contiguous bytes). Columns: 0 px, 1 py, 2 cos(theta), 3 sin(theta),
    4 rw/2, 5 rh/2, 6 ow/2, 7 oh/2, 8 sigma_x, 9 sigma_y, 10 sigma_theta,
    11 sigma_w/2, 12 sigma_h/2, 13 theta, 14-15 zero."""
    pos = configs.position
    theta = configs.pose_theta
    robot = torch.as_tensor(robot_wh, dtype=torch.float32, device=pos.device)
    robot = torch.broadcast_to(robot, pos.shape)
    zero = torch.zeros_like(theta)
    cols = [
        pos[:, 0], pos[:, 1], torch.cos(theta), torch.sin(theta),
        robot[:, 0] * 0.5, robot[:, 1] * 0.5,
        configs.obstacle_wh[:, 0] * 0.5, configs.obstacle_wh[:, 1] * 0.5,
        configs.std_dev[:, 0], configs.std_dev[:, 1], configs.std_dev[:, 2],
        configs.std_dev[:, 3] * 0.5, configs.std_dev[:, 4] * 0.5,
        theta, zero, zero,
    ]
    return torch.stack(cols, dim=1).contiguous()


def _obb_separated(p: torch.Tensor, z_dx, z_dy, z_th, z_dw, z_dh) -> torch.Tensor:
    """Separation mask of the relative-angle oriented-box test
    (mc_pallas.py:159-204) for (C, S) draws against (C, 16) params.
    ``z_dw``/``z_dh`` None = no shape noise."""
    col = lambda i: p[:, i : i + 1]  # noqa: E731 — (C, 1), broadcasts over S
    px, py, cos_a, sin_a, theta = col(0), col(1), col(2), col(3), col(13)
    hx1, hy1, ow_h, oh_h = col(4), col(5), col(6), col(7)
    sx, sy, sth, swh, shh = col(8), col(9), col(10), col(11), col(12)
    dx = z_dx * sx
    dy = z_dy * sy
    if z_dw is None:
        a = ow_h.abs()
        b = oh_h.abs()
    else:
        a = (ow_h + z_dw * swh).abs()
        b = (oh_h + z_dh * shh).abs()
    delta = theta - z_th * sth
    cd_raw = torch.cos(delta)
    sd_raw = torch.sin(delta)
    cd = cd_raw.abs()
    sd = sd_raw.abs()
    dxv = px - dx
    dyv = py - dy
    u = dxv * cos_a + dyv * sin_a
    v = -dxv * sin_a + dyv * cos_a
    sep = u.abs() > hx1 + a * cd + b * sd
    sep = sep | (v.abs() > hy1 + a * sd + b * cd)
    sep = sep | ((u * cd_raw - v * sd_raw).abs() > a + hx1 * cd + hy1 * sd)
    sep = sep | ((u * sd_raw + v * cd_raw).abs() > b + hx1 * sd + hy1 * cd)
    return sep


def _philox_words(uids, seed, j0: int, j1: int, offset: int, n_words: int):
    """The first ``n_words`` (<= 8) Philox words (C, j1-j0, n_words) of
    samples [j0, j1) (+ offset): draw block 0's four, then block 1's."""
    dev = uids.device
    idx = torch.arange(j0, j1, dtype=torch.int64, device=dev) + int(offset)
    lo = (idx & prng.MASK32)[None, :]
    hi = (idx >> 32)[None, :]
    uid = (uids.to(torch.int64) & prng.MASK32)[:, None]
    s0, s1 = int(seed[0]), int(seed[1])
    words = list(prng.philox4x32(lo, hi, uid, 0, s0, s1))
    if n_words > 4:
        words += list(prng.philox4x32(lo, hi, uid, 1, s0, s1))
    return torch.stack([torch.broadcast_to(x, (uid.shape[0], j1 - j0))
                        for x in words[:n_words]], dim=-1)


def _box_muller_normals(codes: torch.Tensor, n_normals: int) -> torch.Tensor:
    """(C, S, n_normals) normals of Box-Muller pairs over consecutive 24-bit
    codes (C, S, 2 * pairs): outputs in order c0, s0, c1, s1, ..."""
    c, s = prng.box_muller_from_codes(codes[..., 0::2], codes[..., 1::2])
    return torch.stack([c, s], dim=-1).flatten(-2)[..., :n_normals]


def philox_normals(uids, seed, j0: int, j1: int, offset: int, n_normals: int,
                   normal_method: str = "erfinv") -> torch.Tensor:
    """The normals (C, j1-j0, n_normals) the kernels draw for samples
    [j0, j1) (+ offset) of rows ``uids``: n_normals 23-bit codes through
    erf_inv, or ceil(n_normals / 2) Box-Muller pairs."""
    normal_defines(normal_method)
    if normal_method == "erfinv":
        return prng.normal_from_codes(
            _philox_words(uids, seed, j0, j1, offset, n_normals) >> 9)
    pairs = -(-n_normals // 2)
    words = _philox_words(uids, seed, j0, j1, offset, 2 * pairs)
    return _box_muller_normals(words >> 8, n_normals)


def uniform_normals(uniforms: torch.Tensor, normal_method: str = "erfinv"
                    ) -> torch.Tensor:
    """The TPU kernels' ``_TEST_UNIFORM_FN`` hook: pre-drawn (C, n, D)
    uniforms in (0, 1], each the 24-bit code ``u * 2^24 - 1`` (exact), as
    normals (C, n, D). erf_inv takes each code's top 23 bits. Box-Muller
    pairs as the TPU kernel does for one step of n samples, two samples of a
    tile row a pair: sample j < n/2 takes u1 = uniforms[:, j] and
    u2 = uniforms[:, j + n/2] and gets r cos a, sample j + n/2 gets r sin a
    (n even)."""
    normal_defines(normal_method)
    codes = (uniforms.to(torch.float32) * float(1 << 24) - 1.0).to(torch.int32)
    if normal_method == "erfinv":
        return prng.normal_from_codes(codes >> 1)
    half = codes.shape[1] // 2
    if 2 * half != codes.shape[1]:
        raise ValueError(f"Box-Muller uniforms need an even sample count, got "
                         f"{codes.shape[1]}")
    c, s = prng.box_muller_from_codes(codes[:, :half], codes[:, half:])
    return torch.cat([c, s], dim=1)


def normal_chunks(uids, seed, n: int, offset: int, n_normals: int,
                  normal_method: str, uniforms, step: int):
    """The plain versions' normals, ``step`` samples at a time: yields
    (C, <= step, n_normals) tensors of samples [0, n) in order, from Philox
    or, when ``uniforms`` is given, from the test hook (`uniform_normals`)."""
    z_all = None
    if uniforms is not None:
        z_all = uniform_normals(uniforms[:, :n, :n_normals], normal_method)
    for j0 in range(0, n, step):
        j1 = min(n, j0 + step)
        if z_all is not None:
            yield z_all[:, j0:j1]
        else:
            yield philox_normals(uids, seed, j0, j1, offset, n_normals, normal_method)


def mc_counts_plain(
    params: torch.Tensor,
    uids: torch.Tensor,
    seed,
    n: int,
    *,
    offset: int = 0,
    shape_noise: bool = True,
    normal_method: str = "erfinv",
    uniforms: torch.Tensor | None = None,
    max_elems: int = 1 << 16,
) -> torch.Tensor:
    """The kernel's function in torch operations, on any device.

    ``seed``: the round's two uint32 words. ``uniforms``: optional
    pre-drawn (C, n, 3 or 5) floats in (0, 1] that replace Philox — each
    becomes the 24-bit code ``u * 2^24 - 1``, then a normal as the TPU
    kernel's ``_TEST_UNIFORM_FN`` hook (mc_pallas.py:94-116) makes it
    (`uniform_normals`), so tests can replay that kernel's draws.
    ``max_elems``: rows x samples per chunk of the sample axis (the
    default keeps a chunk's temporaries in a CPU's cache). Returns int32
    (C,)."""
    c = params.shape[0]
    n = int(n)
    counts = torch.zeros((c,), dtype=torch.int32, device=params.device)
    step = max(1, max_elems // max(c, 1))
    for z in normal_chunks(uids, seed, n, offset, 5 if shape_noise else 3,
                           normal_method, uniforms, step):
        if shape_noise:
            sep = _obb_separated(params, z[..., 0], z[..., 1], z[..., 2],
                                 z[..., 3], z[..., 4])
        else:
            sep = _obb_separated(params, z[..., 0], z[..., 1], z[..., 2],
                                 None, None)
        counts += (~sep).sum(dim=1, dtype=torch.int32)
    return counts


def check_out(out, params: torch.Tensor) -> None:
    """``out``, where given, must be an int32 (C,) contiguous tensor on
    ``params``' device: the counts land there."""
    if out is None:
        return
    if (out.dtype != torch.int32 or out.shape != (params.shape[0],)
            or out.device != params.device or not out.is_contiguous()):
        raise ValueError(
            f"out must be a contiguous int32 ({params.shape[0]},) tensor on "
            f"{params.device}, got {out.dtype} {tuple(out.shape)} on {out.device}")


def _check_inputs(params: torch.Tensor, uids: torch.Tensor, n: int) -> None:
    if params.dtype != torch.float32 or params.dim() != 2 or (
        params.shape[1] != PARAM_COLS
    ):
        raise ValueError(
            f"params must be float32 (C, {PARAM_COLS}), got {params.dtype} "
            f"{tuple(params.shape)}"
        )
    if uids.dtype != torch.int32 or uids.shape != (params.shape[0],):
        raise ValueError(
            f"uids must be int32 ({params.shape[0]},), got {uids.dtype} "
            f"{tuple(uids.shape)}"
        )
    if uids.device != params.device:
        raise ValueError(f"uids on {uids.device}, params on {params.device}")
    if not (params.is_contiguous() and uids.is_contiguous()):
        raise ValueError("params and uids must be contiguous")
    if int(n) < 0:
        raise ValueError(f"n must be >= 0, got {n}")


def _kernel_lib(normal_method: str = "erfinv") -> ctypes.CDLL:
    lib = cuda_build.load(_KERNEL, normal_defines(normal_method))
    lib.mc_counts_launch.restype = ctypes.c_int
    lib.mc_counts_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.mc_max_samples_per_round.restype = ctypes.c_longlong
    lib.mc_max_samples_per_round.argtypes = []
    return lib


def mc_counts(
    params: torch.Tensor,
    uids: torch.Tensor,
    seed,
    n: int,
    *,
    offset: int = 0,
    shape_noise: bool = True,
    normal_method: str = "erfinv",
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Collision counts out of ``n`` samples per configuration: int32 (C,).

    ``params`` (C, 16) float32 from `pack_mc_params`; ``uids`` int32 (C,)
    row identities (the stream key); ``seed`` the round's two uint32
    words; ``offset`` the index of the first sample; ``normal_method``
    "erfinv" or "box_muller" (the module's docstring). CUDA tensors launch
    the kernel's build for that method, CPU tensors run the plain
    version. ``out``: an int32 (C,) tensor the counts are added into and
    which is returned (the adaptive driver passes its running counts);
    None = a new zeroed one."""
    global LAUNCHES, BOX_MULLER_LAUNCHES
    _check_inputs(params, uids, n)
    check_out(out, params)
    normal_defines(normal_method)
    if params.device.type == "cpu":
        counts = mc_counts_plain(params, uids, seed, n, offset=offset,
                                 shape_noise=shape_noise,
                                 normal_method=normal_method)
        return counts if out is None else out.add_(counts)
    if params.device.type != "cuda":
        raise ValueError(f"unsupported device {params.device}")
    counts = out if out is not None else torch.zeros(
        (params.shape[0],), dtype=torch.int32, device=params.device)
    if int(n) == 0 or params.shape[0] == 0:
        return counts
    lib = _kernel_lib(normal_method)
    if int(n) > lib.mc_max_samples_per_round():
        raise ValueError(
            f"n={n} exceeds the kernel's {lib.mc_max_samples_per_round()} "
            "samples per call; split the round with `offset`"
        )
    err = cuda_build.launch(
        params.device, lib.mc_counts_launch, params.data_ptr(), uids.data_ptr(),
        counts.data_ptr(), int(params.shape[0]), int(n), int(offset),
        int(seed[0]) & prng.MASK32, int(seed[1]) & prng.MASK32,
        int(bool(shape_noise)))
    if err != 0:
        raise RuntimeError(f"mc_counts_launch failed: CUDA error {err}")
    if normal_method == "box_muller":
        BOX_MULLER_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return counts


def round_seed(key, round_tag: int):
    """The round's two seed words: threefry ``fold_in(key, round_tag)``
    (mc_pallas.py:375-378)."""
    folded = prng.fold_in(key, int(round_tag))
    return int(folded[0]), int(folded[1])


def mc_round_cuda(
    key,
    uids: torch.Tensor,
    configs,
    robot_wh,
    round_tag: int,
    *,
    n_batch: int,
    offset: int = 0,
    shape_noise: bool = True,
    normal_method: str = "erfinv",
) -> torch.Tensor:
    """One round on the fused kernel: int32 (C,) counts of ``n_batch``
    samples per configuration, the round's sample indices ``offset`` on
    (a sample shard's part of the round). ``round_tag`` must differ across
    rounds so every round draws fresh samples."""
    params = pack_mc_params(configs, robot_wh)
    return mc_counts(params, uids.to(torch.int32).contiguous(),
                     round_seed(key, round_tag), n_batch, offset=offset,
                     shape_noise=shape_noise, normal_method=normal_method)
