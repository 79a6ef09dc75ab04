"""Batched convex k-gon SAT (true edge normals): the CUDA kernel and its
plain version.

Counterpart of ``collide2d_tpu/ops/polygon_pallas.py``, with its layout:
a k-gon batch is the (2K, 8, N/8) SoA of `pack_polygons`, rows x0..x_{K-1},
y0..y_{K-1}, pair ``p = s * (N/8) + l`` at ``[:, s, l]``; polygons are
padded to a fixed K by repeating their last vertex (`pad_polygons`), which
needs no masks inside the test (see `ops.sat.sat_polygons`).

`sat_polygons_cuda_t` takes packed batches and routes on their device:

- a CUDA tensor launches ``csrc/polygon_kernel.cu`` (built at first use by
  `utils.cuda_build`: one library for the K buckets 4, 8 and 16, and one
  for each pair of buckets above 16, `kernel_defines`) and counts the
  launch in ``LAUNCHES``; a failed build or a failed launch raises;
- a CPU tensor runs `sat_polygons_plain`: the same test in torch
  operations on the same packed rows (`ops.sat.polygon_columns_collide`),
  each product and sum rounded on its own.

Labels are float32 (8M,) in {0, 1}, bitwise the Pallas kernel's.
`sat_polygons_cuda` is the drop-in for `ops.sat.sat_polygons` on
repeat-padded (N, K, 2) inputs: it packs, pads N and returns int32 (N,);
`sat_columns_cuda` takes the packed columns of any N (the scene queries
build and roll them).
"""

from __future__ import annotations

import ctypes

import torch

from collide2d_tpu_torch.ops.sat import polygon_columns_collide

LANE_BLOCK = 512  # lanes per block of the TPU grid; kept for the M % block contract
REGISTER_BUCKETS = (4, 8, 16)  # the K buckets of the default build
_KERNEL = "polygon_kernel"
_DTYPES = (torch.float32, torch.bfloat16)
# Launches of the CUDA kernel in this process (never the plain version).
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def k_bucket(k: int) -> int:
    """The K a polygon of ``k`` vertices is padded to inside the kernels
    6, 9 and 10: 4, 8 or 16 up to 16, else the next power of two
    (``csrc/polygon_soa.cuh::k_bucket``)."""
    if k < 1:
        raise ValueError(f"a polygon needs at least one vertex, got k={k}")
    for b in REGISTER_BUCKETS:
        if k <= b:
            return b
    return 1 << (k - 1).bit_length()


def kernel_defines(k1: int, k2: int) -> tuple[tuple[str, int], ...]:
    """The ``-D`` defines of the library of kernels 6, 9 and 10 that
    carries the bucket pair of (k1, k2): none for the default build (every
    pair of 4, 8 and 16), else ``POLY_KB1`` / ``POLY_KB2`` (a build for
    that one pair, compiled at its first use)."""
    b1, b2 = k_bucket(k1), k_bucket(k2)
    if max(b1, b2) <= REGISTER_BUCKETS[-1]:
        return ()
    return (("POLY_KB1", b1), ("POLY_KB2", b2))


def pad_polygons(p: torch.Tensor, k: int) -> torch.Tensor:
    """(N, k0, 2) -> (N, k, 2) by repeating the last vertex (k0 <= k)."""
    n, k0, _ = p.shape
    if k0 > k:
        raise ValueError(f"polygon has {k0} vertices > K={k}")
    if k0 == k:
        return p
    return torch.cat([p, p[:, k0 - 1 : k0].expand(n, k - k0, 2)], dim=1)


def pack_polygons(p: torch.Tensor) -> torch.Tensor:
    """(N, K, 2) vertex batch -> (2K, 8, N/8) SoA layout (N % 8 == 0)."""
    n, k, _ = p.shape
    if n % 8:
        raise ValueError(f"pack_polygons needs N % 8 == 0, got N={n}")
    # (N, K, 2) -> (2, K, N): coordinate-major, so rows are x0.., then y0..
    return p.permute(2, 1, 0).contiguous().view(2 * k, 8, n // 8)


def soa_columns(p: torch.Tensor) -> torch.Tensor:
    """(N, K, 2) -> (2K, N): rows x0..x_{K-1}, y0..y_{K-1}, `pack_polygons`'
    order before its (8, N/8) view, for any N."""
    return p.permute(2, 1, 0).reshape(2 * p.shape[1], p.shape[0])


def pad_columns(cols: torch.Tensor) -> torch.Tensor:
    """(R, N) columns -> (R, M), M = N rounded up to the kernel's pair
    multiple (8 * `LANE_BLOCK`), padded with copies of the last column."""
    pad = (-cols.shape[1]) % (8 * LANE_BLOCK)
    if pad:
        cols = torch.cat([cols, cols[:, -1:].expand(-1, pad)], dim=1)
    return cols


def sat_columns_cuda(a: torch.Tensor, b: torch.Tensor, *, k1: int,
                     k2: int) -> torch.Tensor:
    """`sat_polygons_cuda_t` on (2K1, N) x (2K2, N) `soa_columns` of any N:
    pads N (`pad_columns`), runs and slices the padding away -> float32
    (N,) in {0, 1}."""
    n = a.shape[1]
    a, b = pad_columns(a).contiguous(), pad_columns(b).contiguous()
    out = sat_polygons_cuda_t(a.view(2 * k1, 8, -1), b.view(2 * k2, 8, -1), k1=k1, k2=k2)
    return out[:n]


def pack_polygons_bf16(p: torch.Tensor) -> torch.Tensor:
    """(N, K, 2) float32 -> (2K, 8, N/8) bfloat16 SoA: coordinates rounded
    to bfloat16 (labels of pairs within that rounding of touching can
    differ from f32; coarse labeling only), the test still in float32."""
    return pack_polygons(p).to(torch.bfloat16)


def sat_polygons_plain(p1t: torch.Tensor, p2t: torch.Tensor, k1: int,
                       k2: int) -> torch.Tensor:
    """Kernel 6 in torch operations: boolean (8, M) collide mask of packed
    pairs, float32 arithmetic whatever the input type."""
    v1 = p1t.to(torch.float32)
    v2 = p2t.to(torch.float32)
    return polygon_columns_collide([v1[i] for i in range(k1)],
                                   [v1[k1 + i] for i in range(k1)],
                                   [v2[i] for i in range(k2)],
                                   [v2[k2 + i] for i in range(k2)])


def _check(p1t: torch.Tensor, p2t: torch.Tensor, k1: int, k2: int) -> None:
    if p1t.dtype not in _DTYPES or p2t.dtype != p1t.dtype:
        raise ValueError(f"packed inputs must share one dtype of {_DTYPES}, "
                         f"got {p1t.dtype} and {p2t.dtype}")
    if k1 < 1 or k2 < 1:
        raise ValueError(f"K1 and K2 must be >= 1, got {k1} and {k2}")
    if (p1t.dim() != 3 or p1t.shape[:2] != (2 * k1, 8) or p2t.dim() != 3
            or p2t.shape[:2] != (2 * k2, 8) or p2t.shape[2] != p1t.shape[2]):
        raise ValueError(f"packed inputs must be (2*{k1}, 8, M) and "
                         f"(2*{k2}, 8, M), got {tuple(p1t.shape)} and "
                         f"{tuple(p2t.shape)}")
    if p1t.device != p2t.device:
        raise ValueError(f"inputs on {p1t.device} and {p2t.device}")
    if p1t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {p1t.device}")
    if p1t.shape[2] % LANE_BLOCK:
        raise ValueError(f"M={p1t.shape[2]} must be a multiple of block={LANE_BLOCK}")


def _kernel_lib(k1: int, k2: int) -> ctypes.CDLL:
    from collide2d_tpu_torch.utils import cuda_build

    lib = cuda_build.load(_KERNEL, kernel_defines(k1, k2))
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.polygon_sat_launch.restype = ctypes.c_int
    lib.polygon_sat_launch.argtypes = [p, p, p, ll, i, i, i, p]
    return lib


def sat_polygons_cuda_t(p1t: torch.Tensor, p2t: torch.Tensor, *, k1: int,
                        k2: int) -> torch.Tensor:
    """SAT over SoA k-gon pairs: (2K1, 8, M) x (2K2, 8, M), float32 or
    bfloat16 -> float32 (8M,) in {0, 1}. M must be a multiple of
    `LANE_BLOCK`."""
    global LAUNCHES
    _check(p1t, p2t, k1, k2)
    if p1t.device.type == "cpu":
        return sat_polygons_plain(p1t, p2t, k1, k2).reshape(-1).to(torch.float32)
    if not (p1t.is_contiguous() and p2t.is_contiguous()):
        raise ValueError("packed inputs must be contiguous")
    n = p1t.shape[1] * p1t.shape[2]
    out = torch.empty((n,), dtype=torch.float32, device=p1t.device)
    if n == 0:
        return out
    lib = _kernel_lib(k1, k2)
    # The launch goes to the current device: make it the tensors' one.
    with torch.cuda.device(p1t.device):
        err = lib.polygon_sat_launch(
            p1t.data_ptr(), p2t.data_ptr(), out.data_ptr(), n, int(k1), int(k2),
            int(p1t.dtype == torch.bfloat16),
            torch.cuda.current_stream(p1t.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"polygon_sat_launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def sat_polygons_cuda(p1: torch.Tensor, p2: torch.Tensor, *,
                      precision: str = "f32") -> torch.Tensor:
    """Drop-in for `ops.sat.sat_polygons` on repeat-padded (N, K, 2)
    inputs (no masks): int32 (N,). Pads N to the block alignment with
    copies of the last pair (sliced away), packs, and runs
    `sat_polygons_cuda_t`. ``precision='bf16'`` rounds the coordinates to
    bfloat16 before the test."""
    if precision not in ("f32", "bf16"):
        raise ValueError(f"precision must be 'f32' or 'bf16', got {precision!r}")
    n, k1, k2 = p1.shape[0], p1.shape[1], p2.shape[1]
    if n == 0:
        return torch.zeros((0,), dtype=torch.int32, device=p1.device)
    a, b = soa_columns(p1), soa_columns(p2)
    if precision == "bf16":
        a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    return sat_columns_cuda(a, b, k1=k1, k2=k2).to(torch.int32)
