"""Batched rectangle-pair SAT and parametric OBB tests: the CUDA kernels
and their plain versions.

Counterpart of ``collide2d_tpu/ops/sat_pallas.py``, with its layouts:

- `pack_rects`: (N, 4, 2) vertices -> (8, 8, N/8) SoA, rows x0..x3,
  y0..y3, pair ``p = s * (N/8) + l`` at ``[:, s, l]``; `pack_rects_bf16`
  the same in bfloat16 (half the bytes, coordinates rounded);
- `pack_obbs`: centres, FULL extents and angles -> (6, 8, N/8), rows cx,
  cy, cos, sin, |w|/2, |h|/2;
- `unpack_labels`: (8, N/8) -> (N,).

The four ``*_cuda_t`` functions take packed batches and a scalar
``shift`` added to every second-body coordinate (benchmarks use it to
defeat hoisting). Each routes on the device of its inputs:

- a CUDA tensor launches the kernel of ``csrc/sat_kernel.cu`` (built at
  first use by `utils.cuda_build`) and counts the launch in
  ``LAUNCHES[name]``; a failed build or launch raises;
- a CPU tensor runs the plain version: the same test in torch operations
  on the same packed rows (`ops.sat.rect_columns_collide`,
  `ops.sat.obb_overlap`), each product and sum rounded on its own.

Labels are float32 in {0, 1}; counts are a float32 0-d tensor, exact
below 2^24 as the TPU kernel's float32 sum is. `sat_rects_cuda` and
`obb_collide_cuda` are the drop-ins that pad, pack and return int32 (N,).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from collide2d_tpu_torch.ops.sat import obb_overlap, rect_columns_collide
from collide2d_tpu_torch.utils import cuda_build

LANE_BLOCK = 1024  # lanes per block of the TPU grid; kept for the M % block contract
_KERNEL = "sat_kernel"
# Launches of each CUDA kernel in this process (never the plain versions).
LAUNCHES = {"sat_label": 0, "sat_count": 0, "obb_label": 0, "obb_count": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def pack_rects(rects: torch.Tensor) -> torch.Tensor:
    """(N, 4, 2) vertex batch -> (8, 8, N/8) SoA layout (N % 8 == 0)."""
    n = rects.shape[0]
    if n % 8:
        raise ValueError(f"pack_rects needs N % 8 == 0, got N={n}")
    # (N, 4, 2) -> (2, 4, N): coordinate-major, so rows are x0..x3, y0..y3.
    return rects.reshape(n, 4, 2).permute(2, 1, 0).contiguous().view(8, 8, n // 8)


def pack_rects_bf16(rects: torch.Tensor) -> torch.Tensor:
    """(N, 4, 2) float32 -> (8, 8, N/8) bfloat16 SoA: coordinates rounded to
    bfloat16 (8 mantissa bits), the test itself still runs in float32."""
    return pack_rects(rects).to(torch.bfloat16)


def pack_obbs(centers: torch.Tensor, exts: torch.Tensor,
              thetas: torch.Tensor) -> torch.Tensor:
    """(N,2) centres + (N,2) FULL extents + (N,) angles -> (6, 8, N/8).

    Rows: cx, cy, cos(theta), sin(theta), |w|/2, |h|/2 — abs-then-halve,
    as `ops.sat.obb_collide`. N % 8 == 0."""
    n = centers.shape[0]
    if n % 8:
        raise ValueError(f"pack_obbs needs N % 8 == 0, got N={n}")
    rows = torch.stack([
        centers[:, 0], centers[:, 1], torch.cos(thetas), torch.sin(thetas),
        exts[:, 0].abs() * 0.5, exts[:, 1].abs() * 0.5,
    ])
    return rows.reshape(6, 8, n // 8)


def unpack_labels(out: torch.Tensor) -> torch.Tensor:
    """(8, N/8) kernel output -> (N,) labels (row-major pair order)."""
    return out.reshape(-1)


def _f32(shift) -> float:
    """The shift as the kernel receives it: a float32 value."""
    return float(np.float32(shift))


def sat_collide_plain(r1t: torch.Tensor, r2t: torch.Tensor,
                      shift: float = 0.0) -> torch.Tensor:
    """Kernels 2 and 3 in torch operations: boolean (8, M) collide mask of
    packed pairs, float32 arithmetic whatever the input type."""
    v1 = r1t.to(torch.float32)
    v2 = r2t.to(torch.float32) + _f32(shift)
    return rect_columns_collide([v1[i] for i in range(4)],
                                [v1[4 + i] for i in range(4)],
                                [v2[i] for i in range(4)],
                                [v2[4 + i] for i in range(4)])


def obb_collide_plain(b1t: torch.Tensor, b2t: torch.Tensor,
                      shift: float = 0.0) -> torch.Tensor:
    """Kernels 4 and 5 in torch operations: boolean (8, M) collide mask of
    packed boxes."""
    shift = _f32(shift)
    dx = b1t[0] - (b2t[0] + shift)
    dy = b1t[1] - (b2t[1] + shift)
    return obb_overlap(dx, dy, b1t[2], b1t[3], b1t[4], b1t[5],
                       b2t[2], b2t[3], b2t[4], b2t[5])


def _check(a: torch.Tensor, b: torch.Tensor, rows: int, dtypes, block: int) -> int:
    """Validate a packed pair batch; returns M (lanes)."""
    if a.dtype not in dtypes or b.dtype != a.dtype:
        raise ValueError(f"packed inputs must share one dtype of {dtypes}, got "
                         f"{a.dtype} and {b.dtype}")
    if a.dim() != 3 or a.shape[:2] != (rows, 8) or b.shape != a.shape:
        raise ValueError(f"packed inputs must both be ({rows}, 8, M), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"inputs on {a.device} and {b.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")
    m = a.shape[2]
    if m % block:
        raise ValueError(f"M={m} must be a multiple of block={block}")
    return m


def _kernel_lib() -> ctypes.CDLL:
    lib = cuda_build.load(_KERNEL)
    p, ll, f, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float, ctypes.c_int
    for fn in (lib.sat_label_launch, lib.sat_count_launch):
        fn.restype = ctypes.c_int
        fn.argtypes = [p, p, p, ll, f, i, p]
    for fn in (lib.obb_label_launch, lib.obb_count_launch):
        fn.restype = ctypes.c_int
        fn.argtypes = [p, p, p, ll, f, p]
    return lib


def _launch(name: str, a: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
            shift) -> None:
    """Launch kernel ``name`` on the current stream; raises on an error."""
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("packed inputs must be contiguous")
    lib = _kernel_lib()
    n = a.shape[1] * a.shape[2]
    args = [a.data_ptr(), b.data_ptr(), out.data_ptr(), n, _f32(shift)]
    if name.startswith("sat"):
        args.append(int(a.dtype == torch.bfloat16))
    err = cuda_build.launch(a.device, getattr(lib, f"{name}_launch"), *args)
    if err != 0:
        raise RuntimeError(f"{name}_launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _labels(name, plain, a, b, shift) -> torch.Tensor:
    if a.device.type == "cpu":
        return unpack_labels(plain(a, b, shift).to(torch.float32))
    out = torch.empty((a.shape[1] * a.shape[2],), dtype=torch.float32,
                      device=a.device)
    _launch(name, a, b, out, shift)
    return out


def _count(name, plain, a, b, shift) -> torch.Tensor:
    if a.device.type == "cpu":
        return plain(a, b, shift).sum(dtype=torch.int64).to(torch.float32)
    total = torch.zeros((), dtype=torch.int64, device=a.device)
    _launch(name, a, b, total, shift)
    return total.to(torch.float32)


_SAT_DTYPES = (torch.float32, torch.bfloat16)


def sat_rects_cuda_t(r1t: torch.Tensor, r2t: torch.Tensor, shift: float = 0.0,
                     *, block: int = LANE_BLOCK) -> torch.Tensor:
    """SAT over SoA pairs: (8, 8, M) x (8, 8, M), float32 or bfloat16 ->
    float32 (8M,) in {0, 1}. M must be a multiple of ``block``."""
    _check(r1t, r2t, 8, _SAT_DTYPES, block)
    return _labels("sat_label", sat_collide_plain, r1t, r2t, shift)


def sat_count_cuda_t(r1t: torch.Tensor, r2t: torch.Tensor, shift: float = 0.0,
                     *, block: int = LANE_BLOCK) -> torch.Tensor:
    """Total collision count over SoA pairs: float32 0-d tensor."""
    _check(r1t, r2t, 8, _SAT_DTYPES, block)
    return _count("sat_count", sat_collide_plain, r1t, r2t, shift)


def obb_collide_cuda_t(b1t: torch.Tensor, b2t: torch.Tensor, shift: float = 0.0,
                       *, block: int = LANE_BLOCK) -> torch.Tensor:
    """Param-form OBB test over SoA boxes: (6, 8, M) x (6, 8, M) float32 ->
    float32 (8M,) in {0, 1}."""
    _check(b1t, b2t, 6, (torch.float32,), block)
    return _labels("obb_label", obb_collide_plain, b1t, b2t, shift)


def obb_count_cuda_t(b1t: torch.Tensor, b2t: torch.Tensor, shift: float = 0.0,
                     *, block: int = LANE_BLOCK) -> torch.Tensor:
    """Total collision count over SoA param boxes: float32 0-d tensor."""
    _check(b1t, b2t, 6, (torch.float32,), block)
    return _count("obb_count", obb_collide_plain, b1t, b2t, shift)


def _pad_rows(a: torch.Tensor, padded: int) -> torch.Tensor:
    n = a.shape[0]
    if padded == n:
        return a
    return torch.cat([a, a.new_zeros((padded - n,) + tuple(a.shape[1:]))])


def sat_rects_cuda(r1: torch.Tensor, r2: torch.Tensor, *,
                   block: int = LANE_BLOCK, precision: str = "f32") -> torch.Tensor:
    """Drop-in for `ops.sat.sat_rects` on (N, 4, 2) inputs: int32 (N,).

    Pads to the block alignment with zero rectangles (sliced away),
    packs, and runs `sat_rects_cuda_t`. ``precision='bf16'`` rounds the
    coordinates to bfloat16 before the test."""
    n = r1.shape[0]
    padded = -(-n // (8 * block)) * (8 * block)
    pack = pack_rects_bf16 if precision == "bf16" else pack_rects
    out = sat_rects_cuda_t(pack(_pad_rows(r1, padded)),
                           pack(_pad_rows(r2, padded)), block=block)
    return out[:n].to(torch.int32)


def obb_collide_cuda(c1, ext1, th1, c2, ext2, th2, *,
                     block: int = LANE_BLOCK) -> torch.Tensor:
    """Drop-in for `ops.sat.obb_collide` on parametric boxes: int32 (N,).
    Centres and extents (N, 2), angles (N,)."""
    n = c1.shape[0]
    padded = -(-n // (8 * block)) * (8 * block)
    args = [_pad_rows(a.to(torch.float32), padded)
            for a in (c1, ext1, th1, c2, ext2, th2)]
    out = obb_collide_cuda_t(pack_obbs(*args[:3]), pack_obbs(*args[3:]),
                             block=block)
    return out[:n].to(torch.int32)
