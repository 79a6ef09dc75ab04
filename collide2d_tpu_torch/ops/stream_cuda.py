"""The streaming-bandwidth probe (kernel 16): the CUDA kernel and its plain
version.

Counterpart of the Pallas kernel inside
``collide2d_tpu/utils/benchmarks.py::bench_stream_bandwidth_pallas``: two
float32 (8, 8, M) batches packed as `ops.sat_cuda.pack_rects` packs them
(the SAT count kernel's memory pattern) and a float32 scalar ``s`` ->
the float32 sum over (8, 8, TILE) tiles of ``sum(r1_tile) * s +
sum(r2_tile)``.

`stream_sum` routes on the device of its inputs:

- a CUDA tensor launches ``csrc/stream_kernel.cu`` (built at first use by
  `utils.cuda_build`) and counts the launch in ``LAUNCHES``; a failed
  build or launch raises. Its value is the same on every launch with the
  same inputs (no float atomics);
- a CPU tensor runs `stream_sum_plain`: the tile sums in torch operations,
  in tile order.

The two add in other orders, so they agree to float32 rounding of sums of
2^26 terms at the bench's 2^23 pairs: within 1e-5 x (sum|r1| * s +
sum|r2|).
"""

from __future__ import annotations

import ctypes

import torch

from collide2d_tpu_torch.ops.sat_cuda import _f32

TILE = 4096  # lanes of one tile, the TPU kernel's block
_KERNEL = "stream_kernel"
# Launches of the CUDA kernel in this process (never the plain version).
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def bytes_read(r1: torch.Tensor, r2: torch.Tensor) -> int:
    """Bytes the probe must read: each input once (64 B a pair)."""
    return r1.numel() * r1.element_size() + r2.numel() * r2.element_size()


def _check(r1: torch.Tensor, r2: torch.Tensor) -> None:
    if r1.dtype != torch.float32 or r2.dtype != torch.float32:
        raise ValueError(f"inputs must be float32, got {r1.dtype} and {r2.dtype}")
    if r1.dim() != 3 or r1.shape[:2] != (8, 8) or r2.shape != r1.shape:
        raise ValueError(f"inputs must both be (8, 8, M), got {tuple(r1.shape)} "
                         f"and {tuple(r2.shape)}")
    if r1.device != r2.device:
        raise ValueError(f"inputs on {r1.device} and {r2.device}")
    if r1.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {r1.device}")


def stream_sum_plain(r1: torch.Tensor, r2: torch.Tensor, s: float) -> torch.Tensor:
    """The TPU kernel's sum in torch operations: per (8, 8, TILE) tile
    ``sum(r1_tile) * s + sum(r2_tile)`` (a last tile may be partial),
    summed over the tiles in order. float32 0-d tensor."""
    _check(r1, r2)
    m = r1.shape[2]
    s = _f32(s)

    def tile_sums(r: torch.Tensor) -> torch.Tensor:
        flat = r.reshape(64, m)
        whole = m - m % TILE
        sums = flat[:, :whole].reshape(64, whole // TILE, TILE).sum(dim=(0, 2))
        if whole < m:
            sums = torch.cat([sums, flat[:, whole:].sum().reshape(1)])
        return sums

    return (tile_sums(r1) * s + tile_sums(r2)).sum()


def _kernel_lib() -> ctypes.CDLL:
    from collide2d_tpu_torch.utils import cuda_build

    lib = cuda_build.load(_KERNEL)
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.stream_sum_blocks.restype = i
    lib.stream_sum_blocks.argtypes = [ll, i]
    lib.stream_sum_launch.restype = i
    lib.stream_sum_launch.argtypes = [p, p, ll, ctypes.c_float, i, p, p, p, p]
    return lib


def _launch(a: torch.Tensor, b: torch.Tensor, s: float) -> torch.Tensor:
    """Launch kernel 16 over every element of two contiguous, 16-byte
    aligned float32 CUDA tensors of one size (any count; the kernel reads
    the last ``numel % 4`` one at a time). Raises on a failed launch."""
    global LAUNCHES
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("inputs must be contiguous")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("inputs must be 16-byte aligned")
    lib = _kernel_lib()
    n = a.numel()
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    blocks = lib.stream_sum_blocks(n, sms)
    # [partials of a | partials of b | ticket (bits 0) | result]
    scratch = torch.zeros((2 * blocks + 2,), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    base = scratch.data_ptr()
    err = lib.stream_sum_launch(a.data_ptr(), b.data_ptr(), n, _f32(s), blocks,
                                base, base + 8 * blocks, base + 8 * blocks + 4,
                                stream)
    if err != 0:
        raise RuntimeError(f"stream_sum_launch failed: CUDA error {err}")
    LAUNCHES += 1
    return scratch[-1]


def stream_sum(r1: torch.Tensor, r2: torch.Tensor, s: float) -> torch.Tensor:
    """``s * sum(r1) + sum(r2)`` of two (8, 8, M) float32 batches: a float32
    0-d tensor. CUDA tensors launch kernel 16, CPU tensors run
    `stream_sum_plain`."""
    _check(r1, r2)
    if r1.device.type == "cpu":
        return stream_sum_plain(r1, r2, s)
    return _launch(r1, r2, s)
