"""Configuration- and sample-axis sharding over several devices.

Counterpart of ``collide2d_tpu/parallel/sharding.py``. A `Mesh` is a 2-D
``(config, sample)`` array of torch devices:

- the CONFIG axis splits a batch's rows into contiguous blocks, one block
  a mesh row (the reference's one thread a configuration);
- the SAMPLE axis splits each round's samples across a row's devices (the
  reference's sequential samples of a thread). The threefry path gives
  sample shard ``s`` the steps ``s, s + S, s + 2S, ...`` of the
  single-device stream with the same step tags; the fused kernels give
  each shard a contiguous range of sample indices. Both streams are keyed
  by (key, row uid, tag or sample index), and int32 sums are exact, so
  the summed counts equal the unsharded counts bit for bit on both paths.

Unlike a JAX mesh, a `Mesh` may repeat a device: a repeated entry is a
logical shard whose work runs on that device in turn (one card, or the
CPU, can then hold a mesh of any shape). Each entry also carries the
index of the process that owns it (`distributed.global_mesh`); a process
runs only its own entries, and the partial counts of a round are summed
over the process group with one ``all_reduce``.

``config_spec`` (a JAX ``PartitionSpec``) has no counterpart: blocks are
the contiguous split `shard_configs` makes.
"""

from __future__ import annotations

import numpy as np
import torch


def _rank() -> int:
    """This process's rank in the default process group (0 without one)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class Mesh:
    """A ``(config, sample)`` array of torch devices.

    ``devices``: (a, s) object array of `torch.device`; ``process_index``:
    (a, s) int array, the rank of the process that owns each entry.
    ``shape`` is ``{"config": a, "sample": s}``, as a JAX mesh's."""

    def __init__(self, devices, process_index=None) -> None:
        src = np.asarray(devices, dtype=object)
        devs = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(src.shape):
            devs[idx] = torch.device(src[idx])
        if devs.ndim != 2 or devs.size == 0:
            raise ValueError(f"a mesh is a non-empty 2-D device array, got shape "
                             f"{devs.shape}")
        self.devices = devs
        if process_index is None:
            process_index = np.full(devs.shape, _rank(), dtype=np.int64)
        self.process_index = np.asarray(process_index, dtype=np.int64)
        if self.process_index.shape != devs.shape:
            raise ValueError("process_index must have the devices' shape")

    @property
    def shape(self) -> dict:
        return {"config": int(self.devices.shape[0]),
                "sample": int(self.devices.shape[1])}

    def is_local(self, i: int, j: int = 0) -> bool:
        """Whether entry (i, j) belongs to this process."""
        return int(self.process_index[i, j]) == _rank()

    @property
    def spans_processes(self) -> bool:
        return bool((self.process_index != self.process_index.flat[0]).any())

    def __repr__(self) -> str:
        rows = [[f"{d}@{p}" for d, p in zip(dr, pr)]
                for dr, pr in zip(self.devices, self.process_index)]
        return f"Mesh({self.shape}, {rows})"


def local_devices(device="cuda") -> list[torch.device]:
    """The devices a run on ``device`` can spread over: every visible card
    for a CUDA device, else the device itself (torch has one CPU device)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def make_mesh(devices=None, *, sample_axis: int | None = None) -> Mesh:
    """A 2-D ``(config, sample)`` mesh over ``devices`` (default: every
    visible card; with none it raises, it never falls back to the CPU).

    ``sample_axis`` fixes the sample-axis size, which must divide the
    device count; by default the mesh is all-config (pure data
    parallelism). ``devices`` may repeat a device (logical shards)."""
    if devices is None:
        devices = local_devices("cuda")
        if not devices:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "devices explicitly")
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    s = sample_axis or 1
    if n == 0 or n % s:
        raise ValueError(f"sample_axis={s} does not divide {n} devices")
    arr = np.empty((n // s, s), dtype=object)
    for i, d in enumerate(devices):
        arr[i // s, i % s] = d
    return Mesh(arr)


def config_blocks(num: int, mesh: Mesh) -> list[tuple[int, int]]:
    """The [lo, hi) row range of each config block: contiguous blocks, equal
    when the config axis divides ``num``, else the first ``num % a`` one row
    longer (no row is dropped)."""
    a = mesh.shape["config"]
    per, extra = divmod(int(num), a)
    out, lo = [], 0
    for i in range(a):
        hi = lo + per + (1 if i < extra else 0)
        out.append((lo, hi))
        lo = hi
    return out


def shard_configs(configs, mesh: Mesh) -> list:
    """``configs`` (any configuration class: `Configs`, `PolygonConfigs`,
    `MovingConfigs`, `MovingPolygonConfigs`) split into the mesh's config
    blocks, each block of the same class on its mesh row's first device.
    A block whose row belongs to another process is None."""
    out = []
    for i, (lo, hi) in enumerate(config_blocks(configs.num, mesh)):
        if not mesh.is_local(i):
            out.append(None)
            continue
        dev = mesh.devices[i, 0]
        out.append(type(configs)(*(a[lo:hi].to(dev) for a in configs)))
    return out


def sharded_mc_round(key, uids: torch.Tensor, configs, robot_wh, chunk_offset: int,
                     *, n_batch: int, step_samples: int, mesh: Mesh,
                     use_vertices: bool = False) -> torch.Tensor:
    """One threefry round sharded over a ``(config, sample)`` mesh: int32
    (C,) counts on ``configs``' device, bitwise the unsharded `mc_round` at
    the same ``step_samples`` (`estimator._sample_sharded_counts`).
    ``n_batch`` must be a multiple of sample axis x step_samples."""
    from collide2d_tpu_torch.mc.estimator import _sample_sharded_counts

    n_sample = mesh.shape["sample"]
    if n_batch % (n_sample * step_samples):
        raise ValueError(
            f"n_batch={n_batch} must be a multiple of sample_axis x "
            f"step_samples = {n_sample} x {step_samples}")
    return _sample_sharded_counts(
        key, uids, configs, robot_wh, chunk_offset, n_batch // step_samples,
        step_samples=step_samples, use_vertices=use_vertices, mesh=mesh)


def sample_sharded_probability(key, configs, robot_wh, n_samples: int,
                               mesh: Mesh | None = None, *,
                               step_samples: int = 0) -> torch.Tensor:
    """Fixed-budget collision probability (float32 (C,)) with the sample
    budget split over the mesh's sample axis (default: every card on it).
    ``n_samples`` must be a multiple of the sample-axis size."""
    if mesh is None:
        devs = local_devices("cuda")
        mesh = make_mesh(devs or None, sample_axis=len(devs) or None)
    n_sample = mesh.shape["sample"]
    if n_samples % n_sample:
        raise ValueError(
            f"n_samples={n_samples} must be a multiple of the sample-axis "
            f"device count {n_sample}")
    if step_samples <= 0:
        per_dev = n_samples // n_sample
        step_samples = max(1, min(per_dev, 512))
        while per_dev % step_samples:
            step_samples -= 1
    uids = torch.arange(configs.num, dtype=torch.int32,
                        device=configs.position.device)
    counts = sharded_mc_round(key, uids, configs, robot_wh, 0,
                              n_batch=int(n_samples),
                              step_samples=int(step_samples), mesh=mesh)
    return counts.to(torch.float32) / torch.tensor(
        float(n_samples), dtype=torch.float32, device=counts.device)
