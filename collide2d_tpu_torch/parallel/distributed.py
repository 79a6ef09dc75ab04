"""Multi-process deployment: a process group, a global mesh and batch ranges.

Counterpart of ``collide2d_tpu/parallel/distributed.py``, over
``torch.distributed``. Two patterns, in order of preference for this
embarrassingly parallel workload:

1. **Batch partitioning (no collectives).** Batch ``i``'s key is
   ``fold_in(master, i)`` and its file is ``{i}.npy``, so processes that
   generate disjoint batch ranges (`process_batch_range`) into one
   directory write exactly the files of a single-process run.
2. **A global mesh.** After `initialize_multihost`, `global_mesh` builds a
   ``(config, sample)`` mesh over every process's devices, the config axis
   spanning processes and each sample-axis group inside one process. Every
   process holds the whole batch and its bookkeeping, runs the counts of
   its own mesh entries, and the round's (C,) int32 counts are summed with
   one ``all_reduce``; every process then makes the same decisions and
   gets the same labels as a single-process run.

The group uses gloo: it runs on the CPU, on one card shared by several
processes and on one card a process, and a (C,) int32 sum a round is the
only collective, so NCCL would buy nothing.
"""

from __future__ import annotations

import torch

from collide2d_tpu_torch.parallel.sharding import Mesh, local_devices


def initialize_multihost(coordinator_address: str, num_processes: int,
                         process_id: int) -> None:
    """Join the default process group (gloo) at ``coordinator_address``
    (``host:port``; process 0 listens there). Call it on every process
    before building a global mesh."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id))


def _group() -> tuple[int, int]:
    """(rank, size) of the default process group, or (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_mesh(sample_axis: int | None = None, devices=None) -> Mesh:
    """A ``(config, sample)`` mesh over every process's devices, in
    process-major order. ``devices``: this process's devices (default:
    every visible card). ``sample_axis`` must divide each process's device
    count, so every sample-axis group stays inside one process and its
    partial counts are summed before the group's one collective."""
    import numpy as np

    local = [torch.device(d) for d in (devices if devices is not None
                                       else local_devices("cuda"))]
    if not local:
        raise RuntimeError("global_mesh: this process has no device")
    rank, size = _group()
    mine = [str(d) for d in local]
    if size > 1:
        import torch.distributed as dist

        every: list = [None] * size
        dist.all_gather_object(every, mine)
    else:
        every = [mine]
    s = sample_axis or 1
    for p, devs in enumerate(every):
        if s > len(devs) or len(devs) % s:
            raise ValueError(
                f"sample_axis={s} must divide the per-process device count "
                f"{len(devs)} (process {p}): a sample-axis group must stay "
                "inside one process")
    flat = [(torch.device(d), p) for p, devs in enumerate(every) for d in devs]
    n = len(flat)
    devs = np.empty((n // s, s), dtype=object)
    procs = np.empty((n // s, s), dtype=np.int64)
    for i, (d, p) in enumerate(flat):
        devs[i // s, i % s] = d
        procs[i // s, i % s] = p
    return Mesh(devs, procs)


def process_batch_range(num_batches: int, start_batch_count: int = 0,
                        process_id: int | None = None,
                        num_processes: int | None = None) -> range:
    """This process's contiguous slice of the global batch indices: run the
    same `GenerateConfig` on every process with ``num_batches`` /
    ``start_batch_count`` taken from it, and the union of the outputs is
    byte-identical to a single-process run over all batches. Rank and size
    default to the process group's (0 and 1 without one)."""
    rank, size = _group()
    pid = rank if process_id is None else process_id
    n = size if num_processes is None else num_processes
    if not 0 <= pid < n:
        raise ValueError(f"process_id {pid} out of range for {n} processes")
    per = num_batches // n
    extra = num_batches % n
    lo = start_batch_count + pid * per + min(pid, extra)
    hi = lo + per + (1 if pid < extra else 0)
    return range(lo, hi)
