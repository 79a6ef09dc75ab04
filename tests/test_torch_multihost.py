"""The port's multi-process story, run: real OS processes on the CPU.

Counterparts of tests/test_multihost.py's two tests, and one more:

- two processes generate disjoint `process_batch_range` slices into one
  directory; the union is byte-identical to a single-process run;
- two processes join one gloo process group (`initialize_multihost`) on a
  free local port and sum a tensor across it;
- two processes label one batch over a `global_mesh` whose config axis
  spans both (each runs its own block; the counts meet in one
  ``all_reduce`` a round); each process's labels are bitwise the
  single-process run's, on the threefry path and on kernel 1's plain
  version.

Every child gets a timeout and is killed in a ``finally``.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import torch

from collide2d_tpu_torch.data.pipeline import GenerateConfig, generate_dataset
from collide2d_tpu_torch.mc import prng
from collide2d_tpu_torch.mc.driver import adaptive_collision_probabilities as acp
from collide2d_tpu_torch.mc.estimator import AdaptiveConfig, Configs

# The suite runs one xdist worker per core: one torch thread each keeps
# the workers from oversubscribing the host.
torch.set_num_threads(1)

FAST = dict(max_samples=4000, initial_batch=1000, initial_phase_samples=2000,
            later_batch=2000, bin_accuracy=(0.02, 0.02, 0.05), min_active=64)
ROBOT = (4.07, 1.74)

_GENERATE = r"""
import sys, torch
torch.set_num_threads(1)
from collide2d_tpu_torch.parallel import process_batch_range
from collide2d_tpu_torch.data.pipeline import GenerateConfig, generate_dataset
from collide2d_tpu_torch.mc.estimator import AdaptiveConfig

pid, nproc, num_batches, data_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                     int(sys.argv[3]), sys.argv[4])
r = process_batch_range(num_batches, 0, process_id=pid, num_processes=nproc)
generate_dataset(GenerateConfig(
    data_dir=data_dir, num_batches=len(r), batch_size=64, start_batch_count=r.start,
    num_poses=8, num_variances=8, seed=7, verbose=False, max_samples=4000,
    device="cpu"))
"""

_HANDSHAKE = r"""
import sys, torch
torch.set_num_threads(1)
import torch.distributed as dist
from collide2d_tpu_torch.parallel import initialize_multihost, process_batch_range
rank = int(sys.argv[2])
initialize_multihost(sys.argv[1], 2, rank)
t = torch.tensor([rank + 1], dtype=torch.int32)
dist.all_reduce(t)
assert int(t) == 3, int(t)
assert process_batch_range(5) == (range(0, 3) if rank == 0 else range(3, 5))
dist.destroy_process_group()
"""

_GLOBAL_MESH = r"""
import sys, numpy as np, torch
torch.set_num_threads(1)
import torch.distributed as dist
from collide2d_tpu_torch.parallel import global_mesh, initialize_multihost
from tests.test_torch_multihost import label_batch
initialize_multihost(sys.argv[1], 2, int(sys.argv[2]))
mesh = global_mesh(devices=["cpu"])
assert mesh.shape == {"config": 2, "sample": 1} and mesh.spans_processes
out = {}
for impl in ("threefry", "cuda"):
    cp, n, done = label_batch(impl, mesh)
    out.update({f"{impl}_cp": cp, f"{impl}_n": n, f"{impl}_done": done})
np.savez(sys.argv[3], **out)
dist.destroy_process_group()
"""


def label_batch(impl, mesh=None):
    """The labels of one fixed batch of 200 rows (shared with the child
    processes)."""
    rng = np.random.default_rng(77)
    pose = rng.uniform(0, 0.3, (200, 3))
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    cfgs = Configs(f32(rng.uniform(-6, 6, (200, 2))), f32(rng.uniform(0, 6.28, 200)),
                   f32(rng.uniform(0.5, 5, (200, 2))),
                   f32(np.concatenate([pose, np.zeros((200, 2))], axis=1)))
    cfg = AdaptiveConfig(**dict(FAST, bin_accuracy=(0.002, 0.002, 0.005)), impl=impl)
    return acp(prng.PRNGKey(5), cfgs, ROBOT, cfg, mesh=mesh)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _run_pair(script, args_of, timeout=300):
    """Run ``script`` in two processes (argv from ``args_of(pid)``); assert
    both exit 0; kill both on any failure."""
    procs = [subprocess.Popen([sys.executable, "-c", script, *args_of(pid)],
                              env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE)
             for pid in (0, 1)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err.decode()[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def test_two_process_generate_union_is_byte_identical(tmp_path):
    num_batches = 3  # odd on purpose: an uneven 2 / 1 split
    shared = tmp_path / "shared"
    shared.mkdir()
    _run_pair(_GENERATE, lambda pid: [str(pid), "2", str(num_batches), str(shared)])
    ref = tmp_path / "ref"
    generate_dataset(GenerateConfig(
        data_dir=str(ref), num_batches=num_batches, batch_size=64, num_poses=8,
        num_variances=8, seed=7, verbose=False, max_samples=4000, device="cpu"))
    for name in [f"{i}.npy" for i in range(num_batches)] + ["poses.npy",
                                                            "variances.npy"]:
        assert (shared / name).read_bytes() == (ref / name).read_bytes(), name


def test_initialize_multihost_handshake():
    port = _free_port()
    _run_pair(_HANDSHAKE, lambda pid: [f"localhost:{port}", str(pid)], timeout=180)


def test_global_mesh_two_process_labels_bitwise(tmp_path):
    port = _free_port()
    outs = [tmp_path / f"p{pid}.npz" for pid in (0, 1)]
    _run_pair(_GLOBAL_MESH, lambda pid: [f"localhost:{port}", str(pid),
                                         str(outs[pid])])
    for impl in ("threefry", "cuda"):
        want = label_batch(impl)
        for out in outs:
            with np.load(out) as z:
                for name, w in zip(("cp", "n", "done"), want):
                    np.testing.assert_array_equal(z[f"{impl}_{name}"], w)
