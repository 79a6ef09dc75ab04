"""Quickest proof that the PyTorch/CUDA port runs its main path on one GPU.

Run with no arguments from the repository root on a machine with an
NVIDIA H100 (sm_90a) and nvcc:

    python3 chip_smoke.py

Phases (each prints its result and seconds on its own line; any failure
raises, and the script then exits non-zero without printing a result):

1. the card's name and power limit (nvidia-smi); build the kernels from
   this checkout, one nvcc per library, started together: the fused Monte
   Carlo kernel (collide2d_tpu_torch/csrc/mc_kernel.cu), the SAT kernels
   (csrc/sat_kernel.cu), the k-gon SAT kernel (csrc/polygon_kernel.cu),
   the fused k-gon Monte Carlo kernel (csrc/mc_polygon_kernel.cu, one
   library per shape: k = 8 and the gate's k = 6, 4-gon robot, 2 kept
   axes), the query kernels (csrc/distance_kernel.cu, csrc/manifold_kernel.cu,
   csrc/toi_kernel.cu), the trajectory kernels (csrc/mc_toi_kernel.cu,
   csrc/mc_moving_polygon_kernel.cu at k = 8, csrc/screen_kernel.cu), the
   scene raycast kernel (csrc/raycast_kernel.cu) and the streaming-bandwidth
   probe (csrc/stream_kernel.cu);
2. the kernel against its plain PyTorch version on the card, same Philox
   stream, C = 100,000 annulus configurations x n = 4096 samples, shape
   noise off and on, and the adaptive tail's 256 rows x 100,000 samples:
   sum |dcount| <= 1e-5 * C * n; samples/s of both, timed with CUDA
   events after a warm-up; the counts' fingerprint (as in phase 10) and
   the kernel's issue floor (below) beside its bound;
3. the main path: ``collide2d-torch generate --device cuda -n 2
   -b 100000 --seed 7`` at the default 64^4-row tables, 4e6 cap and
   reference bins, in process; two (100000, 5) float32 files with finite
   cp in [0, 1], kernel launches > 0, zero-probability share in
   [0.5, 0.7]; configs/s and mean samples per configuration;
4. the acceptance bar: ``ztest --cps_only true`` with another seed on the
   first 32,768 rows of batch 0, then ``compare`` (its exit code printed):
   mean |d| <= 1e-3 and a share within +-0.005 of at least 0.93; beside
   them the binomial prediction of both (`_expected_agreement` on each
   row's sample counts, recovered from the labels by the stopping rule:
   `mc.schedule_sim.stopping_counts`), and the phase fails when the share
   lies more than 4 sd below it or the mean |d| more than 4 sd above it (a
   bias, not noise); whether 0.95 held, and whether the prediction meets
   it;
5. stream invariance: ``generate -n 2 -b 16384`` with
   ``--overlap_batches 1`` and ``3`` at one seed give bitwise-equal files;
6. the SAT kernels at N = 2^23 pairs (the JAX bench's size), inputs drawn
   on the card by a seeded torch.Generator as in `example_configs`: the
   main path ``CollisionProbabilityModel.collide`` (vertex f32 and bf16,
   obb) and the count entry points launch every kernel; then each kernel
   against its plain version on the same packed tensors: 0 labels differ,
   counts exact, collision share in (0, 1); kernel ms (CUDA events, 20
   launches after a warm-up), plain ms (1 run), pairs/s and GB/s;
7. ``relabel --device cuda`` with another seed on phase 3's two batches:
   order and shapes kept, mean |d| <= 1e-3 and a share within +-0.005 of
   at least 0.93 against phase 3's labels; configs/s;
8. ``generate -n 1 -b 100000 --seed 7`` with ``--prune_sigma 6`` against
   the same call without it: rows `possible_collision_mask` keeps are
   bitwise equal, pruned rows have cp = 0; then ``--schedule opt``: files
   as in phase 3; checkpoints, mean samples per configuration, configs/s;
9. the k-gon SAT kernel: `PolygonCollisionProbabilityModel.collide` and
   `CollisionProbabilityModel.collide_polygons` on 2^20 configurations of
   the polylabel workload (plain, bf16, ``broad_phase=True`` and
   ``'prune'``, which must equal the plain call) launch it and equal the
   torch path; then the kernel against its plain version on the same
   packed tensors at 2^23 pairs (k = 8 f32 and bf16, k1 = 4 against k2 = 6,
   and the model's k1 = 4 against k2 = 8): 0 labels differ, collision share
   in (0, 1); kernel ms (CUDA events, 20 launches after a warm-up), plain
   ms, pairs/s and GB/s;
10. the fused k-gon Monte Carlo kernel against its plain version, same
   Philox stream, on C = 100,000 rows of the polylabel workload (k = 8, the
   4.07 x 1.74 robot as a 4-gon, 2 kept axes) x n = 4096 samples and the
   tail's 256 rows x 100,000: sum |dcount| <= 1e-5 * C * n; samples/s of
   both; the counts' fingerprint (their sum and the sum of counts[c] *
   (c % 9973): equal fingerprints say the bits held across versions) and
   the kernel's issue floor (below); then the agreement gate against the
   threefry path on the card
   (4,096 `example_polygon_configs` rows at k = 6, 65,536 samples each):
   max z < 6 and a share with z > 3 of at most 3 x 0.27%;
11. ``polylabel --device cuda`` on the 100,000-row k = 8 workload (an .npz
   written as polylabel reads it): finite cp in [0, 1], samples within the
   cap, kernel launches > 0; configs/s, mean samples per configuration,
   converged share; the same call again under torch.profiler, which must
   write the same labels (kernel launches per round, device busy share);
   ``polylabel`` with another seed on the first 16,384 rows: mean |d| <=
   1e-3 and a share within +-0.005 of at least 0.93; ``--prune_sigma 6``
   on those rows: rows that `possible_collision_mask` keeps are bitwise the
   first run's, pruned rows have cp = 0;
12. signed distance: ``CollisionProbabilityModel.distance(impl='auto')`` on
   2^23 rectangle rows (drawn as in phase 6) launches kernel 8 and
   ``PolygonCollisionProbabilityModel.distance`` on 2^20 polylabel rows
   kernel 9; ``distance <= 0`` differs from kernel 4's / kernel 6's labels
   on 0 rows, values within 2e-5 of ``impl='torch'`` on 2^16 rows; then
   kernel 8 at 2^23 box pairs and kernel 9 at 2^22 pairs of the JAX bench's
   k-gons (k = 8, and the model's 4 against 8) against their plain
   versions: max abs diff <= 2e-5, 0 signs differ; kernel ms (CUDA events,
   20 launches after a warm-up), plain ms, pairs/s and GB/s;
13. contact manifold: both models' ``contact_manifold`` on 2^20 polylabel
   and 2^20 rectangle rows launch kernel 10; against ``impl='torch'`` on
   2^16 rows and the kernel against its plain version at 2^22 pairs (k = 8,
   margin 0 and 0.1): counts differ on at most 1e-5 of pairs, points,
   depths and normal within 2e-5 where they agree; kernel ms, plain ms,
   pairs/s (phases 12-14 also time each model call whole, 5 calls after a
   warm-up);
14. time of impact: ``CollisionProbabilityModel.time_of_impact(impl=
   'auto')`` on 2^21 rows (unit speed toward the obstacle, omega U(-1, 1),
   every 4th row 0) launches kernel 12 (against ``impl='torch'`` on 2^16
   rows: hits differ on at most 1e-3, |dt| <= 1e-3, as the polygon-distance
   loop may stop a step of ~tol/bound apart); then the kernel against its
   plain version at the JAX bench's 2^21 pairs (t_max 8, 64 iterations,
   tol 1e-4): hits differ on at most 1e-4 of pairs, t within 1e-5 where
   both hit; the rotating share, mean, maximum and warp-maximum
   advancement steps (the plain version counts them), kernel ms, plain ms,
   queries/s;
15. kernel 13 (fused trajectory Monte Carlo, rectangles) against its plain
   version on the same Philox stream: 100,000 translation-only rows of the
   JAX bench's trajectory workload (utils/benchmarks.py:527-540, seed 5,
   shape noise on) x 4,096 samples, and 8,192 rotating rows x 2,048 with 48
   advancement steps and tol 1e-4: sum |dcount| <= 1e-5 of the samples;
   samples/s, mean and warp-maximum advancement steps (from the plain
   version), the counts' fingerprint, and the translation run's issue
   floor beside its bound; then the agreement gate against the threefry
   window path (4,096 rows x 65,536 samples: max z < 6, share with z > 3
   <= 3 x 0.27%);
16. ``movelabel --device cuda`` on the 100,000 translation-only rows at the
   4e6 cap and reference bins: finite cp in [0, 1], samples within the cap,
   kernel-13 launches > 0 and kernel-15 launches 0; configs/s, mean
   samples, converged share; the same call under torch.profiler (the same
   labels; device busy share, kernel 13's share of it); another seed on
   the first 16,384 rows: mean |d| <= 1e-3 and a share within +-0.005 of
   at least 0.93, or, where the rows' binomial noise alone predicts a
   share below 0.93, both within 4 standard deviations of that prediction
   (`_relabel_bar`); ``--prune_sigma 6`` on them (kept rows bitwise, pruned
   rows cp = 0); then 8,192 rotating rows under 'auto' (the threefry
   screened cascade, stage A on kernel 15; launches > 0), the same run
   through the API with ``screen_impl='torch'`` (counts within 1e-5 of the
   samples), and ``--impl cuda`` (kernel 13's advancement loop), each at a
   10,000-sample cap (the cascade is host-bound); configs/s of each;
17. kernel 14 (translation-only k-gon trajectories) against its plain
   version on 100,000 `example_polygon_configs` k = 8 rows with velocity
   U(-2, 2)^2 and t_max U(0.5, 3) x 4,096 samples (2 kept robot axes):
   sum |dcount| <= 1e-5 of the samples; the fingerprint and issue floor
   as in phase 10; at zero velocity its counts equal kernel 7's bit for
   bit; the agreement gate as in phase 15;
   `PolygonCollisionProbabilityModel.label` and ``movelabel`` on the
   100,000 rows (kernel-14 launches > 0, the same labels, the checks of
   phase 16); ``movelabel`` on 4,096 rotating k = 6 rows of the JAX bench
   (utils/benchmarks.py:646-677; the threefry cascade, cap 4,000): finite
   cp in [0, 1], configs/s;
18. kernel 15 (stage A of the rotating cascade) against its plain version
   at the JAX bench's step, 8,192 rotating rows x 512 lanes: flags differ
   on at most 1e-5 of lanes, t0 equal where they agree; kernel ms, plain
   ms, lanes/s; then one threefry step of the cascade at that shape, whole
   (kernel 15 or the torch screen) and its draws alone (host clock).
19. kernel 11 (scene raycast): ``scene_raycast(impl='auto')`` on the JAX
   bench's scene (utils/benchmarks.py:1963-1976: 2^22 rays, origins
   U(-50, 50)^2, directions standard normal, 64 regular 8-gons in a 40-side
   box) and on a single ray launches it; then the kernel against its plain
   version at t_max inf and 4, on 4,096 shapes (past one shared-memory
   tile) x 2^16 rays with the default tile and a 61-shape tile (equal), and
   on 1,000 masked mixed-k shapes: t, index or normal differ on at most
   1e-5 of the rays (bitwise expected); kernel ms, plain ms, rays/s, the
   bound, the kernel's share of it, and the bound with the division at its
   SASS count and by the Pallas estimate;
20. the dense scene queries at `bench_scene`'s shape (N = 2,048 8-gons in a
   40-side box, row tile 64): kernel-6 and kernel-10 launches > 0; the
   matrix equals `ops.sat.sat_polygons` on the same card tensors bit for
   bit, symmetric with a false diagonal; the pairs (capacity 16,384) equal
   the matrix's upper triangle; the manifolds against kernel 10's plain
   version and `ops.manifold` (`_scene_manifold_check`); ms of each call,
   the matrix's pairs/s (N^2 / time) and kernel 6's share of it;
21. the swept query at `bench_scene_swept`'s shape (N = 32,768, window
   128, capacity 16,384, area side 2,560): the certificate false, the
   pairs equal the dense query's, the swept manifolds as in phase 20, a
   window of 4 fails closed (count 0, zero pairs, the flag raised);
   dense-equivalent (N^2 / time) and narrow (N * window / time) pairs/s;
22. the bench entry points, in process: the headline of
   ``python -m collide2d_tpu_torch.bench`` (kernel 16, the
   streaming-bandwidth probe, and torch's reduction, then kernel 3 at 2^23
   pairs x 100 calls: ``bandwidth_check`` ok), then every leg of
   ``run_all(device="cuda")`` (``collide2d-torch bench``): finite positive
   values, the swept query's certificate false; kernels 1, 3, 6, 7, 10, 11
   and 16 launched. Then kernel 16 against its plain version on the
   probe's 2^23 pairs: within 1e-5 x (sum|r1| * s + sum|r2|), and two
   launches bitwise equal; kernel ms, plain ms and the library call's ms
   (``r1.sum() * s + r2.sum()``), GB/s and the share of 3.35 TB/s.

The second-to-last lines are the card (name, power limit) and one JSON
object describing each kernel of the path, with ``bound_ms``: the larger
of the bytes the function must move over 3.35 TB/s and the FP32
operations its source writes for these inputs over 67 TFLOP/s (an FMA
counts 2; the library calls ``log1pf``, ``sqrtf``, ``sincosf`` and the
integer Philox rounds are not counted, so the Monte Carlo bounds are
floors; the query kernels, kernel 11 among them (`raycast_ops`, 32 bytes
a ray), count an IEEE ``sqrtf`` or division as one operation and leave
out ``sincosf``; phase 19 also prints kernel 11's bound with its division
at the 7 instructions of its SASS fast path; kernel 12's and 13's work
depends on the data, so their bounds count the distance evaluations this
run's lanes take; kernel 15's is the larger of 28 bytes a lane and its
counted operations). The fused Monte Carlo kernels 1, 7, 13 and 14 also
carry ``issue_floor_ms``: the fewest SASS instructions one iteration of
their sample loop can issue (`_shortest_iteration` on ``cuobjdump -sass``
of the built library; kernel 13's window loop), over the samples an
iteration evaluates, times the samples, over 132 SMs x 128 lanes x the SM
clock's maximum (nvidia-smi). ``bound_ms`` keeps its convention,
comparable across kernels; it leaves out the stream's integer and library
work, and kernels 7, 13 and 14 must not contract a multiply and an add, so
they cannot come near it, while the issue floor counts what the card must
issue. No single PyTorch call computes any of these functions but kernel
16's (a sum of each stream), so ``library_ms`` is null for the others.
The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
C_CHECK, N_CHECK = 100_000, 4096
TAIL_ROWS, TAIL_SAMPLES = 256, 100_000
MISMATCH_BOUND = 1e-5
SAT_PAIRS = 1 << 23
# Bytes each kernel moves per pair (in + out): 8 f32 coordinates of each
# rectangle (bf16: half) or 6 f32 rows of each box, plus a 4-byte label.
SAT_BYTES = {"sat_label": 68, "sat_label_bf16": 36, "sat_count": 64,
             "sat_count_bf16": 32, "obb_label": 52, "obb_count": 48}
# FP32 operations per pair written in csrc/sat_kernel.cu: 8 shift adds,
# 4 axes x (2 subs, 8 projections of 3, 12 min/max, 2 compares); the box
# test's 4 shift adds and differences, cd/sd 6, 4 projections of 3, 4
# reaches of 4 and 4 compares.
SAT_OPS = {"sat_label": 168, "sat_count": 168, "obb_label": 42, "obb_count": 42}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_FP32_PER_S = 67e12  # H100 SXM FP32 outside the tensor cores, FMA = 2
# FP32 operations of one normal in the Monte Carlo kernels: (b + 0.5) *
# 2^-22 - 1 (3), erf_inv's x * -x, w < 5, w - 2.5 or sqrt(w) - 3, 8 Horner
# steps and p * x (20), * sqrt(2) (1).
NORMAL_OPS = 24
POLY_K, POLY_ROBOT = 8, ((-2.035, -0.87), (2.035, -0.87), (2.035, 0.87),
                         (-2.035, 0.87))
POLY_ROWS = 100_000
POLY_HEAD = 16_384


def _bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the byte and the
    operation bound, and which one it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mc_ops_per_sample(shape_noise: bool) -> int:
    """csrc/mc_kernel.cu: 3 (5) normals, the box test's 38 operations (dx,
    dy, delta, the offset, u, v, four tests), 4 more for noisy extents."""
    return (5 if shape_noise else 3) * NORMAL_OPS + 38 + (4 if shape_noise else 0)


def mc_poly_ops_per_sample(k: int, k2: int, k2a: int) -> int:
    """csrc/mc_polygon_kernel.cu: 3 normals, dx/dy/dtheta and (u1, u2) (9),
    each kept robot axis 5K + 5 (translation 3, K blends of 3, min/max,
    2 adds, 2 compares), each obstacle normal 5 K2 + 5."""
    return 3 * NORMAL_OPS + 9 + k2a * (5 * k + 5) + k * (5 * k2 + 5)


def sat_poly_ops_per_pair(k1: int, k2: int) -> int:
    """csrc/polygon_kernel.cu: (k1 + k2) axes x (2 for the axis, k1 + k2
    projections of 3, 2 (k1 + k2 - 2) min/max, 2 compares) = 5 (k1 + k2)^2."""
    return 5 * (k1 + k2) ** 2


def _line(phase: str, seconds: float, **fields) -> None:
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{phase}] {body} seconds={seconds:.3f}", flush=True)


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def _quiet(fn, *args):
    """Run ``fn(*args)`` with its progress lines captured (returned)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args)
    return result, buf.getvalue()


def _events_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build():
    from collide2d_tpu_torch.ops.mc_polygon_cuda import shape_defines
    from collide2d_tpu_torch.utils import cuda_build

    t = time.monotonic()
    # kernels 7 and 14 build once per shape: phases 10, 11 and 17 launch
    # them at k = 8 against the 4-gon robot's 2 kept axes, phase 10's
    # agreement gate kernel 7 at k = 6
    jobs = [(name, ()) for name in (
        "mc_kernel", "sat_kernel", "polygon_kernel", "distance_kernel",
        "manifold_kernel", "toi_kernel", "mc_toi_kernel", "screen_kernel",
        "raycast_kernel", "stream_kernel")] + [
        ("mc_polygon_kernel", shape_defines(POLY_K, 4, 2)),
        ("mc_polygon_kernel", shape_defines(6, 4, 2)),
        ("mc_moving_polygon_kernel", shape_defines(POLY_K, 4, 2))]
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = list(pool.map(lambda job: cuda_build.build(*job), jobs))
    for job in jobs:
        cuda_build.load(*job)
    _line("1 build", time.monotonic() - t,
          kernels=",".join(f"{name}.cu" + "".join(f":{v}" for _, v in defs)
                           for name, defs in jobs),
          libraries=",".join(lib.name for lib in libs))


def _rect_mc_params(c: int, shape_noise: bool) -> torch.Tensor:
    """Phase 2's kernel-1 rows on the card: ``c`` annulus configurations of
    the reference tables (65,536 poses and variances, with shape variance
    when ``shape_noise``), seed 11."""
    from collide2d_tpu_torch.data.pipeline import GenerateConfig, _sample_tables
    from collide2d_tpu_torch.mc import prng
    from collide2d_tpu_torch.mc.estimator import Configs
    from collide2d_tpu_torch.mc.noise import sample_configuration_batch
    from collide2d_tpu_torch.ops import mc_cuda

    dev = torch.device("cuda")
    poses, variances = _sample_tables(GenerateConfig(
        num_poses=65_536, num_variances=65_536, shape_variance=shape_noise))
    cfg = GenerateConfig()
    pos, _, _, pose, sd = sample_configuration_batch(
        prng.PRNGKey(11), torch.as_tensor(poses, device=dev),
        torch.as_tensor(np.sqrt(variances), device=dev),
        num_configs=c, r_offset=cfg.r_offset, spread=cfg.spread)
    return mc_cuda.pack_mc_params(Configs(pos, pose[:, 2], pose[:, :2], sd), cfg.robot_wh)


# (name, rows, samples, shape noise) of kernel 1's checks: the reference
# default and shape noise at full batch width, then the adaptive tail's
# shape (min_active rows, later_batch samples a round).
MC_CASES = (("default", C_CHECK, N_CHECK, False),
            ("shape_noise", C_CHECK, N_CHECK, True),
            ("tail", TAIL_ROWS, TAIL_SAMPLES, False))


def mc_kernel_instance(shape_noise: bool) -> str:
    """Kernel 1's instantiation at these inputs in the SASS: <shape noise,
    wide indices = false> (csrc/mc_kernel.cu)."""
    return f"mc_counts_kernelILb{int(shape_noise)}ELb0E"


def phase_kernel_vs_plain() -> dict:
    from collide2d_tpu_torch.mc import prng
    from collide2d_tpu_torch.ops import mc_cuda

    dev = torch.device("cuda")
    result = {}
    for key, c, n, shape_noise in MC_CASES:
        t = time.monotonic()
        params = _rect_mc_params(c, shape_noise)
        uids = torch.arange(c, dtype=torch.int32, device=dev)
        seed = mc_cuda.round_seed(prng.PRNGKey(12), 3)
        got = mc_cuda.mc_counts(params, uids, seed, n, shape_noise=shape_noise)
        want = mc_cuda.mc_counts_plain(params, uids, seed, n,
                                       shape_noise=shape_noise, max_elems=1 << 24)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        total = int(diff.sum())
        if total > MISMATCH_BOUND * c * n:
            raise RuntimeError(
                f"kernel disagrees with its plain version: sum|dcount|={total} "
                f"> {MISMATCH_BOUND} * C * n ({key})")
        if not (0 < int(got.sum()) < c * n):
            raise RuntimeError("degenerate counts: all hits or none")
        kernel_ms = _events_ms(lambda: mc_cuda.mc_counts(
            params, uids, seed, n, shape_noise=shape_noise), reps=20)
        plain_ms = _events_ms(lambda: mc_cuda.mc_counts_plain(
            params, uids, seed, n, shape_noise=shape_noise,
            max_elems=1 << 24), reps=1)
        # 64 bytes of parameters and a 4-byte uid in, a 4-byte count out
        bound, bound_by = _bound_ms(c * 72, c * n * mc_ops_per_sample(shape_noise))
        floor = issue_floor("mc_kernel", (), mc_kernel_instance(shape_noise),
                            "mc_batch_samples", c * n)
        counts_sum, counts_fp = _fingerprint(got)
        result[key] = dict(sum_abs_diff=total, max_abs_err=int(diff.max()),
                           rows_differ=int((diff > 0).sum()),
                           kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound,
                           bound_by=bound_by, issue_floor_ms=floor["issue_floor_ms"])
        _line("2 kernel-vs-plain", time.monotonic() - t, case=key,
              shape_noise=shape_noise, C=c, n=n, sum_abs_dcount=total,
              rows_differ=result[key]["rows_differ"], counts_sum=counts_sum,
              counts_fingerprint=counts_fp, kernel_ms=f"{kernel_ms:.4f}",
              plain_ms=f"{plain_ms:.2f}", bound_ms=f"{bound:.4f}", bound_by=bound_by,
              **{k: (f"{v:.4f}" if isinstance(v, float) else v) for k, v in floor.items()},
              kernel_samples_per_s=f"{c * n / kernel_ms * 1e3:.4e}",
              plain_samples_per_s=f"{c * n / plain_ms * 1e3:.4e}")
    return result


def _generate(argv):
    from collide2d_tpu_torch import cli
    from collide2d_tpu_torch.data.pipeline import generate_dataset

    return generate_dataset(cli.generate_config(cli.parse_args(["generate", *argv])))


def _check_batch(path: Path, rows_expected: int = 100_000) -> np.ndarray:
    """A written batch: (rows, 5) float32, finite, cp in [0, 1]."""
    rows = np.load(path)
    if rows.shape != (rows_expected, 5) or rows.dtype != np.float32:
        raise RuntimeError(f"{path.name}: shape {rows.shape} dtype {rows.dtype}")
    cp = rows[:, 2]
    if not (np.isfinite(rows).all() and (cp >= 0).all() and (cp <= 1).all()):
        raise RuntimeError(f"{path.name}: cp not finite in [0, 1]")
    return rows


def phase_main_path(work: Path) -> int:
    from collide2d_tpu_torch.ops import mc_cuda

    t = time.monotonic()
    data = work / "main"
    mc_cuda.reset_launches()
    stats, _ = _quiet(_generate, ["--device", "cuda", "-n", "2", "-b", "100000",
                                  "--seed", "7", "--data_dir", str(data)])
    torch.cuda.synchronize()
    launches = mc_cuda.LAUNCHES
    if launches <= 0:
        raise RuntimeError("the main path never launched the kernel")
    zero = []
    for i in range(2):
        rows = _check_batch(data / f"{i}.npy")
        zero.append(float((rows[:, 2] == 0).mean()))
    zero_share = float(np.mean(zero))
    if not 0.5 <= zero_share <= 0.7:
        raise RuntimeError(f"zero-probability share {zero_share:.4f} not in [0.5, 0.7]")
    _line("3 generate", time.monotonic() - t, batches=2, batch_size=100_000,
          tables="64^4", setup_s=f"{stats.setup_seconds:.2f}",
          label_s=f"{stats.label_seconds:.3f}",
          configs_per_s=f"{stats.rows / stats.label_seconds:.1f}",
          mean_samples_per_config=f"{stats.samples_used / stats.rows:.1f}",
          slot_efficiency=f"{stats.samples_used / stats.slots_dispatched:.4f}",
          zero_share=f"{zero_share:.4f}", kernel_launches=launches)
    return launches


ACCEPT_ROWS = 32_768


def phase_acceptance(work: Path) -> dict:
    """Phase 4: ``ztest`` with another seed on the first rows of batch 0,
    ``compare``, and the binomial prediction of the agreement."""
    from collide2d_tpu_torch import cli
    from collide2d_tpu_torch.data.validate import compare_labels
    from collide2d_tpu_torch.mc.estimator import AdaptiveConfig
    from collide2d_tpu_torch.mc.schedule_sim import stopping_counts

    t = time.monotonic()
    data = work / "main"
    rows = np.load(data / "0.npy")[:ACCEPT_ROWS]
    head, inp, out = (work / f"ztest_{x}.npy" for x in ("head", "in", "cps"))
    np.save(head, rows)
    np.save(inp, rows[:, [0, 1, 3, 4]].astype(np.float32))
    rc, _ = _quiet(cli.main, [
        "ztest", "--device", "cuda", "--data_dir", str(data),
        "--data_file_in", str(inp), "--data_file_out", str(out),
        "--cps_only", "true", "--seed", "8"])
    if rc != 0:
        raise RuntimeError(f"ztest exited {rc}")
    other = np.load(out)
    report = compare_labels(rows, other)
    share, mean_d = report.frac_within_tolerance, report.mean_abs_diff
    # Neither file keeps per-row counts: derive them from the stopping rule
    # on generate's cadence (1,000 a round to 20,000, then 100,000) and
    # ztest's fixed 10,000, both rounded up to the kernel's 64-sample granule.
    bins = dict(accuracy_bins=tuple(np.load(data / "meta" / "accuracy_bins.npy").tolist()),
                bin_accuracy=tuple(np.load(data / "meta" / "bin_accuracy.npy").tolist()))
    n_gen = stopping_counts(rows[:, 2], AdaptiveConfig(**bins))
    n_zt = stopping_counts(other, AdaptiveConfig(**bins, fixed_batch=10_000))
    exp = _expected_agreement(rows[:, 2], n_gen, other, n_zt)
    rc, _ = _quiet(cli.main, ["compare", str(head), str(out)])
    fields = dict(
        rows=ACCEPT_ROWS, mean_abs_d=f"{mean_d:.3e}",
        predicted_mean_abs_d=f"{exp['mean_d']:.3e}+-{exp['mean_d_sd']:.1e}",
        share_within_tol=f"{share:.4f}",
        predicted_share=f"{exp['share']:.4f}+-{exp['share_sd']:.4f}",
        share_sd_from_prediction=f"{(share - exp['share']) / exp['share_sd']:.2f}",
        share_cp_in_0p1_0p9=f"{exp['mid']:.4f}",
        mean_samples_generate=f"{n_gen.mean():.0f}", mean_samples_ztest=f"{n_zt.mean():.0f}",
        counts="stopping_rule", tol=report.tolerance, compare_exit=rc,
        bar_0p95_held=share >= 0.95, prediction_meets_0p95=exp["share"] >= 0.95)
    if mean_d > 1e-3 or share < 0.93:
        raise RuntimeError(f"acceptance bar missed: {report} {fields}")
    if (share < exp["share"] - 4 * exp["share_sd"]
            or mean_d > exp["mean_d"] + 4 * exp["mean_d_sd"]):
        raise RuntimeError(f"a bias beyond 4 sd of the binomial prediction: {fields}")
    _line("4 ztest+compare", time.monotonic() - t, **fields)
    return fields


def phase_invariance(work: Path) -> None:
    t = time.monotonic()
    dirs = []
    for overlap in (1, 3):
        d = work / f"overlap{overlap}"
        _quiet(_generate, ["--device", "cuda", "-n", "2", "-b", "16384",
                           "--num_poses", "4096", "--num_variances", "4096",
                           "--seed", "3", "--overlap_batches", str(overlap),
                           "--data_dir", str(d)])
        dirs.append(d)
    for i in range(2):
        if (dirs[0] / f"{i}.npy").read_bytes() != (dirs[1] / f"{i}.npy").read_bytes():
            raise RuntimeError(f"batch {i} differs between --overlap_batches 1 and 3")
    _line("5 invariance", time.monotonic() - t, batches=2, batch_size=16_384,
          bitwise_equal=True)


def phase_sat() -> dict:
    """Phase 6: returns per-kernel launches, errors and times."""
    from collide2d_tpu_torch.models.collision_model import CollisionProbabilityModel
    from collide2d_tpu_torch.ops import sat_cuda
    from collide2d_tpu_torch.ops.geometry import rects_from_params

    t = time.monotonic()
    dev = torch.device("cuda")
    n = SAT_PAIRS
    g = torch.Generator(device=dev).manual_seed(6)
    pos = torch.rand((n, 2), generator=g, device=dev) * 12.0 - 6.0
    theta = torch.rand((n,), generator=g, device=dev) * (2.0 * math.pi)
    wh = torch.rand((n, 2), generator=g, device=dev) * 4.9 + 0.1
    model = CollisionProbabilityModel()
    ext = model._robot_ext(pos)
    zeros, zeros_t = torch.zeros_like(pos), torch.zeros_like(theta)
    packs = {
        "f32": (sat_cuda.pack_rects(rects_from_params(pos, ext, theta)),
                sat_cuda.pack_rects(rects_from_params(zeros, wh, zeros_t))),
        "obb": (sat_cuda.pack_obbs(pos, ext, theta), sat_cuda.pack_obbs(zeros, wh, zeros_t)),
    }
    packs["bf16"] = tuple(p.to(torch.bfloat16) for p in packs["f32"])

    # The main path: the model's labels, and the count kernels' entry points
    # (the throughput legs call them on packed pairs).
    sat_cuda.reset_launches()
    labels = {
        "f32": model.collide(pos, theta, wh),
        "bf16": model.collide(pos, theta, wh, precision="bf16"),
        "obb": model.collide(pos, theta, wh, method="obb"),
    }
    counts = {"f32": sat_cuda.sat_count_cuda_t(*packs["f32"]),
              "bf16": sat_cuda.sat_count_cuda_t(*packs["bf16"]),
              "obb": sat_cuda.obb_count_cuda_t(*packs["obb"])}
    torch.cuda.synchronize()
    launches = dict(sat_cuda.LAUNCHES)
    if min(launches.values()) <= 0:
        raise RuntimeError(f"a SAT kernel was never launched: {launches}")

    result = {name: {"launches": launches[name], "max_abs_err": 0.0}
              for name in launches}
    for key in ("f32", "bf16", "obb"):
        a, b = packs[key]
        label_fn, count_fn, plain_fn, label_name, count_name = (
            (sat_cuda.obb_collide_cuda_t, sat_cuda.obb_count_cuda_t,
             sat_cuda.obb_collide_plain, "obb_label", "obb_count") if key == "obb"
            else (sat_cuda.sat_rects_cuda_t, sat_cuda.sat_count_cuda_t,
                  sat_cuda.sat_collide_plain, "sat_label", "sat_count"))
        got = label_fn(a, b)
        want = plain_fn(a, b).reshape(-1).to(torch.float32)
        differ = int((got != want).sum())
        share = float(want.mean())
        if differ or not torch.equal(labels[key], got.to(torch.int32)):
            raise RuntimeError(f"{label_name} ({key}): {differ} labels differ "
                               "from the plain version")
        if not 0.0 < share < 1.0:
            raise RuntimeError(f"degenerate collision share {share} ({key})")
        plain_count = int(want.sum())
        count_err = abs(int(counts[key]) - plain_count)
        if count_err:
            raise RuntimeError(f"{count_name} ({key}): {int(counts[key])} != "
                               f"plain sum {plain_count}")
        for name, fn, plain, exact in (
                (label_name, lambda: label_fn(a, b), lambda: plain_fn(a, b),
                 float((got - want).abs().max())),
                (count_name, lambda: count_fn(a, b),
                 lambda: plain_fn(a, b).sum(), float(count_err))):
            kernel_ms = _events_ms(fn, reps=20)
            plain_ms = _events_ms(plain, reps=1)
            tag = name + ("_bf16" if key == "bf16" else "")
            gbps = SAT_BYTES[tag] * n / (kernel_ms * 1e-3) / 1e9
            _line("6 sat", time.monotonic() - t, kernel=tag, pairs=n,
                  labels_differ=differ, count=int(counts[key]),
                  collision_share=f"{share:.4f}",
                  kernel_ms=f"{kernel_ms:.4f}", plain_ms=f"{plain_ms:.3f}",
                  kernel_pairs_per_s=f"{n / kernel_ms * 1e3:.4e}",
                  plain_pairs_per_s=f"{n / plain_ms * 1e3:.4e}",
                  bytes_per_pair=SAT_BYTES[tag], kernel_gb_per_s=f"{gbps:.1f}")
            entry = result[name]
            entry["max_abs_err"] = max(entry["max_abs_err"], exact)
            if key != "bf16":  # the f32 (and obb) timings are the reported ones
                entry.update(ms=kernel_ms, plain_ms=plain_ms)
    return result


def _relabel(argv):
    from collide2d_tpu_torch import cli
    from collide2d_tpu_torch.data.pipeline import relabel_dataset

    return relabel_dataset(cli.relabel_config(cli.parse_args(["relabel", *argv])))


def phase_relabel(work: Path) -> None:
    from collide2d_tpu_torch.data.validate import compare_labels

    t = time.monotonic()
    main, inp, out = work / "main", work / "relabel_in", work / "relabel_out"
    inp.mkdir()
    (out / "meta").mkdir(parents=True)
    for name in ("poses.npy", "variances.npy", "meta/accuracy_bins.npy",
                 "meta/bin_accuracy.npy"):
        os.symlink(main / name, out / name)
    for i in range(2):
        rows = np.load(main / f"{i}.npy")
        np.save(inp / f"{i}.npy", rows[:, [0, 1, 3, 4]].astype(np.float32))
    stats, _ = _quiet(_relabel, [
        "--device", "cuda", "--data_in", str(inp), "--data_out", str(out),
        "--seed", "8", "--shuffle", "false"])
    reports = []
    for i in range(2):
        new = _check_batch(out / f"{i}.npy")
        old = np.load(main / f"{i}.npy")
        if not np.array_equal(new[:, [0, 1, 3, 4]], old[:, [0, 1, 3, 4]]):
            raise RuntimeError(f"relabel batch {i}: rows not in input order")
        reports.append(compare_labels(old, new))
    mean_d = float(np.mean([r.mean_abs_diff for r in reports]))
    share = float(np.mean([r.frac_within_tolerance for r in reports]))
    if mean_d > 1e-3 or share < 0.93:
        raise RuntimeError(f"relabel misses the acceptance bar: {reports}")
    _line("7 relabel", time.monotonic() - t, batches=2, batch_size=100_000,
          label_s=f"{stats.label_seconds:.3f}",
          configs_per_s=f"{stats.rows / stats.label_seconds:.1f}",
          mean_samples_per_config=f"{stats.samples_used / stats.rows:.1f}",
          mean_abs_d=f"{mean_d:.3e}", share_within_tol=f"{share:.4f}")


def phase_prune_opt(work: Path) -> None:
    from collide2d_tpu_torch.mc.estimator import Configs
    from collide2d_tpu_torch.ops.broad_phase import possible_collision_mask

    t = time.monotonic()
    main = work / "main"
    tables = ["--pose_dir", str(main / "poses.npy"),
              "--variance_dir", str(main / "variances.npy")]
    base = ["--device", "cuda", "-n", "1", "-b", "100000", "--seed", "7", *tables]
    runs = {}
    for name, extra in (("full", []), ("pruned", ["--prune_sigma", "6"])):
        stats, _ = _quiet(_generate, [*base, *extra, "--data_dir", str(work / name)])
        runs[name] = (stats, _check_batch(work / name / "0.npy"))
    full, pruned = runs["full"][1], runs["pruned"][1]
    if not np.array_equal(full[:, [0, 1, 3, 4]], pruned[:, [0, 1, 3, 4]]):
        raise RuntimeError("pruned and unpruned runs sampled different rows")
    poses = np.load(main / "poses.npy")[full[:, 4].astype(np.int64)]
    sds = np.sqrt(np.load(main / "variances.npy")[full[:, 3].astype(np.int64)])
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device="cuda")  # noqa: E731
    configs = Configs(f32(full[:, :2]), f32(poses[:, 2]), f32(poses[:, :2]), f32(sds))
    keep = possible_collision_mask(configs, (4.07, 1.74), 6.0).cpu().numpy()
    if not np.array_equal(pruned[keep], full[keep]):
        raise RuntimeError(f"{int((pruned[keep] != full[keep]).any(1).sum())} kept "
                           "rows differ from the unpruned run")
    if (pruned[~keep, 2] != 0).any():
        raise RuntimeError("a pruned row has cp != 0")
    rate = {k: s.rows / s.label_seconds for k, (s, _) in runs.items()}
    _line("8 prune", time.monotonic() - t, rows=100_000,
          pruned_share=f"{1.0 - keep.mean():.4f}", kept_rows_bitwise_equal=True,
          configs_per_s_unpruned=f"{rate['full']:.1f}",
          configs_per_s_pruned=f"{rate['pruned']:.1f}",
          mean_samples_unpruned=f"{runs['full'][0].samples_used / len(full):.1f}",
          mean_samples_pruned=f"{runs['pruned'][0].samples_used / len(full):.1f}")

    t = time.monotonic()
    stats, log = _quiet(_generate, [*base, "--schedule", "opt",
                                    "--data_dir", str(work / "opt")])
    rows = _check_batch(work / "opt" / "0.npy")
    zero_share = float((rows[:, 2] == 0).mean())
    if not 0.5 <= zero_share <= 0.7:
        raise RuntimeError(f"opt: zero-probability share {zero_share:.4f} not in [0.5, 0.7]")
    found = re.search(r"opt schedule: (\d+) checkpoints", log)
    if found is None:
        raise RuntimeError("opt: the schedule was not resolved")
    _line("8 opt", time.monotonic() - t, rows=100_000, checkpoints=found.group(1),
          label_s=f"{stats.label_seconds:.3f}",
          configs_per_s=f"{stats.rows / stats.label_seconds:.1f}",
          mean_samples_per_config=f"{stats.samples_used / stats.rows:.1f}",
          zero_share=f"{zero_share:.4f}")


def _polygon_workload(n: int, seed: int = 0):
    """The polylabel workload of the JAX package's `bench_e2e_polygons`
    (utils/benchmarks.py:1599-1620), drawn on the card: annulus positions
    (`sample_configuration_batch`, r_offset (4.07 + 1.74) / 4, spread 4)
    over 4,096-row pose and sigma tables (sigmas sqrt(U(0, 0.3)) for x, y
    and theta), per-row ellipse k-gons with semi-axes in [0.5, 2.5]."""
    from collide2d_tpu_torch.mc import prng
    from collide2d_tpu_torch.mc.estimator import PolygonConfigs
    from collide2d_tpu_torch.mc.noise import sample_configuration_batch

    dev = torch.device("cuda")
    k_tab, k_cfg, _, k_geo = prng.split(prng.PRNGKey(seed), 4)
    t_pose, t_sd = prng.split(k_tab, 2)
    lo = torch.tensor([0.1, 0.1, 0.0], device=dev)
    hi = torch.tensor([5.0, 5.0, 2.0 * math.pi], device=dev)
    poses = prng.uniform(t_pose, (4096, 3), device=dev) * (hi - lo) + lo
    std_devs = torch.sqrt(prng.uniform(t_sd, (4096, 5), 0.0, 0.3, dev))
    std_devs[:, 3:] = 0.0
    pos, _, _, pose, sd = sample_configuration_batch(
        prng.fold_in(k_cfg, 0), poses, std_devs, num_configs=n,
        r_offset=(4.07 + 1.74) / 4, spread=4.0)
    ka, kb = prng.split(prng.fold_in(k_geo, 0), 2)
    ang = prng.uniform(ka, (n, POLY_K), 0.0, 2.0 * math.pi, dev).sort(dim=-1).values
    ab = prng.uniform(kb, (n, 1, 2), 0.5, 2.5, dev)
    verts = torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1) * ab
    return PolygonConfigs(pos, pose[:, 2], verts.contiguous(), sd[:, :3].contiguous())


def _random_polygons(g, n: int, k: int, spread: float) -> torch.Tensor:
    """(n, k, 2) convex k-gons on the card: ellipse points at sorted angles,
    semi-axes in [0.3, 2.5], shifted by up to ``spread``."""
    dev = torch.device("cuda")
    ang = (torch.rand((n, k), generator=g, device=dev) * (2 * math.pi)).sort(-1).values
    ab = torch.rand((n, 1, 2), generator=g, device=dev) * 2.2 + 0.3
    shift = (torch.rand((n, 1, 2), generator=g, device=dev) * 2 - 1) * spread
    return torch.stack([torch.cos(ang), torch.sin(ang)], -1) * ab + shift


def phase_polygon_sat() -> dict:
    """Phase 9: returns kernel 6's launches on the model path, its largest
    error against the plain version, and its times at k = 8 f32."""
    from collide2d_tpu_torch.models.collision_model import (
        CollisionProbabilityModel,
        PolygonCollisionProbabilityModel,
    )
    from collide2d_tpu_torch.ops import polygon_cuda

    t = time.monotonic()
    configs = _polygon_workload(1 << 20, seed=9)
    model = PolygonCollisionProbabilityModel(np.asarray(POLY_ROBOT, np.float32))
    robot = model._placed_robot(configs)
    polygon_cuda.reset_launches()
    labels = {
        "plain": model.collide(configs),
        "bf16": model.collide(configs, precision="bf16"),
        "aabb": model.collide(configs, broad_phase=True),
        "prune": model.collide(configs, broad_phase="prune"),
        "collide_polygons": CollisionProbabilityModel().collide_polygons(
            robot, configs.obstacle_verts),
    }
    torch.cuda.synchronize()
    launches = polygon_cuda.LAUNCHES
    if launches < len(labels):
        raise RuntimeError(f"the model path launched the k-gon kernel {launches} "
                           f"times for {len(labels)} calls")
    want = model.collide(configs, impl="torch")
    for name in ("plain", "aabb", "prune", "collide_polygons"):
        if not torch.equal(labels[name], want):
            raise RuntimeError(f"collide ({name}): "
                               f"{int((labels[name] != want).sum())} labels differ "
                               "from the torch path")
    share = float(want.float().mean())
    if not 0.0 < share < 1.0:
        raise RuntimeError(f"degenerate collision share {share} on the model path")
    bf16_differ = int((labels["bf16"] != want).sum())
    _line("9 k-gon model", time.monotonic() - t, configs=1 << 20, k=POLY_K,
          robot_k=4, kernel_launches=launches, collision_share=f"{share:.4f}",
          bf16_labels_differ_from_f32=bf16_differ)

    result = {"launches": launches, "max_abs_err": 0.0}
    g = torch.Generator(device="cuda").manual_seed(10)
    n = SAT_PAIRS
    for tag, k1, k2, bf16 in (("k8", 8, 8, False), ("k8_bf16", 8, 8, True),
                              ("k4_k6", 4, 6, False), ("k4_k8", 4, 8, False)):
        t = time.monotonic()
        pack = polygon_cuda.pack_polygons_bf16 if bf16 else polygon_cuda.pack_polygons
        a = pack(_random_polygons(g, n, k1, 3.0))
        b = pack(_random_polygons(g, n, k2, 3.0))
        got = polygon_cuda.sat_polygons_cuda_t(a, b, k1=k1, k2=k2)
        want = polygon_cuda.sat_polygons_plain(a, b, k1, k2).reshape(-1).float()
        torch.cuda.synchronize()
        differ = int((got != want).sum())
        share = float(want.mean())
        if differ:
            raise RuntimeError(f"sat_polygons ({tag}): {differ} labels differ "
                               "from the plain version")
        if not 0.0 < share < 1.0:
            raise RuntimeError(f"degenerate collision share {share} ({tag})")
        kernel_ms = _events_ms(
            lambda: polygon_cuda.sat_polygons_cuda_t(a, b, k1=k1, k2=k2), reps=20)
        plain_ms = _events_ms(
            lambda: polygon_cuda.sat_polygons_plain(a, b, k1, k2), reps=1)
        nbytes = (2 * k1 + 2 * k2) * a.element_size() + 4
        bound, bound_by = _bound_ms(nbytes * n, sat_poly_ops_per_pair(k1, k2) * n)
        _line("9 k-gon sat", time.monotonic() - t, case=tag, k1=k1, k2=k2,
              pairs=n, labels_differ=differ, collision_share=f"{share:.4f}",
              kernel_ms=f"{kernel_ms:.4f}", plain_ms=f"{plain_ms:.3f}",
              bound_ms=f"{bound:.4f}", bound_by=bound_by,
              kernel_pairs_per_s=f"{n / kernel_ms * 1e3:.4e}",
              plain_pairs_per_s=f"{n / plain_ms * 1e3:.4e}", bytes_per_pair=nbytes,
              kernel_gb_per_s=f"{nbytes * n / (kernel_ms * 1e-3) / 1e9:.1f}")
        if tag == "k8":
            result.update(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound,
                          bound_by=bound_by)
        del a, b, got, want
    return result


def phase_mc_polygon() -> dict:
    """Phase 10: returns kernel 7's largest error and times at C = 100,000
    x n = 4096."""
    from collide2d_tpu_torch.mc import prng
    from collide2d_tpu_torch.mc.estimator import mc_round
    from collide2d_tpu_torch.models.collision_model import example_polygon_configs
    from collide2d_tpu_torch.ops import mc_cuda, mc_polygon_cuda

    dev = torch.device("cuda")
    robot = np.asarray(POLY_ROBOT, np.float32)
    a_keep = mc_polygon_cuda.dedup_robot_axes(robot)
    result = {"max_abs_err": 0}
    for key, c, n in (("workload", POLY_ROWS, N_CHECK),
                      ("tail", TAIL_ROWS, TAIL_SAMPLES)):
        t = time.monotonic()
        configs = _polygon_workload(c, seed=11)
        params = mc_polygon_cuda.pack_polygon_mc_params(configs, robot, a_keep)
        dims = dict(k=POLY_K, k2=len(robot), k2a=len(a_keep))
        uids = torch.arange(c, dtype=torch.int32, device=dev)
        seed = mc_cuda.round_seed(prng.PRNGKey(12), 3)
        got = mc_polygon_cuda.mc_poly_counts(params, uids, seed, n, **dims)
        want = mc_polygon_cuda.mc_poly_counts_plain(params, uids, seed, n,
                                                    max_elems=1 << 22, **dims)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        total = int(diff.sum())
        if total > MISMATCH_BOUND * c * n:
            raise RuntimeError(
                f"k-gon kernel disagrees with its plain version: sum|dcount|="
                f"{total} > {MISMATCH_BOUND} * C * n ({key})")
        if not 0 < int(got.sum()) < c * n:
            raise RuntimeError("degenerate k-gon counts: all hits or none")
        kernel_ms = _events_ms(lambda: mc_polygon_cuda.mc_poly_counts(
            params, uids, seed, n, **dims), reps=20)
        plain_ms = _events_ms(lambda: mc_polygon_cuda.mc_poly_counts_plain(
            params, uids, seed, n, max_elems=1 << 22, **dims), reps=1)
        bound, bound_by = _bound_ms(c * (params.shape[1] * 4 + 8),
                                    c * n * mc_poly_ops_per_sample(**dims))
        floor = issue_floor("mc_polygon_kernel", mc_polygon_cuda.shape_defines(**dims),
                            "mc_poly_counts_kernelILb0E", "mc_poly_batch_samples", c * n)
        result["max_abs_err"] = max(result["max_abs_err"], int(diff.max()))
        if key == "workload":
            result.update(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound,
                          bound_by=bound_by, issue_floor_ms=floor["issue_floor_ms"])
        counts_sum, counts_fp = _fingerprint(got)
        _line("10 k-gon mc", time.monotonic() - t, case=key, C=c, n=n,
              table_rows=params.shape[1], kept_axes=len(a_keep),
              sum_abs_dcount=total, rows_differ=int((diff > 0).sum()),
              counts_sum=counts_sum, counts_fingerprint=counts_fp,
              kernel_ms=f"{kernel_ms:.4f}", plain_ms=f"{plain_ms:.2f}",
              bound_ms=f"{bound:.4f}", bound_by=bound_by,
              **{k: (f"{v:.4f}" if isinstance(v, float) else v) for k, v in floor.items()},
              kernel_samples_per_s=f"{c * n / kernel_ms * 1e3:.4e}",
              plain_samples_per_s=f"{c * n / plain_ms * 1e3:.4e}")

    # The agreement gate of the JAX package's `bench_agreement_polygons`
    # (utils/benchmarks.py:1334-1405): the kernel against the threefry path.
    t = time.monotonic()
    c, n = 4096, 1 << 16
    configs = example_polygon_configs(c, k=6, seed=7, device=dev)
    uids = torch.arange(c, dtype=torch.int32, device=dev)
    cp = {}
    for impl in ("cuda", "threefry"):
        counts = mc_round(prng.PRNGKey(8), uids, configs, robot, 0, n_batch=n,
                          impl=impl)
        cp[impl] = counts.cpu().numpy().astype(np.float64) / n
    diff = np.abs(cp["cuda"] - cp["threefry"])
    pooled = (cp["cuda"] + cp["threefry"]) / 2.0
    var = pooled * (1.0 - pooled) * (2.0 / n)
    z = np.where(var > 0, diff / np.sqrt(np.maximum(var, 1e-300)), 0.0)
    frac3, max_z = float((z > 3.0).mean()), float(z.max())
    if not (max_z < 6.0 and frac3 <= 3 * 0.0027):
        raise RuntimeError(f"k-gon agreement gate failed: max z {max_z:.2f}, "
                           f"share z > 3 {frac3:.4f}")
    _line("10 k-gon agreement", time.monotonic() - t, configs=c, n_samples=n,
          max_z=f"{max_z:.3f}", frac_z_gt3=f"{frac3:.5f}",
          mean_abs_diff=f"{diff.mean():.3e}",
          frac_within_005=f"{(diff <= 0.005).mean():.4f}")
    return result


def _polylabel(argv) -> float:
    """``collide2d-torch polylabel`` in process; returns its seconds."""
    from collide2d_tpu_torch import cli

    t = time.monotonic()
    rc, _ = _quiet(cli.main, ["polylabel", *argv])
    torch.cuda.synchronize()
    if rc != 0:
        raise RuntimeError(f"polylabel exited {rc}")
    return time.monotonic() - t


def _profiled(fn, kernel: str = "mc_poly_counts_kernel"):
    """``fn()`` under torch.profiler: (its result, device kernels launched,
    device busy microseconds, microseconds of the kernels named ``kernel``),
    or None for the numbers when the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):  # the tracer's start-up, not measured
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        result = fn()
    spans, kernels, k7_us = [], 0, 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        if not e.name.startswith(("Memcpy", "Memset")):
            kernels += 1
        if kernel in e.name:
            k7_us += e.time_range.end - e.time_range.start
    if not spans:
        return result, None, None, None
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return result, kernels, busy, k7_us


def phase_polylabel(work: Path) -> int:
    """Phase 11: returns kernel 7's launches on the main path."""
    from collide2d_tpu_torch.data.validate import compare_labels
    from collide2d_tpu_torch.ops import mc_polygon_cuda
    from collide2d_tpu_torch.ops.broad_phase import possible_collision_mask

    t = time.monotonic()
    configs = _polygon_workload(POLY_ROWS, seed=0)
    robot = np.asarray(POLY_ROBOT, np.float32)
    fields = {name: getattr(configs, name).cpu().numpy() for name in configs._fields}
    src = work / "polys.npz"
    np.savez(src, robot_verts=robot, **fields)
    head = work / "polys_head.npz"
    np.savez(head, robot_verts=robot,
             **{name: a[:POLY_HEAD] for name, a in fields.items()})
    setup_s = time.monotonic() - t

    def outputs(path):
        with np.load(path) as d:
            return d["cp"], d["n_samples"], d["converged"]

    out = work / "polylabels.npz"
    mc_polygon_cuda.reset_launches()
    seconds = _polylabel(["--device", "cuda", "--data_in", str(src),
                          "--data_out", str(out), "--seed", "7"])
    launches = mc_polygon_cuda.LAUNCHES
    if launches <= 0:
        raise RuntimeError("polylabel never launched the k-gon kernel")
    cp, n_used, done = outputs(out)
    if cp.shape != (POLY_ROWS,) or not (np.isfinite(cp).all() and (cp >= 0).all()
                                        and (cp <= 1).all()):
        raise RuntimeError("polylabel: cp not finite in [0, 1]")
    if not ((n_used > 0).all() and (n_used <= 4_000_000 + 100_032).all()):
        raise RuntimeError(f"polylabel: n_samples outside the cap "
                           f"[{n_used.min()}, {n_used.max()}]")
    _line("11 polylabel", time.monotonic() - t, rows=POLY_ROWS, k=POLY_K,
          setup_s=f"{setup_s:.2f}", call_s=f"{seconds:.3f}",
          configs_per_s=f"{POLY_ROWS / seconds:.1f}",
          mean_samples_per_config=f"{n_used.mean():.1f}",
          converged_share=f"{done.mean():.4f}", zero_share=f"{(cp == 0).mean():.4f}",
          kernel_launches=launches)

    t = time.monotonic()
    prof_out = work / "polylabels_profiled.npz"
    mc_polygon_cuda.reset_launches()
    t_call = time.monotonic()
    _, kernels, busy_us, k7_us = _profiled(lambda: _polylabel([
        "--device", "cuda", "--data_in", str(src), "--data_out", str(prof_out),
        "--seed", "7"]))
    wall_us = (time.monotonic() - t_call) * 1e6
    rounds = mc_polygon_cuda.LAUNCHES
    if not all(np.array_equal(a, b) for a, b in zip(outputs(prof_out), (cp, n_used, done))):
        raise RuntimeError("the profiled polylabel run wrote other labels")
    if kernels is None:
        profile = dict(device_activity="not measured")
    else:
        # the busy share of the profiled call, and its device busy time over
        # the unprofiled call's seconds (the same rounds, bitwise the same
        # labels), which the tracer's host overhead does not stretch
        profile = dict(device_kernels=kernels, rounds=rounds,
                       kernels_per_round=f"{kernels / rounds:.1f}",
                       device_busy_s=f"{busy_us / 1e6:.4f}",
                       device_busy_share=f"{busy_us / wall_us:.4f}",
                       busy_over_unprofiled_call=f"{busy_us / 1e6 / seconds:.4f}",
                       mc_poly_kernel_share_of_busy=f"{k7_us / busy_us:.4f}")
    _line("11 polylabel profile", time.monotonic() - t, labels_bitwise_equal=True,
          wall_s=f"{wall_us / 1e6:.3f}", **profile)

    t = time.monotonic()
    ind = work / "polylabels_seed8.npz"
    _polylabel(["--device", "cuda", "--data_in", str(head), "--data_out", str(ind),
                "--seed", "8"])
    report = compare_labels(cp[:POLY_HEAD], outputs(ind)[0])
    if report.mean_abs_diff > 1e-3 or report.frac_within_tolerance < 0.93:
        raise RuntimeError(f"polylabel misses the acceptance bar: {report}")
    pruned_out = work / "polylabels_pruned.npz"
    _polylabel(["--device", "cuda", "--data_in", str(head), "--data_out",
                str(pruned_out), "--seed", "7", "--prune_sigma", "6"])
    head_cfgs = type(configs)(*(a[:POLY_HEAD] for a in configs))
    keep = possible_collision_mask(head_cfgs, robot, 6.0).cpu().numpy()
    for got, want in zip(outputs(pruned_out), (cp, n_used, done)):
        if not np.array_equal(got[keep], want[:POLY_HEAD][keep]):
            raise RuntimeError("pruned polylabel: kept rows differ from the "
                               "unpruned run")
    if (outputs(pruned_out)[0][~keep] != 0).any():
        raise RuntimeError("pruned polylabel: a pruned row has cp != 0")
    _line("11 polylabel check", time.monotonic() - t, rows=POLY_HEAD,
          mean_abs_d=f"{report.mean_abs_diff:.3e}",
          share_within_tol=f"{report.frac_within_tolerance:.4f}",
          pruned_share=f"{1.0 - keep.mean():.4f}", kept_rows_bitwise_equal=True)
    return launches


def _rect_rows(n: int, seed: int):
    """``n`` rows of the rectangle model's scene, drawn on the card as in
    phase 6: robot position U(-6, 6)^2, angle U(0, 2 pi), obstacle extents
    U(0.1, 5)^2."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    pos = torch.rand((n, 2), generator=g, device=dev) * 12.0 - 6.0
    theta = torch.rand((n,), generator=g, device=dev) * (2.0 * math.pi)
    wh = torch.rand((n, 2), generator=g, device=dev) * 4.9 + 0.1
    return pos, theta, wh, g


def _bench_polygons(g, n: int, k: int, area_side: float = 10.0) -> torch.Tensor:
    """The JAX bench's k-gons (utils/benchmarks.py:186-197) on the card:
    regular k-gons of radius U(0.5, 1) at a random rotation, centres
    U(0, area_side)^2."""
    dev = torch.device("cuda")
    centers = torch.rand((n, 1, 2), generator=g, device=dev) * area_side
    radius = torch.rand((n, 1, 1), generator=g, device=dev) * 0.5 + 0.5
    rot = torch.rand((n, 1), generator=g, device=dev) * (2 * math.pi)
    ang = rot + torch.arange(k, device=dev, dtype=torch.float32) * (2 * math.pi / k)
    return centers + radius * torch.stack([torch.cos(ang), torch.sin(ang)], -1)


def _bucket(k: int) -> int:
    return 4 if k <= 4 else 8 if k <= 8 else 16


# FP32 operations per pair written in csrc/obb_distance.cuh (kernel 8 adds
# the offset's 2 shifts and 2 differences): cos/sin of the relative angle
# 6, 4 projections of 3, 4 radii of 4 with their differences and max 23,
# the relative sine 3, 4 vertex pairs x 36 (4 scaled half extents, 4
# vertices of 4, 2 point-box distances of 7, 2 mins), sqrt and select 2.
OBB_DISTANCE_OPS = 194
# One distance evaluation of kernel 12: the advanced angles 4 and offset
# 10, the distance without kernel 8's offset (190), the stop tests and the
# step 5 (sincosf not counted); a rotating lane adds 21 (relative velocity,
# circumradii, bound, hit test), a translating lane's window is 96.
TOI_EVAL_OPS, TOI_SETUP_OPS, TOI_WINDOW_OPS = 209, 21, 96


def polygon_distance_ops(k1: int, k2: int) -> int:
    """csrc/distance_kernel.cu at the K buckets: A = K1 + K2 axes x (the
    axis 2, |n|^2 3, A projections of 3, 2 (A - 2) min/max, the gap 4, 1/|n|
    2, select and max 2) = A (5A + 9); each of the A segments 7 (edge, |e|^2,
    test, reciprocal) and each of the 2 K1 K2 point-segment tests 17; sqrt
    and select 2."""
    k1, k2 = _bucket(k1), _bucket(k2)
    a = k1 + k2
    return a * (5 * a + 9) + 7 * a + 34 * k1 * k2 + 2


def manifold_ops(k1: int, k2: int) -> int:
    """csrc/manifold_kernel.cu at the K buckets: each face of one body
    against the other's KO vertices 15 + 4 KO (normal, 1/|n|, offset, KO
    projections of 3 and mins, separation, select, compare); the reference
    bias 4; each incident face 13; the two clips, the depths and the filter
    67."""
    k1, k2 = _bucket(k1), _bucket(k2)
    return k1 * (15 + 4 * k2) + k2 * (15 + 4 * k1) + 4 + 13 * max(k1, k2) + 67


def _compare(fn, plain, reps: int = 20):
    """(kernel ms over ``reps`` launches after a warm-up, plain ms of one
    call)."""
    return _events_ms(fn, reps=reps), _events_ms(plain, reps=1)


def phase_distance() -> dict:
    """Phase 12: kernels 8 and 9 on the models' `distance` and against their
    plain versions; returns each kernel's entry of the kernels line."""
    from collide2d_tpu_torch.models.collision_model import (
        CollisionProbabilityModel,
        PolygonCollisionProbabilityModel,
    )
    from collide2d_tpu_torch.ops import distance_cuda, polygon_cuda, sat_cuda

    t = time.monotonic()
    pos, theta, wh, g = _rect_rows(SAT_PAIRS, seed=12)
    configs = _polygon_workload(1 << 20, seed=12)
    model = CollisionProbabilityModel()
    pmodel = PolygonCollisionProbabilityModel(np.asarray(POLY_ROBOT, np.float32))
    distance_cuda.reset_launches()
    d_rect = model.distance(pos, theta, wh, impl="auto")
    d_poly = pmodel.distance(configs, impl="auto")
    torch.cuda.synchronize()
    launches = dict(distance_cuda.LAUNCHES)
    if min(launches.values()) <= 0:
        raise RuntimeError(f"a distance kernel was never launched: {launches}")
    sign = {"rect": int(((d_rect <= 0).to(torch.int32)
                         != model.collide(pos, theta, wh, method="obb")).sum()),
            "poly": int(((d_poly <= 0).to(torch.int32) != pmodel.collide(configs)).sum())}
    if any(sign.values()):
        raise RuntimeError(f"distance <= 0 differs from the SAT labels: {sign}")
    sub = slice(0, 1 << 16)
    head = type(configs)(*(a[sub] for a in configs))
    vs_torch = {
        "rect": float((d_rect[sub] - model.distance(pos[sub], theta[sub], wh[sub],
                                                     impl="torch")).abs().max()),
        "poly": float((d_poly[sub] - pmodel.distance(head, impl="torch")).abs().max())}
    if max(vs_torch.values()) > 2e-5:
        raise RuntimeError(f"the kernels' distances differ from impl='torch': {vs_torch}")
    # the whole calls, packing and vertex placement included
    call_ms = {"rect": _events_ms(lambda: model.distance(pos, theta, wh, impl="auto"), 5),
               "kgon": _events_ms(lambda: pmodel.distance(configs, impl="auto"), 5)}
    _line("12 distance model", time.monotonic() - t, rect_rows=SAT_PAIRS,
          kgon_rows=1 << 20, launches=launches,
          sign_mismatch_vs_kernel4=sign["rect"], sign_mismatch_vs_kernel6=sign["poly"],
          max_abs_vs_torch_rect=f"{vs_torch['rect']:.3e}",
          max_abs_vs_torch_kgon=f"{vs_torch['poly']:.3e}",
          overlap_share_rect=f"{float((d_rect < 0).float().mean()):.4f}",
          rect_call_ms=f"{call_ms['rect']:.3f}", kgon_call_ms=f"{call_ms['kgon']:.3f}")
    del d_rect, d_poly, configs

    result = {}
    t = time.monotonic()
    n = SAT_PAIRS  # the JAX bench: both boxes U(-6, 6)^2, U(0.1, 5)^2, U(0, 2 pi)
    pos2, theta2, wh2, _ = _rect_rows(n, seed=13)
    a = sat_cuda.pack_obbs(pos, wh, theta)
    b = sat_cuda.pack_obbs(pos2, wh2, theta2)
    got = distance_cuda.obb_distance_cuda_t(a, b)
    want = distance_cuda.obb_distance_plain(a, b).reshape(-1)
    err = float((got - want).abs().max())
    differ = int(((got <= 0) != (want <= 0)).sum())
    if err > 2e-5 or differ:
        raise RuntimeError(f"obb_distance: max |d| {err} or {differ} signs from the plain version")
    ms, plain_ms = _compare(lambda: distance_cuda.obb_distance_cuda_t(a, b),
                            lambda: distance_cuda.obb_distance_plain(a, b))
    bound, bound_by = _bound_ms(52 * n, OBB_DISTANCE_OPS * n)
    result["obb_distance"] = dict(launches=launches["obb_distance"], max_abs_err=err,
                                  ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                  bound_by=bound_by)
    _line("12 obb_distance", time.monotonic() - t, pairs=n, max_abs_diff=f"{err:.3e}",
          bitwise_equal=bool(torch.equal(got, want)), sign_mismatch=differ,
          kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.3f}", bound_ms=f"{bound:.4f}",
          bound_by=bound_by, kernel_pairs_per_s=f"{n / ms * 1e3:.4e}",
          kernel_gb_per_s=f"{52 * n / (ms * 1e-3) / 1e9:.1f}")
    del a, b, got, want, pos, theta, wh, pos2, theta2, wh2

    n = 1 << 22
    for tag, k1, k2 in (("k8", 8, 8), ("k4_k8", 4, 8)):
        t = time.monotonic()
        a = polygon_cuda.pack_polygons(_bench_polygons(g, n, k1))
        b = polygon_cuda.pack_polygons(_bench_polygons(g, n, k2))
        got = distance_cuda.polygon_distance_cuda_t(a, b, k1=k1, k2=k2)
        want = distance_cuda.polygon_distance_plain(a, b, k1, k2).reshape(-1)
        label = polygon_cuda.sat_polygons_cuda_t(a, b, k1=k1, k2=k2)
        err = float((got - want).abs().max())
        differ = int(((got <= 0) != (want <= 0)).sum())
        vs_label = int(((got <= 0) != (label > 0)).sum())
        if err > 2e-5 or differ or vs_label:
            raise RuntimeError(f"polygon_distance ({tag}): max |d| {err}, {differ} signs "
                               f"from the plain version, {vs_label} from kernel 6")
        ms, plain_ms = _compare(
            lambda: distance_cuda.polygon_distance_cuda_t(a, b, k1=k1, k2=k2),
            lambda: distance_cuda.polygon_distance_plain(a, b, k1, k2))
        nbytes = (2 * k1 + 2 * k2) * 4 + 4
        bound, bound_by = _bound_ms(nbytes * n, polygon_distance_ops(k1, k2) * n)
        if tag == "k8":
            result["polygon_distance"] = dict(
                launches=launches["polygon_distance"], max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by)
        else:
            result["polygon_distance"]["max_abs_err"] = max(
                result["polygon_distance"]["max_abs_err"], err)
        _line("12 polygon_distance", time.monotonic() - t, case=tag, pairs=n,
              max_abs_diff=f"{err:.3e}", bitwise_equal=bool(torch.equal(got, want)),
              sign_mismatch=differ, sign_mismatch_vs_kernel6=vs_label,
              overlap_share=f"{float((want < 0).float().mean()):.4f}",
              kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.3f}", bound_ms=f"{bound:.4f}",
              bound_by=bound_by, ops_per_pair=polygon_distance_ops(k1, k2),
              kernel_pairs_per_s=f"{n / ms * 1e3:.4e}",
              kernel_gb_per_s=f"{nbytes * n / (ms * 1e-3) / 1e9:.1f}")
        del a, b, got, want, label
    return result


def _manifold_diff(got, want):
    """Count mismatches and the largest difference of points and depths on
    the valid slots and of the normal, where the counts agree."""
    count, points, depths, normal = got
    w_count, w_points, w_depths, w_normal = want
    same = count == w_count
    valid = (torch.arange(2, device=count.device)[None] < w_count[:, None]) & same[:, None]
    live = (w_count > 0) & same
    diffs = ((points - w_points).abs().amax(-1)[valid], (depths - w_depths).abs()[valid],
             (normal - w_normal).abs().amax(-1)[live])
    return int((~same).sum()), max((float(d.max()) for d in diffs if d.numel()),
                                   default=0.0)


def phase_manifold() -> dict:
    """Phase 13: kernel 10 on both models' `contact_manifold` and against
    its plain version; returns its entry of the kernels line."""
    from collide2d_tpu_torch.models.collision_model import (
        CollisionProbabilityModel,
        PolygonCollisionProbabilityModel,
    )
    from collide2d_tpu_torch.ops import manifold_cuda, polygon_cuda

    t = time.monotonic()
    rows = 1 << 20
    configs = _polygon_workload(rows, seed=13)
    pos, theta, wh, g = _rect_rows(rows, seed=14)
    model = CollisionProbabilityModel()
    pmodel = PolygonCollisionProbabilityModel(np.asarray(POLY_ROBOT, np.float32))
    manifold_cuda.reset_launches()
    got = {"kgon": pmodel.contact_manifold(configs),
           "rect": model.contact_manifold(pos, theta, wh)}
    torch.cuda.synchronize()
    launches = manifold_cuda.LAUNCHES
    if launches < len(got):
        raise RuntimeError(f"the models launched kernel 10 {launches} times for "
                           f"{len(got)} calls")
    sub = slice(0, 1 << 16)
    want = {"kgon": pmodel.contact_manifold(type(configs)(*(a[sub] for a in configs)),
                                            impl="torch"),
            "rect": model.contact_manifold(pos[sub], theta[sub], wh[sub], impl="torch")}
    report = {}
    for key in got:
        differ, err = _manifold_diff(tuple(a[sub] for a in got[key]), want[key])
        if differ > 1e-5 * (1 << 16) or err > 2e-5:
            raise RuntimeError(f"contact_manifold ({key}): {differ} counts differ from "
                               f"impl='torch', values by {err}")
        report[key] = (differ, err, float((got[key][0] > 0).float().mean()))
    call_ms = {"kgon": _events_ms(lambda: pmodel.contact_manifold(configs), 5),
               "rect": _events_ms(lambda: model.contact_manifold(pos, theta, wh), 5)}
    _line("13 manifold model", time.monotonic() - t, rows=rows, launches=launches,
          **{f"{k}_counts_differ_vs_torch": v[0] for k, v in report.items()},
          **{f"{k}_max_abs_vs_torch": f"{v[1]:.3e}" for k, v in report.items()},
          **{f"{k}_contact_share": f"{v[2]:.4f}" for k, v in report.items()},
          **{f"{k}_call_ms": f"{v:.3f}" for k, v in call_ms.items()})
    del got, want, configs

    n = 1 << 22
    result = {"launches": launches, "max_abs_err": 0.0}
    a = polygon_cuda.pack_polygons(_bench_polygons(g, n, 8))
    b = polygon_cuda.pack_polygons(_bench_polygons(g, n, 8))
    for margin in (0.0, 0.1):
        t = time.monotonic()
        out = manifold_cuda.polygon_manifold_cuda_t(a, b, k1=8, k2=8, margin=margin)
        ref = manifold_cuda.polygon_manifold_plain(a, b, 8, 8, margin)
        differ, err = _manifold_diff(manifold_cuda.unpack_manifold(out, n),
                                     manifold_cuda.unpack_manifold(ref, n))
        if differ > 1e-5 * n or err > 2e-5:
            raise RuntimeError(f"polygon_manifold (margin {margin}): {differ} counts "
                               f"differ from the plain version, values by {err}")
        ms, plain_ms = _compare(
            lambda: manifold_cuda.polygon_manifold_cuda_t(a, b, k1=8, k2=8, margin=margin),
            lambda: manifold_cuda.polygon_manifold_plain(a, b, 8, 8, margin))
        bound, bound_by = _bound_ms((128 + 36) * n, manifold_ops(8, 8) * n)
        counts = torch.bincount(ref[0].reshape(-1).to(torch.int64), minlength=3)
        result["max_abs_err"] = max(result["max_abs_err"], err)
        if margin == 0.0:
            result.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by)
        _line("13 polygon_manifold", time.monotonic() - t, k=8, margin=margin, pairs=n,
              counts_differ=differ, max_abs_diff=f"{err:.3e}",
              bitwise_equal=bool(torch.equal(out, ref)),
              count_shares="/".join(f"{float(c) / n:.4f}" for c in counts),
              kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.3f}", bound_ms=f"{bound:.4f}",
              bound_by=bound_by, ops_per_pair=manifold_ops(8, 8),
              kernel_pairs_per_s=f"{n / ms * 1e3:.4e}",
              kernel_gb_per_s=f"{164 * n / (ms * 1e-3) / 1e9:.1f}")
        del out, ref
    return result


def _toi_agreement(got, want):
    """(hit/miss mismatches, largest |dt| where both hit)."""
    hit_g, hit_w = torch.isfinite(got), torch.isfinite(want)
    both = hit_g & hit_w
    dt = float((got[both] - want[both]).abs().max()) if bool(both.any()) else 0.0
    return int((hit_g != hit_w).sum()), dt


def phase_toi() -> dict:
    """Phase 14: kernel 12 on `CollisionProbabilityModel.time_of_impact` and
    against its plain version at the JAX bench's shape; returns its entry of
    the kernels line."""
    from collide2d_tpu_torch.models.collision_model import CollisionProbabilityModel
    from collide2d_tpu_torch.ops import toi_cuda

    t = time.monotonic()
    rows = 1 << 21
    kw = dict(t_max=8.0, iters=64, tol=1e-4)
    pos, theta, wh, g = _rect_rows(rows, seed=15)
    vel = -pos / pos.norm(dim=-1, keepdim=True)  # unit speed toward the obstacle
    omega = torch.rand((rows,), generator=g, device="cuda") * 2.0 - 1.0
    omega[::4] = 0.0  # translation only: the exact window
    model = CollisionProbabilityModel()
    toi_cuda.reset_launches()
    t_auto = model.time_of_impact(pos, theta, wh, vel, omega, impl="auto", **kw)
    torch.cuda.synchronize()
    launches = toi_cuda.LAUNCHES
    if launches <= 0:
        raise RuntimeError("time_of_impact never launched kernel 12")
    sub = slice(0, 1 << 16)
    t_torch = model.time_of_impact(pos[sub], theta[sub], wh[sub], vel[sub], omega[sub],
                                   impl="torch", **kw)
    differ, dt = _toi_agreement(t_auto[sub], t_torch)
    # The torch path advances on the polygon distance, an equivalent form:
    # its loop can stop a step of at most ~tol / bound away.
    if differ > 1e-3 * (1 << 16) or dt > 1e-3:
        raise RuntimeError(f"time_of_impact: {differ} hits differ from impl='torch', "
                           f"|dt| {dt}")
    call_ms = _events_ms(lambda: model.time_of_impact(pos, theta, wh, vel, omega,
                                                      impl="auto", **kw), 5)
    _line("14 toi model", time.monotonic() - t, rows=rows, launches=launches,
          call_ms=f"{call_ms:.3f}",
          hit_share=f"{float(torch.isfinite(t_auto).float().mean()):.4f}",
          rotating_share=f"{float((omega != 0).float().mean()):.4f}",
          hits_differ_vs_torch=differ, max_abs_dt_vs_torch=f"{dt:.3e}")
    del t_auto, t_torch

    t = time.monotonic()
    n = 1 << 21  # the JAX bench (utils/benchmarks.py:474-498)
    unif = lambda lo, hi, *s: torch.rand(s, generator=g, device="cuda") * (hi - lo) + lo  # noqa: E731
    c2 = unif(3.0, 6.0, n, 2)
    zeros = torch.zeros_like(c2)
    b1 = toi_cuda.pack_moving_obbs(zeros, unif(0.5, 3.0, n, 2), unif(0.0, 7.0, n), zeros,
                                   unif(-1.0, 1.0, n))
    b2 = toi_cuda.pack_moving_obbs(c2, unif(0.5, 3.0, n, 2), unif(0.0, 7.0, n),
                                   -c2 / c2.norm(dim=-1, keepdim=True), unif(-1.0, 1.0, n))
    got = toi_cuda.moving_obb_toi_cuda_t(b1, b2, **kw)
    want, steps = toi_cuda.moving_obb_toi_plain(b1, b2, return_steps=True, **kw)
    want, steps = want.reshape(-1), steps.reshape(-1)
    differ, dt = _toi_agreement(got, want)
    if differ > 1e-4 * n or dt > 1e-5:
        raise RuntimeError(f"moving_obb_toi: {differ} hits differ from the plain version, "
                           f"|dt| {dt}")
    ms, plain_ms = _compare(lambda: toi_cuda.moving_obb_toi_cuda_t(b1, b2, **kw),
                            lambda: toi_cuda.moving_obb_toi_plain(b1, b2, **kw))
    rotating = (b1[7] != 0).reshape(-1) | (b2[7] != 0).reshape(-1)
    evals = torch.where(rotating, steps + 1, 0).to(torch.float64)
    ops = (float(evals.sum()) * TOI_EVAL_OPS + int(rotating.sum()) * TOI_SETUP_OPS
           + int((~rotating).sum()) * TOI_WINDOW_OPS)
    bound, bound_by = _bound_ms(68 * n, ops)
    warp_steps = steps.reshape(-1, 32).amax(dim=1).to(torch.float64)
    _line("14 moving_obb_toi", time.monotonic() - t, pairs=n, t_max=8.0, iters=64,
          tol=1e-4, hits_differ=differ, max_abs_dt=f"{dt:.3e}",
          bitwise_equal=bool(torch.equal(got, want)),
          hit_share=f"{float(torch.isfinite(want).float().mean()):.4f}",
          rotating_share=f"{float(rotating.float().mean()):.4f}",
          mean_steps=f"{float(steps.double().mean()):.2f}", max_steps=int(steps.max()),
          mean_warp_max_steps=f"{float(warp_steps.mean()):.2f}",
          kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.2f}", bound_ms=f"{bound:.4f}",
          bound_by=bound_by, kernel_queries_per_s=f"{n / ms * 1e3:.4e}")
    return dict(launches=launches, max_abs_err=dt, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=bound_by)


# ---- the trajectory slice (kernels 13, 14, 15) ---------------------------

ROBOT_WH = (4.07, 1.74)
TRAJ_ROWS, TRAJ_HEAD = 100_000, 16_384
ROT_ROWS, ROT_SAMPLES = 8192, 2048
SCREEN_LANES = 512
# The rotating runs take the threefry cascade, which is host-bound (tens of
# small launches and one readback a step): their cap is cut so the phase
# stays near a minute.
ROT_CAP, ROT_KGON_ROWS, ROT_KGON_CAP = 10_000, 4096, 4_000
# FP32 operations a sample of kernel 13 beyond its normals: the obstacle's
# offset, angle and extents 9, the offsets and the hit test 5; a
# translating sample adds the window (TOI_WINDOW_OPS), a rotating one
# TOI_EVAL_OPS an evaluation.
MC_TOI_NOISE_OPS = 14
# Kernel 15, a lane: the obstacle 11, the t = 0 test 46, the window
# TOI_WINDOW_OPS, the segment-invariant projections of the obstacle axes
# 12, each segment 113 (bounds 3, cd/sd 8, the rotated offsets, speeds and
# radii 30, 4 axes x 17, the ANDs 4), the flags and warm start 5.
SCREEN_LANE_OPS, SCREEN_SEG_OPS = 11 + 46 + 12 + 5, 113


def mc_toi_kernel_instance(shape_noise: bool, ca_iters: int) -> str:
    """Kernel 13's instantiation at these inputs in the SASS: <shape noise,
    advancement loop (ca_iters > 0), wide indices = false>
    (csrc/mc_toi_kernel.cu)."""
    return f"mc_toi_counts_kernelILb{int(shape_noise)}ELb{int(ca_iters > 0)}ELb0E"


def mc_moving_poly_ops_per_sample(k: int, k2: int, k2a: int) -> int:
    """csrc/mc_moving_polygon_kernel.cu: kernel 7's normals, offsets and
    (u1, u2) (3 normals + 9), the relative velocity in the obstacle frame
    (6), each kept robot axis 5K + 13 (translation 3, K blends of 3,
    min/max, 2 adds, the speed 3, the window 8 with its division), each
    obstacle normal 5 K2 + 13, the hit test 3."""
    return 3 * NORMAL_OPS + 9 + 6 + k2a * (5 * k + 13) + k * (5 * k2 + 13) + 3


def _moving_rects(n: int, rotating: bool, seed: int = 5):
    """The JAX bench's trajectory rows (utils/benchmarks.py:527-540) on the
    card: position U(-6, 6)^2, angle U(0, 2 pi), obstacle U(0.5, 5)^2,
    sigmas U(0, 0.3) (shape noise on), velocity U(-2, 2)^2, omega
    U(-0.5, 0.5) or 0, t_max U(0.5, 3)."""
    from collide2d_tpu_torch.mc.moving import moving_configs

    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    pos = f32(rng.uniform(-6, 6, (n, 2)))
    theta = f32(rng.uniform(0, 2 * np.pi, n))
    wh = f32(rng.uniform(0.5, 5, (n, 2)))
    sd = f32(rng.uniform(0, 0.3, (n, 5)))
    vel = f32(rng.uniform(-2, 2, (n, 2)))
    omega = f32(rng.uniform(-0.5, 0.5, n) * (1.0 if rotating else 0.0))
    t_max = f32(rng.uniform(0.5, 3, n))
    return moving_configs(pos, theta, wh, sd, vel, omega, t_max, device="cuda")


def _moving_kgons(n: int, seed: int = 7):
    """Translation-only k = 8 trajectories: `example_polygon_configs(n, k=8,
    seed)` with velocity U(-2, 2)^2 and t_max U(0.5, 3)."""
    from collide2d_tpu_torch.mc.moving import moving_polygon_configs
    from collide2d_tpu_torch.models.collision_model import example_polygon_configs

    b = example_polygon_configs(n, k=POLY_K, seed=seed, device="cuda")
    rng = np.random.default_rng(seed)
    return moving_polygon_configs(
        b.position, b.pose_theta, b.obstacle_verts, b.std_dev,
        rng.uniform(-2, 2, (n, 2)), 0.0, rng.uniform(0.5, 3, n), device="cuda")


def _rotating_kgons(n: int, k: int = 6):
    """The JAX bench's rotating k-gon trajectories (utils/benchmarks.py:
    646-677): its numpy rows (seed 7) and its convex polygons (rotated
    regular k-gons of radius U(0.5, 1) centred in a 10 x 10 box, drawn with
    the threefry streams of `_random_convex_polygons`, :186-197)."""
    from collide2d_tpu_torch.mc import prng
    from collide2d_tpu_torch.mc.moving import moving_polygon_configs

    kc, kr, ka = prng.split(prng.PRNGKey(2), 3)
    centers = prng.uniform(kc, (n, 1, 2), 0.0, 10.0, "cuda")
    radius = prng.uniform(kr, (n, 1, 1), 0.5, 1.0, "cuda")
    rot = prng.uniform(ka, (n, 1), 0.0, 2 * np.pi, "cuda")
    ang = rot + torch.arange(k, dtype=torch.float32, device="cuda") * float(
        np.float32(2 * np.pi / k))
    polys = centers + radius * torch.stack([torch.cos(ang), torch.sin(ang)], -1)
    rng = np.random.default_rng(7)
    pos = rng.uniform(-6, 6, (n, 2))
    theta = rng.uniform(0, 2 * np.pi, n)
    sd = rng.uniform(0, 0.3, (n, 3))
    vel = rng.uniform(-2, 2, (n, 2))
    omega = rng.uniform(-0.5, 0.5, n)
    t_max = rng.uniform(0.5, 3, n)
    return moving_polygon_configs(pos, theta, polys, sd, vel, omega, t_max,
                                  device="cuda")


def _save_npz(path: Path, configs, **extra) -> Path:
    np.savez(path, **{f: getattr(configs, f).cpu().numpy() for f in configs._fields},
             **extra)
    return path


def _movelabel(argv) -> float:
    """``collide2d-torch movelabel`` in process; returns its seconds."""
    from collide2d_tpu_torch import cli

    t = time.monotonic()
    rc, _ = _quiet(cli.main, ["movelabel", "--device", "cuda", *argv])
    torch.cuda.synchronize()
    if rc != 0:
        raise RuntimeError(f"movelabel exited {rc}")
    return time.monotonic() - t


def _host_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the host clock, synchronised, after
    one warm-up call (for calls that read back to the host)."""
    fn()
    torch.cuda.synchronize()
    t = time.monotonic()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.monotonic() - t) * 1e3 / reps


def _labels(path: Path):
    with np.load(path) as d:
        return d["cp"], d["n_samples"], d["converged"]


def _check_labels(name: str, labels, rows: int, cap: int) -> None:
    cp, n_used, _ = labels
    if cp.shape != (rows,) or not (np.isfinite(cp).all() and (cp >= 0).all()
                                   and (cp <= 1).all()):
        raise RuntimeError(f"{name}: cp not finite in [0, 1]")
    if not ((n_used > 0).all() and (n_used <= cap + 100_032).all()):
        raise RuntimeError(f"{name}: n_samples outside the cap "
                           f"[{n_used.min()}, {n_used.max()}]")


def _agreement_gate(name: str, configs, robot, phase: str) -> dict:
    """The kernel against the threefry window path on the card: 65,536
    samples of each row, max z < 6 and a share with z > 3 of at most 3 x
    0.27% (the JAX bench's agreement gate)."""
    from collide2d_tpu_torch.mc import prng
    from collide2d_tpu_torch.mc.estimator import mc_round

    t = time.monotonic()
    c, n = configs.num, 1 << 16
    uids = torch.arange(c, dtype=torch.int32, device="cuda")
    cp = {}
    for impl in ("cuda", "threefry"):
        counts = mc_round(prng.PRNGKey(8), uids, configs, robot, 0, n_batch=n,
                          impl=impl, ca_iters=0)
        cp[impl] = counts.cpu().numpy().astype(np.float64) / n
    diff = np.abs(cp["cuda"] - cp["threefry"])
    pooled = (cp["cuda"] + cp["threefry"]) / 2.0
    var = pooled * (1.0 - pooled) * (2.0 / n)
    z = np.where(var > 0, diff / np.sqrt(np.maximum(var, 1e-300)), 0.0)
    frac3, max_z = float((z > 3.0).mean()), float(z.max())
    if not (max_z < 6.0 and frac3 <= 3 * 0.0027):
        raise RuntimeError(f"{name} agreement gate failed: max z {max_z:.2f}, "
                           f"share z > 3 {frac3:.4f}")
    _line(phase, time.monotonic() - t, kernel=name, configs=c, n_samples=n,
          max_z=f"{max_z:.3f}", frac_z_gt3=f"{frac3:.5f}",
          mean_abs_diff=f"{diff.mean():.3e}", mean_cp=f"{cp['threefry'].mean():.4f}")
    return dict(max_z=max_z, frac3=frac3)


def phase_mc_toi() -> dict:
    """Phase 15: kernel 13 against its plain version on the same Philox
    stream (translation-only rows at the main path's width, rotating rows
    at the JAX bench's shape), then its agreement gate; returns its entry of
    the kernels line (times of the translation run) and the rotating run's
    steps."""
    from collide2d_tpu_torch.mc import prng
    from collide2d_tpu_torch.ops import mc_cuda, mc_toi_cuda

    result = {"max_abs_err": 0}
    seed = mc_cuda.round_seed(prng.PRNGKey(12), 3)
    for key, c, n, rotating, ca_iters in (("translation", TRAJ_ROWS, N_CHECK, False, 0),
                                          ("rotating", ROT_ROWS, ROT_SAMPLES, True, 48)):
        t = time.monotonic()
        params = mc_toi_cuda.pack_mc_toi_params(_moving_rects(c, rotating), ROBOT_WH)
        uids = torch.arange(c, dtype=torch.int32, device="cuda")
        kw = dict(ca_iters=ca_iters, tol=1e-4)
        got = mc_toi_cuda.mc_toi_counts(params, uids, seed, n, **kw)
        want, steps, warp_steps = mc_toi_cuda.mc_toi_counts_plain(
            params, uids, seed, n, max_elems=1 << 24, return_steps=True, **kw)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        total = int(diff.sum())
        if total > MISMATCH_BOUND * c * n:
            raise RuntimeError(f"kernel 13 disagrees with its plain version: "
                               f"sum|dcount|={total} > {MISMATCH_BOUND} * C * n ({key})")
        if not 0 < int(got.sum()) < c * n:
            raise RuntimeError(f"degenerate kernel-13 counts ({key})")
        ms = _events_ms(lambda: mc_toi_cuda.mc_toi_counts(params, uids, seed, n, **kw),
                        reps=20 if not rotating else 5)
        plain_ms = _events_ms(lambda: mc_toi_cuda.mc_toi_counts_plain(
            params, uids, seed, n, max_elems=1 << 24, **kw), reps=1)
        evals = float((steps + (n if rotating else 0)).sum())  # + the final check
        ops = c * n * (5 * NORMAL_OPS + MC_TOI_NOISE_OPS) + (
            evals * TOI_EVAL_OPS if rotating else c * n * TOI_WINDOW_OPS)
        bound, bound_by = _bound_ms(c * 68, ops)
        mean_steps = float(steps.sum()) / (c * n)
        warp_max = float(warp_steps.sum()) / (c * -(-n // 32))
        # the window loop's floor (the advancement loop's work depends on
        # the data: its bound counts the steps taken)
        floor = {} if rotating else issue_floor(
            "mc_toi_kernel", (), mc_toi_kernel_instance(True, ca_iters),
            "mc_toi_batch_samples", c * n)
        counts_sum, counts_fp = _fingerprint(got)
        result["max_abs_err"] = max(result["max_abs_err"], int(diff.max()))
        result[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                           mean_steps=mean_steps, warp_max_steps=warp_max,
                           issue_floor_ms=floor.get("issue_floor_ms"))
        _line("15 mc_toi", time.monotonic() - t, case=key, C=c, n=n, ca_iters=ca_iters,
              sum_abs_dcount=total, rows_differ=int((diff > 0).sum()),
              hit_share=f"{float(want.sum()) / (c * n):.4f}", counts_sum=counts_sum,
              counts_fingerprint=counts_fp,
              mean_steps=f"{mean_steps:.2f}", mean_warp_max_steps=f"{warp_max:.2f}",
              kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.2f}", bound_ms=f"{bound:.4f}",
              bound_by=bound_by,
              **{k: (f"{v:.4f}" if isinstance(v, float) else v) for k, v in floor.items()},
              kernel_samples_per_s=f"{c * n / ms * 1e3:.4e}",
              plain_samples_per_s=f"{c * n / plain_ms * 1e3:.4e}")
        del params, got, want, steps, warp_steps
    _agreement_gate("mc_toi", _moving_rects(4096, False, seed=6), ROBOT_WH, "15 agreement")
    out = result["translation"]
    return dict(max_abs_err=result["max_abs_err"], ms=out["ms"], plain_ms=out["plain_ms"],
                bound_ms=out["bound_ms"], bound_by=out["bound_by"],
                issue_floor_ms=out["issue_floor_ms"], rotating=result["rotating"])


def _relabel_bar(name: str, full_cp, full_n, head_path: Path, out: Path,
                 extra=()) -> dict:
    """Another seed on the first rows against the first run's labels. The
    bar: mean |d| <= 1e-3 and a share within +-0.005 of at least 0.93, or,
    where the rows' own binomial noise predicts a share below 0.93 (many
    rows at mid cp, whose 1e-2 bin lets two runs differ by ~0.007), both
    numbers within 4 standard deviations of that prediction."""
    from collide2d_tpu_torch.data.validate import compare_labels

    _movelabel(["--data_in", str(head_path), "--data_out", str(out), "--seed", "8",
                *extra])
    other = _labels(out)
    report = compare_labels(full_cp[:TRAJ_HEAD], other[0])
    share, mean_d = report.frac_within_tolerance, report.mean_abs_diff
    exp = _expected_agreement(full_cp[:TRAJ_HEAD], full_n[:TRAJ_HEAD], *other[:2])
    fields = dict(mean_abs_d=f"{mean_d:.3e}", share_within_tol=f"{share:.4f}",
                  expected_mean_abs_d=f"{exp['mean_d']:.3e}",
                  expected_share_within_tol=f"{exp['share']:.4f}",
                  share_cp_in_0p1_0p9=f"{exp['mid']:.4f}")
    fixed = mean_d <= 1e-3 and share >= 0.93
    predicted = (share >= exp["share"] - 4 * exp["share_sd"]
                 and mean_d <= exp["mean_d"] + 4 * exp["mean_d_sd"])
    if not (fixed or (exp["share"] < 0.93 and predicted)):
        raise RuntimeError(f"{name} misses the relabel bar: {report} {fields}")
    fields["bar"] = "fixed" if fixed else "binomial_prediction"
    return fields


def _expected_agreement(cp_a, n_a, cp_b, n_b) -> dict:
    """What two independent runs' binomial noise alone predicts: each
    row's difference taken as normal with sd^2 = p (1 - p) (1/n_a + 1/n_b)
    at the pooled p. Returns the expected share within +-0.005 and mean
    |d|, their standard deviations over the rows, and the share of rows
    with pooled cp in (0.1, 0.9)."""
    from math import erf

    p = (cp_a.astype(np.float64) + cp_b) / 2.0
    sd = np.sqrt(p * (1.0 - p) * (1.0 / np.maximum(n_a, 1) + 1.0 / np.maximum(n_b, 1)))
    within = np.where(sd > 0, np.vectorize(erf)(0.005 / (np.maximum(sd, 1e-300)
                                                         * np.sqrt(2.0))), 1.0)
    rows = p.size
    return dict(share=float(within.mean()),
                share_sd=float(np.sqrt((within * (1 - within)).sum())) / rows,
                mean_d=float((sd * np.sqrt(2 / np.pi)).mean()),
                mean_d_sd=float(np.sqrt((sd * sd * (1 - 2 / np.pi)).sum())) / rows,
                mid=float(((p > 0.1) & (p < 0.9)).mean()))


def _prune_check(name: str, head_cfgs, robot, full, head_path: Path, out: Path) -> str:
    from collide2d_tpu_torch.ops.broad_phase import possible_collision_mask

    _movelabel(["--data_in", str(head_path), "--data_out", str(out), "--seed", "7",
                "--prune_sigma", "6"])
    keep = possible_collision_mask(head_cfgs, robot, 6.0).cpu().numpy()
    pruned = _labels(out)
    for got, want in zip(pruned, full):
        if not np.array_equal(got[keep], want[:TRAJ_HEAD][keep]):
            raise RuntimeError(f"{name} --prune_sigma 6: kept rows differ")
    if (pruned[0][~keep] != 0).any():
        raise RuntimeError(f"{name} --prune_sigma 6: a pruned row has cp != 0")
    return f"{1.0 - keep.mean():.4f}"


def _reset_trajectory_counts() -> None:
    from collide2d_tpu_torch.ops import mc_moving_polygon_cuda, mc_toi_cuda, screen_cuda

    for mod in (mc_toi_cuda, mc_moving_polygon_cuda, screen_cuda):
        mod.reset_launches()


def _trajectory_counts() -> dict:
    from collide2d_tpu_torch.ops import mc_moving_polygon_cuda, mc_toi_cuda, screen_cuda

    torch.cuda.synchronize()
    return {"13": mc_toi_cuda.LAUNCHES, "14": mc_moving_polygon_cuda.LAUNCHES,
            "15": screen_cuda.LAUNCHES}


def phase_movelabel_rects(work: Path) -> dict:
    """Phase 16: ``movelabel --device cuda`` on rectangles; returns kernel
    13's and kernel 15's launches on their paths."""
    from collide2d_tpu_torch.mc import prng
    from collide2d_tpu_torch.mc.driver import adaptive_collision_probabilities
    from collide2d_tpu_torch.mc.estimator import AdaptiveConfig

    t = time.monotonic()
    configs = _moving_rects(TRAJ_ROWS, rotating=False)
    src = _save_npz(work / "moves.npz", configs)
    head_cfgs = type(configs)(*(a[:TRAJ_HEAD] for a in configs))
    head = _save_npz(work / "moves_head.npz", head_cfgs)
    out = work / "movelabels.npz"
    _reset_trajectory_counts()
    seconds = _movelabel(["--data_in", str(src), "--data_out", str(out), "--seed", "7"])
    counts = _trajectory_counts()
    if counts["13"] <= 0 or counts["15"] != 0:
        raise RuntimeError(f"translation-only movelabel launched {counts}")
    full = _labels(out)
    _check_labels("movelabel", full, TRAJ_ROWS, 4_000_000)
    launches = {"13": counts["13"]}
    _line("16 movelabel", time.monotonic() - t, rows=TRAJ_ROWS, motion="translation",
          call_s=f"{seconds:.3f}", configs_per_s=f"{TRAJ_ROWS / seconds:.1f}",
          mean_samples_per_config=f"{full[1].mean():.1f}",
          converged_share=f"{full[2].mean():.4f}", zero_share=f"{(full[0] == 0).mean():.4f}",
          mean_cp=f"{full[0].mean():.4f}", kernel13_launches=counts["13"],
          kernel15_launches=counts["15"])
    t = time.monotonic()
    t_call = time.monotonic()
    _, kernels, busy_us, k13_us = _profiled(lambda: _movelabel([
        "--data_in", str(src), "--data_out", str(work / "movelabels_profiled.npz"),
        "--seed", "7"]), kernel="mc_toi_counts_kernel")
    wall_us = (time.monotonic() - t_call) * 1e6
    if not all(np.array_equal(a, b) for a, b in
               zip(_labels(work / "movelabels_profiled.npz"), full)):
        raise RuntimeError("the profiled movelabel run wrote other labels")
    profile = (dict(device_activity="not measured") if kernels is None else dict(
        device_kernels=kernels, device_busy_s=f"{busy_us / 1e6:.4f}",
        device_busy_share=f"{busy_us / wall_us:.4f}",
        busy_over_unprofiled_call=f"{busy_us / 1e6 / seconds:.4f}",
        mc_toi_kernel_share_of_busy=f"{k13_us / busy_us:.4f}"))
    _line("16 movelabel profile", time.monotonic() - t, labels_bitwise_equal=True,
          wall_s=f"{wall_us / 1e6:.3f}", **profile)

    t = time.monotonic()
    bar = _relabel_bar("movelabel", full[0], full[1], head,
                       work / "movelabels_seed8.npz")
    pruned_share = _prune_check("movelabel", head_cfgs, ROBOT_WH, full, head,
                                work / "movelabels_pruned.npz")
    _line("16 movelabel check", time.monotonic() - t, rows=TRAJ_HEAD, **bar,
          pruned_share=pruned_share, kept_rows_bitwise_equal=True)

    # rotating rows: 'auto' is the threefry screened cascade, stage A on
    # kernel 15; the same run through the API with the torch screen
    t = time.monotonic()
    rot = _moving_rects(ROT_ROWS, rotating=True)
    rot_src = _save_npz(work / "moves_rot.npz", rot)
    rot_out = work / "movelabels_rot.npz"
    cap = ["--max_samples", str(ROT_CAP)]
    _reset_trajectory_counts()
    rot_s = _movelabel(["--data_in", str(rot_src), "--data_out", str(rot_out),
                        "--seed", "7", *cap])
    counts = _trajectory_counts()
    if counts["15"] <= 0 or counts["13"] != 0:
        raise RuntimeError(f"rotating movelabel (auto) launched {counts}")
    launches["15"] = counts["15"]
    labels = _labels(rot_out)
    _check_labels("rotating movelabel", labels, ROT_ROWS, ROT_CAP)
    t_api = time.monotonic()
    torch_screen = adaptive_collision_probabilities(
        prng.PRNGKey(7), rot, np.asarray(ROBOT_WH, np.float32),
        AdaptiveConfig(max_samples=ROT_CAP, screen_impl="torch"))
    torch.cuda.synchronize()
    api_s = time.monotonic() - t_api
    k_cuda = np.rint(labels[0].astype(np.float64) * labels[1])
    k_torch = np.rint(torch_screen[0].astype(np.float64) * torch_screen[1])
    dcount = float(np.abs(k_cuda - k_torch).sum())
    if dcount > MISMATCH_BOUND * float(labels[1].sum()):
        raise RuntimeError(f"kernel-15 cascade differs from the torch screen's: "
                           f"sum|dcount| {dcount}")
    _line("16 movelabel rotating", time.monotonic() - t, rows=ROT_ROWS, cap=ROT_CAP,
          impl="auto", kernel15_launches=counts["15"], call_s=f"{rot_s:.3f}",
          configs_per_s=f"{ROT_ROWS / rot_s:.1f}",
          torch_screen_configs_per_s=f"{ROT_ROWS / api_s:.1f}",
          sum_abs_dcount_vs_torch_screen=dcount,
          rows_differ=int((k_cuda != k_torch).sum()),
          mean_samples_per_config=f"{labels[1].mean():.1f}",
          converged_share=f"{labels[2].mean():.4f}", mean_cp=f"{labels[0].mean():.4f}")

    t = time.monotonic()
    _reset_trajectory_counts()
    cuda_s = _movelabel(["--data_in", str(rot_src), "--data_out",
                         str(work / "movelabels_rot_cuda.npz"), "--seed", "7", "--impl",
                         "cuda", *cap])
    counts = _trajectory_counts()
    if counts["13"] <= 0:
        raise RuntimeError(f"rotating movelabel (--impl cuda) launched {counts}")
    cuda_labels = _labels(work / "movelabels_rot_cuda.npz")
    _check_labels("rotating movelabel --impl cuda", cuda_labels, ROT_ROWS, ROT_CAP)
    _line("16 movelabel rotating cuda", time.monotonic() - t, rows=ROT_ROWS, cap=ROT_CAP,
          kernel13_launches=counts["13"], call_s=f"{cuda_s:.3f}",
          configs_per_s=f"{ROT_ROWS / cuda_s:.1f}",
          mean_cp=f"{cuda_labels[0].mean():.4f}",
          mean_cp_cascade=f"{labels[0].mean():.4f}")
    return launches


def phase_mc_moving_polygon(work: Path) -> dict:
    """Phase 17: kernel 14 against its plain version and kernel 7, its
    agreement gate, and the k-gon trajectory paths; returns its entry of the
    kernels line."""
    from collide2d_tpu_torch.mc import prng
    from collide2d_tpu_torch.models.collision_model import PolygonCollisionProbabilityModel
    from collide2d_tpu_torch.ops import mc_cuda, mc_moving_polygon_cuda as mmp
    from collide2d_tpu_torch.ops import mc_polygon_cuda

    t = time.monotonic()
    robot = np.asarray(POLY_ROBOT, np.float32)
    a_keep = mc_polygon_cuda.dedup_robot_axes(robot)
    dims = dict(k=POLY_K, k2=len(robot), k2a=len(a_keep))
    c, n = TRAJ_ROWS, N_CHECK
    configs = _moving_kgons(c)
    params = mmp.pack_moving_polygon_mc_params(configs, robot, a_keep)
    uids = torch.arange(c, dtype=torch.int32, device="cuda")
    seed = mc_cuda.round_seed(prng.PRNGKey(12), 3)
    got = mmp.mc_moving_poly_counts(params, uids, seed, n, **dims)
    want = mmp.mc_moving_poly_counts_plain(params, uids, seed, n, max_elems=1 << 22, **dims)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    total = int(diff.sum())
    if total > MISMATCH_BOUND * c * n:
        raise RuntimeError(f"kernel 14 disagrees with its plain version: "
                           f"sum|dcount|={total}")
    if not 0 < int(got.sum()) < c * n:
        raise RuntimeError("degenerate kernel-14 counts")
    ms = _events_ms(lambda: mmp.mc_moving_poly_counts(params, uids, seed, n, **dims), 20)
    plain_ms = _events_ms(lambda: mmp.mc_moving_poly_counts_plain(
        params, uids, seed, n, max_elems=1 << 22, **dims), 1)
    bound, bound_by = _bound_ms(c * (params.shape[1] * 4 + 8),
                                c * n * mc_moving_poly_ops_per_sample(**dims))
    floor = issue_floor("mc_moving_polygon_kernel", mc_polygon_cuda.shape_defines(**dims),
                        "mc_moving_poly_counts_kernelILb0E", "mc_moving_poly_batch_samples",
                        c * n)
    counts_sum, counts_fp = _fingerprint(got)
    # zero velocity: kernel 7's counts bit for bit on the same stream
    still = configs._replace(velocity=torch.zeros_like(configs.velocity))
    k14 = mmp.mc_moving_poly_counts(mmp.pack_moving_polygon_mc_params(still, robot, a_keep),
                                    uids, seed, n, **dims)
    k7 = mc_polygon_cuda.mc_poly_counts(
        mc_polygon_cuda.pack_polygon_mc_params(still, robot, a_keep), uids, seed, n, **dims)
    if not torch.equal(k14, k7):
        raise RuntimeError(f"kernel 14 at zero velocity differs from kernel 7 on "
                           f"{int((k14 != k7).sum())} rows")
    result = dict(max_abs_err=int(diff.max()), ms=ms, plain_ms=plain_ms, bound_ms=bound,
                  bound_by=bound_by, issue_floor_ms=floor["issue_floor_ms"])
    _line("17 mc_moving_poly", time.monotonic() - t, C=c, n=n, k=POLY_K,
          table_rows=params.shape[1], kept_axes=len(a_keep), sum_abs_dcount=total,
          rows_differ=int((diff > 0).sum()), hit_share=f"{float(want.sum()) / (c * n):.4f}",
          counts_sum=counts_sum, counts_fingerprint=counts_fp,
          zero_velocity_equals_kernel7=True, kernel_ms=f"{ms:.4f}",
          plain_ms=f"{plain_ms:.2f}", bound_ms=f"{bound:.4f}", bound_by=bound_by,
          **{k: (f"{v:.4f}" if isinstance(v, float) else v) for k, v in floor.items()},
          kernel_samples_per_s=f"{c * n / ms * 1e3:.4e}",
          plain_samples_per_s=f"{c * n / plain_ms * 1e3:.4e}")
    del params, got, want, k14, k7, still
    _agreement_gate("mc_moving_poly", _moving_kgons(4096, seed=8), robot, "17 agreement")

    # the model and the CLI on the 100,000 rows
    t = time.monotonic()
    model = PolygonCollisionProbabilityModel(robot)
    _reset_trajectory_counts()
    t_call = time.monotonic()
    cp_model, n_model, _ = model.label(prng.PRNGKey(7), configs)
    model_s = time.monotonic() - t_call
    counts = _trajectory_counts()
    if counts["14"] <= 0:
        raise RuntimeError(f"PolygonCollisionProbabilityModel.label launched {counts}")
    src = _save_npz(work / "moving_polys.npz", configs, robot_verts=robot)
    head_cfgs = type(configs)(*(a[:TRAJ_HEAD] for a in configs))
    head = _save_npz(work / "moving_polys_head.npz", head_cfgs, robot_verts=robot)
    out = work / "moving_polylabels.npz"
    _reset_trajectory_counts()
    seconds = _movelabel(["--data_in", str(src), "--data_out", str(out), "--seed", "7"])
    counts = _trajectory_counts()
    if counts["14"] <= 0 or counts["13"] or counts["15"]:
        raise RuntimeError(f"k-gon movelabel launched {counts}")
    result["launches"] = counts["14"]
    full = _labels(out)
    _check_labels("k-gon movelabel", full, TRAJ_ROWS, 4_000_000)
    if not np.array_equal(full[0], cp_model):
        raise RuntimeError("movelabel and PolygonCollisionProbabilityModel.label "
                           "labeled the same rows differently")
    _line("17 movelabel k-gon", time.monotonic() - t, rows=TRAJ_ROWS, k=POLY_K,
          motion="translation", call_s=f"{seconds:.3f}",
          configs_per_s=f"{TRAJ_ROWS / seconds:.1f}",
          model_label_configs_per_s=f"{TRAJ_ROWS / model_s:.1f}",
          mean_samples_per_config=f"{full[1].mean():.1f}",
          converged_share=f"{full[2].mean():.4f}", zero_share=f"{(full[0] == 0).mean():.4f}",
          mean_cp=f"{full[0].mean():.4f}", kernel14_launches=counts["14"])
    t = time.monotonic()
    bar = _relabel_bar("k-gon movelabel", full[0], full[1], head,
                       work / "moving_polys_seed8.npz")
    pruned_share = _prune_check("k-gon movelabel", head_cfgs, robot, full, head,
                                work / "moving_polys_pruned.npz")
    _line("17 movelabel k-gon check", time.monotonic() - t, rows=TRAJ_HEAD, **bar,
          pruned_share=pruned_share, kept_rows_bitwise_equal=True)

    # rotating k-gons: the threefry cascade
    t = time.monotonic()
    rot = _rotating_kgons(ROT_KGON_ROWS)
    rot_src = _save_npz(work / "moving_polys_rot.npz", rot, robot_verts=robot)
    rot_out = work / "moving_polylabels_rot.npz"
    _reset_trajectory_counts()
    rot_s = _movelabel(["--data_in", str(rot_src), "--data_out", str(rot_out), "--seed",
                        "7", "--max_samples", str(ROT_KGON_CAP)])
    counts = _trajectory_counts()
    labels = _labels(rot_out)
    _check_labels("rotating k-gon movelabel", labels, ROT_KGON_ROWS, ROT_KGON_CAP)
    _line("17 movelabel k-gon rotating", time.monotonic() - t, rows=ROT_KGON_ROWS, k=6,
          cap=ROT_KGON_CAP, call_s=f"{rot_s:.3f}",
          configs_per_s=f"{ROT_KGON_ROWS / rot_s:.1f}",
          mean_samples_per_config=f"{labels[1].mean():.1f}",
          converged_share=f"{labels[2].mean():.4f}", mean_cp=f"{labels[0].mean():.4f}",
          kernel_launches="/".join(f"{k}:{v}" for k, v in counts.items()))
    return result


def phase_screen() -> dict:
    """Phase 18: kernel 15 against its plain version at the JAX bench's
    step (8,192 rotating rows x 512 lanes); returns its entry of the kernels
    line."""
    from collide2d_tpu_torch.ops import screen_cuda

    t = time.monotonic()
    c, s = ROT_ROWS, SCREEN_LANES
    params = screen_cuda.pack_screen_params(_moving_rects(c, rotating=True), ROBOT_WH)
    z = torch.randn((c, s, 5), generator=torch.Generator(device="cuda").manual_seed(18),
                    device="cuda")
    flags, t0 = screen_cuda.rotating_screen(z, params)
    want_f, want_t = screen_cuda.rotating_screen_plain(z, params)
    torch.cuda.synchronize()
    agree = flags == want_f
    differ = int((~agree).sum())
    t0_err = float((t0[agree] - want_t[agree]).abs().max())
    if differ > MISMATCH_BOUND * c * s or t0_err != 0.0:
        raise RuntimeError(f"kernel 15: {differ} flags differ from the plain version, "
                           f"t0 by {t0_err} where they agree")
    ms, plain_ms = _compare(lambda: screen_cuda.rotating_screen(z, params),
                            lambda: screen_cuda.rotating_screen_plain(z, params))
    ops = c * s * (SCREEN_LANE_OPS + TOI_WINDOW_OPS + 8 * SCREEN_SEG_OPS)
    bound, bound_by = _bound_ms(28 * c * s, ops)
    shares = {f"share_bit{b}": f"{float(((want_f >> b) & 1).float().mean()):.4f}"
              for b in range(3)}
    ambiguous = ((want_f & 1) != 0) & ((want_f & 2) == 0)
    _line("18 screen", time.monotonic() - t, C=c, S=s, flags_differ=differ,
          bitwise_equal=bool(torch.equal(flags, want_f) and torch.equal(t0, want_t)),
          ambiguous_share=f"{float(ambiguous.float().mean()):.4f}", **shares,
          kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.3f}", bound_ms=f"{bound:.4f}",
          bound_by=bound_by, kernel_lanes_per_s=f"{c * s / ms * 1e3:.4e}",
          kernel_gb_per_s=f"{28 * c * s / (ms * 1e-3) / 1e9:.1f}")
    # one threefry step of the rotating cascade, whole and in parts
    from collide2d_tpu_torch.mc import moving, prng

    configs = _moving_rects(c, rotating=True)
    keys = prng.fold_in_many(prng.PRNGKey(3), torch.arange(c, dtype=torch.int32,
                                                           device="cuda"))
    draws_ms = _host_ms(lambda: prng.normal(keys, (s, 5)), 3)
    step_ms = {impl: _host_ms(lambda: moving.counts_chunk_moving(
        keys, configs, ROBOT_WH, s, screen_impl=impl), 3) for impl in ("cuda", "torch")}
    _, (_, _, amb) = moving.counts_chunk_moving(keys, configs, ROBOT_WH, s,
                                                return_screen_masks=True)
    _line("18 cascade step", time.monotonic() - t, C=c, S=s,
          draws_ms=f"{draws_ms:.3f}", step_ms_kernel15=f"{step_ms['cuda']:.3f}",
          step_ms_torch_screen=f"{step_ms['torch']:.3f}",
          rest_ms=f"{step_ms['cuda'] - draws_ms - ms:.3f}",
          ambiguous_lane_share=f"{float(amb.float().mean()):.4f}",
          ambiguous_row_share=f"{float(amb.any(dim=1).float().mean()):.4f}",
          step_samples_per_s=f"{c * s / step_ms['cuda'] * 1e3:.4e}")
    flag_err = int((flags - want_f).abs().max())
    return dict(max_abs_err=float(max(flag_err, t0_err)), ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=bound_by)


RAYS, RAY_SHAPES, RAY_K = 1 << 22, 64, 8
# FP32 operations written in csrc/raycast_kernel.cu. A (ray, face): no and
# nd 6, num 1, the divisor's test and select 2, the division 1, the parallel
# test 2, lo and hi 6, the entry's test and 3 selects 4, the exit's min 1.
# A (ray, shape): the hit's 4 tests, the inside test, max and select 2, the
# argmin's test and 5 updates. `bound_ms` counts the IEEE division as one
# operation, as the other query kernels count theirs; the secondary
# `bound_ms_div_sass` counts it at the RAYCAST_DIV_SASS instructions of its
# fast path in the SASS (MUFU.RCP, FCHK and the FFMA refinement,
# `cuobjdump -sass` of the built library). A ray moves 32 bytes: origin and
# direction in (16), t, index and normal out (16).
RAYCAST_FACE_OPS, RAYCAST_SHAPE_OPS, RAYCAST_DIV_SASS = 23, 13, 7
RAYCAST_RAY_BYTES = 32
RAYCAST_PALLAS_FACE_OPS = 16  # the Pallas cost estimate (raycast_pallas.py:138)
SCENE_N, SCENE_CAPACITY = 2048, 16_384
# The most face ties whose manifold may choose other faces than
# ops.manifold: the larger of a handful and 5% of the ties.
TIE_OTHER_FACES_MIN, TIE_OTHER_FACES_SHARE = 3, 0.05
SWEPT_N, SWEPT_WINDOW = 32_768, 128


def raycast_ops(rays: int, shapes: int, kp: int, div_ops: int = 1) -> int:
    return rays * shapes * (kp * (RAYCAST_FACE_OPS - 1 + div_ops) + RAYCAST_SHAPE_OPS)


def _ray_agreement(got, want):
    """(rays whose t, index or normal differ, largest |difference| of t and
    normal where both hit)."""
    t, idx, nrm = got
    w_t, w_idx, w_nrm = want
    differ = (t != w_t) | (idx != w_idx) | (nrm != w_nrm).any(-1)
    both = torch.isfinite(t) & torch.isfinite(w_t)
    err = max(float((t - w_t)[both].abs().max()) if bool(both.any()) else 0.0,
              float((nrm - w_nrm).abs().max()))
    return int(differ.sum()), err


def phase_raycast() -> dict:
    """Phase 19: kernel 11 on `scene_raycast(impl='auto')` and against its
    plain version; returns its entry of the kernels line."""
    from collide2d_tpu_torch.ops import raycast, raycast_cuda

    t = time.monotonic()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(19)
    # the JAX bench (utils/benchmarks.py:1963-1976): 64 regular 8-gons in a
    # 40-side box, origins U(-50, 50)^2, directions standard normal
    polys = _bench_polygons(g, RAY_SHAPES, RAY_K, area_side=40.0)
    origin = torch.rand((RAYS, 2), generator=g, device=dev) * 100.0 - 50.0
    direction = torch.randn((RAYS, 2), generator=g, device=dev)
    raycast_cuda.reset_launches()
    main_out = raycast.scene_raycast(origin, direction, polys)
    one = raycast.scene_raycast(origin[7], direction[7], polys)
    torch.cuda.synchronize()
    launches = raycast_cuda.LAUNCHES
    if launches < 2:
        raise RuntimeError(f"scene_raycast launched kernel 11 {launches} times for 2 calls")
    if not (one[0] == main_out[0][7] and one[1] == main_out[1][7]):
        raise RuntimeError("a single ray differs from the same ray in the batch")
    _line("19 scene_raycast", time.monotonic() - t, rays=RAYS, shapes=RAY_SHAPES,
          k=RAY_K, launches=launches,
          hit_share=f"{float(torch.isfinite(main_out[0]).float().mean()):.4f}")
    del main_out

    result = {"launches": launches, "max_abs_err": 0.0}
    g2 = torch.Generator(device=dev).manual_seed(20)
    big = _bench_polygons(g2, 4096, RAY_K, area_side=320.0)
    mixed = _bench_polygons(g2, 1000, RAY_K, area_side=40.0)
    mask = torch.arange(RAY_K, device=dev)[None] < torch.randint(
        3, RAY_K + 1, (1000, 1), generator=g2, device=dev)
    mixed = torch.where(mask[..., None], mixed, 1e3)  # garbage padding, masked out
    r16 = 1 << 16
    o16 = torch.rand((r16, 2), generator=g2, device=dev) * 340.0 - 10.0
    d16 = torch.randn((r16, 2), generator=g2, device=dev)
    # (case, table, origin, direction, t_max, tile_shapes)
    cases = (("bench", raycast_cuda.pack_scene_tables(polys), origin, direction, math.inf, 0),
             ("bench_tmax4", None, origin, direction, 4.0, 0),
             ("tiled_4096", raycast_cuda.pack_scene_tables(big), o16, d16, math.inf, 0),
             ("tiled_4096_tile61", None, o16, d16, math.inf, 61),
             ("mixed_k_mask", raycast_cuda.pack_scene_tables(mixed, mask), origin[:r16],
              direction[:r16], math.inf, 0))
    table, first_tile = None, None
    for tag, tab, o, d, t_max, tile in cases:
        t = time.monotonic()
        table = table if tab is None else tab
        got = raycast_cuda.scene_raycast_cuda_t(o, d, table, t_max=t_max, tile_shapes=tile)
        want = raycast_cuda.scene_raycast_plain(o, d, table, t_max=t_max)
        torch.cuda.synchronize()
        differ, err = _ray_agreement(got, want)
        r = o.shape[0]
        if differ > 1e-5 * r:
            raise RuntimeError(f"scene_raycast ({tag}): {differ} rays differ from the "
                               f"plain version (max |d| {err})")
        if tag == "tiled_4096":
            first_tile = got
        if tag == "tiled_4096_tile61" and not all(map(torch.equal, got, first_tile)):
            raise RuntimeError("kernel 11 depends on its shared-memory tile size")
        result["max_abs_err"] = max(result["max_abs_err"], err)
        fields = dict(case=tag, rays=r, shapes=table.shape[0], faces=table.shape[1],
                      t_max=t_max, rays_differ=differ, max_abs_diff=f"{err:.3e}",
                      bitwise_equal=all(map(torch.equal, got, want)),
                      hit_share=f"{float(torch.isfinite(want[0]).float().mean()):.4f}")
        if tag in ("bench", "tiled_4096"):
            ms, plain_ms = _compare(
                lambda: raycast_cuda.scene_raycast_cuda_t(o, d, table, t_max=t_max),
                lambda: raycast_cuda.scene_raycast_plain(o, d, table, t_max=t_max))
            shapes, kp = table.shape[0], table.shape[1]
            nbytes = RAYCAST_RAY_BYTES * r
            bound, bound_by = _bound_ms(nbytes, raycast_ops(r, shapes, kp))
            div_sass = _bound_ms(nbytes, raycast_ops(r, shapes, kp, RAYCAST_DIV_SASS))[0]
            pallas = _bound_ms(nbytes, RAYCAST_PALLAS_FACE_OPS * r * shapes * kp)[0]
            fields.update(
                kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.3f}", bound_ms=f"{bound:.4f}",
                bound_by=bound_by, share_of_bound=f"{bound / ms:.3f}",
                bound_ms_div_sass=f"{div_sass:.4f}",
                bound_ms_pallas_estimate=f"{pallas:.4f}",
                kernel_rays_per_s=f"{r / ms * 1e3:.4e}",
                plain_rays_per_s=f"{r / plain_ms * 1e3:.4e}")
            if tag == "bench":
                result.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by)
        _line("19 scene_raycast kernel", time.monotonic() - t, **fields)
        del got, want
    return result


def _scene_manifold_check(tag: str, man, polys) -> dict:
    """The manifolds of a scene call on its listed pairs, against kernel
    10's plain version (counts differ on at most 1e-5 of the pairs, values
    within 1e-5; bitwise expected) and against `ops.manifold` on the same
    card tensors, with face ties allowed: a pair whose two best face
    separations (over both bodies) lie within 16 ulps of its largest
    |coordinate| may choose another reference face (its count or normal
    then differs); every other pair has the same count, the normal within
    1e-5 and points and depths within 1e-5 of max(1, that coordinate). The
    two round the unit normal differently, and at the swept scene's
    coordinates of up to 2,560 an ulp is 2.4e-4. Rounding moves a tie's
    choice now and then, never most of them: more than
    `TIE_OTHER_FACES_MIN` or `TIE_OTHER_FACES_SHARE` of the ties choosing
    other faces fails."""
    from collide2d_tpu_torch.ops import manifold_cuda, polygon_cuda
    from collide2d_tpu_torch.ops.distance_cuda import pad_pairs
    from collide2d_tpu_torch.ops.manifold import _face_separations, polygon_contact_manifold

    pairs, count = man[0], int(man[1])
    got = tuple(a[:count] for a in man[2:6])
    p1 = polys.index_select(0, pairs[:count, 0].long())
    p2 = polys.index_select(0, pairs[:count, 1].long())
    a, b = pad_pairs(p1, p2, 8 * polygon_cuda.LANE_BLOCK)
    plain = manifold_cuda.unpack_manifold(manifold_cuda.polygon_manifold_plain(
        polygon_cuda.pack_polygons(a), polygon_cuda.pack_polygons(b), 8, 8), count)
    differ_plain, err_plain = _manifold_diff(got, plain)

    scale = torch.maximum(p1.abs().amax((1, 2)), p2.abs().amax((1, 2))).clamp(min=1.0)
    seps = torch.cat([_face_separations(p1, p2)[0], _face_separations(p2, p1)[0]], -1)
    top = seps.topk(2, dim=-1).values
    tie = top[:, 0] - top[:, 1] <= 16 * scale * 2.0 ** -23
    want = polygon_contact_manifold(p1, p2)
    other = (got[0] != want[0]) | ((got[3] - want[3]).abs().amax(-1) > 1e-5)
    keep = ~other
    valid = (torch.arange(2, device=polys.device)[None] < want[0][:, None]) & keep[:, None]
    rel = torch.cat([((got[1] - want[1]).abs().amax(-1) / scale[:, None])[valid],
                     ((got[2] - want[2]).abs() / scale[:, None])[valid]])
    untied, err = int((other & ~tie).sum()), float(rel.max()) if rel.numel() else 0.0
    ties, at_ties = int(tie.sum()), int((other & tie).sum())
    if differ_plain > 1e-5 * count or err_plain > 1e-5 or untied or err > 1e-5:
        raise RuntimeError(f"{tag}: manifold counts differ on {differ_plain} pairs from kernel "
                           f"10's plain version (values by {err_plain}); {untied} pairs "
                           f"without a face tie chose other faces than ops.manifold, values "
                           f"differ by {err} of their scale")
    if at_ties > max(TIE_OTHER_FACES_MIN, TIE_OTHER_FACES_SHARE * ties):
        raise RuntimeError(f"{tag}: {at_ties} of {ties} face ties chose other faces than "
                           f"ops.manifold: a face choice that rounding does not explain")
    if count and not bool((got[0] > 0).all()):
        raise RuntimeError(f"{tag}: a listed pair has no contact point")
    return dict(manifold_counts_differ_plain=differ_plain,
                manifold_max_abs_diff_plain=f"{err_plain:.3e}",
                manifold_face_ties=ties,
                manifold_tie_share=f"{ties / max(count, 1):.4f}",
                manifold_other_faces_at_ties_torch=at_ties,
                manifold_max_rel_diff_torch=f"{err:.3e}")


def _scene_counts():
    from collide2d_tpu_torch.ops import manifold_cuda, polygon_cuda

    torch.cuda.synchronize()
    return polygon_cuda.LAUNCHES, manifold_cuda.LAUNCHES


def _reset_scene_counts() -> None:
    from collide2d_tpu_torch.ops import manifold_cuda, polygon_cuda

    polygon_cuda.reset_launches()
    manifold_cuda.reset_launches()


def phase_scene_dense() -> None:
    """Phase 20: the dense scene queries at `bench_scene`'s shape."""
    from collide2d_tpu_torch.ops import scene
    from collide2d_tpu_torch.ops.sat import sat_polygons

    t = time.monotonic()
    n = SCENE_N
    g = torch.Generator(device="cuda").manual_seed(21)
    polys = _bench_polygons(g, n, 8, area_side=40.0)  # utils/benchmarks.py:1837-1844
    _reset_scene_counts()
    m = scene.scene_collision_matrix(polys, row_tile=64)
    pairs, count, overflow = scene.scene_colliding_pairs(polys, capacity=SCENE_CAPACITY)
    man = scene.scene_contact_manifolds(polys, capacity=SCENE_CAPACITY)
    k6, k10 = _scene_counts()
    if k6 <= 0 or k10 <= 0:
        raise RuntimeError(f"the dense scene path launched kernel 6 {k6} and kernel 10 "
                           f"{k10} times")
    eye = torch.eye(n, dtype=torch.bool, device="cuda")
    want = (sat_polygons(polys[:, None], polys[None]) == 1) & ~eye
    if not (torch.equal(m, want) and torch.equal(m, m.T)) or bool(m.diagonal().any()):
        raise RuntimeError(f"the matrix differs from sat_polygons on {int((m != want).sum())} "
                           "pairs, or is not symmetric with a false diagonal")
    want_pairs = torch.triu(m, 1).nonzero().to(torch.int32)
    c = int(count)
    if bool(overflow) or c != len(want_pairs) or not torch.equal(pairs[:c], want_pairs) \
            or bool(pairs[c:].any()):
        raise RuntimeError(f"scene_colliding_pairs: count {c}, {len(want_pairs)} in the matrix")
    if not (torch.equal(man[0], pairs) and int(man[1]) == c):
        raise RuntimeError("scene_contact_manifolds listed other pairs")
    man_fields = _scene_manifold_check("dense manifolds", man, polys)
    ms = {"matrix": _events_ms(lambda: scene.scene_collision_matrix(polys), 5),
          "pairs": _events_ms(lambda: scene.scene_colliding_pairs(
              polys, capacity=SCENE_CAPACITY), 5),
          "manifolds": _events_ms(lambda: scene.scene_contact_manifolds(
              polys, capacity=SCENE_CAPACITY), 5)}
    _, kernels, busy_us, k6_us = _profiled(lambda: scene.scene_collision_matrix(polys),
                                           kernel="polygon_sat_kernel")
    prof = {} if busy_us is None else dict(
        matrix_device_kernels=kernels, matrix_busy_ms=f"{busy_us / 1e3:.3f}",
        kernel6_share_of_busy=f"{k6_us / busy_us:.4f}",
        kernel6_share_of_call=f"{k6_us / 1e3 / ms['matrix']:.4f}")
    _line("20 dense scene", time.monotonic() - t, shapes=n, k=8, row_tile=64,
          kernel6_launches=k6, kernel10_launches=k10, colliding_pairs=c,
          matrix_equal_sat_polygons=True, **man_fields,
          **{f"{k}_ms": f"{v:.3f}" for k, v in ms.items()},
          matrix_pairs_per_s=f"{n * n / ms['matrix'] * 1e3:.4e}", **prof)


def phase_scene_swept() -> None:
    """Phase 21: the swept query at `bench_scene_swept`'s shape."""
    from collide2d_tpu_torch.ops import scene

    t = time.monotonic()
    n, w = SWEPT_N, SWEPT_WINDOW
    side = max(40.0, n * 4.0 / (w / 2.5))  # utils/benchmarks.py:1871-1886
    g = torch.Generator(device="cuda").manual_seed(22)
    polys = _bench_polygons(g, n, 8, area_side=side)
    _reset_scene_counts()
    pairs, count, overflow, exceeded = scene.scene_colliding_pairs_swept(
        polys, capacity=SCENE_CAPACITY, window=w)
    man = scene.scene_contact_manifolds(polys, capacity=SCENE_CAPACITY,
                                        broad_phase="swept", window=w)
    k6, k10 = _scene_counts()
    if k6 <= 0 or k10 <= 0:
        raise RuntimeError(f"the swept scene path launched kernel 6 {k6} and kernel 10 "
                           f"{k10} times")
    if bool(exceeded) or bool(overflow):
        raise RuntimeError(f"window_exceeded {bool(exceeded)}, overflow {bool(overflow)}")
    dense = scene.scene_colliding_pairs(polys, capacity=SCENE_CAPACITY, row_tile=256)
    if not (torch.equal(pairs, dense[0]) and int(count) == int(dense[1])):
        raise RuntimeError(f"the swept pairs ({int(count)}) differ from the dense "
                           f"query's ({int(dense[1])})")
    if not (torch.equal(man[0], pairs) and int(man[1]) == int(count)) or bool(man[6]):
        raise RuntimeError("the swept manifolds listed other pairs")
    man_fields = _scene_manifold_check("swept manifolds", man, polys)
    narrow = scene.scene_contact_manifolds(polys, capacity=SCENE_CAPACITY,
                                           broad_phase="swept", window=4)
    if not (bool(narrow[6]) and int(narrow[1]) == 0 and not bool(narrow[0].any())):
        raise RuntimeError("a window of 4 did not fail closed")
    ms = _events_ms(lambda: scene.scene_colliding_pairs_swept(
        polys, capacity=SCENE_CAPACITY, window=w), 5)
    dense_ms = _events_ms(lambda: scene.scene_colliding_pairs(
        polys, capacity=SCENE_CAPACITY, row_tile=256), 1)
    _line("21 swept scene", time.monotonic() - t, shapes=n, k=8, window=w,
          area_side=side, kernel6_launches=k6, kernel10_launches=k10,
          colliding_pairs=int(count), window_exceeded=False, equal_dense=True,
          window4_fails_closed=True, **man_fields, swept_ms=f"{ms:.3f}",
          dense_ms=f"{dense_ms:.3f}",
          dense_equivalent_pairs_per_s=f"{n * n / ms * 1e3:.4e}",
          narrow_pairs_per_s=f"{n * w / ms * 1e3:.4e}")


# ---- phase 22: the bench entry points and kernel 16 ----


STREAM_PAIRS = 1 << 23


def _bench_counts() -> dict:
    """Launches of the kernels the bench legs run (kernel number: count)."""
    from collide2d_tpu_torch.ops import (manifold_cuda, mc_cuda, mc_polygon_cuda,
                                         polygon_cuda, raycast_cuda, sat_cuda,
                                         stream_cuda)

    torch.cuda.synchronize()
    return {"1": mc_cuda.LAUNCHES, "3": sat_cuda.LAUNCHES["sat_count"],
            "6": polygon_cuda.LAUNCHES, "7": mc_polygon_cuda.LAUNCHES,
            "10": manifold_cuda.LAUNCHES, "11": raycast_cuda.LAUNCHES,
            "16": stream_cuda.LAUNCHES}


def _reset_bench_counts() -> None:
    from collide2d_tpu_torch.ops import (manifold_cuda, mc_cuda, mc_polygon_cuda,
                                         polygon_cuda, raycast_cuda, sat_cuda,
                                         stream_cuda)

    for mod in (manifold_cuda, mc_cuda, mc_polygon_cuda, polygon_cuda,
                raycast_cuda, sat_cuda, stream_cuda):
        mod.reset_launches()


def phase_bench() -> dict:
    """Phase 22: the bench headline and `run_all` on the card, then kernel
    16 against its plain version; returns kernel 16's entry of the kernels
    line."""
    from collide2d_tpu_torch import bench
    from collide2d_tpu_torch.ops import sat_cuda, stream_cuda
    from collide2d_tpu_torch.utils import benchmarks as bm

    t = time.monotonic()
    probes = []
    _reset_bench_counts()
    head = bench.headline(log=probes.append)
    for probe in probes:
        _line("22 bench probe", time.monotonic() - t, **{
            k: probe[k] for k in ("metric", "value", "seconds_per_iter", "bytes")})
    _line("22 bench headline", time.monotonic() - t, **head)
    if head["bandwidth_check"] != "ok" or not 0 < head["effective_gbps"] < math.inf:
        raise RuntimeError(f"bench headline: {head}")
    t = time.monotonic()
    legs = [json.loads(line) for line in bm.run_all(device="cuda")]
    counts = _bench_counts()
    for leg in legs:
        print("[22 run_all] " + json.dumps(leg), flush=True)
        if leg["metric"] == "learned_train":
            continue
        if not 0 < leg["value"] < math.inf:
            raise RuntimeError(f"run_all leg {leg['metric']}: value {leg['value']}")
    swept = next(leg for leg in legs if leg["metric"] == "scene_swept_pairs_per_sec_effective")
    if swept["window_exceeded"] or swept["capacity_overflow"]:
        raise RuntimeError(f"bench_scene_swept lost its certificate: {swept}")
    _line("22 run_all", time.monotonic() - t, legs=len(legs),
          launches=",".join(f"{k}:{v}" for k, v in counts.items()))
    if min(counts.values()) <= 0:
        raise RuntimeError(f"a kernel of the bench path was never launched: {counts}")

    t = time.monotonic()
    r1, r2 = bm._random_pairs(STREAM_PAIRS, device="cuda")
    r1t, r2t = sat_cuda.pack_rects(r1), sat_cuda.pack_rects(r2)
    del r1, r2
    s = bm._stream_scale(7)
    got = stream_cuda.stream_sum(r1t, r2t, s)
    again = stream_cuda.stream_sum(r1t, r2t, s)
    want = stream_cuda.stream_sum_plain(r1t, r2t, s)
    torch.cuda.synchronize()
    err = abs(float(got) - float(want))
    tol = 1e-5 * float(r1t.double().abs().sum() * s + r2t.double().abs().sum())
    if err > tol or not torch.equal(got, again):
        raise RuntimeError(f"stream_sum: {float(got)} / {float(again)} against the plain "
                           f"version's {float(want)} (|d| {err}, bound {tol})")
    ms, plain_ms = _compare(lambda: stream_cuda.stream_sum(r1t, r2t, s),
                            lambda: stream_cuda.stream_sum_plain(r1t, r2t, s))
    library_ms = _events_ms(lambda: r1t.sum() * s + r2t.sum(), reps=20)
    nbytes = stream_cuda.bytes_read(r1t, r2t) + 4
    bound, bound_by = _bound_ms(nbytes, 2 * r1t.numel() + 2)
    gbps = (nbytes - 4) / (ms * 1e-3) / 1e9
    _line("22 stream kernel", time.monotonic() - t, pairs=STREAM_PAIRS, value=float(got),
          plain_value=float(want), abs_diff=f"{err:.3e}", bound_abs_diff=f"{tol:.3e}",
          kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
          bound_ms=f"{bound:.4f}", bound_by=bound_by, share_of_bound=f"{bound / ms:.3f}",
          kernel_gb_per_s=f"{gbps:.1f}", share_of_3_35_tb_s=f"{gbps / 3350:.3f}",
          library_gb_per_s=f"{(nbytes - 4) / (library_ms * 1e-3) / 1e9:.1f}")
    return {"launches": counts["16"], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": library_ms}


# ---- kernels 1, 7, 13 and 14: the counts' fingerprint and the issue floor ----


def _fingerprint(counts: torch.Tensor) -> tuple[int, int]:
    """(sum of the counts, sum of counts[c] * (c % 9973)): equal fingerprints
    on the same inputs say the bits held."""
    c = counts.to(torch.int64)
    weight = torch.arange(c.shape[0], device=c.device, dtype=torch.int64) % 9973
    return int(c.sum()), int((c * weight).sum())


_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def _shortest_iteration(ins: list, start: int, end: int) -> tuple[int, int]:
    """(instructions, LDS) on the shortest path through one iteration of the
    loop whose body is [start, end] (``end``: its backward branch): every
    conditional forward branch may go either way, nested loops run no
    second time, calls cost their one instruction. The fewest instructions a
    warp can issue for one iteration."""
    body = [x for x in ins if start <= x[0] <= end]
    addrs = [x[0] for x in body]
    best = [None] * len(body)
    best[0] = (0, 0)
    for i, (addr, pred, op, args) in enumerate(body):
        if best[i] is None:
            continue
        here = (best[i][0] + 1, best[i][1] + op.startswith("LDS"))
        if addr == end:
            return here
        succ = []
        if op.startswith("BRA"):
            target = re.search(r"0x([0-9a-f]+)", args)
            t = int(target.group(1), 16) if target else None
            if t is not None and addr < t <= end:
                succ.append(next(j for j, a in enumerate(addrs) if a >= t))
            # BRA.DIV / BRA.CONV branch only when the warp has diverged
            if pred or op != "BRA":
                succ.append(i + 1)
        elif not op.startswith(("EXIT", "RET")) or pred:
            succ.append(i + 1)
        for j in succ:
            if best[j] is None or here < best[j]:
                best[j] = here
    raise RuntimeError("no path through the loop")


def sass_loops(lib: Path, kernel: str) -> dict:
    """The SASS of the kernel whose mangled name holds ``kernel`` in the
    library (``cuobjdump -sass``): its instruction and ``LDS`` counts; for
    each backward branch (a loop), the instructions, ``LDS`` and ``CALL`` in
    its body, innermost first; and the shortest path through one iteration
    of the largest loop (`_shortest_iteration`). ``NOP`` padding is not
    counted."""
    from collide2d_tpu_torch.utils import cuda_build

    tool = Path(cuda_build.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    body = next(part for part in text.split("Function : ")[1:]
                if kernel in part.split("\n", 1)[0])
    ins = [(int(a, 16), pred.strip(), op, args)
           for a, pred, op, args in _SASS_LINE.findall(body) if op != "NOP"]

    def count(lo, hi):
        ops = [op for a, _, op, _ in ins if lo <= a <= hi]
        return dict(instructions=len(ops), lds=sum(op.startswith("LDS") for op in ops),
                    calls=sum(op.startswith("CALL") for op in ops))

    loops = []  # a loop closes with a predicated backward branch; an
    # unpredicated one returns from out-of-line code (a divergent vote)
    for a, pred, op, args in ins:
        target = re.search(r"0x([0-9a-f]+)", args) if op == "BRA" and pred else None
        if target and int(target.group(1), 16) < a:
            loops.append(dict(start=int(target.group(1), 16), end=a,
                              **count(int(target.group(1), 16), a)))
    loops.sort(key=lambda x: x["instructions"])
    main = loops[-1]
    return dict(text=body, loops=loops,
                shortest=_shortest_iteration(ins, main["start"], main["end"]),
                **count(0, 1 << 62))


def _sm_clock_hz() -> tuple[float, float]:
    """(the SM clock now, its maximum), in Hz, as nvidia-smi reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    now, top = (float(x) * 1e6 for x in out.splitlines()[0].split(","))
    return now, top


def issue_floor(name: str, defines, kernel: str, batch_fn: str, samples: int) -> dict:
    """A fused Monte Carlo kernel's issue floor for ``samples`` samples
    (kernels 1, 7, 13, 14): the shortest path through one iteration of the
    sample loop of the instantiation whose mangled name holds ``kernel``
    (the one these samples run: 32-bit indices; kernel 13's window loop,
    with no advancement loop in the function) over the S samples an iteration
    evaluates (``batch_fn``), SASS instructions a sample, times the samples,
    over 132 SMs x 128 lanes x the SM clock's maximum; beside it the static
    SASS and LDS of the loop a sample."""
    from collide2d_tpu_torch.utils import cuda_build

    lib = cuda_build.build(name, defines)
    batch = getattr(cuda_build.load(name, defines), batch_fn)()
    sass = sass_loops(lib, kernel)
    per_sample, lds = (x / batch for x in sass["shortest"])
    now, top = _sm_clock_hz()
    return dict(sass_per_sample=per_sample, lds_per_sample=lds,
                static_sass_per_sample=sass["loops"][-1]["instructions"] / batch,
                issue_floor_ms=per_sample * samples / (132 * 128 * top) * 1e3,
                sm_clock_mhz=now / 1e6, sm_clock_max_mhz=top / 1e6)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    t0 = time.monotonic()
    card = _card()
    print(f"[1 card] {card}", flush=True)
    if not (HERE / "collide2d_tpu_torch" / "__init__.py").is_file():
        raise SystemExit("chip_smoke: run it from a checkout of the repository")
    sys.path.insert(0, str(HERE))
    import collide2d_tpu_torch

    if Path(collide2d_tpu_torch.__file__).resolve().parent != HERE / "collide2d_tpu_torch":
        raise SystemExit("chip_smoke: imported collide2d_tpu_torch from outside this checkout")
    phase_build()
    check = phase_kernel_vs_plain()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        work = Path(tmp)
        launches = phase_main_path(work)
        phase_acceptance(work)
        phase_invariance(work)
        sat = phase_sat()
        phase_relabel(work)
        phase_prune_opt(work)
        poly_sat = phase_polygon_sat()
        poly_mc = phase_mc_polygon()
        poly_mc["launches"] = phase_polylabel(work)
    queries = phase_distance()
    queries["polygon_manifold"] = phase_manifold()
    queries["moving_obb_toi"] = phase_toi()
    mc_toi = phase_mc_toi()
    rotating = mc_toi.pop("rotating")
    _line("15 mc_toi steps", 0.0, rotating_mean_steps=f"{rotating['mean_steps']:.2f}",
          rotating_warp_max_steps=f"{rotating['warp_max_steps']:.2f}",
          rotating_kernel_ms=f"{rotating['ms']:.4f}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        traj_launches = phase_movelabel_rects(Path(tmp))
        moving_poly = phase_mc_moving_polygon(Path(tmp))
    screen = phase_screen()
    raycast = phase_raycast()
    phase_scene_dense()
    phase_scene_swept()
    stream = phase_bench()
    mc_toi["launches"] = traj_launches["13"]
    screen["launches"] = traj_launches["15"]
    default = check["default"]
    kernels = {"kernels": [{
        "name": "mc_counts",
        "route": "cuda",
        "source": "collide2d_tpu_torch/csrc/mc_kernel.cu",
        "replaces": "collide2d_tpu/ops/mc_pallas.py:207",
        "launches": launches,
        "max_abs_err": max(check[k]["max_abs_err"] for k in check),
        "ms": default["kernel_ms"],
        "plain_ms": default["plain_ms"],
        "bound_ms": default["bound_ms"],
        "bound_by": default["bound_by"],
        "issue_floor_ms": default["issue_floor_ms"],
        "library_ms": None,
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "collide2d_tpu_torch/csrc/sat_kernel.cu",
        "replaces": f"collide2d_tpu/ops/sat_pallas.py:{line}",
        **sat[name],
        **dict(zip(("bound_ms", "bound_by"), _bound_ms(
            SAT_BYTES[name] * SAT_PAIRS, SAT_OPS[name] * SAT_PAIRS))),
        "library_ms": None,
    } for name, line in (("sat_label", 96), ("sat_count", 100),
                         ("obb_label", 268), ("obb_count", 303))] + [{
        "name": "sat_polygons",
        "route": "cuda",
        "source": "collide2d_tpu_torch/csrc/polygon_kernel.cu",
        "replaces": "collide2d_tpu/ops/polygon_pallas.py:92",
        **poly_sat,
        "library_ms": None,
    }, {
        "name": "mc_poly_counts",
        "route": "cuda",
        "source": "collide2d_tpu_torch/csrc/mc_polygon_kernel.cu",
        "replaces": "collide2d_tpu/ops/mc_polygon_pallas.py:254",
        **poly_mc,
        "library_ms": None,
    }] + [{
        "name": name,
        "route": "cuda",
        "source": f"collide2d_tpu_torch/csrc/{source}",
        "replaces": f"collide2d_tpu/ops/{replaces}",
        **queries[name],
        "library_ms": None,
    } for name, source, replaces in (
        ("obb_distance", "distance_kernel.cu", "distance_pallas.py:125"),
        ("polygon_distance", "distance_kernel.cu", "distance_pallas.py:229"),
        ("polygon_manifold", "manifold_kernel.cu", "manifold_pallas.py:181"),
        ("moving_obb_toi", "toi_kernel.cu", "toi_pallas.py:81"))] + [{
        "name": name,
        "route": "cuda",
        "source": f"collide2d_tpu_torch/csrc/{source}",
        "replaces": f"collide2d_tpu/ops/{replaces}",
        **entry,
        "library_ms": None,
    } for name, source, replaces, entry in (
        ("mc_toi_counts", "mc_toi_kernel.cu", "mc_toi_pallas.py:170", mc_toi),
        ("mc_moving_poly_counts", "mc_moving_polygon_kernel.cu",
         "mc_moving_polygon_pallas.py:182", moving_poly),
        ("rotating_screen", "screen_kernel.cu", "screen_pallas.py:99", screen),
        ("scene_raycast", "raycast_kernel.cu", "raycast_pallas.py:48", raycast))] + [{
        "name": "stream_sum",
        "route": "cuda",
        "source": "collide2d_tpu_torch/csrc/stream_kernel.cu",
        "replaces": "collide2d_tpu/utils/benchmarks.py:990",
        **stream,
    }]}
    print(f"[done] seconds={time.monotonic() - t0:.1f}", flush=True)
    print(card, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
