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
   csrc/mc_moving_polygon_kernel.cu at k = 8, csrc/screen_kernel.cu at 8
   segments), the scene raycast kernel (csrc/raycast_kernel.cu at 8 faces a
   shape, and its build that counts the faces it evaluates) and the
   streaming-bandwidth probe (csrc/stream_kernel.cu); the query kernels'
   library also in its build that counts kernel 9's passes; the Box-Muller
   builds (-DMC_BOX_MULLER=1) of kernels 1, 7 (k = 8 and 6) and 14 (k = 8),
   and kernel 14 at the bench's k = 6 (phase 17 and the bench); kernel 7 at
   k = 20 (phase 26); and kernels 6, 9 and 10 at the K bucket pairs above 16
   that phases 24 and 25 launch ((4, 32), (4, 64), (32, 32): one library
   each, `polygon_cuda.kernel_defines`), with ptxas's registers and spill
   bytes;
2. the kernel against its plain PyTorch version on the card, same Philox
   stream, C = 100,000 annulus configurations x n = 4096 samples, shape
   noise off and on, and the adaptive tail's 256 rows x 100,000 samples:
   sum |dcount| <= 1e-5 * C * n; samples/s of both, timed with CUDA
   events after a warm-up; the counts' fingerprint (as in phase 10) and
   the kernel's issue floor (below) beside its bound; then on each case the
   kernel's Box-Muller build (`_box_muller_vs_plain`) against its plain
   version at the same bar, its ms beside the erf_inv build's, its bound
   and its counts' fingerprint;
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
8b. mid-run resume on the card: on each fused Monte Carlo kernel's main
   path, at its size (kernel 1: batch 0 of phase 3's ``generate``, 100,000
   rows, reference defaults; kernel 7: phase 11's 100,000 k = 8 rows;
   kernels 13 and 14: phases 16 and 17's 100,000 translation-only
   rectangles and k = 8 rows), an uninterrupted run, the same run with a
   checkpoint every round interrupted from its progress hook once round 3
   is reported, and its resume (`_resume_case`): the resume's first
   progress report lies past the checkpointed samples, the kernel runs in
   it, every output is bitwise the uninterrupted run's (kernel 1's also
   phase 3's batch 0, byte for byte) and the file is gone; the rounds
   before the interrupt, the checkpoint's bytes, the median and largest
   write ms (readback and write) and the label seconds of the three runs;
   then ``generate -n 2 -b 100000 --overlap_batches 2 --checkpoint_every 8
   --resume`` on phase 3's tables: its batches are phase 3's byte for
   byte, no checkpoint is left, and with batch 1 deleted a rerun rewrites
   it byte for byte and leaves batch 0 untouched (beside it the label
   seconds of the same call without checkpoints); and `data.balance` over
   phase 3's batches (no plot);
8c. the learned model on phase 3's 2 x 100,000 rows (nothing generated
   anew): `models.learned.load_training_data` on the card launches kernel
   8 (the signed-distance feature); ``collide2d-torch train --device
   cuda`` at `TrainConfig`'s full width (hidden 256 x 3, batch 8,192,
   bfloat16, 10 epochs) with each epoch's loss, seconds and rows/s; the
   last epoch's loss below 0.8 x the first's, the validation MAE below 0.7
   x the constant-mean predictor's (the JAX test's bar), beside the
   validation BCE and the per-bin MAE; the saved model's cps on the card
   equal the trained one's bit for bit; ``collide2d-torch predict`` on
   batch 1 and `compare_labels` against its Monte Carlo labels (mean |d|,
   share within +-0.01, ``compare``'s exit code printed, not gated);
   `cp_from_configs` at 2^20 configurations of phase 3's tables
   (configs/s); kernel 8's launches on that path > 0. Then featurize's ms
   (host clock, synchronised), kernel 8's ms at its 204,800 padded pairs
   beside its bound, the card's features against their plain versions
   (columns 0-10 and the distance on the card's tensors bit for bit;
   against the CPU's, the distance within 1 ulp and the margin bitwise
   where the distance is, else within 2 ulp), and a full-width epoch
   with the tensor-core product against the float32 product of bfloat16
   operands, and `cp_from_configs` at 2^20 under each (CUDA events, in
   turns a, b, b, a);
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
   the kernel's issue floor (below); the Box-Muller build on both cases as
   in phase 2; then the agreement gate against the threefry path on the
   card (4,096 `example_polygon_configs` rows at k = 6, 65,536 samples
   each; `_z_gate`: max z < 6 and a share with z > 3 of at most 3 x 0.27%),
   and the Box-Muller build's round (`mc_round_polygons_cuda`) against the
   same threefry counts;
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
   k-gons (k = 8, and the model's 4 against 8; `polygon_distance_inputs`)
   against their plain versions: max abs diff <= 2e-5, 0 signs differ
   (bitwise expected); kernel ms (CUDA events, 20 launches after a
   warm-up), plain ms, pairs/s and GB/s; kernel 9's pairs through each of
   its passes (its counting build), the operations it evaluates beside
   the full work's, its issue floor at both (`polygon_distance_issue_
   floor`), and its output's fingerprint and whether it is the parent
   design's (`PARENT_FINGERPRINTS`);
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
   tol 1e-4; `toi_inputs`): hits differ on at most 1e-4 of pairs, t within
   1e-5 where both hit (bitwise expected); the rotating share, mean,
   maximum and warp-maximum advancement steps (the plain version counts
   them), kernel ms, plain ms, queries/s, the issue floor at the
   evaluations the pairs take and at their groups of 32 run to the slowest
   (`toi_issue_floor`), and the output's fingerprint and whether it is the
   parent design's;
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
16b. the mid-run resume of the rotating cascade (stage A on kernel 15)
   at phase 16's 8,192 rows and 10,000 cap, as phase 8b's cases, against
   phase 16's ``movelabel`` run as the uninterrupted one;
17. kernel 14 (translation-only k-gon trajectories) against its plain
   version on 100,000 `example_polygon_configs` k = 8 rows with velocity
   U(-2, 2)^2 and t_max U(0.5, 3) x 4,096 samples (2 kept robot axes):
   sum |dcount| <= 1e-5 of the samples; the fingerprint and issue floor
   as in phase 10; at zero velocity its counts equal kernel 7's bit for
   bit; the Box-Muller build as in phase 2; then the k = 6 instance that
   the bench's legs launch, on the fused leg's 4,096 rows
   (`_bench_moving_polygon_configs`) x 4,096 samples, against its plain
   version at the same bar, its ms beside the k = 8 instance's; the
   agreement gate as in phase 15, and the Box-Muller build's round
   against the same threefry counts;
   `PolygonCollisionProbabilityModel.label` and ``movelabel`` on the
   100,000 rows (kernel-14 launches > 0, the same labels, the checks of
   phase 16); ``movelabel`` on 4,096 rotating k = 6 rows of the JAX bench
   (utils/benchmarks.py:646-677; the threefry cascade, cap 4,000): finite
   cp in [0, 1], configs/s;
18. kernel 15 (stage A of the rotating cascade) against its plain version
   at the JAX bench's step, 8,192 rotating rows x 512 lanes
   (`screen_inputs`): flags differ on at most 1e-5 of lanes, t0 equal
   where they agree (bitwise expected); kernel ms, plain ms, lanes/s, the
   bound and the issue floor (`screen_issue_floor`), and the outputs'
   fingerprint (`output_fingerprint`) and whether it is the parent
   design's (`PARENT_FINGERPRINTS`); then one threefry step of the cascade
   at that shape, whole (kernel 15 or the torch screen) and its draws
   alone (host clock).
19. kernel 11 (scene raycast): ``scene_raycast(impl='auto')`` on the JAX
   bench's scene (utils/benchmarks.py:1963-1976: 2^22 rays, origins
   U(-50, 50)^2, directions standard normal, 64 regular 8-gons in a 40-side
   box) and on a single ray launches it; then the kernel against its plain
   version (`raycast_inputs`) at t_max inf and 4, on 4,096 shapes (past
   one shared-memory tile) x 2^16 rays with the default tile and a
   61-shape tile (equal), and on 1,000 masked mixed-k shapes: t, index or
   normal differ on at most 1e-5 of the rays (bitwise expected), with each
   case's fingerprint and whether it is the parent design's; kernel ms,
   plain ms, rays/s, the bound, the kernel's share of it, the bound by the
   Pallas estimate, the (ray, face) pairs the kernel evaluates (its
   counting build) and its issue floor (`raycast_issue_floor`) at every
   face and at those;
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
   ``run_all(device="cuda")`` (``collide2d-torch bench``; the learned
   model's training leg among them): finite positive values, the swept query's certificate false; kernels 1, 3, 6, 7, 10, 11
   and 16 launched. Then kernel 16 against its plain version on the
   probe's 2^23 pairs: within 1e-5 x (sum|r1| * s + sum|r2|), and two
   launches bitwise equal; kernel ms, plain ms and the library call's ms
   (``r1.sum() * s + r2.sum()``), GB/s and the share of 3.35 TB/s. Then
   the full bench, ``python -m collide2d_tpu_torch.bench`` in a process of
   its own (`phase_full_bench`, every leg of the root bench.py at its
   sizes): exit code 0 with no leg failed, the last line the headline with
   ``bandwidth_check`` ok, the line before it the digest (<= 1,750
   characters, n >= 25), both within the last 2,000 characters of its
   output, the three agreement legs ok, every kernel it runs launched
   (kernel 1's Box-Muller build among them, its A/B leg); each leg's line,
   the digest and the bench's wall seconds.
23. the multi-device path (it runs inside phase 3's directory, between
   phases 11 and 12) over `_mesh_cards`: four logical entries of cuda:0 on
   a one-card machine, every card on a machine with an even number of
   them. ``generate`` at phase 3's settings, one batch, on the (n, 1) mesh
   that ``--data_parallel`` builds and on the (n/2, 2) mesh
   (``GenerateConfig(mesh=...)``), in turns with the unsharded call: batch
   0 is phase 3's byte for byte every time (label seconds and configs/s of
   each beside phase 3's; kernel 1's launches on this path);
   ``generate --data_parallel`` (no mesh on one card): the same bytes;
   ``--trace_dir`` on a 16,384-row generate leaves a non-empty
   torch.profiler trace (its events and kernel events counted); kernels 1,
   7, 13 and 14 one round each on 100,000 of phase 3's rows and on phases
   10's, 15's and 17's inputs under both meshes: one launch a mesh entry,
   counts bitwise the unsharded launch's (fingerprint, host ms of each);
   kernel 15 through a threefry round of 2,048 rotating rectangles (phase
   16's kind) x 1,024 samples under both meshes, bitwise too; the threefry path under a (1, n) sample
   mesh on 4,096 of phase 3's rows at a 20,000 cap: labels bitwise the
   unsharded run's; two processes over gloo (both on cuda:0, or each on
   half the cards; `_MESH_WORKER`): their `process_batch_range` slices of
   phase 3's 2 x 100,000 rows are phase 3's files byte for byte (tables
   too), and a `global_mesh` run (config axis over both processes) on
   16,384 rows gives each process the single-process labels bit for bit;
   and data-parallel ``train_model`` (on two entries of cuda:0, or every
   card; float32, full width, 3 epochs on phase 3's rows) within rtol
   2e-4, atol 2e-5 of the single-device run. The kernels line gives
   kernels 1, 7, 13, 14 and 15 a ``launches_by_path`` with this path
   beside their main one.
24. k-gons above 16 vertices: kernels 6 (float32 and bfloat16 planes), 9
   and 10 at 2^20 pairs of a 4-gon against 17-, 20-, 32- and 64-gons and of
   32-gons against 32-gons (`_random_polygons`), each against its plain
   version: labels bitwise, kernel 9 within 2e-5 with 0 signs apart (and
   its sign kernel 6's label), kernel 10's counts apart on at most 1e-5 of
   the pairs and values within 2e-5; every case timed (CUDA events, 20
   launches after a warm-up) beside its plain version and bound, with the
   card's name and power limit; the bucket pairs (4, 32) and (32, 32) are
   entries of the kernels line (with ptxas's registers and spill bytes);
25. the routes at k = 20, each bucket pair's launches counted from 0: a
   4-gon robot (bucket pair (4, 32)) and a 20-gon robot ((32, 32)) against
   2^20 `example_polygon_configs` 20-gons through
   `PolygonCollisionProbabilityModel.collide`, `CollisionProbabilityModel
   .collide_polygons`, ``distance(impl='auto')`` and ``contact_manifold``
   (labels equal ``impl='torch'``'s, distance signs the labels, values
   within 2e-5 of ``impl='torch'`` on 2^16 rows, manifold counts as phase
   13); with the 20-gon robot, the scene queries on 2,048 of the bench's
   20-gons in a 40-side box: the matrix bitwise `ops.sat.sat_polygons` on
   every pair on the card, the swept pairs (window 512) the matrix's, the
   dense manifolds as phase 20's (`_scene_manifold_check`); kernels 6, 9
   and 10 launched on both routes;
26. kernel 7 at k = 20 against the 4-gon robot (its own library) against
   its plain version on the same Philox stream, 16,384 rows x 4,096
   samples: sum |dcount| <= 1e-5 of the samples; kernel ms, plain ms, bound;
   then ``PolygonCollisionProbabilityModel.label`` on those rows launches it
   (its entry's launches);
27. the five torch examples (``examples/*_torch.py``), each ``main(device=
   "cuda")`` in process at the JAX examples' sizes: each finishes, its
   numbers are checked (quickstart's labels [1 1 0] and the JAX file's k-gon
   label, contact_queries' labels, scene pairs and ray as the JAX file
   prints them, trajectory_validation's times of impact, probabilities in
   [0, 1]), and each prints the kernels it launched (every count read
   from 0 before it); the kernels line adds them as an ``examples`` path.

The second-to-last lines are the card (name, power limit) and one JSON
object describing each kernel of the path (the Box-Muller builds of
kernels 1, 7 and 14 as entries of their own: launches in the full bench,
and in phases 10's and 17's Box-Muller rounds; kernels 6, 9 and 10 at the
bucket pairs (4, 32) and (32, 32) and kernel 7 at k = 20 too: launches on
phases 25's and 26's routes), with ``bound_ms``: the larger
of the bytes the function must move over 3.35 TB/s and the FP32
operations its source writes for these inputs over 67 TFLOP/s (an FMA
counts 2; the library calls ``log1pf``, ``sqrtf``, ``sincosf`` and the
integer Philox rounds are not counted, so the Monte Carlo bounds are
floors; the query kernels, kernel 11 among them (`raycast_ops`, 32 bytes
a ray), count an IEEE ``sqrtf`` or division as one operation and leave
out ``sincosf``; kernel 12's and 13's work depends on the data, so their
bounds count the distance evaluations this run's lanes take; kernel 15's
is the larger of 28 bytes a lane and its counted operations; kernel 11's
counts every face, whatever its early exit skips, so the row stays
comparable across versions; kernel 9's counts every axis and test of
every pair, whatever its split skips). The fused Monte Carlo kernels 1,
7, 13 and 14 and kernels 15, 11, 12 and 9 also carry ``issue_floor_ms``:
the fewest SASS instructions the card must issue for the work
(`_shortest_iteration` on ``cuobjdump -sass`` of the built library, every
forward branch either way): one iteration of the sample loop over the samples it evaluates,
times the samples (1, 7, 13, 14; kernel 13's window loop); one lane's
body over the lanes a thread takes, times the lanes (15); one iteration
of the shape loop through every face (its exit's votes issued, not
taken) over the (ray, face) pairs it covers, times rays x shapes x faces
(11); one iteration of the stepping loop times the distance evaluations,
and each pair's set-up or window once (12); each pair through every axis
and every test (9; beside it the floor at the work its passes evaluate);
over 132 SMs x 128 lanes x the SM clock's maximum (nvidia-smi).
``bound_ms`` keeps its convention, comparable across kernels; it leaves
out the stream's integer and library work, and kernels 7, 9, 11, 12, 13,
14 and 15 must not contract a multiply and an add, so they cannot come
near it,
while the issue floor counts what the card must issue. No single PyTorch
call computes any of these functions but kernel 16's (a sum of each
stream), so ``library_ms`` is null for the others.
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
# FP32 operations of one Box-Muller pair (csrc/mc_stream.cuh::
# box_muller_pair): (b + 1) * 2^-24 twice (4), -2 * log u1 (1), 2 pi u2 (1),
# r cos a and r sin a (2); logf, sqrtf and sincosf are not counted.
BOX_MULLER_PAIR_OPS = 8


def normals_ops(n: int, normal_method: str = "erfinv") -> int:
    """FP32 operations of a sample's ``n`` normals: erf_inv, or
    ceil(n / 2) Box-Muller pairs."""
    if normal_method == "erfinv":
        return n * NORMAL_OPS
    return -(-n // 2) * BOX_MULLER_PAIR_OPS
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


def mc_ops_per_sample(shape_noise: bool, normal_method: str = "erfinv") -> int:
    """csrc/mc_kernel.cu: 3 (5) normals, the box test's 38 operations (dx,
    dy, delta, the offset, u, v, four tests), 4 more for noisy extents."""
    return (normals_ops(5 if shape_noise else 3, normal_method) + 38
            + (4 if shape_noise else 0))


def mc_poly_ops_per_sample(k: int, k2: int, k2a: int,
                           normal_method: str = "erfinv") -> int:
    """csrc/mc_polygon_kernel.cu: 3 normals, dx/dy/dtheta and (u1, u2) (9),
    each kept robot axis 5K + 5 (translation 3, K blends of 3, min/max,
    2 adds, 2 compares), each obstacle normal 5 K2 + 5."""
    return normals_ops(3, normal_method) + 9 + k2a * (5 * k + 5) + k * (5 * k2 + 5)


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
    from collide2d_tpu_torch.ops.distance_cuda import distance_defines
    from collide2d_tpu_torch.ops.mc_cuda import normal_defines
    from collide2d_tpu_torch.ops.mc_polygon_cuda import shape_defines
    from collide2d_tpu_torch.ops.raycast_cuda import raycast_defines
    from collide2d_tpu_torch.ops.screen_cuda import screen_defines
    from collide2d_tpu_torch.utils import cuda_build

    t = time.monotonic()
    # kernels 7 and 14 build once per shape: phases 10, 11 and 17 launch
    # them at k = 8 against the 4-gon robot's 2 kept axes, phase 10's
    # agreement gate kernel 7 at k = 6; kernel 15 once per segment count (the
    # cascade's 8), kernel 11 once per face count (8: every scene here has
    # k <= 8; also the build that counts its work, phase 19); kernel 9's
    # build that counts the pairs of its passes (phase 12); the Box-Muller
    # builds of kernels 1, 7 and 14 (phases 2, 10 and 17, and the bench's
    # A/B leg), and the shapes phase 22's bench launches besides (kernel 14
    # at the JAX bench's k = 6, phase 17 checks it)
    bm = normal_defines("box_muller")
    jobs = [(name, ()) for name in (
        "mc_kernel", "sat_kernel", "polygon_kernel", "distance_kernel",
        "manifold_kernel", "toi_kernel", "mc_toi_kernel", "stream_kernel")] + [
        ("mc_polygon_kernel", shape_defines(POLY_K, 4, 2)),
        ("mc_polygon_kernel", shape_defines(6, 4, 2)),
        ("mc_moving_polygon_kernel", shape_defines(POLY_K, 4, 2)),
        ("screen_kernel", screen_defines(8)),
        ("raycast_kernel", raycast_defines(RAY_K)),
        ("raycast_kernel", raycast_defines(RAY_K, count_faces=True)),
        ("distance_kernel", distance_defines(count=True)),
        ("mc_kernel", bm),
        ("mc_polygon_kernel", shape_defines(POLY_K, 4, 2) + bm),
        ("mc_polygon_kernel", shape_defines(6, 4, 2) + bm),
        ("mc_moving_polygon_kernel", shape_defines(POLY_K, 4, 2) + bm),
        ("mc_moving_polygon_kernel", shape_defines(6, 4, 2)),
        ("mc_polygon_kernel", shape_defines(20, 4, 2))]  # phase 26
    # kernels 6, 9 and 10 at the bucket pairs above 16 of phases 24 and 25,
    # with ptxas's report (registers, spill bytes)
    reported = big_k_builds()
    with ThreadPoolExecutor(len(jobs) + len(reported)) as pool:
        big = [pool.submit(_build_reported, *job) for job in reported]
        libs = list(pool.map(lambda job: cuda_build.build(*job), jobs))
        libs += [f.result() for f in big]
    jobs += reported
    for job in jobs:
        cuda_build.load(*job)
    _line("1 build", time.monotonic() - t,
          kernels=",".join(f"{name}.cu" + "".join(f":{v}" for _, v in defs)
                           for name, defs in jobs),
          libraries=",".join(lib.name for lib in libs),
          above_16=_json({f"{k[0]}:{k[1]}x{k[2]}": v for k, v in BIG_K_PTXAS.items()}))


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
        result[key]["box_muller"] = _box_muller_vs_plain(
            "2 kernel-vs-plain box_muller", key, c, n, kernel_ms,
            lambda **kw: mc_cuda.mc_counts(params, uids, seed, n,
                                           shape_noise=shape_noise, **kw),
            lambda **kw: mc_cuda.mc_counts_plain(params, uids, seed, n,
                                                 shape_noise=shape_noise,
                                                 max_elems=1 << 24, **kw),
            c * 72, c * n * mc_ops_per_sample(shape_noise, "box_muller"))
        del params, uids
    return result


def _box_muller_vs_plain(phase: str, case: str, c: int, n: int, erfinv_ms: float,
                         kernel, plain, nbytes: float, ops: float) -> dict:
    """The Box-Muller build of a fused Monte Carlo kernel (1, 7 or 14) on a
    phase's inputs: ``kernel(normal_method=...)`` against ``plain(...)``,
    sum |dcount| <= 1e-5 of the samples; its ms beside the erf_inv build's
    (``erfinv_ms``, measured on the same inputs just before); its bound at
    ``ops`` (`normals_ops` counts the pairs)."""
    t = time.monotonic()
    got = kernel(normal_method="box_muller")
    want = plain(normal_method="box_muller")
    torch.cuda.synchronize()
    diff = (got - want).abs()
    total = int(diff.sum())
    if total > MISMATCH_BOUND * c * n:
        raise RuntimeError(f"{phase}: the Box-Muller build disagrees with its plain "
                           f"version: sum|dcount|={total} > {MISMATCH_BOUND} * C * n "
                           f"({case})")
    if not 0 < int(got.sum()) < c * n:
        raise RuntimeError(f"{phase}: degenerate Box-Muller counts ({case})")
    ms = _events_ms(lambda: kernel(normal_method="box_muller"), reps=20)
    plain_ms = _events_ms(lambda: plain(normal_method="box_muller"), reps=1)
    bound, bound_by = _bound_ms(nbytes, ops)
    counts_sum, counts_fp = _fingerprint(got)
    _line(phase, time.monotonic() - t, case=case, C=c, n=n, sum_abs_dcount=total,
          rows_differ=int((diff > 0).sum()), counts_sum=counts_sum,
          counts_fingerprint=counts_fp, kernel_ms=f"{ms:.4f}",
          erfinv_kernel_ms=f"{erfinv_ms:.4f}", plain_ms=f"{plain_ms:.2f}",
          bound_ms=f"{bound:.4f}", bound_by=bound_by,
          kernel_samples_per_s=f"{c * n / ms * 1e3:.4e}")
    return dict(max_abs_err=int(diff.max()), ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by)


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


def phase_main_path(work: Path):
    """Phase 3: returns kernel 1's launches and the run's `GenerateStats`."""
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
    return launches, stats


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


RESUME_AFTER_ROUND = 3


class _Interrupt(Exception):
    """Raised from a run's progress hook to stop it mid-run."""


def _resume_case(name: str, key, configs, robot, cfg, ckpt: Path, launches, card: str,
                 base=None, base_s=None) -> dict:
    """One mid-run resume on the card through `AdaptiveRun` (the driver
    under `adaptive_collision_probabilities` and the pipeline): an
    uninterrupted run (or the one a caller already made: ``base``,
    ``base_s``), the same run with a checkpoint every round interrupted
    from its progress hook once round `RESUME_AFTER_ROUND` is reported, and
    its resume. Fails unless the checkpoint existed, the resume's first
    progress report lies past its samples, the kernel ran in the resume
    (``launches``: (reset, read)), every output equals the uninterrupted
    run's bit for bit and the file is gone. Returns the labels and the
    line's numbers."""
    from collide2d_tpu_torch.mc.driver import AdaptiveRun

    def label(progress=None, **kw):
        t = time.monotonic()
        run = AdaptiveRun(key, configs, robot, cfg, progress=progress, **kw)
        run.scheduler.run()
        out = run.materialize()
        torch.cuda.synchronize()
        return out, time.monotonic() - t, run

    t = time.monotonic()
    if base is None:
        base, base_s, _ = label()

    def interrupt(*, round, **kw):
        if round >= RESUME_AFTER_ROUND:
            raise _Interrupt(round)

    t_cut = time.monotonic()
    run = AdaptiveRun(key, configs, robot, cfg, progress=interrupt,
                      checkpoint_path=str(ckpt), checkpoint_every=1)
    try:
        run.scheduler.run()
    except _Interrupt as stop:
        torch.cuda.synchronize()
        interrupted_at = stop.args[0]
    else:
        raise RuntimeError(f"resume {name}: the run ended before round {RESUME_AFTER_ROUND}")
    cut_s = time.monotonic() - t_cut
    if not ckpt.is_file():
        raise RuntimeError(f"resume {name}: no checkpoint after the interrupt")
    with np.load(ckpt) as z:
        n_saved, round_saved = int(z["n_samples"]), int(z["round"])
    nbytes = ckpt.stat().st_size
    write_ms = list(run.ops.checkpoint_ms)
    seen = []
    launches[0]()
    out, resume_s, resumed = label(progress=lambda **kw: seen.append(kw["n_samples"]),
                                   checkpoint_path=str(ckpt), checkpoint_every=1)
    n_launches = launches[1]()
    write_ms += resumed.ops.checkpoint_ms
    if not (seen and min(seen) > n_saved):
        raise RuntimeError(f"resume {name}: restarted (first report at "
                           f"{seen[:1]} samples, checkpoint at {n_saved})")
    if n_launches <= 0:
        raise RuntimeError(f"resume {name}: the kernel never launched in the resume")
    if not all(np.array_equal(a, b) for a, b in zip(out, base)):
        rows = int((out[0] != base[0]).sum())
        raise RuntimeError(f"resume {name}: {rows} labels differ from the "
                           "uninterrupted run")
    if ckpt.exists():
        raise RuntimeError(f"resume {name}: the checkpoint outlived a clean finish")
    line = dict(
        kernel=name, rows=configs.num, interrupted_at_round=interrupted_at,
        checkpoint_round=round_saved, checkpoint_samples=n_saved,
        checkpoint_bytes=nbytes, writes=len(write_ms),
        median_write_ms=f"{float(np.median(write_ms)):.3f}",
        max_write_ms=f"{max(write_ms):.3f}", uninterrupted_label_s=f"{base_s:.3f}",
        interrupted_label_s=f"{cut_s:.3f}", resumed_label_s=f"{resume_s:.3f}",
        resume_first_report_samples=min(seen), resume_launches=n_launches,
        labels_bitwise_equal=True, checkpoint_removed=True)
    _line("8b resume" if name != "15" else "16b resume", time.monotonic() - t,
          **line, card=json.dumps(card))
    return dict(labels=out, **line)


def _launch_counter(mod):
    return mod.reset_launches, lambda: mod.LAUNCHES


def phase_resume(work: Path, card: str) -> None:
    """Phase 8b: mid-run resumes on kernels 1, 7, 13 and 14 at the main
    paths' sizes, then the overlapped ``generate --resume`` and balancing
    of phase 3's batches (`_resume_case`; the rotating cascade is phase
    16b)."""
    from collide2d_tpu_torch.data import balance, schemas
    from collide2d_tpu_torch.data.pipeline import GenerateConfig
    from collide2d_tpu_torch.mc import prng
    from collide2d_tpu_torch.mc.estimator import AdaptiveConfig, Configs
    from collide2d_tpu_torch.mc.noise import sample_configuration_batch
    from collide2d_tpu_torch.ops import mc_cuda, mc_moving_polygon_cuda, mc_polygon_cuda, mc_toi_cuda
    from collide2d_tpu_torch.utils import native

    main = work / "main"
    cfg = AdaptiveConfig()  # the reference bins and cap: generate's defaults
    # kernel 1: batch 0 of phase 3's generate (its tables, seed 7)
    gen = GenerateConfig()
    poses_t = torch.as_tensor(np.load(main / "poses.npy"), device="cuda")
    sd_t = torch.as_tensor(np.sqrt(np.load(main / "variances.npy")), device="cuda")
    k_init, k_mc = prng.split(prng.fold_in(prng.PRNGKey(7), 0))
    positions, pose_idx, var_idx, pose_cols, sd_rows = sample_configuration_batch(
        k_init, poses_t, sd_t, num_configs=100_000, r_offset=gen.r_offset,
        spread=gen.spread)
    rects = Configs(positions, pose_cols[:, 2], pose_cols[:, 0:2], sd_rows)
    res = _resume_case("1", k_mc, rects, gen.robot_wh, cfg, work / "resume_1.npz",
                       _launch_counter(mc_cuda), card)
    rows = schemas.pack_dataset_rows(positions.cpu().numpy(), res["labels"][0],
                                     var_idx.cpu().numpy(), pose_idx.cpu().numpy())
    rows = rows[native.std_shuffle_perm(len(rows), 0)]
    if rows.tobytes() != np.load(main / "0.npy").tobytes():
        raise RuntimeError("resume 1: the resumed labels are not phase 3's batch 0")

    robot = np.asarray(POLY_ROBOT, np.float32)
    _resume_case("7", prng.PRNGKey(11), _polygon_workload(POLY_ROWS, seed=0), robot,
                 cfg, work / "resume_7.npz", _launch_counter(mc_polygon_cuda), card)
    _resume_case("13", prng.PRNGKey(7), _moving_rects(TRAJ_ROWS, rotating=False),
                 ROBOT_WH, cfg, work / "resume_13.npz", _launch_counter(mc_toi_cuda),
                 card)
    _resume_case("14", prng.PRNGKey(7), _moving_kgons(TRAJ_ROWS), robot, cfg,
                 work / "resume_14.npz", _launch_counter(mc_moving_polygon_cuda), card)

    # the pipeline: overlapped generate with per-batch checkpoints and
    # --resume; a deleted batch is rewritten bitwise, the other skipped
    t = time.monotonic()
    d = work / "resume_pipeline"
    base = ["--device", "cuda", "-n", "2", "-b", "100000", "--seed", "7",
            "--overlap_batches", "2", "--pose_dir", str(main / "poses.npy"),
            "--variance_dir", str(main / "variances.npy")]
    argv = [*base, "--checkpoint_every", "8", "--resume", "--data_dir", str(d)]
    first, _ = _quiet(_generate, argv)
    batches = [(d / f"{i}.npy").read_bytes() for i in range(2)]
    if batches != [(main / f"{i}.npy").read_bytes() for i in range(2)]:
        raise RuntimeError("resume pipeline: the checkpointed batches are not phase 3's")
    if list(d.glob("checkpoint_*")):
        raise RuntimeError("resume pipeline: checkpoints outlived a clean finish")
    mtime0 = (d / "0.npy").stat().st_mtime_ns
    (d / "1.npy").unlink()
    second, _ = _quiet(_generate, argv)
    if (d / "1.npy").read_bytes() != batches[1]:
        raise RuntimeError("resume pipeline: the rewritten 1.npy differs")
    if (d / "0.npy").stat().st_mtime_ns != mtime0 or (d / "0.npy").read_bytes() != batches[0]:
        raise RuntimeError("resume pipeline: 0.npy was rewritten")
    if list(d.glob("checkpoint_*")):
        raise RuntimeError("resume pipeline: checkpoints outlived a clean finish")
    # the same generate without checkpoints: what the cadence costs
    control, _ = _quiet(_generate, [*base, "--data_dir", str(work / "resume_control")])
    _line("8b resume pipeline", time.monotonic() - t, batches=2, batch_size=100_000,
          overlap_batches=2, checkpoint_every=8,
          first_label_s=f"{first.label_seconds:.3f}",
          no_checkpoint_label_s=f"{control.label_seconds:.3f}",
          rerun_label_s=f"{second.label_seconds:.3f}", rerun_rows=second.rows,
          batch1_bitwise_equal=True, batch0_untouched=True, equal_to_phase3=True,
          card=json.dumps(card))

    # balance (host numpy, no plot) over phase 3's batches
    t = time.monotonic()
    data = balance.load_data(main)
    bins = balance.compute_bin_idx(data[:, 2], balance.DEFAULT_BALANCE_BINS)
    single = balance.balance_single(data, bins)
    b0, b1 = (np.load(main / f"{i}.npy") for i in range(2))
    pair = balance.balance(b0, b1, balance.compute_bin_idx(b0[:, 2], balance.DEFAULT_BALANCE_BINS),
                           balance.compute_bin_idx(b1[:, 2], balance.DEFAULT_BALANCE_BINS))
    per_bin = [int(m.sum()) for m in bins]
    if data.shape != (200_000, 5) or len(single) != min(per_bin) * len(bins):
        raise RuntimeError(f"balance: {data.shape} rows, {len(single)} balanced")
    _line("8b balance", time.monotonic() - t, rows=len(data),
          rows_per_bin=json.dumps(per_bin), balanced_rows=len(single),
          balanced_pair=json.dumps([len(pair[0]), len(pair[1])]))


LEARNED_CONFIGS = 1 << 20  # cp_from_configs' timing batch


def _learned_feature_check(learned, distance_cuda, positions, var_idx, pose_idx,
                           poses, std, got: np.ndarray) -> dict:
    """The card's features against their plain versions on the same rows:
    columns 0-10 and the plain distance on the card's own tensors bit for
    bit; against the CPU's plain version the distance within 1 ulp (torch's
    CPU sqrt misrounds a fraction of a percent of inputs) and the margin
    bitwise wherever the distance is, else within 2 ulp."""
    cpu = learned.featurize(positions, var_idx, pose_idx, poses, std, device="cpu")
    t = torch.from_numpy(got).to("cuda")
    x = t[:, 0]
    rw, rh = (float(np.float32(v * 0.5)) for v in learned.ROBOT_WH)
    plain = distance_cuda.obb_signed_distance_tile(
        0.0 - x, 0.0 - t[:, 1], t[:, 4], t[:, 5], torch.full_like(x, rw),
        torch.full_like(x, rh), torch.ones_like(x), torch.zeros_like(x),
        t[:, 2].abs() * 0.5, t[:, 3].abs() * 0.5)
    ulps = np.abs(got[:, 11:].view(np.int32).astype(np.int64)
                  - cpu[:, 11:].view(np.int32).astype(np.int64))
    check = {"table_cols_equal": bool(np.array_equal(got[:, :11], cpu[:, :11])),
             "distance_differ_card_plain": int((plain != t[:, 11]).sum()),
             "distance_max_ulp_vs_cpu": int(ulps[:, 0].max()),
             "margin_max_ulp_vs_cpu": int(ulps[:, 1].max()),
             "margin_differ_where_distance_equal": int((ulps[ulps[:, 0] == 0, 1] > 0).sum()),
             "rows_differ_cpu": int((ulps > 0).any(axis=1).sum())}
    if (not check["table_cols_equal"] or check["distance_differ_card_plain"]
            or check["distance_max_ulp_vs_cpu"] > 1 or check["margin_max_ulp_vs_cpu"] > 2
            or check["margin_differ_where_distance_equal"]):
        raise RuntimeError(f"learned features: the card's differ from the plain version: {check}")
    return check


def phase_learned(work: Path, card: str) -> int:
    """Phase 8c: the learned model on phase 3's two batches; returns kernel
    8's launches on its main path (featurize, train, predict,
    cp_from_configs)."""
    from collide2d_tpu_torch import cli
    from collide2d_tpu_torch.data import balance, schemas
    from collide2d_tpu_torch.data.validate import compare_labels
    from collide2d_tpu_torch.mc import prng
    from collide2d_tpu_torch.mc.estimator import Configs
    from collide2d_tpu_torch.models import learned
    from collide2d_tpu_torch.ops import distance_cuda

    main = work / "main"
    t0 = t = time.monotonic()
    distance_cuda.reset_launches()
    feats, labels = learned.load_training_data(main, device="cuda")
    torch.cuda.synchronize()
    load_s = time.monotonic() - t
    load_launches = distance_cuda.LAUNCHES["obb_distance"]
    if load_launches <= 0:
        raise RuntimeError("load_training_data never launched kernel 8")

    # train at TrainConfig's full width through the CLI, each epoch timed
    # (the wrapper's sync stands where train_model syncs anyway)
    epochs, results = [], []
    run_epoch, save_model = learned.run_epoch, learned.save_model

    def timed_epoch(*args, **kwargs):
        t0 = time.monotonic()
        loss = run_epoch(*args, **kwargs)
        torch.cuda.synchronize()
        epochs.append((time.monotonic() - t0, float(loss)))
        return loss

    def kept_save(path, result, cfg):
        results.append((result, cfg))
        return save_model(path, result, cfg)

    # torch.optim's first AdamW imports torch._dynamo: once a process
    t = time.monotonic()
    learned.adamw(learned.MLP((1,), device="cuda"), 1e-3, 1e-4)
    adamw_first_s = time.monotonic() - t
    model_path = work / "learned_model.npz"
    learned.run_epoch, learned.save_model = timed_epoch, kept_save
    try:
        t = time.monotonic()
        _, train_out = _quiet(cli.main, ["train", "--data_dir", str(main), "--out",
                                         str(model_path), "--device", "cuda"])
        torch.cuda.synchronize()
        train_s = time.monotonic() - t
    finally:
        learned.run_epoch, learned.save_model = run_epoch, save_model
    (result, cfg), = results
    steps = (len(labels) - int(len(labels) * cfg.val_fraction)) // cfg.batch_size
    for i, (sec, loss) in enumerate(epochs):
        _line("8c learned epoch", sec, epoch=i + 1, loss=f"{loss:.6f}",
              rows_per_s=f"{steps * cfg.batch_size / sec:.1f}")
    history = [loss for _, loss in epochs]
    if history != result.history or not history[-1] < 0.8 * history[0]:
        raise RuntimeError(f"learned: the loss did not fall below 0.8 x the first "
                           f"epoch's: {history}")
    mean_mae = float(np.mean(np.abs(labels - labels.mean())))
    if not result.val_mae < 0.7 * mean_mae:
        raise RuntimeError(f"learned: validation MAE {result.val_mae} not below 0.7 x "
                           f"the constant-mean predictor's {mean_mae}")

    # save / load on the card: identical cps
    direct = learned.LearnedCollisionModel(result.params, result.norm_mean,
                                           result.norm_std, cfg.compute_dtype, device="cuda")
    loaded = learned.LearnedCollisionModel.load(model_path, device="cuda")
    head = feats[:65_536]
    if not torch.equal(direct.cp_from_features(head), loaded.cp_from_features(head)):
        raise RuntimeError("learned: the saved model's cps differ from the trained one's")

    # predict batch 1 through the CLI; compare with its Monte Carlo labels
    t = time.monotonic()
    pred = work / "learned_cps.npy"
    _quiet(cli.main, ["predict", "--model", str(model_path), "--data_in",
                      str(main / "1.npy"), "--data_dir", str(main), "--out", str(pred),
                      "--device", "cuda"])
    predict_s = time.monotonic() - t
    cps, rows1 = np.load(pred), np.load(main / "1.npy")
    if cps.shape != (len(rows1),) or not (np.isfinite(cps).all() and (cps >= 0).all()
                                          and (cps <= 1).all()):
        raise RuntimeError(f"learned predict: cps {cps.shape} not finite in [0, 1]")
    report = compare_labels(rows1, cps, tolerance=0.01)
    compare_rc = _quiet(cli.main, ["compare", str(main / "1.npy"), str(pred),
                                   "--tolerance", "0.01"])[0]

    # cp_from_configs at 2^20 configurations of phase 3's tables
    poses = np.load(main / "poses.npy")
    std = np.sqrt(np.load(main / "variances.npy")).astype(np.float32)
    g = torch.Generator(device="cuda").manual_seed(13)
    pi = torch.randint(0, len(poses), (LEARNED_CONFIGS,), device="cuda", generator=g)
    vi = torch.randint(0, len(std), (LEARNED_CONFIGS,), device="cuda", generator=g)
    poses_t, std_t = torch.as_tensor(poses, device="cuda"), torch.as_tensor(std, device="cuda")
    configs = Configs(torch.rand(LEARNED_CONFIGS, 2, device="cuda", generator=g) * 16 - 8,
                      poses_t[pi, 2], poses_t[pi, 0:2], std_t[vi])
    surrogate = loaded.cp_from_configs(configs)
    torch.cuda.synchronize()
    launches = distance_cuda.LAUNCHES["obb_distance"]
    if not (surrogate.shape == (LEARNED_CONFIGS,) and bool(torch.isfinite(surrogate).all())):
        raise RuntimeError("learned cp_from_configs: not finite")

    # featurize alone, and kernel 8 at its shape, beside the check
    data = balance.load_data(main)
    positions, _, var_idx, pose_idx = schemas.unpack_dataset_rows(data)
    poses_f, std_f = learned._load_tables(main)
    args = (positions, var_idx, pose_idx, poses_f, std_f)
    featurize_ms = _host_ms(lambda: learned.featurize(*args, device="cuda"), reps=5)
    check = _learned_feature_check(learned, distance_cuda, *args,
                                   learned.featurize(*args, device="cuda"))
    n = len(data)
    padded = -(-n // learned._PAIR_ALIGN) * learned._PAIR_ALIGN
    boxes = torch.zeros((6, 8, padded // 8), device="cuda")
    boxes[2] = 1.0
    k8_ms = _events_ms(lambda: distance_cuda.obb_distance_cuda_t(boxes, boxes), reps=20)
    bound, bound_by = _bound_ms(52 * padded, OBB_DISTANCE_OPS * padded)

    # the low-precision product: tensor cores (a) against the float32
    # product of bfloat16 operands (b), a full-width epoch each, in turns
    x = torch.from_numpy((feats - result.norm_mean) / result.norm_std).to("cuda")
    y = torch.from_numpy(labels).to("cuda")
    model = learned.params_from_jax(result.params, device="cuda")
    opt = learned.adamw(model, cfg.learning_rate, cfg.weight_decay)
    # and cp_from_configs at 2^20 configurations under each
    routes = {"a": learned._mm_tensor_cores, "b": learned._mm_exact_f32}
    route_ms = {"a": [], "b": []}
    configs_ms = {"a": [], "b": []}
    try:
        for name in ("a", "b", "b", "a"):
            learned._LOW_PRECISION_MM["cuda"] = routes[name]
            route_ms[name].append(_events_ms(lambda: learned.run_epoch(
                model, opt, prng.PRNGKey(5), x, y, torch.bfloat16,
                cfg.batch_size, steps), reps=3))
            configs_ms[name].append(_events_ms(lambda: loaded.cp_from_configs(configs),
                                               reps=5))
    finally:
        learned._LOW_PRECISION_MM["cuda"] = routes["a"]

    per_bin = ",".join(f"{v:.5f}" for v in result.val_mae_per_bin)
    _line("8c learned", time.monotonic() - t0, rows=n, features=feats.shape[1],
          load_training_data_s=f"{load_s:.3f}", featurize_ms=f"{featurize_ms:.3f}",
          kernel8_ms=f"{k8_ms:.4f}", kernel8_bound_ms=f"{bound:.4f}",
          kernel8_bound_by=bound_by, **check, hidden="256,256,256",
          batch=cfg.batch_size, epochs=len(epochs), steps_per_epoch=steps,
          adamw_first_s=f"{adamw_first_s:.3f}", train_s=f"{train_s:.3f}",
          epoch_s_total=f"{sum(s for s, _ in epochs):.3f}",
          val_bce=f"{result.val_bce:.6f}", val_mae=f"{result.val_mae:.6f}",
          mean_predictor_mae=f"{mean_mae:.6f}", val_mae_per_bin=per_bin,
          save_load_bitwise=True, predict_s=f"{predict_s:.3f}",
          predict_mean_abs_diff=f"{report.mean_abs_diff:.6f}",
          predict_within_0_01=f"{report.frac_within_tolerance:.4f}",
          compare_rc=compare_rc,
          cp_from_configs_ms=",".join(f"{v:.3f}" for v in configs_ms["a"]),
          cp_from_configs_per_s=f"{LEARNED_CONFIGS / (np.mean(configs_ms['a']) * 1e-3):.1f}",
          cp_from_configs_ms_exact_f32=",".join(f"{v:.3f}" for v in configs_ms["b"]),
          epoch_ms_tensor_cores=",".join(f"{v:.3f}" for v in route_ms["a"]),
          epoch_ms_exact_f32=",".join(f"{v:.3f}" for v in route_ms["b"]),
          kernel8_launches=launches, card=json.dumps(card))
    return launches


def phase_resume_rotating(work: Path, card: str, base_s: float) -> None:
    """Phase 16b: the mid-run resume of the rotating cascade (stage A on
    kernel 15) at phase 16's 8,192 rows and cap; its uninterrupted run is
    phase 16's ``movelabel`` (the same rows, seed and configuration), whose
    labels and seconds it reuses."""
    from collide2d_tpu_torch.mc import prng
    from collide2d_tpu_torch.mc.estimator import AdaptiveConfig
    from collide2d_tpu_torch.ops import screen_cuda

    _resume_case("15", prng.PRNGKey(7), _moving_rects(ROT_ROWS, rotating=True), ROBOT_WH,
                 AdaptiveConfig(max_samples=ROT_CAP), work / "resume_15.npz",
                 _launch_counter(screen_cuda), card,
                 base=_labels(work / "movelabels_rot.npz"), base_s=base_s)


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
        fingerprint = output_fingerprint(got)
        _line("9 k-gon sat", time.monotonic() - t, case=tag, k1=k1, k2=k2,
              pairs=n, labels_differ=differ, collision_share=f"{share:.4f}",
              fingerprint=_json(fingerprint),
              parent_rows_equal=fingerprint == PARENT_FINGERPRINTS[f"polygon_sat_{tag}"],
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
        bm = _box_muller_vs_plain(
            "10 k-gon mc box_muller", key, c, n, kernel_ms,
            lambda **kw: mc_polygon_cuda.mc_poly_counts(params, uids, seed, n, **dims,
                                                        **kw),
            lambda **kw: mc_polygon_cuda.mc_poly_counts_plain(
                params, uids, seed, n, max_elems=1 << 22, **dims, **kw),
            c * (params.shape[1] * 4 + 8),
            c * n * mc_poly_ops_per_sample(**dims, normal_method="box_muller"))
        if key == "workload":
            result["box_muller"] = bm
        else:
            result["box_muller"]["max_abs_err"] = max(result["box_muller"]["max_abs_err"],
                                                      bm["max_abs_err"])

    # The agreement gate of the JAX package's `bench_agreement_polygons`
    # (utils/benchmarks.py:1334-1405): the kernel against the threefry path,
    # then the Box-Muller build against the same threefry counts (its round
    # entry point, `mc_round_polygons_cuda`; its launches there are its
    # entry of the kernels line).
    t = time.monotonic()
    c, n = 4096, 1 << 16
    configs = example_polygon_configs(c, k=6, seed=7, device=dev)
    uids = torch.arange(c, dtype=torch.int32, device=dev)
    cp = {}
    for impl in ("cuda", "threefry"):
        counts = mc_round(prng.PRNGKey(8), uids, configs, robot, 0, n_batch=n,
                          impl=impl)
        cp[impl] = counts.cpu().numpy().astype(np.float64) / n
    _z_gate("10 k-gon agreement", "mc_poly_counts", cp["cuda"], cp["threefry"], n, t)
    t = time.monotonic()
    mc_polygon_cuda.reset_launches()
    counts = mc_polygon_cuda.mc_round_polygons_cuda(
        prng.PRNGKey(8), uids, configs, robot, 0, n_batch=n, normal_method="box_muller")
    result["box_muller"]["launches"] = mc_polygon_cuda.BOX_MULLER_LAUNCHES
    _z_gate("10 k-gon agreement box_muller", "mc_poly_counts box_muller",
            counts.cpu().numpy().astype(np.float64) / n, cp["threefry"], n, t,
            launches=result["box_muller"]["launches"])
    return result


def _z_gate(phase: str, name: str, cp_kernel, cp_threefry, n: int, t: float,
            **fields) -> dict:
    """The JAX bench's agreement gate (`utils.benchmarks.agreement_stats`:
    max z < 6 and a share with z > 3 of at most 3 x 0.27%) of a kernel's
    cps against the threefry path's; raises when it fails."""
    from collide2d_tpu_torch.utils.benchmarks import agreement_stats

    gate = agreement_stats(cp_kernel, cp_threefry, n)
    if not gate["ok"]:
        raise RuntimeError(f"{name} agreement gate failed: max z {gate['value']:.2f}, "
                           f"share z > 3 {gate['frac_z_gt3']:.4f}")
    _line(phase, time.monotonic() - t, kernel=name, configs=len(cp_kernel), n_samples=n,
          max_z=f"{gate['value']:.3f}", frac_z_gt3=f"{gate['frac_z_gt3']:.5f}",
          mean_abs_diff=f"{gate['mean_abs_diff']:.3e}",
          frac_within_005=f"{gate['frac_within_005']:.4f}",
          mean_cp=f"{float(np.mean(cp_threefry)):.4f}", **fields)
    return gate


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
    """The K bucket kernels 6, 9 and 10 pad a k-gon to."""
    from collide2d_tpu_torch.ops.polygon_cuda import k_bucket

    return k_bucket(k)


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


def polygon_distance_ops_evaluated(k1: int, k2: int, pairs: int, undecided: int,
                                   separated: int) -> int:
    """The FP32 operations csrc/distance_kernel.cu evaluates at the K
    buckets when its passes take ``pairs``, ``undecided`` and ``separated``
    pairs (polygon_distance.cuh): A = K1 + K2; every pair polygon 1's 4
    first axes unscaled, each 5A + 6 (the axis 2, |n|^2 3, A projections of
    3, 2 (A - 2) min/max, the gap 3, the two tests 2); an undecided pair
    every axis, A (5A + 9), and its select 1; a separated pair the A
    segments, 8 each (edge 2, |e|^2 3, test, reciprocal, select), and the
    2 K1 K2 point-segment tests, 14 each (the clamp one saturating
    multiply), and its sqrt 1."""
    k1, k2 = _bucket(k1), _bucket(k2)
    a = k1 + k2
    return (pairs * 4 * (5 * a + 6) + undecided * (a * (5 * a + 9) + 1)
            + separated * (8 * a + 28 * k1 * k2 + 1))


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


def polygon_distance_inputs(g=None) -> list:
    """Phase 12's kernel-9 cases on the card, drawn as the phase draws them
    (``g``: the generator after its rectangle rows; None draws those
    first): (tag, k1, k2, packed polygons 1, packed polygons 2) at 2^22
    pairs of the JAX bench's k-gons, k = 8 and 4 against 8."""
    from collide2d_tpu_torch.ops import polygon_cuda

    if g is None:
        g = _rect_rows(SAT_PAIRS, seed=12)[3]
    n = 1 << 22
    cases = []
    for tag, k1, k2 in (("k8", 8, 8), ("k4_k8", 4, 8)):
        a = polygon_cuda.pack_polygons(_bench_polygons(g, n, k1))
        b = polygon_cuda.pack_polygons(_bench_polygons(g, n, k2))
        cases.append((tag, k1, k2, a, b))
    return cases


def phase_distance() -> dict:
    """Phase 12: kernels 8 and 9 on the models' `distance` and against their
    plain versions; returns each kernel's entry of the kernels line."""
    from collide2d_tpu_torch.models.collision_model import (
        CollisionProbabilityModel,
        PolygonCollisionProbabilityModel,
    )
    from collide2d_tpu_torch.ops import distance_cuda, polygon_cuda, sat_cuda
    from collide2d_tpu_torch.utils import cuda_build

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

    lib = cuda_build.build("distance_kernel")
    for tag, k1, k2, a, b in polygon_distance_inputs(g):
        t = time.monotonic()
        n = a.shape[1] * a.shape[2]
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
        counted, undecided, separated = distance_cuda.polygon_distance_passes(a, b, k1=k1,
                                                                              k2=k2)
        if not torch.equal(counted, got):
            raise RuntimeError(f"kernel 9's counting build differs ({tag})")
        evaluated = polygon_distance_ops_evaluated(k1, k2, n, undecided, separated)
        floor = polygon_distance_issue_floor(lib, k1, k2, n, undecided, separated)
        fingerprint = output_fingerprint(got)
        if tag == "k8":
            result["polygon_distance"] = dict(
                launches=launches["polygon_distance"], max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                issue_floor_ms=floor["issue_floor_ms"])
        else:
            result["polygon_distance"]["max_abs_err"] = max(
                result["polygon_distance"]["max_abs_err"], err)
        _line("12 polygon_distance", time.monotonic() - t, case=tag, pairs=n,
              max_abs_diff=f"{err:.3e}", bitwise_equal=bool(torch.equal(got, want)),
              sign_mismatch=differ, sign_mismatch_vs_kernel6=vs_label,
              overlap_share=f"{float((want < 0).float().mean()):.4f}",
              kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.3f}", bound_ms=f"{bound:.4f}",
              bound_by=bound_by, issue_floor_ms=f"{floor['issue_floor_ms']:.4f}",
              issue_floor_ms_at_work_evaluated=(
                  f"{floor['issue_floor_ms_at_work_evaluated']:.4f}"),
              share_of_issue_floor=f"{floor['issue_floor_ms_at_work_evaluated'] / ms:.3f}",
              sass_per_pair=f"{floor['sass_per_pair']:.1f}",
              sass_per_pair_evaluated=f"{floor['sass_per_pair_evaluated']:.1f}",
              ops_per_pair=polygon_distance_ops(k1, k2),
              ops_per_pair_evaluated=f"{evaluated / n:.1f}",
              undecided_share=f"{undecided / n:.4f}", separated_share=f"{separated / n:.4f}",
              kernel_pairs_per_s=f"{n / ms * 1e3:.4e}",
              kernel_gb_per_s=f"{nbytes * n / (ms * 1e-3) / 1e9:.1f}",
              fingerprint=_json(fingerprint),
              parent_rows_equal=fingerprint == PARENT_FINGERPRINTS[f"polygon_distance_{tag}"])
        del a, b, got, want, label, counted
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
        fingerprint = output_fingerprint(out)
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
              kernel_gb_per_s=f"{164 * n / (ms * 1e-3) / 1e9:.1f}",
              fingerprint=_json(fingerprint),
              parent_rows_equal=fingerprint == PARENT_FINGERPRINTS[
                  f"polygon_manifold_m{margin}"])
        del out, ref
    return result


def _toi_agreement(got, want):
    """(hit/miss mismatches, largest |dt| where both hit)."""
    hit_g, hit_w = torch.isfinite(got), torch.isfinite(want)
    both = hit_g & hit_w
    dt = float((got[both] - want[both]).abs().max()) if bool(both.any()) else 0.0
    return int((hit_g != hit_w).sum()), dt


def toi_inputs():
    """Phase 14's inputs on the card: the model call's arguments (2^21
    rows drawn as in phase 6, unit speed toward the obstacle, omega U(-1,
    1), every 4th 0) and the kernel's pairs (b1, b2) at the JAX bench's
    2^21 (utils/benchmarks.py:474-498: box 1 at the origin, box 2 at U(3,
    6)^2 heading for it at unit speed, extents U(0.5, 3)^2, angles U(0, 7),
    rates U(-1, 1))."""
    from collide2d_tpu_torch.ops import toi_cuda

    rows = 1 << 21
    pos, theta, wh, g = _rect_rows(rows, seed=15)
    vel = -pos / pos.norm(dim=-1, keepdim=True)  # unit speed toward the obstacle
    omega = torch.rand((rows,), generator=g, device="cuda") * 2.0 - 1.0
    omega[::4] = 0.0  # translation only: the exact window
    n = 1 << 21
    unif = lambda lo, hi, *s: torch.rand(s, generator=g, device="cuda") * (hi - lo) + lo  # noqa: E731
    c2 = unif(3.0, 6.0, n, 2)
    zeros = torch.zeros_like(c2)
    b1 = toi_cuda.pack_moving_obbs(zeros, unif(0.5, 3.0, n, 2), unif(0.0, 7.0, n), zeros,
                                   unif(-1.0, 1.0, n))
    b2 = toi_cuda.pack_moving_obbs(c2, unif(0.5, 3.0, n, 2), unif(0.0, 7.0, n),
                                   -c2 / c2.norm(dim=-1, keepdim=True), unif(-1.0, 1.0, n))
    return (pos, theta, wh, vel, omega), (b1, b2)


def toi_work(steps: torch.Tensor, rotating: torch.Tensor) -> dict:
    """Kernel 12's work on a batch from the plain version's steps (pair
    order): its pairs, rotating and translating pairs, distance evaluations
    (steps + 1 a rotating pair), and the evaluations when each group of 32
    pairs runs to its slowest (32 x its most)."""
    evals = torch.where(rotating, steps + 1, 0).to(torch.float64)
    pad = -evals.numel() % 32
    warp = torch.cat([evals, evals.new_zeros(pad)]).reshape(-1, 32).amax(dim=1)
    return dict(pairs=evals.numel(), rotating=int(rotating.sum()),
                translating=int((~rotating).sum()), evals=float(evals.sum()),
                warp_max_evals=32 * float(warp.sum()))


def phase_toi() -> dict:
    """Phase 14: kernel 12 on `CollisionProbabilityModel.time_of_impact` and
    against its plain version at the JAX bench's shape; returns its entry of
    the kernels line."""
    from collide2d_tpu_torch.models.collision_model import CollisionProbabilityModel
    from collide2d_tpu_torch.ops import toi_cuda
    from collide2d_tpu_torch.utils import cuda_build

    t = time.monotonic()
    kw = dict(t_max=8.0, iters=64, tol=1e-4)
    (pos, theta, wh, vel, omega), (b1, b2) = toi_inputs()
    rows = pos.shape[0]
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
    n = b1.shape[1] * b1.shape[2]
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
    work = toi_work(steps, rotating)
    ops = (work["evals"] * TOI_EVAL_OPS + work["rotating"] * TOI_SETUP_OPS
           + work["translating"] * TOI_WINDOW_OPS)
    bound, bound_by = _bound_ms(68 * n, ops)
    floor = toi_issue_floor(cuda_build.build("toi_kernel"), work)
    fingerprint = output_fingerprint(got)
    _line("14 moving_obb_toi", time.monotonic() - t, pairs=n, t_max=8.0, iters=64,
          tol=1e-4, hits_differ=differ, max_abs_dt=f"{dt:.3e}",
          bitwise_equal=bool(torch.equal(got, want)),
          hit_share=f"{float(torch.isfinite(want).float().mean()):.4f}",
          rotating_share=f"{float(rotating.float().mean()):.4f}",
          mean_steps=f"{float(steps.double().mean()):.2f}", max_steps=int(steps.max()),
          mean_warp_max_steps=f"{work['warp_max_evals'] / n - 1:.2f}",
          kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.2f}", bound_ms=f"{bound:.4f}",
          bound_by=bound_by, issue_floor_ms=f"{floor['issue_floor_ms']:.4f}",
          issue_floor_ms_at_warp_max=f"{floor['issue_floor_ms_at_warp_max']:.4f}",
          share_of_issue_floor=f"{floor['issue_floor_ms'] / ms:.3f}",
          sass_per_evaluation=floor["sass_per_evaluation"],
          sass_setup=floor["sass_setup"], sass_window=floor["sass_window"],
          kernel_queries_per_s=f"{n / ms * 1e3:.4e}", fingerprint=_json(fingerprint),
          parent_rows_equal=fingerprint == PARENT_FINGERPRINTS["moving_obb_toi"])
    return dict(launches=launches, max_abs_err=dt, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=bound_by, issue_floor_ms=floor["issue_floor_ms"])


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


def mc_moving_poly_ops_per_sample(k: int, k2: int, k2a: int,
                                  normal_method: str = "erfinv") -> int:
    """csrc/mc_moving_polygon_kernel.cu: kernel 7's normals, offsets and
    (u1, u2) (3 normals + 9), the relative velocity in the obstacle frame
    (6), each kept robot axis 5K + 13 (translation 3, K blends of 3,
    min/max, 2 adds, the speed 3, the window 8 with its division), each
    obstacle normal 5 K2 + 13, the hit test 3."""
    return (normals_ops(3, normal_method) + 9 + 6 + k2a * (5 * k + 13)
            + k * (5 * k2 + 13) + 3)


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
    gate = _z_gate(phase, name, cp["cuda"], cp["threefry"], n, t)
    return dict(max_z=gate["value"], frac3=gate["frac_z_gt3"], cp_threefry=cp["threefry"])


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
    launches["rotating_call_s"] = rot_s
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


def _moving_poly_k6(k8_ms: float) -> dict:
    """Kernel 14's k = 6 instance, the one the bench's legs launch
    (`bench_mc_moving_polygons_cuda`, the moving agreement leg), on the
    fused leg's rows against its plain version: sum |dcount| <= 1e-5 of the
    samples; its ms beside the k = 8 instance's (``k8_ms``)."""
    from collide2d_tpu_torch.mc import prng
    from collide2d_tpu_torch.ops import mc_cuda, mc_moving_polygon_cuda as mmp
    from collide2d_tpu_torch.ops import mc_polygon_cuda
    from collide2d_tpu_torch.utils.benchmarks import _bench_moving_polygon_configs

    t = time.monotonic()
    robot = np.asarray(POLY_ROBOT, np.float32)
    a_keep = mc_polygon_cuda.dedup_robot_axes(robot)
    dims = dict(k=6, k2=len(robot), k2a=len(a_keep))
    c, n = 4096, N_CHECK
    params = mmp.pack_moving_polygon_mc_params(
        _bench_moving_polygon_configs(c, 6, None, device="cuda"), robot, a_keep)
    uids = torch.arange(c, dtype=torch.int32, device="cuda")
    seed = mc_cuda.round_seed(prng.PRNGKey(12), 3)
    got = mmp.mc_moving_poly_counts(params, uids, seed, n, **dims)
    want = mmp.mc_moving_poly_counts_plain(params, uids, seed, n, max_elems=1 << 22, **dims)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    total = int(diff.sum())
    if total > MISMATCH_BOUND * c * n:
        raise RuntimeError(f"kernel 14 at k = 6 disagrees with its plain version: "
                           f"sum|dcount|={total}")
    if not 0 < int(got.sum()) < c * n:
        raise RuntimeError("degenerate kernel-14 counts at k = 6")
    ms = _events_ms(lambda: mmp.mc_moving_poly_counts(params, uids, seed, n, **dims), 20)
    plain_ms = _events_ms(lambda: mmp.mc_moving_poly_counts_plain(
        params, uids, seed, n, max_elems=1 << 22, **dims), 1)
    bound, bound_by = _bound_ms(c * (params.shape[1] * 4 + 8),
                                c * n * mc_moving_poly_ops_per_sample(**dims))
    counts_sum, counts_fp = _fingerprint(got)
    _line("17 mc_moving_poly k6", time.monotonic() - t, C=c, n=n, k=6,
          table_rows=params.shape[1], sum_abs_dcount=total,
          rows_differ=int((diff > 0).sum()), hit_share=f"{float(want.sum()) / (c * n):.4f}",
          counts_sum=counts_sum, counts_fingerprint=counts_fp, kernel_ms=f"{ms:.4f}",
          k8_kernel_ms=f"{k8_ms:.4f}", plain_ms=f"{plain_ms:.2f}",
          bound_ms=f"{bound:.4f}", bound_by=bound_by,
          kernel_samples_per_s=f"{c * n / ms * 1e3:.4e}")
    return dict(max_abs_err=int(diff.max()), ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by)


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
    del got, want, k14, k7, still
    result["at_k6"] = _moving_poly_k6(ms)
    result["max_abs_err"] = max(result["max_abs_err"], result["at_k6"]["max_abs_err"])
    result["box_muller"] = _box_muller_vs_plain(
        "17 mc_moving_poly box_muller", "workload", c, n, ms,
        lambda **kw: mmp.mc_moving_poly_counts(params, uids, seed, n, **dims, **kw),
        lambda **kw: mmp.mc_moving_poly_counts_plain(params, uids, seed, n,
                                                     max_elems=1 << 22, **dims, **kw),
        c * (params.shape[1] * 4 + 8),
        c * n * mc_moving_poly_ops_per_sample(**dims, normal_method="box_muller"))
    del params
    gate_cfgs = _moving_kgons(4096, seed=8)
    gate = _agreement_gate("mc_moving_poly", gate_cfgs, robot, "17 agreement")
    # the Box-Muller build against the same threefry counts, through its round
    # entry point; its launches there are its entry of the kernels line
    t = time.monotonic()
    mmp.reset_launches()
    n_gate = 1 << 16
    counts = mmp.mc_round_moving_polygons_cuda(
        prng.PRNGKey(8), torch.arange(gate_cfgs.num, dtype=torch.int32, device="cuda"),
        gate_cfgs, robot, 0, n_batch=n_gate, normal_method="box_muller")
    result["box_muller"]["launches"] = mmp.BOX_MULLER_LAUNCHES
    _z_gate("17 agreement box_muller", "mc_moving_poly box_muller",
            counts.cpu().numpy().astype(np.float64) / n_gate, gate["cp_threefry"],
            n_gate, t, launches=mmp.BOX_MULLER_LAUNCHES)

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


# The outputs' fingerprints (`output_fingerprint`) of the parent design of
# kernels 15 and 11 (one lane and one ray a thread, the segment and face
# counts at run time) on phases 18's and 19's inputs, as
# collide2d_tpu_torch/utils/screen_raycast_ab.py read them on an NVIDIA H100
# 80GB HBM3: a phase prints whether its rows still give them.
PARENT_FINGERPRINTS = {
    "screen": [[10487352, 52243561836], [3292475531722752, -2095983300125392896]],
    "bench": [[7934448592301371, 2642182077419583801], [28560672, 142395503675],
              [-355336895403970, -1781786261551589747]],
    "bench_tmax4": [[8722553871540300, 6572558719870126062], [6033627, 30030823062],
                    [-4074380463265, -18921781910312878]],
    "tiled_4096": [[75482540400096, 362644631784681500], [119206822, 572141867485],
                   [-1785034964261, -10319684041998149]],
    "mixed_k_mask": [[112542160542211, 539860471064536403], [10367747, 49638750314],
                     [-7435365211565, -37114815545445991]],
}
PARENT_FINGERPRINTS["tiled_4096_tile61"] = PARENT_FINGERPRINTS["tiled_4096"]
# Kernels 12 and 9 of the parent design (one pair a thread, run to its own
# convergence or straight through every axis and test) on phases 14's and
# 12's inputs, as collide2d_tpu_torch/utils/query_ab.py read them on an
# NVIDIA H100 80GB HBM3.
PARENT_FINGERPRINTS.update({
    "moving_obb_toi": [[2295888978931727, -7010529741765896440]],
    "polygon_distance_k8": [[3991350494082069, 1442949483532275846]],
    "polygon_distance_k4_k8": [[4048248728329246, 1723718990348694370]],
})
# Kernels 6 and 10 at K <= 16 before their builds took buckets above 16 (the
# default build is unchanged), on phases 9's and 13's inputs, as the
# libraries of the earlier sources gave them on an NVIDIA H100 80GB HBM3: a
# phase prints whether its rows still give them.
PARENT_FINGERPRINTS.update({
    "polygon_sat_k8": [[2969604972347392, -3641570457343229952]],
    "polygon_sat_k8_bf16": [[2967587193356288, -3651264824303681536]],
    "polygon_sat_k4_k6": [[2147658332372992, -7745487865244549120]],
    "polygon_sat_k4_k8": [[2350249095987200, -6731089513440870400]],
    "polygon_manifold_m0.0": [[10277302339206905, -4093843761959985904]],
    "polygon_manifold_m0.1": [[10312058850344697, -3921371372812138925]],
})


def screen_inputs():
    """Phase 18's inputs on the card, at the JAX bench's step: draws z
    (8,192, 512, 5) and the rotating rows' params (8,192, 16)."""
    from collide2d_tpu_torch.ops import screen_cuda

    params = screen_cuda.pack_screen_params(_moving_rects(ROT_ROWS, rotating=True),
                                            ROBOT_WH)
    z = torch.randn((ROT_ROWS, SCREEN_LANES, 5),
                    generator=torch.Generator(device="cuda").manual_seed(18), device="cuda")
    return z, params


def _json(x) -> str:
    return json.dumps(x, separators=(",", ":"))


def phase_screen() -> dict:
    """Phase 18: kernel 15 against its plain version at the JAX bench's
    step (8,192 rotating rows x 512 lanes); returns its entry of the kernels
    line."""
    from collide2d_tpu_torch.ops import screen_cuda
    from collide2d_tpu_torch.utils import cuda_build

    t = time.monotonic()
    z, params = screen_inputs()
    c, s = z.shape[0], z.shape[1]
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
    floor = screen_issue_floor(
        cuda_build.build("screen_kernel", screen_cuda.screen_defines(8)), c * s)
    fingerprint = output_fingerprint(flags, t0)
    shares = {f"share_bit{b}": f"{float(((want_f >> b) & 1).float().mean()):.4f}"
              for b in range(3)}
    ambiguous = ((want_f & 1) != 0) & ((want_f & 2) == 0)
    _line("18 screen", time.monotonic() - t, C=c, S=s, flags_differ=differ,
          bitwise_equal=bool(torch.equal(flags, want_f) and torch.equal(t0, want_t)),
          ambiguous_share=f"{float(ambiguous.float().mean()):.4f}", **shares,
          kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.3f}", bound_ms=f"{bound:.4f}",
          bound_by=bound_by, issue_floor_ms=f"{floor['issue_floor_ms']:.4f}",
          sass_per_lane=f"{floor['sass_per_lane']:.1f}",
          share_of_issue_floor=f"{floor['issue_floor_ms'] / ms:.3f}",
          kernel_lanes_per_s=f"{c * s / ms * 1e3:.4e}",
          kernel_gb_per_s=f"{28 * c * s / (ms * 1e-3) / 1e9:.1f}",
          fingerprint=_json(fingerprint),
          parent_rows_equal=fingerprint == PARENT_FINGERPRINTS["screen"])
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
                bound_ms=bound, bound_by=bound_by, issue_floor_ms=floor["issue_floor_ms"])


RAYS, RAY_SHAPES, RAY_K = 1 << 22, 64, 8
# FP32 operations kernel 11's plain version writes. A (ray, face): no and nd
# 6, num 1, the divisor's test and select 2, the division 1, the parallel
# test 2, lo and hi 6, the entry's test and 3 selects 4, the exit's min 1.
# A (ray, shape): the hit's 4 tests, the inside test, max and select 2, the
# argmin's test and 5 updates. `bound_ms` counts the IEEE division as one
# operation, as the other query kernels count theirs; beside it stands the
# kernel's issue floor (`raycast_issue_floor`), which counts the SASS a
# (ray, shape) issues, the division's fast path among it. A ray moves 32
# bytes: origin and direction in (16), t, index and normal out (16).
RAYCAST_FACE_OPS, RAYCAST_SHAPE_OPS = 23, 13
RAYCAST_RAY_BYTES = 32
RAYCAST_PALLAS_FACE_OPS = 16  # the Pallas cost estimate (raycast_pallas.py:138)
SCENE_N, SCENE_CAPACITY = 2048, 16_384
# The most face ties whose manifold may choose other faces than
# ops.manifold: the larger of a handful and 5% of the ties.
TIE_OTHER_FACES_MIN, TIE_OTHER_FACES_SHARE = 3, 0.05
SWEPT_N, SWEPT_WINDOW = 32_768, 128


def raycast_ops(rays: int, shapes: int, kp: int) -> int:
    return rays * shapes * (kp * RAYCAST_FACE_OPS + RAYCAST_SHAPE_OPS)


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


def raycast_inputs():
    """Phase 19's inputs on the card: the JAX bench's scene
    (utils/benchmarks.py:1963-1976: 2^22 rays, origins U(-50, 50)^2,
    directions standard normal, 64 regular 8-gons in a 40-side box) as
    (origin, direction, polys), and the kernel's cases as (name, table,
    origin, direction, t_max, tile_shapes): the scene at t_max inf and 4,
    4,096 shapes past one shared-memory tile x 2^16 rays with the default
    tile and a 61-shape tile, and 1,000 masked mixed-k shapes."""
    from collide2d_tpu_torch.ops import raycast_cuda

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(19)
    polys = _bench_polygons(g, RAY_SHAPES, RAY_K, area_side=40.0)
    origin = torch.rand((RAYS, 2), generator=g, device=dev) * 100.0 - 50.0
    direction = torch.randn((RAYS, 2), generator=g, device=dev)
    g2 = torch.Generator(device=dev).manual_seed(20)
    big = _bench_polygons(g2, 4096, RAY_K, area_side=320.0)
    mixed = _bench_polygons(g2, 1000, RAY_K, area_side=40.0)
    mask = torch.arange(RAY_K, device=dev)[None] < torch.randint(
        3, RAY_K + 1, (1000, 1), generator=g2, device=dev)
    mixed = torch.where(mask[..., None], mixed, 1e3)  # garbage padding, masked out
    r16 = 1 << 16
    o16 = torch.rand((r16, 2), generator=g2, device=dev) * 340.0 - 10.0
    d16 = torch.randn((r16, 2), generator=g2, device=dev)
    bench = raycast_cuda.pack_scene_tables(polys)
    tiled = raycast_cuda.pack_scene_tables(big)
    cases = (("bench", bench, origin, direction, math.inf, 0),
             ("bench_tmax4", bench, origin, direction, 4.0, 0),
             ("tiled_4096", tiled, o16, d16, math.inf, 0),
             ("tiled_4096_tile61", tiled, o16, d16, math.inf, 61),
             ("mixed_k_mask", raycast_cuda.pack_scene_tables(mixed, mask), origin[:r16],
              direction[:r16], math.inf, 0))
    return (origin, direction, polys), cases


def phase_raycast() -> dict:
    """Phase 19: kernel 11 on `scene_raycast(impl='auto')` and against its
    plain version; returns its entry of the kernels line."""
    from collide2d_tpu_torch.ops import raycast, raycast_cuda
    from collide2d_tpu_torch.utils import cuda_build

    t = time.monotonic()
    (origin, direction, polys), cases = raycast_inputs()
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
    first_tile = None
    for tag, table, o, d, t_max, tile in cases:
        t = time.monotonic()
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
        fingerprint = output_fingerprint(*got)
        fields = dict(case=tag, rays=r, shapes=table.shape[0], faces=table.shape[1],
                      t_max=t_max, rays_differ=differ, max_abs_diff=f"{err:.3e}",
                      bitwise_equal=all(map(torch.equal, got, want)),
                      hit_share=f"{float(torch.isfinite(want[0]).float().mean()):.4f}",
                      fingerprint=_json(fingerprint),
                      parent_rows_equal=fingerprint == PARENT_FINGERPRINTS[tag])
        if tag in ("bench", "tiled_4096"):
            ms, plain_ms = _compare(
                lambda: raycast_cuda.scene_raycast_cuda_t(o, d, table, t_max=t_max),
                lambda: raycast_cuda.scene_raycast_plain(o, d, table, t_max=t_max))
            shapes, kp = table.shape[0], table.shape[1]
            nbytes = RAYCAST_RAY_BYTES * r
            bound, bound_by = _bound_ms(nbytes, raycast_ops(r, shapes, kp))
            pallas = _bound_ms(nbytes, RAYCAST_PALLAS_FACE_OPS * r * shapes * kp)[0]
            counted, faces = raycast_cuda.scene_raycast_faces(o, d, table, t_max=t_max)
            if not all(map(torch.equal, counted, got)):
                raise RuntimeError(f"kernel 11's counting build differs ({tag})")
            floor = raycast_issue_floor(
                cuda_build.build("raycast_kernel", raycast_cuda.raycast_defines(kp)),
                r, shapes, kp, faces)
            fields.update(
                kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.3f}", bound_ms=f"{bound:.4f}",
                bound_by=bound_by, share_of_bound=f"{bound / ms:.3f}",
                issue_floor_ms=f"{floor['issue_floor_ms']:.4f}",
                issue_floor_ms_at_faces_evaluated=(
                    f"{floor['issue_floor_ms_at_faces_evaluated']:.4f}"),
                share_of_issue_floor=f"{floor['issue_floor_ms'] / ms:.3f}",
                sass_per_ray_face=f"{floor['sass_per_ray_face']:.2f}",
                faces_evaluated_share=f"{faces / (r * shapes * kp):.4f}",
                bound_ms_pallas_estimate=f"{pallas:.4f}",
                kernel_rays_per_s=f"{r / ms * 1e3:.4e}",
                plain_rays_per_s=f"{r / plain_ms * 1e3:.4e}")
            if tag == "bench":
                result.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                              issue_floor_ms=floor["issue_floor_ms"])
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
    k = polys.shape[1]
    plain = manifold_cuda.unpack_manifold(manifold_cuda.polygon_manifold_plain(
        polygon_cuda.pack_polygons(a), polygon_cuda.pack_polygons(b), k, k), count)
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


# ---- phases 24-27: k-gons above 16 vertices, kernel 7 at K = 20, the examples ----


BIG_K_PAIRS = 1 << 20
# Phase 24's (K1, K2): a 4-gon against 17-, 20-, 32- and 64-gons (the bucket
# pairs (4, 32) and (4, 64)) and 32-gons against 32-gons; every case is
# timed, and the kernels line carries the bucket pairs of `BIG_K_ENTRIES`
# (the ones phase 25's routes at k = 20 launch).
BIG_K_CASES = ((4, 17), (4, 20), (4, 32), (4, 64), (32, 32))
BIG_K_ENTRIES = ((4, 32), (32, 32))
BIG_K_ROWS = 1 << 20  # phase 25's model rows at k = 20
# (kernels line name, library, the TPU kernel it replaces)
BIG_K_KERNELS = (("sat_polygons", "polygon_kernel", "polygon_pallas.py:92"),
                 ("polygon_distance", "distance_kernel", "distance_pallas.py:229"),
                 ("polygon_manifold", "manifold_kernel", "manifold_pallas.py:181"))
# ptxas's registers and spill bytes of each big-bucket build (phase 1),
# by (library, K1 bucket, K2 bucket)
BIG_K_PTXAS: dict = {}
# Phase 26: kernel 7 at K = 20 against the 4-gon robot (2 kept axes)
K20_MC_ROWS, K20_MC_SAMPLES = 16_384, 4096
# Phase 27: the torch examples, and what the JAX files print for their
# deterministic numbers (quickstart's k-gon label, contact_queries' labels,
# scene pairs and the shape the ray hits)
EXAMPLES = ("quickstart", "polygon_labeling", "contact_queries", "trajectory_validation",
            "train_model")
QUICKSTART_KGON_LABEL = 1
# The kernels line's names (K <= 16 builds) by `bench.launch_counts`' numbers
KERNEL_NUMBERS = {
    "mc_counts": "1", "mc_counts_box_muller": "1bm", "sat_label": "2", "sat_count": "3",
    "obb_label": "4", "obb_count": "5", "sat_polygons": "6", "mc_poly_counts": "7",
    "mc_poly_counts_box_muller": "7bm", "obb_distance": "8", "polygon_distance": "9",
    "polygon_manifold": "10", "scene_raycast": "11", "moving_obb_toi": "12",
    "mc_toi_counts": "13", "mc_moving_poly_counts": "14",
    "mc_moving_poly_counts_box_muller": "14bm", "rotating_screen": "15", "stream_sum": "16"}
CONTACT_LABELS, CONTACT_SCENE_PAIRS, CONTACT_RAY_SHAPE = [1, 0, 0], 49, 15


def big_k_builds() -> list:
    """The libraries of kernels 6, 9 and 10 at the bucket pairs phases 24
    and 25 launch: (library, defines)."""
    from collide2d_tpu_torch.ops.polygon_cuda import kernel_defines

    return [(lib, kernel_defines(k1, k2)) for _, lib, _ in BIG_K_KERNELS
            for k1, k2 in ((4, 32), (4, 64), (32, 32))]


def _build_reported(name: str, defines) -> Path:
    """Build ``csrc/<name>.cu`` with ``defines`` where `cuda_build.load`
    looks for it, with ptxas's report (the -Xptxas -v flag does not change
    the binary) kept in `BIG_K_PTXAS`."""
    from collide2d_tpu_torch.utils import cuda_build
    from collide2d_tpu_torch.utils.mc_ab import _nvcc_report

    lib = cuda_build.library_path(name, defines)
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.tmp{os.getpid()}.so")
        t = time.monotonic()
        report = _nvcc_report(cuda_build.CSRC_DIR / f"{name}.cu", defines, tmp)
        os.replace(tmp, lib)
        d = dict(defines)
        # the k-gon kernel's float32 instantiation (kernel 6 also builds a
        # bfloat16 one, the distance library kernel 8)
        fn = next(v for k, v in sorted(report.items())
                  if "polygon_" in k and "bfloat16" not in k)
        BIG_K_PTXAS[(name, d["POLY_KB1"], d["POLY_KB2"])] = dict(
            fn, build_s=round(time.monotonic() - t, 1))
    return lib


def phase_big_k(card: str) -> dict:
    """Phase 24: kernels 6, 9 and 10 above 16 vertices against their plain
    versions at 2^20 pairs; returns the kernels line's entries of
    `BIG_K_ENTRIES` by (name, (K1, K2)) (phase 25 adds their launches)."""
    from collide2d_tpu_torch.ops import distance_cuda, manifold_cuda, polygon_cuda

    g = torch.Generator(device="cuda").manual_seed(24)
    n = BIG_K_PAIRS
    entries = {}
    for k1, k2 in BIG_K_CASES:
        t = time.monotonic()
        a = polygon_cuda.pack_polygons(_random_polygons(g, n, k1, 3.0))
        b = polygon_cuda.pack_polygons(_random_polygons(g, n, k2, 3.0))
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        calls = {
            "sat_polygons": (lambda: polygon_cuda.sat_polygons_cuda_t(a, b, k1=k1, k2=k2),
                             lambda: polygon_cuda.sat_polygons_plain(a, b, k1, k2)),
            "polygon_distance": (
                lambda: distance_cuda.polygon_distance_cuda_t(a, b, k1=k1, k2=k2),
                lambda: distance_cuda.polygon_distance_plain(a, b, k1, k2)),
            "polygon_manifold": (
                lambda: manifold_cuda.polygon_manifold_cuda_t(a, b, k1=k1, k2=k2),
                lambda: manifold_cuda.polygon_manifold_plain(a, b, k1, k2))}
        label, want_label = calls["sat_polygons"][0](), calls["sat_polygons"][1]().reshape(-1)
        label16 = polygon_cuda.sat_polygons_cuda_t(a16, b16, k1=k1, k2=k2)
        want16 = polygon_cuda.sat_polygons_plain(a16, b16, k1, k2).reshape(-1)
        dist, want_dist = (f() for f in calls["polygon_distance"])
        want_dist = want_dist.reshape(-1)
        man, want_man = (f() for f in calls["polygon_manifold"])
        torch.cuda.synchronize()
        differ = int((label != want_label.float()).sum())
        differ16 = int((label16 != want16.float()).sum())
        err9 = float((dist - want_dist).abs().max())
        signs9 = int(((dist <= 0) != (want_dist <= 0)).sum())
        vs_label = int(((dist <= 0) != (label > 0)).sum())
        differ10, err10 = _manifold_diff(manifold_cuda.unpack_manifold(man, n),
                                         manifold_cuda.unpack_manifold(want_man, n))
        share = float(want_label.float().mean())
        if (differ or differ16 or err9 > 2e-5 or signs9 or vs_label
                or differ10 > 1e-5 * n or err10 > 2e-5 or not 0.0 < share < 1.0):
            raise RuntimeError(
                f"k-gons ({k1}, {k2}): {differ} labels ({differ16} bf16) differ from kernel "
                f"6's plain version; kernel 9 by {err9}, {signs9} signs, {vs_label} against "
                f"kernel 6; kernel 10 {differ10} counts, values by {err10}; share {share}")
        timing = {}
        for name, lib, _ in BIG_K_KERNELS:
            fn, plain = calls[name]
            ms, plain_ms = _compare(fn, plain)
            nbytes = (2 * k1 + 2 * k2) * 4 + (36 if name == "polygon_manifold" else 4)
            ops = {"sat_polygons": sat_poly_ops_per_pair, "polygon_distance":
                   polygon_distance_ops, "polygon_manifold": manifold_ops}[name](k1, k2)
            bound, bound_by = _bound_ms(nbytes * n, ops * n)
            timing[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by)
            key = (_bucket(k1), _bucket(k2))
            if key in BIG_K_ENTRIES:
                entry = entries.setdefault((name, key), dict(max_abs_err=0.0))
                err = {"sat_polygons": float(differ), "polygon_distance": err9,
                       "polygon_manifold": err10}[name]
                entry["max_abs_err"] = max(entry["max_abs_err"], err)
                if (k1, k2) == key:  # the timed case fills its bucket exactly
                    ptxas = BIG_K_PTXAS.get((lib, *key), {})
                    entry.update(timing[name], registers=ptxas.get("registers"),
                                 spill_stores_bytes=ptxas.get("spill_stores"),
                                 spill_loads_bytes=ptxas.get("spill_loads"),
                                 stack_frame_bytes=ptxas.get("stack_frame"))
        bf16_ms = _events_ms(lambda: polygon_cuda.sat_polygons_cuda_t(a16, b16, k1=k1, k2=k2),
                             reps=20)
        _line("24 k-gons above 16", time.monotonic() - t, k1=k1, k2=k2,
              buckets=f"{_bucket(k1)}x{_bucket(k2)}", pairs=n, card=card.replace(" ", "_"),
              labels_differ=differ, labels_differ_bf16=differ16,
              collision_share=f"{share:.4f}",
              distance_max_abs_diff=f"{err9:.3e}",
              distance_bitwise=bool(torch.equal(dist, want_dist)),
              distance_sign_mismatch_vs_kernel6=vs_label,
              manifold_counts_differ=differ10, manifold_max_abs_diff=f"{err10:.3e}",
              manifold_bitwise=bool(torch.equal(man, want_man)),
              kernel6_bf16_ms=f"{bf16_ms:.4f}",
              **{f"{name}_{k}": (f"{v:.4f}" if isinstance(v, float) else v)
                 for name, row in timing.items() for k, v in row.items()})
        del a, b, a16, b16, label, label16, dist, man, want_label, want16, want_dist, want_man
        torch.cuda.empty_cache()
    return entries


def _regular_polygon(k: int, radius: float) -> np.ndarray:
    """A CCW regular k-gon around the origin: (k, 2) float32."""
    ang = np.arange(k) * (2.0 * np.pi / k)
    return (radius * np.stack([np.cos(ang), np.sin(ang)], -1)).astype(np.float32)


def _big_k_scene_matrix(polys: torch.Tensor, rows: int = 128) -> torch.Tensor:
    """`ops.sat.sat_polygons` on every pair of one shape set on its card,
    ``rows`` rows of the matrix at a time, diagonal False."""
    from collide2d_tpu_torch.ops.sat import sat_polygons

    n = polys.shape[0]
    out = []
    for r0 in range(0, n, rows):
        r1 = min(r0 + rows, n)
        i = torch.arange(r0, r1, device=polys.device).repeat_interleave(n)
        j = torch.arange(n, device=polys.device).repeat(r1 - r0)
        out.append((sat_polygons(polys[i], polys[j]) == 1).reshape(r1 - r0, n))
    m = torch.cat(out)
    m.fill_diagonal_(False)
    return m


def phase_big_k_routes(entries: dict) -> None:
    """Phase 25: the model and scene routes at k = 20 on the card; sets the
    launches of `phase_big_k`'s entries (each counted from 0 over its bucket
    pair's route: the 4-gon robot's for (4, 32), the 20-gon robot's and the
    scenes' for (32, 32))."""
    from collide2d_tpu_torch import bench
    from collide2d_tpu_torch.models.collision_model import (
        CollisionProbabilityModel,
        PolygonCollisionProbabilityModel,
        example_polygon_configs,
    )
    from collide2d_tpu_torch.ops import scene

    configs = example_polygon_configs(BIG_K_ROWS, k=20, seed=25, device="cuda")
    sub = slice(0, 1 << 16)
    head = type(configs)(*(a[sub] for a in configs))
    routes = {(4, 32): PolygonCollisionProbabilityModel(np.asarray(POLY_ROBOT, np.float32)),
              (32, 32): PolygonCollisionProbabilityModel(_regular_polygon(20, 1.2))}
    for key, model in routes.items():
        t = time.monotonic()
        bench.reset_launch_counts()
        labels = model.collide(configs)
        labels_cp = CollisionProbabilityModel().collide_polygons(
            model._placed_robot(configs), configs.obstacle_verts)
        dist = model.distance(configs, impl="auto")
        man = model.contact_manifold(configs)
        scene_fields = {}
        if key == (32, 32):
            g = torch.Generator(device="cuda").manual_seed(25)
            polys = _bench_polygons(g, SCENE_N, 20, area_side=40.0)
            m = scene.scene_collision_matrix(polys, row_tile=64)
            window = 512
            pairs, count, overflow, exceeded = scene.scene_colliding_pairs_swept(
                polys, capacity=SCENE_CAPACITY, window=window)
            sman = scene.scene_contact_manifolds(polys, capacity=SCENE_CAPACITY)
        torch.cuda.synchronize()
        launched = bench.launch_counts()
        counts = {name: launched[KERNEL_NUMBERS[name]] for name, _, _ in BIG_K_KERNELS}
        if min(counts.values()) <= 0:
            raise RuntimeError(f"the k = 20 routes of bucket pair {key} launched {counts}")
        for name, n in counts.items():
            entries[(name, key)]["launches"] = n
        want = model.collide(head, impl="torch")
        d_torch = model.distance(head, impl="torch")
        m_torch = model.contact_manifold(head, impl="torch")
        torch.cuda.synchronize()
        label_differ = int((labels[sub] != want).sum()) + int((labels_cp != labels).sum())
        sign = int(((dist <= 0).to(torch.int32) != labels).sum())
        d_err = float((dist[sub] - d_torch).abs().max())
        m_differ, m_err = _manifold_diff(tuple(a[sub] for a in man), m_torch)
        share = float(labels.float().mean())
        if label_differ or sign or d_err > 2e-5 or m_differ > 1e-5 * (1 << 16) \
                or m_err > 2e-5 or not 0.0 < share < 1.0:
            raise RuntimeError(
                f"k = 20 model route {key}: {label_differ} labels differ from impl='torch', "
                f"{sign} distance signs from the labels, distances by {d_err}, {m_differ} "
                f"manifold counts by {m_err}; share {share}")
        if key == (32, 32):
            want_m = _big_k_scene_matrix(polys)
            c = int(count)
            want_pairs = torch.triu(want_m, 1).nonzero().to(torch.int32)
            if not (torch.equal(m, want_m) and torch.equal(m, m.T)):
                raise RuntimeError(f"the k = 20 matrix differs from sat_polygons on "
                                   f"{int((m != want_m).sum())} pairs")
            if bool(exceeded) or bool(overflow) or c != len(want_pairs) \
                    or not torch.equal(pairs[:c], want_pairs):
                raise RuntimeError(f"the k = 20 swept pairs: count {c}, {len(want_pairs)} in "
                                   f"the matrix, exceeded {bool(exceeded)}")
            if not (torch.equal(sman[0][:c], want_pairs) and int(sman[1]) == c):
                raise RuntimeError("the k = 20 scene manifolds listed other pairs")
            scene_fields = dict(
                scene_shapes=SCENE_N, scene_window=window, scene_pairs=c,
                matrix_equal_sat_polygons=True, swept_equal_matrix=True,
                **_scene_manifold_check("k = 20 dense manifolds", sman, polys))
        _line("25 k = 20 routes", time.monotonic() - t, buckets=f"{key[0]}x{key[1]}",
              rows=BIG_K_ROWS, robot_k=len(model.robot_verts), obstacle_k=20,
              launches=_json(counts), collision_share=f"{share:.4f}",
              labels_differ_vs_torch=label_differ, distance_sign_mismatch=sign,
              distance_max_abs_vs_torch=f"{d_err:.3e}",
              manifold_counts_differ_vs_torch=m_differ,
              manifold_max_abs_vs_torch=f"{m_err:.3e}", **scene_fields)


def phase_mc_polygon_k20() -> dict:
    """Phase 26: kernel 7 at K = 20 (a library of its own) against its plain
    version on the same Philox stream, then on `PolygonCollisionProbabilityModel
    .label`'s route (its launches); returns its kernels line entry."""
    from collide2d_tpu_torch.mc import prng
    from collide2d_tpu_torch.mc.estimator import AdaptiveConfig
    from collide2d_tpu_torch.models.collision_model import (
        PolygonCollisionProbabilityModel,
        example_polygon_configs,
    )
    from collide2d_tpu_torch.ops import mc_cuda, mc_polygon_cuda

    t = time.monotonic()
    dev = torch.device("cuda")
    c, n = K20_MC_ROWS, K20_MC_SAMPLES
    robot = np.asarray(POLY_ROBOT, np.float32)
    a_keep = mc_polygon_cuda.dedup_robot_axes(robot)
    configs = example_polygon_configs(c, k=20, seed=26, device=dev)
    params = mc_polygon_cuda.pack_polygon_mc_params(configs, robot, a_keep)
    dims = dict(k=20, k2=len(robot), k2a=len(a_keep))
    uids = torch.arange(c, dtype=torch.int32, device=dev)
    seed = mc_cuda.round_seed(prng.PRNGKey(26), 1)
    got = mc_polygon_cuda.mc_poly_counts(params, uids, seed, n, **dims)
    want = mc_polygon_cuda.mc_poly_counts_plain(params, uids, seed, n, max_elems=1 << 22,
                                                **dims)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    total = int(diff.sum())
    if total > MISMATCH_BOUND * c * n or not 0 < int(got.sum()) < c * n:
        raise RuntimeError(f"kernel 7 at K = 20: sum|dcount| {total} against its plain "
                           f"version (bar {MISMATCH_BOUND * c * n:.0f}), counts "
                           f"{int(got.sum())} of {c * n}")
    ms, plain_ms = _compare(
        lambda: mc_polygon_cuda.mc_poly_counts(params, uids, seed, n, **dims),
        lambda: mc_polygon_cuda.mc_poly_counts_plain(params, uids, seed, n,
                                                     max_elems=1 << 22, **dims))
    bound, bound_by = _bound_ms(c * (params.shape[1] * 4 + 8),
                                c * n * mc_poly_ops_per_sample(**dims))
    mc_polygon_cuda.reset_launches()
    cp, used, done = PolygonCollisionProbabilityModel(robot).label(
        prng.PRNGKey(27), configs, AdaptiveConfig(max_samples=100_000))
    launches = mc_polygon_cuda.LAUNCHES
    if launches <= 0 or not (np.isfinite(cp).all() and (cp >= 0).all() and (cp <= 1).all()):
        raise RuntimeError(f"the k = 20 label route launched kernel 7 {launches} times")
    _line("26 k-gon mc k = 20", time.monotonic() - t, C=c, n=n, k=20, k2=len(robot),
          kept_axes=len(a_keep), table_rows=params.shape[1], sum_abs_dcount=total,
          rows_differ=int((diff > 0).sum()), counts_fingerprint=_json(_fingerprint(got)),
          kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.2f}", bound_ms=f"{bound:.4f}",
          bound_by=bound_by, label_route_launches=launches,
          label_mean_samples=f"{used.mean():.1f}", label_converged=f"{done.mean():.4f}")
    return dict(launches=launches, max_abs_err=int(diff.max()), ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=bound_by)


def _example_checks(name: str, out: dict) -> dict:
    """Phase 27's checks of one example's returned numbers; the fields its
    line prints."""
    def probabilities(*arrays):
        for a in arrays:
            a = np.asarray(a, np.float64)
            if not (np.isfinite(a).all() and (a >= 0).all() and (a <= 1).all()):
                raise RuntimeError(f"example {name}: a probability outside [0, 1]")

    if name == "quickstart":
        if out["labels"].tolist() != [1, 1, 0] or out["kgon_label"] != QUICKSTART_KGON_LABEL:
            raise RuntimeError(f"quickstart: labels {out['labels']}, k-gon label "
                               f"{out['kgon_label']}")
        probabilities(out["cp_fixed"], out["cp_adaptive"], out["cp_pruned"])
        return dict(labels=_json(out["labels"].tolist()), kgon_label=out["kgon_label"],
                    cp_adaptive=_json(out["cp_adaptive"].tolist()),
                    samples_used=_json(out["n_used"].tolist()))
    if name == "polygon_labeling":
        probabilities(out["cp_fixed"], out["cp"])
        if not 0.0 < out["collision_rate"] < 1.0:
            raise RuntimeError(f"polygon_labeling: collision rate {out['collision_rate']}")
        return dict(collision_rate=f"{out['collision_rate']:.4f}",
                    mean_cp=f"{out['cp'].mean():.4f}",
                    mean_samples=f"{out['n_used'].mean():.1f}",
                    converged=f"{out['converged'].mean():.4f}")
    if name == "contact_queries":
        if (out["labels"].tolist() != CONTACT_LABELS or out["n_pairs"] != CONTACT_SCENE_PAIRS
                or out["ray"][1] != CONTACT_RAY_SHAPE
                or not (out["distance"][0] < 0 < out["distance"][1])):
            raise RuntimeError(f"contact_queries: labels {out['labels']}, distances "
                               f"{out['distance']}, {out['n_pairs']} scene pairs, ray shape "
                               f"{out['ray'][1]}")
        return dict(labels=_json(out["labels"].tolist()),
                    distance=_json([round(float(x), 5) for x in out["distance"]]),
                    scene_pairs=out["n_pairs"], ray_shape=out["ray"][1])
    if name == "trajectory_validation":
        toi = out["toi"]
        if not (abs(toi[0] - 6.965) <= 1e-3 and abs(toi[1] - 6.965) <= 1e-3
                and np.isinf(toi[2])):
            raise RuntimeError(f"trajectory_validation: time of impact {toi}")
        probabilities(out["cp_fixed"], out["cp"], out["cp_kgon"])
        return dict(toi=_json([float(x) for x in toi]),
                    cp_fixed=_json(out["cp_fixed"].tolist()), pruned=out["pruned"],
                    converged=f"{out['converged'].mean():.4f}",
                    kgon_converged=f"{out['converged_kgon'].mean():.4f}")
    probabilities(out["pred"], out["val_mae"])
    if not np.isfinite(out["history"]).all():
        raise RuntimeError("train_model: a non-finite loss")
    return dict(rows=out["rows"], first_loss=f"{out['history'][0]:.5f}",
                last_loss=f"{out['history'][-1]:.5f}", val_mae=f"{out['val_mae']:.4f}",
                batch0_mae=f"{out['batch0_mae']:.4f}",
                batch0_mean_predictor_mae=f"{out['batch0_mean_mae']:.4f}")


def phase_examples() -> dict:
    """Phase 27: each torch example's ``main(device="cuda")`` in process at
    the JAX examples' sizes; returns the launches each kernel took over all
    five, by number."""
    import importlib.util

    from collide2d_tpu_torch import bench

    total: dict = {}
    for name in EXAMPLES:
        spec = importlib.util.spec_from_file_location(
            f"{name}_torch", HERE / "examples" / f"{name}_torch.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        bench.reset_launch_counts()
        t = time.monotonic()
        out, printed = _quiet(module.main, "cuda")
        torch.cuda.synchronize()
        ran = {k: v for k, v in bench.launch_counts().items() if v}
        for k, v in ran.items():
            total[k] = total.get(k, 0) + v
        _line(f"27 example {name}", time.monotonic() - t, kernels_launched=_json(ran),
              printed_lines=len(printed.splitlines()), **_example_checks(name, out))
    return total


# ---- phase 22: the bench entry points and kernel 16 ----


STREAM_PAIRS = 1 << 23


# Kernels that `run_all`'s legs launch (`bench.launch_counts`' numbers).
RUN_ALL_KERNELS = ("1", "3", "6", "7", "10", "11", "16")


def phase_bench() -> dict:
    """Phase 22: the bench headline and `run_all` on the card, then kernel
    16 against its plain version; returns kernel 16's entry of the kernels
    line."""
    from collide2d_tpu_torch import bench
    from collide2d_tpu_torch.ops import sat_cuda, stream_cuda
    from collide2d_tpu_torch.utils import benchmarks as bm

    t = time.monotonic()
    probes = []
    bench.reset_launch_counts()
    head = bench.headline(log=probes.append)
    for probe in probes:
        _line("22 bench probe", time.monotonic() - t, **{
            k: probe[k] for k in ("metric", "value", "seconds_per_iter", "bytes")})
    _line("22 bench headline", time.monotonic() - t, **head)
    if head["bandwidth_check"] != "ok" or not 0 < head["effective_gbps"] < math.inf:
        raise RuntimeError(f"bench headline: {head}")
    t = time.monotonic()
    legs = [json.loads(line) for line in bm.run_all(device="cuda")]
    counts = {k: v for k, v in bench.launch_counts().items() if k in RUN_ALL_KERNELS}
    for leg in legs:
        print("[22 run_all] " + json.dumps(leg), flush=True)
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


# Kernels the full bench launches (every leg of the root bench.py): all but
# the label kernels 2 and 4 and the Box-Muller builds of 7 and 14, which no
# leg of it runs.
FULL_BENCH_KERNELS = ("1", "1bm", "3", "5", "6", "7", "8", "9", "10", "11", "12", "13",
                      "14", "15", "16")
AGREEMENT_METRICS = ("cuda_vs_jnp_agreement", "polygon_agreement",
                     "moving_polygon_agreement")
TAIL_CHARS = 2000  # a harness that keeps the output's last 2,000 characters
LAUNCH_RECORD = "# launches "  # the bench's stderr line of launches and failed legs


def phase_full_bench() -> dict:
    """Phase 22, the full bench: ``python -m collide2d_tpu_torch.bench`` in a
    process of its own (its output and errors in one stream, as a harness
    that captures both reads them): exit code 0 and no leg failed; the last
    line the headline with ``bandwidth_check`` ok, the line before it the
    digest (at most `DIGEST_BUDGET` characters, n >= 25), both inside the
    last 2,000 characters; every agreement leg ``ok``; every kernel of
    `FULL_BENCH_KERNELS` launched. Returns the kernels' launches in the run
    and its wall seconds."""
    from collide2d_tpu_torch import bench

    torch.cuda.empty_cache()  # the bench's process takes the card's memory
    t = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "collide2d_tpu_torch.bench"], cwd=HERE,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=900)
    wall = time.monotonic() - t
    out = proc.stdout
    for line in out.splitlines():
        if line.startswith("# {"):
            print("[22 bench leg] " + line[2:], flush=True)
    lines = out.rstrip("\n").splitlines()
    if proc.returncode != 0:
        raise RuntimeError(f"the bench exited {proc.returncode}:\n{out[-4000:]}")
    records = [json.loads(line[len(LAUNCH_RECORD):]) for line in lines
               if line.startswith(LAUNCH_RECORD)]
    if len(records) != 1:
        raise RuntimeError(f"the bench printed {len(records)} launch records")
    record = records[0]
    if record["failed"]:
        raise RuntimeError(f"bench legs failed: {record['failed']}")
    head, digest = json.loads(lines[-1]), json.loads(lines[-2])
    if head.get("metric") != "sat_rect_pairs_per_sec" or head.get("bandwidth_check") != "ok":
        raise RuntimeError(f"the bench's last line is not an ok headline: {lines[-1]}")
    if digest.get("metric") != "digest" or digest["n"] < 25 or len(
            lines[-2]) > bench.DIGEST_BUDGET:
        raise RuntimeError(f"the bench's digest: {len(lines[-2])} characters, "
                           f"n={digest.get('n')}")
    tail = out[-TAIL_CHARS:]
    if lines[-1] not in tail or lines[-2] not in tail:
        raise RuntimeError("the digest and the headline are not both in the last "
                           f"{TAIL_CHARS} characters")
    results = [json.loads(line[2:]) for line in lines if line.startswith("# {")]
    agreement = {r["metric"]: r for r in results if r.get("metric") in AGREEMENT_METRICS}
    if set(agreement) != set(AGREEMENT_METRICS) or not all(
            r["ok"] for r in agreement.values()):
        raise RuntimeError(f"agreement legs: {agreement}")
    launches = record["launches"]
    missing = [k for k in FULL_BENCH_KERNELS if launches[k] <= 0]
    if missing:
        raise RuntimeError(f"the full bench never launched kernels {missing}: {launches}")
    _line("22 full bench", wall, exit_code=proc.returncode, legs=len(results),
          digest_chars=len(lines[-2]), digest_n=digest["n"],
          tail_chars=len(lines[-1]) + len(lines[-2]) + 2,
          agreement=",".join(f"{k}:{r['value']:.3f}:{r['ok']}" for k, r in
                             agreement.items()),
          launches=",".join(f"{k}:{v}" for k, v in launches.items()),
          wall_seconds=f"{wall:.1f}")
    print("[22 full bench digest] " + lines[-2], flush=True)
    return {"launches": launches, "seconds": wall}


# ---- kernels 1, 7, 13 and 14: the counts' fingerprint and the issue floor ----


_MESH_WORKER = r"""
import sys
from pathlib import Path

import numpy as np
import torch.distributed as dist

from collide2d_tpu_torch.data.pipeline import GenerateConfig, generate_dataset
from collide2d_tpu_torch.mc import prng
from collide2d_tpu_torch.mc.driver import adaptive_collision_probabilities
from collide2d_tpu_torch.mc.estimator import AdaptiveConfig
from collide2d_tpu_torch.parallel import (
    global_mesh, initialize_multihost, process_batch_range)
from chip_smoke import ROBOT_WH, _head_configs

addr, rank, data, shared, out, rows, devices = sys.argv[1:]
devices = devices.split(",")
initialize_multihost(addr, 2, int(rank))
r = process_batch_range(2)
generate_dataset(GenerateConfig(data_dir=shared, num_batches=len(r), batch_size=100_000,
                                start_batch_count=r.start, seed=7, verbose=False))
mesh = global_mesh(devices=devices)
assert mesh.shape == {"config": 2 * len(devices), "sample": 1}, mesh
assert mesh.spans_processes, mesh
cp, n, done = adaptive_collision_probabilities(
    prng.PRNGKey(21), _head_configs(Path(data), int(rows)), ROBOT_WH,
    AdaptiveConfig(), mesh=mesh)
np.savez(out, cp=cp, n=n, done=done)
dist.destroy_process_group()
"""
MESH_GLOBAL_ROWS = 16_384
MESH_THREEFRY_ROWS = 4096
MESH_ROT_ROWS, MESH_ROT_SAMPLES = 2048, 1024


def _head_configs(data: Path, n: int):
    """`Configs` of the first ``n`` rows of ``data``'s batch 0 on the card,
    gathered from its tables on the host (a gather computes nothing, so the
    rows equal the pipeline's device gather bit for bit)."""
    from collide2d_tpu_torch.data import schemas
    from collide2d_tpu_torch.mc.estimator import Configs

    rows = np.load(data / "0.npy")[:n]
    positions, var_idx, pose_idx = schemas.unpack_relabel_rows(rows[:, [0, 1, 3, 4]])
    poses = np.load(data / "poses.npy")
    sd = np.sqrt(np.load(data / "variances.npy"))
    pose_rows = poses[pose_idx.astype(np.int64)]
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),  # noqa: E731
                                    device="cuda")
    return Configs(f32(positions), f32(pose_rows[:, 2]), f32(pose_rows[:, 0:2]),
                   f32(sd[var_idx.astype(np.int64)]))


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _mesh_cards() -> tuple[list, str]:
    """The entries of phase 23's meshes and their description: every card
    when the machine has an even number of two or more, else four logical
    entries of cuda:0 (a repeated device is a shard that runs in turn)."""
    n = torch.cuda.device_count()
    if n >= 2 and n % 2 == 0:
        return [torch.device("cuda", i) for i in range(n)], f"{n} cards"
    return [torch.device("cuda", 0)] * 4, "cuda:0 x4"


def phase_mesh(work: Path, main_stats) -> dict:
    """Phase 23: the multi-device path over `_mesh_cards` (logical meshes
    of cuda:0 on a one-card machine, real ones on several cards), beside
    phase 3's `GenerateStats`; returns the launches of kernels 1, 7, 13,
    14 and 15 on it."""
    from collide2d_tpu_torch.data.pipeline import GenerateConfig, generate_dataset
    from collide2d_tpu_torch.mc import prng
    from collide2d_tpu_torch.mc.driver import adaptive_collision_probabilities as acp
    from collide2d_tpu_torch.mc.estimator import AdaptiveConfig, mc_round
    from collide2d_tpu_torch.models import learned
    from collide2d_tpu_torch.ops import (
        mc_cuda, mc_moving_polygon_cuda, mc_polygon_cuda, mc_toi_cuda, screen_cuda)
    from collide2d_tpu_torch.parallel import make_mesh

    cards, where = _mesh_cards()
    real = where != "cuda:0 x4"
    n = len(cards)
    meshes = {"config": make_mesh(cards), "mesh": make_mesh(cards, sample_axis=2)}
    shapes = {k: "({config},{sample})".format(**m.shape) for k, m in meshes.items()}
    data = work / "main"
    ref0 = (data / "0.npy").read_bytes()
    launches = {}

    # (a) generate at phase 3's settings, one batch, on the (n, 1) mesh that
    # --data_parallel builds and on the (n/2, 2) mesh, in turns with the
    # unsharded call: batch 0 is phase 3's byte for byte every time.
    t = time.monotonic()
    tables = dict(pose_dir=str(data / "poses.npy"), variance_dir=str(data / "variances.npy"))
    runs = {"plain": [], "config": [], "mesh": []}
    for turn in ("plain", "config", "mesh", "mesh", "config", "plain"):
        out = work / f"mesh_{turn}_{len(runs[turn])}"
        mc_cuda.reset_launches()
        stats = generate_dataset(GenerateConfig(
            data_dir=str(out), num_batches=1, batch_size=100_000, seed=7, verbose=False,
            mesh=meshes.get(turn), **tables))
        torch.cuda.synchronize()
        if turn == "mesh":
            launches["1"] = mc_cuda.LAUNCHES
        runs[turn].append(stats.label_seconds)
        if (out / "0.npy").read_bytes() != ref0:
            raise RuntimeError(f"generate ({turn}) batch 0 differs from phase 3's")
    if launches["1"] <= 0:
        raise RuntimeError("the mesh path never launched kernel 1")
    label = {k: min(v) for k, v in runs.items()}
    _line("23 mesh generate", time.monotonic() - t, entries=where,
          meshes=f"{shapes['config']},{shapes['mesh']}", rows=100_000, bitwise_phase3=True,
          **{f"label_s_{k}": "/".join(f"{x:.3f}" for x in v) for k, v in runs.items()},
          **{f"configs_per_s_{k}": f"{1e5 / s:.1f}" for k, s in label.items()},
          phase3_label_s_2_batches=f"{main_stats.label_seconds:.3f}",
          phase3_configs_per_s=f"{main_stats.rows / main_stats.label_seconds:.1f}",
          kernel1_launches=launches["1"])

    # (b) the CLI: --data_parallel is no mesh on one card and the (n, 1)
    # mesh on several; the same bytes. Beside it --trace_dir on a smaller
    # generate leaves a non-empty trace.
    t = time.monotonic()
    out = work / "mesh_cli"
    _quiet(_generate, ["--device", "cuda", "-n", "1", "-b", "100000", "--seed", "7",
                       "--data_parallel", "--pose_dir", tables["pose_dir"],
                       "--variance_dir", tables["variance_dir"], "--data_dir", str(out)])
    if (out / "0.npy").read_bytes() != ref0:
        raise RuntimeError("generate --data_parallel batch 0 differs from phase 3's")
    trace_dir = work / "trace"
    _quiet(_generate, ["--device", "cuda", "-n", "1", "-b", "16384", "--num_poses",
                       "4096", "--num_variances", "4096", "--seed", "3", "--trace_dir",
                       str(trace_dir), "--data_dir", str(work / "mesh_trace")])
    traces = list(trace_dir.glob("trace_*.json"))
    if len(traces) != 1 or traces[0].stat().st_size == 0:
        raise RuntimeError(f"--trace_dir wrote {traces}")
    events = json.loads(traces[0].read_text()).get("traceEvents", [])
    kernel_events = [e for e in events if e.get("cat") == "kernel"]
    _line("23 mesh cli", time.monotonic() - t, data_parallel_bitwise_phase3=True,
          trace_bytes=traces[0].stat().st_size, trace_events=len(events),
          trace_kernel_events=len(kernel_events),
          trace_has_mc_counts=any("mc_counts" in e.get("name", "") for e in kernel_events))

    # (c) kernels 1, 7, 13 and 14: one round each on 100,000 of phase 3's
    # rows and on phases 10's, 15's and 17's inputs, under both meshes:
    # one launch a mesh entry (added to the path's launches), counts
    # bitwise the unsharded launch's. Then
    # kernel 15, through the threefry path: a round of rotating rectangles
    # (phase 16's kind), its stage A on the card of every shard, bitwise too.
    t = time.monotonic()
    robot = np.asarray(POLY_ROBOT, np.float32)
    key = prng.PRNGKey(12)
    fields = {}
    rounds = (("1", _head_configs(data, 100_000), ROBOT_WH, mc_cuda,
               dict(n_batch=N_CHECK, impl="cuda")),
              ("7", _polygon_workload(POLY_ROWS, seed=11), robot, mc_polygon_cuda,
               dict(n_batch=N_CHECK, impl="cuda")),
              ("13", _moving_rects(TRAJ_ROWS, False), ROBOT_WH, mc_toi_cuda,
               dict(n_batch=N_CHECK, impl="cuda", ca_iters=0)),
              ("14", _moving_kgons(TRAJ_ROWS), robot, mc_moving_polygon_cuda,
               dict(n_batch=N_CHECK, impl="cuda", ca_iters=0)),
              ("15", _moving_rects(MESH_ROT_ROWS, True), ROBOT_WH, screen_cuda,
               dict(n_batch=MESH_ROT_SAMPLES, impl="threefry")))
    for kernel, configs, rb, mod, kw in rounds:
        reps = 1 if kernel == "15" else 3  # a threefry round takes ~1e2 ms
        uids = torch.arange(configs.num, dtype=torch.int32, device=cards[0])
        base = mc_round(key, uids, configs, rb, 3, **kw)
        fp = _fingerprint(base)
        fields[f"k{kernel}_fingerprint"] = f"{fp[0]},{fp[1]}"
        fields[f"k{kernel}_ms_plain"] = f"{_host_ms(lambda: mc_round(key, uids, configs, rb, 3, **kw), reps):.3f}"  # noqa: E501
        for name, mesh in meshes.items():
            mod.reset_launches()
            got = mc_round(key, uids, configs, rb, 3, mesh=mesh, **kw)
            torch.cuda.synchronize()
            count = mod.LAUNCHES
            launches[kernel] = launches.get(kernel, 0) + count
            # the fused kernels launch once an entry; stage A once a step
            if (count != n if kernel != "15" else count <= 0) or not torch.equal(got, base):
                raise RuntimeError(f"kernel {kernel} under the {shapes[name]} mesh: "
                                   f"{count} launches, bitwise={torch.equal(got, base)}")
            fields[f"k{kernel}_launches_{shapes[name]}"] = count
            fields[f"k{kernel}_ms_{shapes[name]}"] = f"{_host_ms(lambda: mc_round(key, uids, configs, rb, 3, mesh=mesh, **kw), reps):.3f}"  # noqa: E501
    _line("23 mesh kernels", time.monotonic() - t, entries=where, bitwise=True,
          samples=N_CHECK, rows_k15=MESH_ROT_ROWS, samples_k15=MESH_ROT_SAMPLES, **fields)

    # (d) the threefry path under a (1, n) sample mesh: an adaptive run of
    # 4,096 of phase 3's rows at a 20,000-sample cap, bitwise unsharded.
    t = time.monotonic()
    configs = _head_configs(data, MESH_THREEFRY_ROWS)
    cfg = AdaptiveConfig(impl="threefry", max_samples=20_000)
    t1 = time.monotonic()
    base = acp(prng.PRNGKey(22), configs, ROBOT_WH, cfg)
    plain_s = time.monotonic() - t1
    t1 = time.monotonic()
    got = acp(prng.PRNGKey(22), configs, ROBOT_WH, cfg,
              mesh=make_mesh(cards, sample_axis=n))
    mesh_s = time.monotonic() - t1
    if not all(np.array_equal(a, b) for a, b in zip(got, base)):
        raise RuntimeError(f"threefry labels under a (1, {n}) sample mesh differ")
    _line("23 mesh threefry", time.monotonic() - t, rows=MESH_THREEFRY_ROWS, cap=20_000,
          mesh=f"(1,{n})", entries=where, bitwise=True, seconds_plain=f"{plain_s:.3f}",
          seconds_mesh=f"{mesh_s:.3f}", mean_cp=f"{base[0].mean():.4f}")

    # (e) two processes over gloo (both on cuda:0, or each on half the
    # cards): disjoint process_batch_range slices of phase 3's 2 x 100,000
    # rows (the union is phase 3's files byte for byte), then a global mesh
    # (config axis over both processes) labeling 16,384 of its rows: every
    # process's labels equal this process's unsharded run.
    t = time.monotonic()
    shared = work / "mesh_shared"
    outs = [work / f"mesh_global_{r}.npz" for r in (0, 1)]
    addr = f"localhost:{_free_port()}"
    half = n // 2 if real else 1
    procs = []
    try:
        for r in (0, 1):
            env = dict(os.environ, PYTHONPATH=str(HERE))
            if real:
                env["CUDA_VISIBLE_DEVICES"] = ",".join(
                    str(i) for i in range(r * half, (r + 1) * half))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _MESH_WORKER, addr, str(r), str(data), str(shared),
                 str(outs[r]), str(MESH_GLOBAL_ROWS),
                 ",".join(f"cuda:{i}" for i in range(half))],
                cwd=str(HERE), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        for p in procs:
            _, err = p.communicate(timeout=300)
            if p.returncode != 0:
                raise RuntimeError(f"mesh worker exited {p.returncode}: "
                                   f"{err.decode()[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    two_s = time.monotonic() - t
    for name in ("0.npy", "1.npy", "poses.npy", "variances.npy"):
        if (shared / name).read_bytes() != (data / name).read_bytes():
            raise RuntimeError(f"two-process union: {name} differs from phase 3's")
    t1 = time.monotonic()
    want = acp(prng.PRNGKey(21), _head_configs(data, MESH_GLOBAL_ROWS), ROBOT_WH,
               AdaptiveConfig())
    one_s = time.monotonic() - t1
    for out in outs:
        with np.load(out) as z:
            if not all(np.array_equal(z[k], w) for k, w in zip(("cp", "n", "done"), want)):
                raise RuntimeError(f"{out.name}: global-mesh labels differ")
    _line("23 mesh processes", two_s, processes=2, backend="gloo", cards_each=half,
          union_bitwise_phase3=True, global_mesh_rows=MESH_GLOBAL_ROWS,
          global_labels_bitwise=True, single_process_label_s=f"{one_s:.3f}")

    # (f) data-parallel training over every card (two entries of cuda:0 on
    # one card) against one device, float32, within the CPU test's tolerance.
    t = time.monotonic()
    dp_cards = cards if real else cards[:2]
    feats, labels = learned.load_training_data(str(data), device="cuda")
    kw = dict(hidden=(256, 256, 256), epochs=3, batch_size=8192, val_fraction=0.0,
              seed=2, compute_dtype="float32")
    seconds = {"single": [], "dp": []}
    result = {}
    for kind in ("single", "dp", "dp", "single"):
        t1 = time.monotonic()
        result[kind] = learned.train_model(
            feats, labels, learned.TrainConfig(**kw, data_parallel=kind == "dp"),
            devices=dp_cards, device="cuda")
        seconds[kind].append(time.monotonic() - t1)
    single, dp = result["single"], result["dp"]
    worst = 0.0
    for k in single.params:
        a, b = np.asarray(dp.params[k]), np.asarray(single.params[k])
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)
        worst = max(worst, float(np.abs(a - b).max()))
    _line("23 mesh train", time.monotonic() - t, rows=feats.shape[0],
          devices=f"{len(dp_cards)} cards" if real else "2x cuda:0", epochs=3,
          max_abs_param_diff=f"{worst:.3e}",
          **{f"seconds_{k}": "/".join(f"{x:.3f}" for x in v) for k, v in seconds.items()},
          loss_single=f"{single.history[-1]:.5f}", loss_dp=f"{dp.history[-1]:.5f}")
    return launches


def _fingerprint(counts: torch.Tensor) -> tuple[int, int]:
    """(sum of the counts, sum of counts[c] * (c % 9973)): equal fingerprints
    on the same inputs say the bits held."""
    c = counts.to(torch.int64)
    weight = torch.arange(c.shape[0], device=c.device, dtype=torch.int64) % 9973
    return int(c.sum()), int((c * weight).sum())


_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def _shortest_iteration(ins: list, start: int, end: int, also: tuple = (),
                        most: bool = False, count: int | None = None) -> tuple:
    """(instructions, LDS, then the instructions of each opcode prefix in
    ``also``) on the shortest path through one iteration of the loop whose
    body is [start, end] (``end``: its backward branch), or from ``start`` to
    the instruction at ``end``: every conditional forward branch may go
    either way, nested loops run no second time, calls cost their one
    instruction. With ``most``, the shortest of the paths that hold the
    most instructions of the first prefix in ``also`` (a path that leaves
    early holds fewer); with ``count``, of those that hold exactly that
    many. The fewest instructions a warp can issue for one iteration."""
    most = most or count is not None
    body = [x for x in ins if start <= x[0] <= end]
    addrs = [x[0] for x in body]
    # per instruction: the shortest path to it for each count it holds of
    # also[0] (with ``most``; else one count)
    best = [{} for _ in body]
    best[0][0] = (0,) * (2 + len(also))
    for i, (addr, pred, op, args) in enumerate(body):
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
        done = []
        for held, path in best[i].items():
            here = (path[0] + 1, path[1] + op.startswith("LDS"),
                    *(n + op.startswith(prefix) for n, prefix in zip(path[2:], also)))
            if most:
                held += op.startswith(also[0])
            if addr == end:
                done.append((held, here))
                continue
            for j in succ:
                if best[j].get(held) is None or here < best[j][held]:
                    best[j][held] = here
        if addr == end:
            top = max((held for held, _ in done), default=None) if count is None else count
            if not any(held == top for held, _ in done):
                break
            return min(here for held, here in done if held == top)
    raise RuntimeError("no path through the loop")


def _sass_function(lib: Path, kernel: str) -> list:
    """The SASS of the kernel whose mangled name holds ``kernel`` in the
    library (``cuobjdump -sass``) as (address, predicate, opcode, operands)
    tuples, ``NOP`` padding left out."""
    from collide2d_tpu_torch.utils import cuda_build

    tool = Path(cuda_build.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    body = next(part for part in text.split("Function : ")[1:]
                if kernel in part.split("\n", 1)[0])
    return [(int(a, 16), pred.strip(), op, args)
            for a, pred, op, args in _SASS_LINE.findall(body) if op != "NOP"]


def _count(ins: list, lo: int, hi: int) -> dict:
    ops = [op for a, _, op, _ in ins if lo <= a <= hi]
    return dict(instructions=len(ops), lds=sum(op.startswith("LDS") for op in ops),
                calls=sum(op.startswith("CALL") for op in ops))


def _loops(ins: list) -> list:
    """Each loop (a predicated backward branch; an unpredicated one returns
    from out-of-line code, a divergent vote) with its body's instructions,
    ``LDS`` and ``CALL``, innermost first."""
    loops = []
    for a, pred, op, args in ins:
        target = re.search(r"0x([0-9a-f]+)", args) if op == "BRA" and pred else None
        if target and int(target.group(1), 16) < a:
            start = int(target.group(1), 16)
            loops.append(dict(start=start, end=a, **_count(ins, start, a)))
    loops.sort(key=lambda x: x["instructions"])
    return loops


def sass_loops(lib: Path, kernel: str) -> dict:
    """The SASS of the kernel whose mangled name holds ``kernel`` in the
    library: its instruction and ``LDS`` counts; each loop (`_loops`); and
    the shortest path through one iteration of the largest loop
    (`_shortest_iteration`)."""
    ins = _sass_function(lib, kernel)
    loops = _loops(ins)
    main = loops[-1]
    return dict(loops=loops, shortest=_shortest_iteration(ins, main["start"], main["end"]),
                **_count(ins, 0, 1 << 62))


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


def _issue_ms(instructions: float) -> tuple[float, float, float]:
    """(ms to issue ``instructions`` lane instructions on 132 SMs x 128 lanes
    at the SM clock's maximum, the clock now, its maximum), clocks in MHz."""
    now, top = _sm_clock_hz()
    return instructions / (132 * 128 * top) * 1e3, now / 1e6, top / 1e6


def screen_issue_floor(lib: Path, lanes: int) -> dict:
    """Kernel 15's issue floor for ``lanes`` lanes: the shortest SASS path
    through the lane part of the kernel (after its one barrier, to its last
    ``EXIT``; the library's segment count is built in and its loop unrolled;
    every forward branch may go either way, so ``sincosf``'s Payne-Hanek
    path and the IEEE division's slow path count nothing), over the lanes a
    thread takes."""
    import ctypes

    per_thread = ctypes.CDLL(str(lib)).rotating_screen_thread_lanes()
    ins = _sass_function(lib, "rotating_screen_kernel")
    start = max(a for a, _, op, _ in ins if op.startswith("BAR"))
    start = next(a for a, _, _, _ in ins if a > start)
    end = max(a for a, _, op, _ in ins if op.startswith("EXIT"))
    path = _shortest_iteration(ins, start, end)
    per_lane = path[0] / per_thread
    ms, now, top = _issue_ms(per_lane * lanes)
    return dict(sass_per_lane=per_lane, lds_per_lane=path[1] / per_thread,
                lanes_per_thread=per_thread, issue_floor_ms=ms, sm_clock_mhz=now,
                sm_clock_max_mhz=top)


def raycast_shape_loop(ins: list) -> dict:
    """Kernel 11's shape loop in its SASS: the largest loop that holds an
    IEEE division's ``MUFU.RCP`` and no barrier."""
    def has(loop, prefix):
        return any(op.startswith(prefix) for a, _, op, _ in ins
                   if loop["start"] <= a <= loop["end"])

    return [x for x in _loops(ins) if has(x, "MUFU.RCP") and not has(x, "BAR")][-1]


def raycast_issue_floor(lib: Path, rays: int, shapes: int, kp: int,
                        faces_evaluated: int | None = None) -> dict:
    """Kernel 11's issue floor for ``rays`` rays x ``shapes`` shapes of ``kp``
    faces, from a library built for ``kp`` (its faces unrolled): the
    shortest SASS path through one iteration of the shape loop
    (`raycast_shape_loop`) among those that divide most often, once for
    each face of each shape the iteration covers and each ray of the thread
    (the early exit's votes issue, their exits are not taken), a (ray,
    face), times rays x shapes x kp: every face evaluated. With
    ``faces_evaluated`` (the (ray, face) pairs a run evaluated) also that
    floor scaled to them."""
    import ctypes

    handle = ctypes.CDLL(str(lib))
    handle.scene_raycast_thread_rays.argtypes = [ctypes.c_longlong]
    per_thread = handle.scene_raycast_thread_rays(rays)
    ins = _sass_function(lib, f"scene_raycast_kernelILi{per_thread}EE")
    shape = raycast_shape_loop(ins)
    path = _shortest_iteration(ins, shape["start"], shape["end"], also=("MUFU.RCP",),
                               most=True)
    if path[2] == 0 or path[2] % (kp * per_thread):
        raise RuntimeError(f"kernel 11's shape loop divides {path[2]} times, not a "
                           f"multiple of {kp} faces x {per_thread} rays")
    per_face = path[0] / path[2]
    ms, now, top = _issue_ms(per_face * rays * shapes * kp)
    out = dict(sass_per_ray_shape=per_face * kp, sass_per_ray_face=per_face,
               lds_per_ray_shape=path[1] * kp / path[2], rays_per_thread=per_thread,
               shapes_per_iteration=path[2] // (kp * per_thread), issue_floor_ms=ms,
               sm_clock_mhz=now, sm_clock_max_mhz=top)
    if faces_evaluated is not None:
        out["issue_floor_ms_at_faces_evaluated"] = ms * faces_evaluated / (rays * shapes * kp)
    return out


def _holds(ins: list, loop: dict, prefix: str) -> int:
    """The instructions of the loop's body whose opcode starts with
    ``prefix``."""
    return sum(op.startswith(prefix) for a, _, op, _ in ins
               if loop["start"] <= a <= loop["end"])


def _path(ins: list, start: int, end: int, prefix: str, want: int) -> tuple:
    """`_shortest_iteration` among the paths with the most ``prefix``
    instructions, which must be ``want``."""
    path = _shortest_iteration(ins, start, end, also=(prefix,), most=True)
    if path[2] != want:
        raise RuntimeError(f"the path over [{start:#x}, {end:#x}] holds {path[2]} "
                           f"{prefix}, not {want}")
    return path


def _largest(loops: list, keep, what: str) -> dict:
    """The largest of ``loops`` that ``keep`` holds, or an error naming
    ``what``."""
    kept = [x for x in loops if keep(x)]
    if not kept:
        raise RuntimeError(f"no loop in the SASS holds {what}")
    return kept[-1]


def toi_issue_floor(lib: Path, work: dict) -> dict:
    """Kernel 12's issue floor for `toi_work`'s ``work``: the shortest SASS
    path through one iteration of its stepping loop (the loop holding the
    distance's one ``MUFU.RSQ`` and no refill), the evaluation taken, a
    distance evaluation; through the refill loop (the one that loads the
    pairs), less its shortest iteration, once a pair: the path with the
    bound's three ``MUFU.RSQ`` a rotating pair's set-up, the one with the
    window's four ``MUFU.RCP`` a translating pair's window. Every forward
    branch may go either way, so ``sincosf``'s Payne-Hanek path and the
    IEEE division's and square root's slow paths count nothing. At the
    evaluations this run's pairs take, and at the evaluations of their
    groups of 32 run to the slowest (one pair a thread)."""
    ins = _sass_function(lib, "moving_obb_toi_kernel")
    loops = _loops(ins)
    refill = max(loops, key=lambda x: (_holds(ins, x, "LDG"), x["instructions"]))
    step = _largest(loops, lambda x: _holds(ins, x, "MUFU.RSQ") and _holds(ins, x, "STG")
                    and (x["end"] < refill["start"] or x["start"] > refill["end"]),
                    "an evaluation outside the refill")
    per_eval = _path(ins, step["start"], step["end"], "MUFU.RSQ", 1)[0]
    base = _shortest_iteration(ins, refill["start"], refill["end"])[0]
    setup = _path(ins, refill["start"], refill["end"], "MUFU.RSQ", 3)[0] - base
    window = _path(ins, refill["start"], refill["end"], "MUFU.RCP", 4)[0] - base
    pairs = work["rotating"] * setup + work["translating"] * window
    ms, now, top = _issue_ms(work["evals"] * per_eval + pairs)
    return dict(sass_per_evaluation=per_eval, sass_setup=setup, sass_window=window,
                issue_floor_ms=ms,
                issue_floor_ms_at_warp_max=_issue_ms(work["warp_max_evals"] * per_eval
                                                     + pairs)[0],
                sm_clock_mhz=now, sm_clock_max_mhz=top)


def polygon_distance_issue_floor(lib: Path, k1: int, k2: int, pairs: int,
                                 undecided: int, separated: int) -> dict:
    """Kernel 9's issue floor for ``pairs`` pairs at (k1, k2), from the
    instantiation of their K buckets: the shortest SASS path between the
    block's first two barriers with every load (the first pass: a pair's
    loads and polygon 1's first normals), a pair; through one iteration of
    the loop over the listed pairs (the one holding every axis's
    ``MUFU.RSQ`` and every point-segment test's ``FMUL.SAT``), the path
    holding every test and one ``MUFU.RSQ`` (the final sqrt) a pair the
    first pass separated, the one holding K1 + K2 ``MUFU.RSQ`` and no sqrt
    an overlapping pair, the one holding K1 + K2 + 1 a pair that takes
    every axis and every test. Every forward branch may go either way (the
    division's and square root's slow paths count nothing). The full work,
    every pair through every axis and every test, and the work evaluated,
    as the library's counting build counts it: ``undecided`` pairs through
    every axis, ``separated`` through the tests."""
    kb1, kb2 = _bucket(k1), _bucket(k2)
    ins = _sass_function(lib, f"polygon_distance_kernelILi{kb1}ELi{kb2}E")
    bars = [a for a, _, op, _ in ins if op.startswith("BAR")]
    tests = 2 * kb1 * kb2
    first = _path(ins, bars[0], bars[1], "LDG", 2 * (kb1 + kb2))[0]
    body = _largest(_loops(ins), lambda x: _holds(ins, x, "MUFU.RSQ") > kb1 + kb2
                    and _holds(ins, x, "FMUL.SAT") >= tests,
                    "every axis's MUFU.RSQ and every test's FMUL.SAT")
    lo, hi = body["start"], body["end"]
    early = _shortest_iteration(ins, lo, hi, also=("FMUL.SAT", "MUFU.RSQ"), count=tests)
    if early[3] != 1:
        raise RuntimeError(f"kernel 9's separated path holds {early[3]} MUFU.RSQ")
    overlap = _shortest_iteration(ins, lo, hi, also=("MUFU.RSQ",), count=kb1 + kb2)[0]
    both = _shortest_iteration(ins, lo, hi, also=("MUFU.RSQ",), count=kb1 + kb2 + 1)[0]
    late = separated - (pairs - undecided)  # undecided pairs that do not overlap
    evaluated = (pairs * first + (pairs - undecided) * early[0]
                 + (undecided - late) * overlap + late * both)
    ms, now, top = _issue_ms(pairs * both)
    return dict(sass_per_pair=both, sass_first_pass=first, sass_separated_early=early[0],
                sass_overlapping=overlap, sass_per_pair_evaluated=evaluated / pairs,
                issue_floor_ms=ms, issue_floor_ms_at_work_evaluated=_issue_ms(evaluated)[0],
                sm_clock_mhz=now, sm_clock_max_mhz=top)


def output_fingerprint(*outputs: torch.Tensor) -> list:
    """`_fingerprint` of each output's 32-bit words, flattened: equal
    fingerprints on the same inputs say the outputs' bits held."""
    return [list(_fingerprint(x.contiguous().view(torch.int32).reshape(-1)))
            for x in outputs]


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
        launches, main_stats = phase_main_path(work)
        phase_acceptance(work)
        phase_invariance(work)
        sat = phase_sat()
        phase_relabel(work)
        phase_prune_opt(work)
        phase_resume(work, card)
        learned_launches = phase_learned(work, card)
        poly_sat = phase_polygon_sat()
        poly_mc = phase_mc_polygon()
        poly_mc["launches"] = phase_polylabel(work)
        mesh_launches = phase_mesh(work, main_stats)
    queries = phase_distance()
    # kernel 8 runs on two paths: the geometry queries (phase 12) and the
    # learned model's features (phase 8c), each counted from 0
    k8 = queries["obb_distance"]
    k8["launches_by_path"] = {"distance": k8["launches"], "learned": learned_launches}
    k8["launches"] += learned_launches
    queries["polygon_manifold"] = phase_manifold()
    queries["moving_obb_toi"] = phase_toi()
    mc_toi = phase_mc_toi()
    rotating = mc_toi.pop("rotating")
    _line("15 mc_toi steps", 0.0, rotating_mean_steps=f"{rotating['mean_steps']:.2f}",
          rotating_warp_max_steps=f"{rotating['warp_max_steps']:.2f}",
          rotating_kernel_ms=f"{rotating['ms']:.4f}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        traj_launches = phase_movelabel_rects(Path(tmp))
        phase_resume_rotating(Path(tmp), card, traj_launches["rotating_call_s"])
        moving_poly = phase_mc_moving_polygon(Path(tmp))
    screen = phase_screen()
    raycast = phase_raycast()
    phase_scene_dense()
    phase_scene_swept()
    stream = phase_bench()
    full_bench = phase_full_bench()
    big_k = phase_big_k(card)
    phase_big_k_routes(big_k)
    mc_poly_k20 = phase_mc_polygon_k20()
    example_launches = phase_examples()
    mc_toi["launches"] = traj_launches["13"]
    screen["launches"] = traj_launches["15"]
    # kernels 1, 7, 13, 14 and 15 also run on the mesh path (phase 23),
    # each path counted from 0
    for entry, path, kernel in ((poly_mc, "polylabel", "7"), (mc_toi, "movelabel", "13"),
                                (moving_poly, "movelabel", "14"),
                                (screen, "movelabel", "15")):
        entry["launches_by_path"] = {path: entry["launches"], "mesh": mesh_launches[kernel]}
        entry["launches"] += mesh_launches[kernel]
    default = check["default"]
    bm1 = dict(default["box_muller"], launches=full_bench["launches"]["1bm"],
               max_abs_err=max(check[k]["box_muller"]["max_abs_err"] for k in check))
    poly_mc_bm = poly_mc.pop("box_muller")
    moving_poly_bm = moving_poly.pop("box_muller")
    kernels = {"kernels": [{
        "name": "mc_counts",
        "route": "cuda",
        "source": "collide2d_tpu_torch/csrc/mc_kernel.cu",
        "replaces": "collide2d_tpu/ops/mc_pallas.py:207",
        "launches": launches + mesh_launches["1"],
        "launches_by_path": {"generate": launches, "mesh": mesh_launches["1"]},
        "max_abs_err": max(check[k]["max_abs_err"] for k in check),
        "ms": default["kernel_ms"],
        "plain_ms": default["plain_ms"],
        "bound_ms": default["bound_ms"],
        "bound_by": default["bound_by"],
        "issue_floor_ms": default["issue_floor_ms"],
        "library_ms": None,
    }] + [{
        # the Box-Muller builds (-DMC_BOX_MULLER=1) of kernels 1, 7 and 14:
        # the TPU kernels' normal_method="box_muller"
        "name": f"{name}_box_muller",
        "route": "cuda",
        "source": f"collide2d_tpu_torch/csrc/{source}",
        "replaces": f"collide2d_tpu/ops/{replaces}",
        **entry,
        "library_ms": None,
    } for name, source, replaces, entry in (
        ("mc_counts", "mc_kernel.cu", "mc_pallas.py:207", bm1),
        ("mc_poly_counts", "mc_polygon_kernel.cu", "mc_polygon_pallas.py:254", poly_mc_bm),
        ("mc_moving_poly_counts", "mc_moving_polygon_kernel.cu",
         "mc_moving_polygon_pallas.py:182", moving_poly_bm))] + [{
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
    }] + [{
        # kernels 6, 9 and 10 above 16 vertices: their builds for the bucket
        # pairs the k = 20 routes take (phases 24 and 25)
        "name": f"{name}_k{key[0]}_k{key[1]}",
        "route": "cuda",
        "source": f"collide2d_tpu_torch/csrc/{lib}.cu",
        "replaces": f"collide2d_tpu/ops/{replaces}",
        **big_k[(name, key)],
        "library_ms": None,
    } for name, lib, replaces in BIG_K_KERNELS for key in BIG_K_ENTRIES] + [{
        "name": "mc_poly_counts_k20",
        "route": "cuda",
        "source": "collide2d_tpu_torch/csrc/mc_polygon_kernel.cu",
        "replaces": "collide2d_tpu/ops/mc_polygon_pallas.py:254",
        **mc_poly_k20,
        "library_ms": None,
    }]}
    # the examples' launches (phase 27), a path of their own
    for entry in kernels["kernels"]:
        n = example_launches.get(KERNEL_NUMBERS.get(entry["name"]), 0)
        if n:
            entry.setdefault("launches_by_path", {"main": entry["launches"]})["examples"] = n
            entry["launches"] += n
    print(f"[done] seconds={time.monotonic() - t0:.1f}", flush=True)
    print(card, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
