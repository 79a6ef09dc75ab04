"""A plain Monte Carlo labeler: the reference put in the program's place.

Each row draws pose noise (dx, dy, dtheta) with a ``torch.Generator``,
places both polygons and counts overlaps by the separating-axis test over
every edge normal of both; it stops at the first checkpoint of the
reference cadence (1,000 samples a round up to 20,000, then 100,000 a
round, generate_dataset.cu:427-430) where the stopping rule holds, or at
the cap. ``dtype`` is the precision of every geometric operation: float32
is the precision the configurations state, bfloat16 the control that has
to come out as not correct.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import stopping

# Samples x rows x axes x vertices per block of the test.
BLOCK_ELEMS = 1 << 24


def checkpoints(max_samples: int) -> list[int]:
    pts = list(range(1000, 20_001, 1000))
    while pts[-1] < max_samples:
        pts.append(min(max_samples, pts[-1] + 100_000))
    return pts


def _normals(v: torch.Tensor) -> torch.Tensor:
    e = torch.roll(v, -1, dims=-2) - v
    return torch.stack([e[..., 1], -e[..., 0]], dim=-1)


def _hits(position, robot_theta, robot, obstacle, sd, n: int, gen,
          dtype) -> torch.Tensor:
    """Overlapping samples among ``n`` for each row (int64)."""
    r, k = obstacle.shape[:2]
    k2 = robot.shape[-2]
    c, s = torch.cos(robot_theta)[:, None], torch.sin(robot_theta)[:, None]
    rx, ry = robot[..., 0], robot[..., 1]
    placed = torch.stack([c * rx - s * ry + position[:, :1],
                          s * rx + c * ry + position[:, 1:]], dim=-1)  # (R, K2, 2)
    robot_axes = _normals(placed)
    obstacle_axes = _normals(obstacle)
    hits = torch.zeros(r, dtype=torch.int64, device=position.device)
    step = max(1, BLOCK_ELEMS // max(1, r * (k + k2) * (k + k2)))
    for j in range(0, n, step):
        m = min(step, n - j)
        z = torch.randn((r, m, 3), generator=gen, device=position.device,
                        dtype=torch.float32).to(dtype) * sd[:, None, :]
        ct, st = torch.cos(z[..., 2])[..., None], torch.sin(z[..., 2])[..., None]
        ox, oy = obstacle[:, None, :, 0], obstacle[:, None, :, 1]
        moved = torch.stack([ct * ox - st * oy + z[..., :1],
                             st * ox + ct * oy + z[..., 1:2]], dim=-1)  # (R, M, K, 2)
        ax, ay = obstacle_axes[:, None, :, 0], obstacle_axes[:, None, :, 1]
        turned = torch.stack([ct * ax - st * ay, st * ax + ct * ay], dim=-1)
        axes = torch.cat([robot_axes[:, None].expand(r, m, k2, 2), turned], dim=-2)
        pr = (axes[..., None, 0] * placed[:, None, None, :, 0]
              + axes[..., None, 1] * placed[:, None, None, :, 1])
        po = (axes[..., None, 0] * moved[:, :, None, :, 0]
              + axes[..., None, 1] * moved[:, :, None, :, 1])
        sep = ((pr.amax(-1) < po.amin(-1)) | (po.amax(-1) < pr.amin(-1))).any(-1)
        hits += (~sep).sum(dim=1)
    return hits


def label(position, robot_theta, robot_verts, obstacle_verts, sd, *, seed: int,
          accuracy_bins, bin_accuracy, max_samples: int, device,
          dtype=torch.float32) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(cp float32, n int64, converged bool) of each row, as the program's
    labels are."""
    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device).to(dtype)

    n_rows = len(position)
    position, robot_theta, sd = t(position), t(robot_theta), t(sd)
    obstacle = t(obstacle_verts)
    robot = t(np.broadcast_to(np.asarray(robot_verts, np.float32),
                              (n_rows,) + np.shape(robot_verts)[-2:]))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    n = np.zeros(n_rows, np.int64)
    k = np.zeros(n_rows, np.int64)
    done = np.zeros(n_rows, bool)
    active = np.arange(n_rows)
    for point in checkpoints(max_samples):
        if active.size == 0:
            break
        idx = torch.as_tensor(active, device=device)
        got = _hits(position[idx], robot_theta[idx], robot[idx], obstacle[idx],
                    sd[idx], point - int(n[active[0]]), gen, dtype)
        k[active] += got.cpu().numpy()
        n[active] = point
        ok = stopping.meets_rule(n[active], k[active], accuracy_bins, bin_accuracy)
        done[active[ok]] = True
        active = active[~ok]
    cp = (k.astype(np.float64) / np.maximum(n, 1)).astype(np.float32)
    return cp, n, done
