"""Drives ``collide2d-torch generate``: one call that labels and writes
``num_batches`` batch files against the benchmark's tables.

Set-up makes the configuration's pose and variance tables from the seed on
the device, writes them as ``.npy`` for ``--pose_dir`` / ``--variance_dir``
(both sides read the same arrays), and runs a warm-up call of the traffic's
``warm_batches`` batches (other batch indices, so other configurations).
The timed call labels ``num_batches`` = the run's seconds times the
traffic's ``batches_per_second`` (the pace measured when the mix was
added), a fixed amount of work for every run of a length. The timed call is the program's own entry,
``generate_dataset(cli.generate_config(cli.parse_args([...])))``, so its
``GenerateStats`` counters come back.

While the timed call runs, a recorder wrapped around the adaptive
driver's ``AdaptiveRun.materialize`` keeps each finished batch's
configurations and its (cp, n, converged) in input order, and the time it
finished. After the window every written file is matched to them row by
row, by position, and held to the tables the benchmark handed in.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from benchmark.core.compare import Labeled
from benchmark.gen import rows
from benchmark.reference.exact import rect_vertices

WARM_START = 1_000_000  # batch indices of the warm-up call


def _key(position: np.ndarray) -> np.ndarray:
    """A row's position as one 64-bit key (float32 x and y, bitwise)."""
    return np.ascontiguousarray(position, np.float32).view(np.uint64).ravel()


class _Recorder:
    """Wraps ``AdaptiveRun.materialize`` while installed."""

    def __init__(self) -> None:
        self.batches: list = []
        self.times: list[float] = []

    def __enter__(self):
        from collide2d_tpu_torch.mc import driver

        self._cls = driver.AdaptiveRun
        self._orig = self._cls.materialize
        orig, batches, times = self._orig, self.batches, self.times

        def materialize(run):
            out = orig(run)
            batches.append((run.configs, out))
            times.append(time.perf_counter())
            return out

        self._cls.materialize = materialize
        return self

    def __exit__(self, *exc) -> None:
        self._cls.materialize = self._orig


def _span_targets():
    """The program's layers a traced window spans (main thread only)."""
    from collide2d_tpu_torch.data import pipeline, schemas
    from collide2d_tpu_torch.mc import driver
    from collide2d_tpu_torch.utils import native

    return [(pipeline, "load_npy", "load_table"),
            (pipeline, "run_interleaved", "label_batches"),
            (driver.AdaptiveScheduler, "step", "driver_step"),
            (driver.AdaptiveRun, "materialize", "batch_outputs"),
            (schemas, "pack_dataset_rows", "pack_rows"),
            (pipeline, "_shuffle_rows", "shuffle_rows"),
            (native.AsyncNpyWriter, "submit", "write_submit"),
            (native.AsyncNpyWriter, "flush", "write_flush")]


class Run:
    def __init__(self, cell, seed: int, device: str, workdir: Path, spans,
                 seconds: float) -> None:
        self.cell, self.device, self.spans = cell, device, spans
        cfg, traffic = cell.config, cell.traffic
        self.batch_size = int(traffic.get("batch_size", cfg["batch_size"]))
        poses, variances = rows.tables(cfg, seed, device)
        self.poses = poses.cpu().numpy()
        self.variances = variances.cpu().numpy()
        del poses, variances
        tables = workdir / "tables"
        tables.mkdir(parents=True)
        np.save(tables / "poses.npy", self.poses)
        np.save(tables / "variances.npy", self.variances)
        self.workdir = workdir
        self.argv = [
            "generate", "--device", device, "--verbose", "false",
            "--pose_dir", str(tables / "poses.npy"),
            "--variance_dir", str(tables / "variances.npy"),
            "--batch_size", str(self.batch_size),
            "--max_samples", str(cfg["max_samples"]),
            "--accuracy_bins", *map(str, cfg["accuracy_bins"]),
            "--bin_accuracy", *map(str, cfg["bin_accuracy"]),
            "--robot_width", str(cfg["robot_width"]),
            "--robot_height", str(cfg["robot_height"]),
            "--spread", str(cfg["spread"]),
            "--seed", str(rows.sub_seed(seed, "program") % 2**31),
            *traffic["args"],
        ]
        self._free_device_cache()
        with spans.span("warm"):
            self._call(workdir / "warm", traffic["warm_batches"], WARM_START)
        self.num_batches = max(2, round(seconds * traffic["batches_per_second"]))

    def _free_device_cache(self) -> None:
        if self.device != "cpu":
            torch.cuda.empty_cache()

    def _call(self, data_dir: Path, num_batches: int, start: int = 0):
        from collide2d_tpu_torch import cli
        from collide2d_tpu_torch.data.pipeline import generate_dataset

        argv = [*self.argv, "--data_dir", str(data_dir), "-n", str(num_batches),
                "-s", str(start)]
        stats = generate_dataset(cli.generate_config(cli.parse_args(argv)))
        if self.device != "cpu":
            torch.cuda.synchronize()
        return stats

    def drive(self, seconds: float) -> dict:
        """The timed call; returns what the window attempted and its time."""
        self.data_dir = self.workdir / "data"
        self.recorder = _Recorder()
        with self.recorder, self.spans.around(_span_targets()), \
                self.spans.span("generate"):
            t0 = time.perf_counter()
            self.stats = self._call(self.data_dir, self.num_batches)
            t1 = time.perf_counter()
        return {"attempted": self.num_batches * self.batch_size, "seconds": t1 - t0}

    def counters(self) -> dict:
        times = np.diff(np.asarray(self.recorder.times))
        return {
            "rows": self.stats.rows,
            "samples_used": self.stats.samples_used,
            "slots_dispatched": self.stats.slots_dispatched,
            "batch_rows": self.batch_size,
            "batch_gaps_s": times[1:] if len(times) > 2 else times,
        }

    def labeled(self) -> Labeled:
        """Every written row, matched to the labeler's record of it; the
        program's state is dropped on the way."""
        recorded = [(tuple(t.cpu().numpy() for t in configs), out)
                    for configs, out in self.recorder.batches]
        self.recorder.batches.clear()
        self._free_device_cache()
        b = self.batch_size
        parts, bad = [], 0
        for i in range(self.num_batches):
            path = self.data_dir / f"{i}.npy"
            if i >= len(recorded) or not path.exists():
                bad += b
                continue
            got = np.load(path)
            (pos, theta, wh, sd), (cp, n, done) = recorded[i]
            if got.shape != (b, 5) or got.dtype != np.float32 or len(cp) != b:
                bad += b
                continue
            parts.append(self._match(got, pos, theta, wh, sd, cp, n, done))
            bad += parts[-1].pop("bad")
        cols = {k: np.concatenate([p[k] for p in parts]) if parts else
                np.zeros((0, 2) if k == "position" else (0,))
                for k in ("position", "pose_idx", "var_idx", "cp", "n", "converged")}
        self.rows = cols
        return Labeled(cp=cols["cp"], n=cols["n"].astype(np.int64),
                       converged=cols["converged"].astype(bool), rows_bad=bad,
                       robot_verts=rows.robot_vertices(self.cell.config),
                       geometry=self._geometry)

    def _match(self, got, pos, theta, wh, sd, cp, n, done) -> dict:
        """A written file against the recorded batch, row by row."""
        k_got, k_rec = _key(got[:, :2]), _key(pos)
        o_got, o_rec = np.argsort(k_got), np.argsort(k_rec)
        same = k_got[o_got] == k_rec[o_rec]
        rec = np.empty(len(got), np.int64)
        rec[o_got] = o_rec  # written row -> recorded row (where keys agree)
        ok = np.zeros(len(got), bool)
        ok[o_got] = same
        pose_idx = got[:, 4].astype(np.int64)
        var_idx = got[:, 3].astype(np.int64)
        in_range = ((got[:, 3] == var_idx) & (got[:, 4] == pose_idx)
                    & (pose_idx >= 0) & (pose_idx < len(self.poses))
                    & (var_idx >= 0) & (var_idx < len(self.variances)))
        ok &= in_range
        pi, vi = np.where(in_range, pose_idx, 0), np.where(in_range, var_idx, 0)
        ok &= got[:, 2] == cp[rec]
        ok &= (self.poses[pi, :2] == wh[rec]).all(axis=1)
        ok &= self.poses[pi, 2] == theta[rec]
        ok &= (np.sqrt(self.variances[vi]) == sd[rec]).all(axis=1)
        ok &= np.unique(k_got).size == len(k_got)
        return {"position": got[:, :2], "pose_idx": pi, "var_idx": vi,
                "cp": got[:, 2], "n": n[rec], "converged": done[rec],
                "bad": int((~ok).sum())}

    def _geometry(self, idx: np.ndarray):
        """(position, robot_theta, obstacle_verts, sd) of labeled rows."""
        pose = self.poses[self.rows["pose_idx"][idx]]
        sd = np.sqrt(self.variances[self.rows["var_idx"][idx]])[:, :3]
        return (self.rows["position"][idx], pose[:, 2],
                rect_vertices(pose[:, 0], pose[:, 1]), sd)


def control_rows(cell, seed: int, count: int, device) -> tuple:
    """``count`` rows for `benchmark.control`, drawn from the seed's tables
    as the generator draws them: (position, robot_theta, robot,
    obstacle_verts, sd), host float32."""
    cfg = cell.config
    poses, variances = rows.tables(cfg, seed, device)
    pos, pose_idx, var_idx = rows.rect_rows(cfg, seed, "control", count, poses,
                                            variances)
    pose = poses[pose_idx].cpu().numpy()
    sd = torch.sqrt(variances[var_idx, :3]).cpu().numpy()
    return (pos.cpu().numpy(), pose[:, 2], rows.robot_vertices(cfg),
            rect_vertices(pose[:, 0], pose[:, 1]).astype(np.float32), sd)
