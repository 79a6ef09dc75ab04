"""Drives ``collide2d-torch movelabel`` in a closed loop: one call per input
file, back to back, each with its own output file and seed.

Set-up writes the trajectory files from the seed (`gen.motion`), one for
each call of the window: the run's seconds times the traffic's
``calls_per_second`` (the pace measured when the mix was added), a fixed
amount of work for every run of a length. A warm-up call labels a file of
its own first. Each call runs with the program's defaults (``--impl
auto``, the default ``--ca_iters``), so the driver's one readback of omega
sends every translation-only file to the fused trajectory kernel with the
advancement compiled out.

A label is P(the motion collides over [0, t_max]), so the comparison
judges each row against the region its robot sweeps
(`reference.exact.swept_robot`), worked out for the rows it compares.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from benchmark.core.compare import Labeled
from benchmark.gen import motion, rows
from benchmark.reference import exact

GEOMETRY = ("position", "pose_theta", "obstacle_verts", "std_dev")
MOTION = ("pose_theta", "velocity", "t_max")


def _span_targets():
    """The program's layers a traced window spans."""
    from collide2d_tpu_torch import cli
    from collide2d_tpu_torch.mc import driver

    return [(cli, "movelabel_inputs", "movelabel_inputs"),
            (cli, "_label", "label"),
            (driver, "adaptive_collision_probabilities", "label_rows"),
            (driver.AdaptiveScheduler, "step", "driver_step"),
            (driver.AdaptiveRun, "materialize", "outputs")]


def swept(robot: np.ndarray, pose_theta, velocity, t_max) -> np.ndarray:
    """Each row's swept robot (R, K2 + 2, 2), float64."""
    return exact.swept_robot(robot, exact.displacement(pose_theta, velocity, t_max))


class _SweptRobots:
    """`Labeled.robot_verts` of a window: a robot per row, (N, K2 + 2, 2),
    worked out only for the rows indexed (`core.compare` takes
    ``robot_verts[idx]``), as the window's rows number in the millions."""

    ndim = 3

    def __init__(self, robot: np.ndarray, columns) -> None:
        self.robot, self.columns = robot, columns

    def __getitem__(self, idx: np.ndarray) -> np.ndarray:
        return swept(self.robot, *self.columns(np.asarray(idx), MOTION))


class Run:
    def __init__(self, cell, seed: int, device: str, workdir: Path, spans,
                 seconds: float) -> None:
        self.cell, self.seed, self.device, self.spans = cell, seed, device, spans
        cfg, traffic = cell.config, cell.traffic
        self.workdir = workdir
        self.rows_per_file = cfg["rows_per_file"]
        self.argv = [
            "movelabel", "--device", device,
            "--max_samples", str(cfg["max_samples"]),
            "--accuracy_bins", *map(str, cfg["accuracy_bins"]),
            "--bin_accuracy", *map(str, cfg["bin_accuracy"]),
            *traffic["args"],
        ]
        (workdir / "in").mkdir(parents=True)
        (workdir / "out").mkdir()
        warm_in = self._write("warm")
        with spans.span("warm"):
            self._call(warm_in, workdir / "out" / "warm.npz", -1)
        self.calls = max(2, round(seconds * traffic["calls_per_second"]))
        self.files = [self._write(i) for i in range(self.calls)]
        self._inputs: dict[int, dict] = {}

    def _write(self, index) -> Path:
        arrays = motion.trajectory_file(self.cell.config, self.seed,
                                        -1 if index == "warm" else index, self.device)
        path = self.workdir / "in" / f"{index}.npz"
        np.savez(path, **arrays)
        return path

    def _call(self, data_in: Path, data_out: Path, i: int) -> None:
        from collide2d_tpu_torch import cli

        seed = (rows.sub_seed(self.seed, "program") + i) % 2**31
        cli.main([*self.argv, "--data_in", str(data_in), "--data_out", str(data_out),
                  "--seed", str(seed)])
        if self.device != "cpu":
            torch.cuda.synchronize()

    def drive(self, seconds: float) -> dict:
        """The window's calls, back to back."""
        t0 = time.perf_counter()
        with self.spans.around(_span_targets()):
            for i, path in enumerate(self.files):
                with self.spans.span("movelabel"):
                    self._call(path, self.workdir / "out" / f"{i}.npz", i)
        t1 = time.perf_counter()
        return {"attempted": self.calls * self.rows_per_file, "seconds": t1 - t0}

    def labeled(self) -> Labeled:
        c = self.rows_per_file
        cp, n, done, bad = [], [], [], 0
        for i in range(self.calls):
            path = self.workdir / "out" / f"{i}.npz"
            ok = path.exists()
            if ok:
                with np.load(path) as out:
                    got = {k: out[k] for k in ("cp", "n_samples", "converged")
                           if k in out}
                ok = len(got) == 3 and all(v.shape == (c,) for v in got.values())
            if not ok:
                got = {"cp": np.full(c, np.nan, np.float32), "n_samples": np.zeros(c),
                       "converged": np.zeros(c, bool)}
                bad += c
            cp.append(got["cp"])
            n.append(got["n_samples"])
            done.append(got["converged"])
        self.samples_used = int(sum(int(x.astype(np.int64).sum()) for x in n))
        robots = _SweptRobots(rows.robot_vertices(self.cell.config), self._columns)
        return Labeled(cp=np.concatenate(cp), n=np.concatenate(n).astype(np.int64),
                       converged=np.concatenate(done).astype(bool), rows_bad=bad,
                       robot_verts=robots,
                       geometry=lambda idx: self._columns(idx, GEOMETRY))

    def counters(self) -> dict:
        """The window's counts (after `labeled`)."""
        return {"rows": self.calls * self.rows_per_file,
                "samples_used": self.samples_used}

    def _columns(self, idx: np.ndarray, keys) -> tuple:
        """The input arrays ``keys`` at the window's rows ``idx`` (in the
        order of ``idx``), from the files the calls read."""
        c = self.rows_per_file
        calls, rows_in = idx // c, idx % c
        out = {k: None for k in keys}
        for call in np.unique(calls):
            f = int(call)
            if f not in self._inputs:
                with np.load(self.files[f]) as arrays:
                    self._inputs[f] = {k: arrays[k] for k in (*GEOMETRY, *MOTION)}
            at = calls == call
            for k in keys:
                col = self._inputs[f][k]
                if out[k] is None:
                    out[k] = np.empty((len(idx),) + col.shape[1:], col.dtype)
                out[k][at] = col[rows_in[at]]
        return tuple(out[k] for k in keys)


def control_rows(cell, seed: int, count: int, device) -> tuple:
    """The first ``count`` rows of the seed's first trajectory file for
    `benchmark.control`: (position, robot_theta, each row's swept robot
    (count, K2 + 2, 2), obstacle_verts, sd), host float32."""
    cfg = cell.config
    f = motion.trajectory_file(cfg, seed, 0, device)
    robot = swept(rows.robot_vertices(cfg), f["pose_theta"][:count],
                  f["velocity"][:count], f["t_max"][:count]).astype(np.float32)
    return (f["position"][:count], f["pose_theta"][:count], robot,
            f["obstacle_verts"][:count], f["std_dev"][:count])
