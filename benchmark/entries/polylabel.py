"""Drives ``collide2d-torch polylabel`` in a closed loop: one call per input
file, back to back, each with its own output file and seed.

Set-up writes the k-gon files from the seed (``gen.rows.kgon_file``), one
for each call of the window: the run's seconds times the traffic's
``calls_per_second`` (the pace measured when the mix was added), a fixed
amount of work for every run of a length. A warm-up call labels a file of
its own first.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from benchmark.core.compare import Labeled
from benchmark.gen import rows

def _span_targets():
    """The program's layers a traced window spans."""
    from collide2d_tpu_torch import cli
    from collide2d_tpu_torch.mc import driver
    from collide2d_tpu_torch.mc.estimator import PolygonConfigs

    return [(PolygonConfigs, "from_padded", "from_padded"),
            (cli, "_label", "label"),
            (driver, "adaptive_collision_probabilities", "label_rows"),
            (driver.AdaptiveScheduler, "step", "driver_step"),
            (driver.AdaptiveRun, "materialize", "outputs")]


class Run:
    def __init__(self, cell, seed: int, device: str, workdir: Path, spans,
                 seconds: float) -> None:
        self.cell, self.seed, self.device, self.spans = cell, seed, device, spans
        cfg, traffic = cell.config, cell.traffic
        self.workdir = workdir
        self.rows_per_file = cfg["rows_per_file"]
        self.argv = [
            "polylabel", "--device", device,
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

    def _write(self, index) -> Path:
        arrays = rows.kgon_file(self.cell.config, self.seed,
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
                with self.spans.span("polylabel"):
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
        self._inputs: dict[int, dict] = {}
        self.samples_used = int(sum(int(x.astype(np.int64).sum()) for x in n))
        robot = rows.robot_vertices(self.cell.config)
        return Labeled(cp=np.concatenate(cp), n=np.concatenate(n).astype(np.int64),
                       converged=np.concatenate(done).astype(bool), rows_bad=bad,
                       robot_verts=robot, geometry=self._geometry)

    def counters(self) -> dict:
        """The window's counts (after `labeled`)."""
        return {"rows": self.calls * self.rows_per_file,
                "samples_used": self.samples_used}

    def _geometry(self, idx: np.ndarray):
        c = self.rows_per_file
        order = np.argsort(idx, kind="stable")
        calls, rows_in = idx[order] // c, idx[order] % c
        parts = {k: [] for k in ("position", "pose_theta", "obstacle_verts", "std_dev")}
        for call in np.unique(calls):
            f = int(call)
            if f not in self._inputs:
                with np.load(self.files[f]) as arrays:
                    self._inputs[f] = {k: arrays[k] for k in parts}
            sel = rows_in[calls == call]
            for k in parts:
                parts[k].append(self._inputs[f][k][sel])
        out = {}
        for k, v in parts.items():
            out[k] = np.empty_like(np.concatenate(v))
            out[k][order] = np.concatenate(v)
        return out["position"], out["pose_theta"], out["obstacle_verts"], out["std_dev"]


def control_rows(cell, seed: int, count: int, device) -> tuple:
    """The first ``count`` rows of the seed's first k-gon file for
    `benchmark.control`: (position, robot_theta, robot, obstacle_verts,
    sd), host float32."""
    cfg = cell.config
    f = rows.kgon_file(cfg, seed, 0, device)
    return (f["position"][:count], f["pose_theta"][:count],
            rows.robot_vertices(cfg), f["obstacle_verts"][:count],
            f["std_dev"][:count])
