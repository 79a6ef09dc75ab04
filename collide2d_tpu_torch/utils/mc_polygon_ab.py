"""Kernels 7 and 14 of this checkout against another version's sources, on
one card, in turns.

    git archive <commit> collide2d_tpu_torch/csrc | tar -x -C .chipwork/parent
    python -m collide2d_tpu_torch.utils.mc_polygon_ab \\
        .chipwork/parent/collide2d_tpu_torch/csrc [--out DIR]

Run it from the root of a checkout (it uses `chip_smoke.py`'s timers and
SASS reader) on a machine with a card and ``nvcc``. The other version's
``mc_polygon_kernel.cu`` and ``mc_moving_polygon_kernel.cu`` must keep the
C interface of the wrappers (``ops/mc_polygon_cuda.py``,
``ops/mc_moving_polygon_cuda.py``); built with no defines they take their
shape at run time, as the runtime-shape kernels before the per-shape build
did. It prints (and with ``--out`` writes to ``DIR/mc_polygon_ab.json``):

- the seconds of one first-call build of each shape's library, one at a
  time (``cuda_build.build``, as a user's first call at a new shape);
- ptxas registers and spill bytes, and the SASS of the sample loop (static
  instructions, ``LDS``, the shortest path) of both versions;
- for each shape of `SHAPES` at 100,000 rows x 4,096 samples, kernel 7 and
  kernel 14 (translation-only rows with velocity U(-2, 2)^2, t_max
  U(0.5, 3); at k = 8 the smoke's phase 10 and 17 inputs), and kernel 7 at
  k = 8 on the adaptive tail's 256 rows x 100,000: ms by CUDA events (20
  launches after a warm-up) in turns (other, this, this, other), and
  whether the per-row counts are equal;
- ``polylabel`` and k-gon ``movelabel`` configs/s on 100,000 k = 8 rows
  (`chip_smoke.py`'s phases 11 and 17), host clock, in the same turns with
  the other version's libraries swapped into the wrappers, and whether the
  labels are equal.

It exits non-zero when any counts or labels differ."""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from collide2d_tpu_torch.mc import prng
from collide2d_tpu_torch.mc.moving import moving_polygon_configs
from collide2d_tpu_torch.models.collision_model import example_polygon_configs
from collide2d_tpu_torch.ops import mc_cuda
from collide2d_tpu_torch.ops import mc_moving_polygon_cuda as m14
from collide2d_tpu_torch.ops import mc_polygon_cuda as m7
from collide2d_tpu_torch.utils import cuda_build

_RECT = ((-2.035, -0.87), (2.035, -0.87), (2.035, 0.87), (-2.035, 0.87))
_HEX = 2.0 * np.stack([np.cos(np.arange(6) * np.pi / 3),
                       np.sin(np.arange(6) * np.pi / 3)], -1)
# id: (K, robot vertices, kept robot axes)
SHAPES = {"k8": (8, _RECT, (0, 1)), "k16": (16, _RECT, (0, 1)),
          "k20": (20, _RECT, (0, 1)), "k8-hexagon-6axes": (8, _HEX, tuple(range(6))),
          "k6-hexagon-3axes": (6, _HEX, (0, 1, 2))}
# library -> (kernel name in the SASS, C prefix)
_KERNELS = {"mc_polygon_kernel": ("mc_poly_counts_kernel", "mc_poly"),
            "mc_moving_polygon_kernel": ("mc_moving_poly_counts_kernel", "mc_moving_poly")}
ROWS, SAMPLES = 100_000, 4096
_TURNS = ("other", "this", "this", "other")


def _nvcc_report(src: Path, defines, out: Path) -> dict:
    """Build ``src`` with the wrappers' flags and ``defines`` into ``out``,
    with ptxas's registers and spill bytes of its counts kernel."""
    cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
           *cuda_build.define_flags(defines), "-Xptxas", "-v", "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    props = re.search(r"Function properties for \S*counts_kernel\S*\s+\d+ bytes stack "
                      r"frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      proc.stderr)
    regs = re.search(r"Compiling entry function '[^']*counts_kernel[^']*'.*?Used (\d+) "
                     r"registers", proc.stderr, re.S)
    return dict(registers=int(regs.group(1)), spill_stores=int(props.group(1)),
                spill_loads=int(props.group(2)))


def _bind(lib: ctypes.CDLL, prefix: str) -> ctypes.CDLL:
    p, i, ll, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint32
    launch = getattr(lib, f"{prefix}_counts_launch")
    launch.restype = ctypes.c_int
    launch.argtypes = [p, p, p, i, i, i, i, i, ll, ll, u, u, p]
    getattr(lib, f"{prefix}_max_samples_per_round").restype = ctypes.c_longlong
    return lib


@contextlib.contextmanager
def _swapped(libs: dict | None):
    """The wrappers launch ``libs``' kernels inside (None: their own)."""
    saved = m7._kernel_lib, m14._kernel_lib
    if libs is not None:
        m7._kernel_lib = lambda *_: libs["mc_polygon_kernel"]
        m14._kernel_lib = lambda *_: libs["mc_moving_polygon_kernel"]
    try:
        yield
    finally:
        m7._kernel_lib, m14._kernel_lib = saved


def _moving(b, seed: int = 7):
    rng = np.random.default_rng(seed)
    n = b.position.shape[0]
    return moving_polygon_configs(b.position, b.pose_theta, b.obstacle_verts, b.std_dev,
                                  rng.uniform(-2, 2, (n, 2)), 0.0,
                                  rng.uniform(0.5, 3, n), device="cuda")


def _turns(cs, other_libs: dict, fn, params, n: int, dims: dict) -> dict:
    """One kernel at one input in turns: ms of each version, counts equal."""
    uids = torch.arange(params.shape[0], dtype=torch.int32, device="cuda")
    seed = mc_cuda.round_seed(prng.PRNGKey(12), 3)
    counts, ms = [], {"other": [], "this": []}
    for tag in _TURNS:
        with _swapped(other_libs if tag == "other" else None):
            counts.append(fn(params, uids, seed, n, **dims))
            ms[tag].append(cs._events_ms(lambda: fn(params, uids, seed, n, **dims), 20))
    return dict(rows=params.shape[0], n=n, **dims,
                counts_equal=all(torch.equal(c, counts[0]) for c in counts),
                hit_share=float(counts[0].sum()) / (params.shape[0] * n),
                fingerprint=cs._fingerprint(counts[0]), ms_other=ms["other"],
                ms_this=ms["this"], speedup=sum(ms["other"]) / sum(ms["this"]))


def _kernels(cs, other_libs: dict, report: dict) -> None:
    """Every shape at ROWS x SAMPLES; at k = 8 on `chip_smoke.py`'s own
    inputs (phase 10's workload and adaptive tail, 256 rows x 100,000
    samples, for kernel 7; phase 17's rows for kernel 14), so the
    fingerprints are comparable with the smoke's."""
    for shape, (k, robot, a_keep) in SHAPES.items():
        robot = np.asarray(robot, np.float32)
        dims = dict(k=k, k2=len(robot), k2a=len(a_keep))
        if shape == "k8":
            static = cs._polygon_workload(ROWS, seed=11)
            moving = cs._moving_kgons(ROWS)
        else:
            static = example_polygon_configs(ROWS, k=k, seed=11, device="cuda")
            moving = _moving(static)
        cases = [("7", m7.mc_poly_counts, m7.pack_polygon_mc_params(static, robot, a_keep),
                  SAMPLES),
                 ("14", m14.mc_moving_poly_counts,
                  m14.pack_moving_polygon_mc_params(moving, robot, a_keep), SAMPLES)]
        if shape == "k8":
            cases.append(("7", m7.mc_poly_counts, m7.pack_polygon_mc_params(
                cs._polygon_workload(cs.TAIL_ROWS, seed=11), robot, a_keep),
                cs.TAIL_SAMPLES))
        for kernel, fn, params, n in cases:
            row = dict(shape=shape, kernel=kernel,
                       **_turns(cs, other_libs, fn, params, n, dims))
            report["kernels"].append(row)
            print("[ab kernel] " + " ".join(f"{a}={b}" for a, b in row.items()), flush=True)


def _end_to_end(cs, other_libs: dict, report: dict) -> None:
    robot = np.asarray(_RECT, np.float32)
    with tempfile.TemporaryDirectory(prefix="mc_polygon_ab_") as tmp:
        work = Path(tmp)
        polys = cs._polygon_workload(cs.POLY_ROWS, seed=0)
        src = work / "polys.npz"
        np.savez(src, robot_verts=robot,
                 **{f: getattr(polys, f).cpu().numpy() for f in polys._fields})
        msrc = cs._save_npz(work / "moving.npz", cs._moving_kgons(cs.TRAJ_ROWS),
                            robot_verts=robot)
        runs = {"polylabel": lambda out: cs._polylabel([
                    "--device", "cuda", "--data_in", str(src), "--data_out", str(out),
                    "--seed", "7"]),
                "movelabel": lambda out: cs._movelabel([
                    "--data_in", str(msrc), "--data_out", str(out), "--seed", "7"])}
        for name, run in runs.items():
            run(work / f"{name}_warm.npz")
            seconds, labels = {"other": [], "this": []}, {}
            for i, tag in enumerate(_TURNS):
                out = work / f"{name}_{i}.npz"
                with _swapped(other_libs if tag == "other" else None):
                    seconds[tag].append(run(out))
                labels[tag] = cs._labels(out)
            same = all(np.array_equal(a, b) for a, b in zip(labels["this"], labels["other"]))
            row = dict(command=name, rows=cs.POLY_ROWS, labels_equal=same,
                       **{f"configs_per_s_{tag}": [cs.POLY_ROWS / s for s in v]
                          for tag, v in seconds.items()})
            report["end_to_end"].append(row)
            print("[ab e2e] " + " ".join(f"{a}={b}" for a, b in row.items()), flush=True)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m collide2d_tpu_torch.utils.mc_polygon_ab")
    parser.add_argument("other_csrc", type=Path,
                        help="the other version's collide2d_tpu_torch/csrc")
    parser.add_argument("--out", type=Path, help="also write mc_polygon_ab.json here")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs

    report = dict(card=cs._card(), builds=[], ptxas=[], kernels=[], end_to_end=[])
    print(f"[card] {report['card']}", flush=True)
    for shape, (k, robot, a_keep) in SHAPES.items():
        for name in _KERNELS:
            t = time.monotonic()
            cuda_build.build(name, m7.shape_defines(k, len(robot), len(a_keep)))
            row = dict(shape=shape, library=name, seconds=time.monotonic() - t)
            report["builds"].append(row)
            print("[ab build] " + " ".join(f"{a}={b}" for a, b in row.items()), flush=True)
    jobs = [("other", name, args.other_csrc / f"{name}.cu", ()) for name in _KERNELS] + [
        (shape, name, cuda_build.CSRC_DIR / f"{name}.cu",
         m7.shape_defines(k, len(robot), len(a_keep)))
        for shape, (k, robot, a_keep) in SHAPES.items() for name in _KERNELS]
    with tempfile.TemporaryDirectory(prefix="mc_polygon_ab_") as tmp:
        libs = [Path(tmp) / f"{tag}_{name}.so" for tag, name, _, _ in jobs]
        with ThreadPoolExecutor(8) as pool:
            reports = list(pool.map(lambda j, lib: _nvcc_report(j[2], j[3], lib), jobs, libs))
        other_libs = {}
        for (tag, name, _, _), lib, rep in zip(jobs, libs, reports):
            sass = cs.sass_loops(lib, _KERNELS[name][0])
            loop = sass["loops"][-1]
            row = dict(version=tag, library=name, **rep, sass=sass["instructions"],
                       loop_static=loop["instructions"], loop_lds=loop["lds"],
                       loop_shortest=sass["shortest"][0])
            report["ptxas"].append(row)
            print("[ab ptxas] " + " ".join(f"{a}={b}" for a, b in row.items()), flush=True)
            if tag == "other":
                other_libs[name] = _bind(ctypes.CDLL(str(lib)), _KERNELS[name][1])
        _kernels(cs, other_libs, report)
        _end_to_end(cs, other_libs, report)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "mc_polygon_ab.json").write_text(json.dumps(report, indent=1))
    ok = (all(r["counts_equal"] for r in report["kernels"])
          and all(r["labels_equal"] for r in report["end_to_end"]))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
