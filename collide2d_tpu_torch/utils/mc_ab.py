"""The fused Monte Carlo kernels 1, 7, 13 and 14 of this checkout against
another version's sources, on one card, in turns.

    git archive <commit> collide2d_tpu_torch/csrc | tar -x -C .chipwork/parent
    python -m collide2d_tpu_torch.utils.mc_ab \\
        .chipwork/parent/collide2d_tpu_torch/csrc [--out DIR] [--kernels 1,13]

Run it from the root of a checkout (it uses `chip_smoke.py`'s inputs,
timers and SASS reader) on a machine with a card and ``nvcc``. The other
version's ``mc_kernel.cu``, ``mc_toi_kernel.cu``, ``mc_polygon_kernel.cu``
and ``mc_moving_polygon_kernel.cu`` must keep the C interfaces of the
wrappers (``ops/mc_cuda.py``, ``ops/mc_toi_cuda.py``,
``ops/mc_polygon_cuda.py``, ``ops/mc_moving_polygon_cuda.py``); kernels 7
and 14 build for k = 8 in both. ``--kernels`` keeps a subset (default all
four). It prints (and with ``--out`` writes to ``DIR/mc_ab.json``):

- ptxas registers and spill bytes of the instantiation each case runs,
  and the SASS of its sample loop (static instructions, ``LDS``, the
  shortest path a sample: `chip_smoke.issue_floor`'s count), both versions;
- for each case, ms by CUDA events (20 launches after a warm-up; 5 for
  the rotating rows) in turns (other, this, this, other), whether the
  per-row counts are equal (``torch.equal``) and their fingerprint
  (`chip_smoke._fingerprint`):
  kernel 1 on phase 2's three inputs (100,000 rows x 4,096 samples with
  shape noise off and on, the adaptive tail's 256 rows x 100,000);
  kernel 13 on phase 15's (100,000 translation-only rows x 4,096 with
  shape noise, 8,192 rotating rows x 2,048 with 48 advancement steps) and
  the translation rows without shape noise; kernels 7 and 14 on phase 10's
  and 17's k = 8 inputs and kernel 7 on the tail;
- end to end, in the same turns with the other version's libraries
  swapped into the wrappers: ``generate -n 2 -b 100000`` (kernel 1;
  configs/s over the label seconds), ``movelabel`` on 100,000
  translation-only rectangles (13), ``polylabel`` (7) and k-gon
  ``movelabel`` (14) on 100,000 k = 8 rows (host clock around the call),
  and whether the labels are equal.

It exits non-zero when any counts or labels differ."""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from collide2d_tpu_torch.mc import prng
from collide2d_tpu_torch.ops import mc_cuda
from collide2d_tpu_torch.ops import mc_moving_polygon_cuda as m14
from collide2d_tpu_torch.ops import mc_polygon_cuda as m7
from collide2d_tpu_torch.ops import mc_toi_cuda as m13
from collide2d_tpu_torch.utils import ab, cuda_build

_RECT = ((-2.035, -0.87), (2.035, -0.87), (2.035, 0.87), (-2.035, 0.87))
_K = 8
_P, _I, _LL, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint32
# kernel -> (library, wrapper module, C prefix, launch argtypes, the
# function giving S; the parent's kernels 1 and 13 take one sample at a time)
_LIBS = {
    "1": ("mc_kernel", mc_cuda, "mc", [_P, _P, _P, _I, _LL, _LL, _U, _U, _I, _P],
          "mc_batch_samples"),
    "13": ("mc_toi_kernel", m13, "mc_toi",
           [_P, _P, _P, _I, _LL, _LL, _U, _U, _I, _I, ctypes.c_float, _P],
           "mc_toi_batch_samples"),
    "7": ("mc_polygon_kernel", m7, "mc_poly",
          [_P, _P, _P, _I, _I, _I, _I, _I, _LL, _LL, _U, _U, _P], "mc_poly_batch_samples"),
    "14": ("mc_moving_polygon_kernel", m14, "mc_moving_poly",
           [_P, _P, _P, _I, _I, _I, _I, _I, _LL, _LL, _U, _U, _P],
           "mc_moving_poly_batch_samples"),
}


def _defines(kernel: str):
    return m7.shape_defines(_K, len(_RECT), 2) if kernel in ("7", "14") else ()


def _instances(kernel: str, case: dict) -> tuple[str, ...]:
    """The SASS names a case's kernel may carry, this layout first: the
    template arguments (kernel 1: shape noise, wide indices; 13: shape
    noise, advancement, wide indices; 7 and 14: wide indices), or the
    parent's (1 and 13: shape noise; 7 and 14: none)."""
    import chip_smoke as cs

    sn = int(case["kw"].get("shape_noise", False))
    if kernel == "1":
        return cs.mc_kernel_instance(bool(sn)), f"mc_counts_kernelILb{sn}E"
    if kernel == "13":
        return (cs.mc_toi_kernel_instance(bool(sn), case["kw"]["ca_iters"]),
                f"mc_toi_counts_kernelILb{sn}E")
    name = "mc_poly_counts_kernel" if kernel == "7" else "mc_moving_poly_counts_kernel"
    return f"{name}ILb0E", name


def _sass(lib: Path, ptxas: dict, kernel: str, case: dict) -> dict:
    """Registers, spill and the sample loop's SASS of the instantiation the
    case runs in ``lib``."""
    import chip_smoke as cs

    handle = ctypes.CDLL(str(lib))
    fn = _LIBS[kernel][4]
    batch = getattr(handle, fn)() if hasattr(handle, fn) else 1
    for name in _instances(kernel, case):
        mangled = [m for m in ptxas if name in m]
        if mangled:
            break
    sass = cs.sass_loops(lib, name)
    loop = sass["loops"][-1]
    return dict(instance=name, **ptxas[mangled[0]], batch_samples=batch,
                sass_per_sample=sass["shortest"][0] / batch,
                static_loop_per_sample=loop["instructions"] / batch,
                lds_per_sample=sass["shortest"][1] / batch)


def _bind(lib: ctypes.CDLL, kernel: str) -> ctypes.CDLL:
    _, _, prefix, argtypes, _ = _LIBS[kernel]
    launch = getattr(lib, f"{prefix}_counts_launch")
    launch.restype = ctypes.c_int
    launch.argtypes = argtypes
    getattr(lib, f"{prefix}_max_samples_per_round").restype = ctypes.c_longlong
    return lib


def _swapped(libs: dict | None):
    """`ab.swapped` with the other version's libraries by kernel (None:
    every wrapper its own)."""
    return ab.swapped({_LIBS[k][1]: lib for k, lib in (libs or {}).items()})


def _cases(cs, kernels) -> list[dict]:
    """Each case: the kernel, its name, the wrapper, inputs, samples and
    keyword arguments; on `chip_smoke.py`'s inputs, so the fingerprints
    are comparable with the smoke's."""
    robot = np.asarray(_RECT, np.float32)
    dims = dict(k=_K, k2=len(robot), k2a=2)
    cases = []
    if "1" in kernels:
        for key, c, n, sn in cs.MC_CASES:
            cases.append(dict(kernel="1", case=key, fn=mc_cuda.mc_counts,
                              params=lambda c=c, sn=sn: cs._rect_mc_params(c, sn), n=n,
                              kw=dict(shape_noise=sn)))
    if "13" in kernels:
        for key, c, n, rot, sn, ca in (
                ("translation", cs.TRAJ_ROWS, cs.N_CHECK, False, True, 0),
                ("translation_no_shape_noise", cs.TRAJ_ROWS, cs.N_CHECK, False, False, 0),
                ("rotating", cs.ROT_ROWS, cs.ROT_SAMPLES, True, True, 48)):
            cases.append(dict(kernel="13", case=key, fn=m13.mc_toi_counts,
                              params=lambda c=c, rot=rot: m13.pack_mc_toi_params(
                                  cs._moving_rects(c, rot), cs.ROBOT_WH), n=n,
                              kw=dict(shape_noise=sn, ca_iters=ca, tol=1e-4),
                              reps=5 if rot else 20))
    if "7" in kernels:
        for key, c, n in (("workload", cs.POLY_ROWS, cs.N_CHECK),
                          ("tail", cs.TAIL_ROWS, cs.TAIL_SAMPLES)):
            cases.append(dict(kernel="7", case=key, fn=m7.mc_poly_counts,
                              params=lambda c=c: m7.pack_polygon_mc_params(
                                  cs._polygon_workload(c, seed=11), robot, (0, 1)),
                              n=n, kw=dims))
    if "14" in kernels:
        cases.append(dict(kernel="14", case="workload", fn=m14.mc_moving_poly_counts,
                          params=lambda: m14.pack_moving_polygon_mc_params(
                              cs._moving_kgons(cs.TRAJ_ROWS), robot, (0, 1)),
                          n=cs.N_CHECK, kw=dims))
    return cases


def _turns(cs, other_libs: dict, case: dict) -> dict:
    """One case in turns: ms of each version, counts equal."""
    params = case["params"]()
    fn, n, kw = case["fn"], case["n"], case["kw"]
    uids = torch.arange(params.shape[0], dtype=torch.int32, device="cuda")
    seed = mc_cuda.round_seed(prng.PRNGKey(12), 3)
    counts, ms = [], {"other": [], "this": []}
    for tag in ab.TURNS:
        with _swapped(other_libs if tag == "other" else None):
            counts.append(fn(params, uids, seed, n, **kw))
            ms[tag].append(cs._events_ms(lambda: fn(params, uids, seed, n, **kw),
                                         case.get("reps", 20)))
    return dict(rows=params.shape[0], n=n,
                counts_equal=all(torch.equal(c, counts[0]) for c in counts),
                hit_share=float(counts[0].sum()) / (params.shape[0] * n),
                fingerprint=cs._fingerprint(counts[0]), ms_other=ms["other"],
                ms_this=ms["this"], speedup=sum(ms["other"]) / sum(ms["this"]))


def _labeled(command, argv, out: Path):
    """A labeling command (`chip_smoke._movelabel` or `_polylabel`) writing
    ``out``.npz with seed 7: its seconds and labels."""
    import chip_smoke as cs

    path = out.with_suffix(".npz")
    return command([*argv, "--data_out", str(path), "--seed", "7"]), cs._labels(path)


def _end_to_end(cs, other_libs: dict, kernels, report: dict) -> None:
    robot = np.asarray(_RECT, np.float32)
    with tempfile.TemporaryDirectory(prefix="mc_ab_") as tmp:
        work = Path(tmp)
        runs = {}
        if "1" in kernels:
            def generate(out):
                stats, _ = cs._quiet(cs._generate, [
                    "--device", "cuda", "-n", "2", "-b", "100000", "--seed", "7",
                    "--data_dir", str(out)])
                torch.cuda.synchronize()
                return stats.label_seconds, [np.load(out / f"{i}.npy") for i in range(2)]
            runs["generate"] = (200_000, generate)
        if "13" in kernels:
            src = cs._save_npz(work / "moves.npz", cs._moving_rects(cs.TRAJ_ROWS, False))
            runs["movelabel_rect"] = (cs.TRAJ_ROWS, lambda out: _labeled(
                cs._movelabel, ["--data_in", str(src)], out))
        if "7" in kernels:
            polys = cs._polygon_workload(cs.POLY_ROWS, seed=0)
            psrc = work / "polys.npz"
            np.savez(psrc, robot_verts=robot,
                     **{f: getattr(polys, f).cpu().numpy() for f in polys._fields})
            runs["polylabel"] = (cs.POLY_ROWS, lambda out: _labeled(
                cs._polylabel, ["--device", "cuda", "--data_in", str(psrc)], out))
        if "14" in kernels:
            msrc = cs._save_npz(work / "moving.npz", cs._moving_kgons(cs.TRAJ_ROWS),
                                robot_verts=robot)
            runs["movelabel_kgon"] = (cs.TRAJ_ROWS, lambda out: _labeled(
                cs._movelabel, ["--data_in", str(msrc)], out))
        for name, (rows, run) in runs.items():
            run(work / f"{name}_warm")
            seconds, labels = {"other": [], "this": []}, {}
            for i, tag in enumerate(ab.TURNS):
                with _swapped(other_libs if tag == "other" else None):
                    s, labels[tag] = run(work / f"{name}_{i}")
                seconds[tag].append(s)
            same = all(np.array_equal(a, b) for a, b in zip(labels["this"], labels["other"]))
            row = dict(command=name, rows=rows, labels_equal=same,
                       **{f"configs_per_s_{tag}": [rows / s for s in v]
                          for tag, v in seconds.items()})
            report["end_to_end"].append(row)
            print("[ab e2e] " + " ".join(f"{a}={b}" for a, b in row.items()), flush=True)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m collide2d_tpu_torch.utils.mc_ab")
    parser.add_argument("other_csrc", type=Path,
                        help="the other version's collide2d_tpu_torch/csrc")
    parser.add_argument("--out", type=Path, help="also write mc_ab.json here")
    parser.add_argument("--kernels", default="1,13,7,14",
                        help="the kernels to compare, comma-separated (default all)")
    args = parser.parse_args(argv)
    kernels = [k for k in args.kernels.split(",") if k]
    if not set(kernels) <= set(_LIBS):
        parser.error(f"--kernels takes {sorted(_LIBS)}")
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs

    report = dict(card=cs._card(), sm_clock_mhz=[f / 1e6 for f in cs._sm_clock_hz()],
                  kernels=kernels,
                  cases=[], end_to_end=[])
    print(f"[card] {report['card']}", flush=True)
    jobs = [(tag, k, csrc / f"{_LIBS[k][0]}.cu")
            for k in kernels
            for tag, csrc in (("other", args.other_csrc), ("this", cuda_build.CSRC_DIR))]
    with tempfile.TemporaryDirectory(prefix="mc_ab_") as tmp:
        libs = [Path(tmp) / f"{tag}_{k}.so" for tag, k, _ in jobs]
        with ThreadPoolExecutor(len(jobs)) as pool:
            ptxas = list(pool.map(lambda j, lib: ab.nvcc_report(j[2], _defines(j[1]), lib),
                                  jobs, libs))
        built = {(tag, k): (lib, rep) for (tag, k, _), lib, rep in zip(jobs, libs, ptxas)}
        other_libs = {k: _bind(ctypes.CDLL(str(built["other", k][0])), k) for k in kernels}
        for case in _cases(cs, kernels):
            k = case["kernel"]
            row = dict(kernel=k, case=case["case"], **_turns(cs, other_libs, case))
            for tag in ("other", "this"):
                row[f"sass_{tag}"] = _sass(*built[tag, k], k, case)
            report["cases"].append(row)
            print("[ab case] " + " ".join(f"{a}={b}" for a, b in row.items()), flush=True)
        _end_to_end(cs, other_libs, kernels, report)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "mc_ab.json").write_text(json.dumps(report, indent=1))
    ok = (all(r["counts_equal"] for r in report["cases"])
          and all(r["labels_equal"] for r in report["end_to_end"]))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
