"""Kernels 12 (time of impact), 9 (k-gon signed distance), 6 (k-gon SAT
labels) and 10 (contact manifolds) of this checkout against another
version's sources, on one card, in turns.

    git archive <commit> collide2d_tpu_torch/csrc | tar -x -C .chipwork/parent
    python -m collide2d_tpu_torch.utils.query_ab \\
        .chipwork/parent/collide2d_tpu_torch/csrc [--out DIR] [--kernels 12,9,6,10]

Run it from the root of a checkout (it uses `chip_smoke.py`'s inputs,
timers, SASS reader and issue floors, and `utils/ab.py`'s ptxas report and
turns) on a machine with a card and ``nvcc``. The other version's
``toi_kernel.cu``, ``distance_kernel.cu``, ``polygon_kernel.cu`` and
``manifold_kernel.cu`` must keep the C entry points of the wrappers
(``moving_obb_toi_launch``, ``polygon_distance_launch``,
``polygon_sat_launch``, ``polygon_manifold_launch``). For kernels 6, 9 and
10 an other version whose source reads the bucket-pair defines (the earlier
design: a library per pair of K buckets above 16, ``-DPOLY_KB1`` /
``-DPOLY_KB2``) also builds once for each bucket pair that phase 24's cases
take (`_bucket_defines`). ``--kernels`` keeps a subset (default all four). A variant sweep is the same run against a copy of this checkout's
csrc with one constant edited (kernel 12's ``kPairsPerLane`` or
``kRefillAt``, kernel 9's ``kMinBlocks``, kernel 6's ``kAxes``, kernel
10's ``kFaces``). It prints (and with ``--out`` writes to
``DIR/query_ab.json``):

- ptxas registers, spill bytes and stack frame of each version's kernels,
  and each version's issue floor at the cases' work (`issue_floor`);
- for kernels 6, 9 and 10, whether each function of both versions' default
  builds at K <= 16 has the same SASS, and the SASS instructions of each
  version's function above 16 (`chip_smoke.big_k_issue_floor`);
- for each case, ms by CUDA events (20 launches after a warm-up) in turns
  (other, this, this, other), whether every output is ``torch.equal`` row by
  row across the turns and to the plain version, and the outputs'
  fingerprint (`chip_smoke.output_fingerprint`): kernel 12 on phase 14's
  2^21 rotating pairs (`chip_smoke.toi_inputs`), on the model's rows of
  phase 14 (a quarter translating) as the model packs them, and on 8,008
  of the rotating pairs at one and at zero steps; kernel 9 on phase 12's
  ``k8`` and ``k4_k8`` cases (`chip_smoke.polygon_distance_inputs`), with
  the pairs each pass of this version takes (its counting build), and on
  2^20 pairs of the bench's 16-gons (the largest bucket); kernel 6 (float32
  and bfloat16 planes), kernel 9 (with the pairs each pass of this version
  takes) and kernel 10 (margin 0) on each of phase 24's cases above 16
  vertices (`chip_smoke.big_k_inputs`);
- end to end, in turns with the other version's library swapped into the
  wrapper: phase 14's ``time_of_impact`` call, phase 12's k-gon
  ``distance`` call, and phase 25's k = 20 routes' ``collide``,
  ``distance`` and ``contact_manifold`` calls (the 4-gon robot and the
  20-gon robot against 2^20 20-gons) (CUDA events, 5 calls after a
  warm-up), and whether their results are equal.

It exits non-zero when any output or result differs, or when a K <= 16
function of kernel 6, 9 or 10 has other SASS than the other version's."""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from collide2d_tpu_torch.ops import distance_cuda, manifold_cuda, polygon_cuda, toi_cuda
from collide2d_tpu_torch.utils import ab, cuda_build

_TOI_KW = dict(t_max=8.0, iters=64, tol=1e-4)
# kernel -> (library, wrapper module)
_LIBS = {"12": ("toi_kernel", toi_cuda), "9": ("distance_kernel", distance_cuda),
         "6": ("polygon_kernel", polygon_cuda), "10": ("manifold_kernel", manifold_cuda)}
# Kernels 6, 9 and 10, and the bucket pairs above 16 of phase 24's cases (the
# other version's builds for them: the earlier design's libraries)
_BIG_K = ("6", "9", "10")
_BIG_K_BUCKETS = ((4, 32), (4, 64), (32, 32))


def _bucket_defines(k1: int, k2: int) -> tuple:
    """The earlier design's defines for the library of (k1, k2)'s bucket
    pair above 16 vertices (``-DPOLY_KB1`` / ``-DPOLY_KB2``), none at K <= 16
    (its default build)."""
    b1, b2 = polygon_cuda.k_bucket(k1), polygon_cuda.k_bucket(k2)
    if max(b1, b2) <= polygon_cuda.REGISTER_BUCKETS[-1]:
        return ()
    return (("POLY_KB1", b1), ("POLY_KB2", b2))


def _in_turns(cs, kernel: str, other: ctypes.CDLL, fn, reps: int | None = 20) -> tuple:
    """`ab.in_turns` with the other version's library of ``kernel``."""
    return ab.in_turns(cs, {_LIBS[kernel][1]: other}, fn, reps)


def _print(tag: str, row: dict) -> None:
    print(f"[ab {tag}] " + " ".join(f"{a}={b}" for a, b in row.items()), flush=True)


def _model_toi_rows(cs, model_args):
    """The packed (b1, b2) phase 14's model call hands kernel 12."""
    from collide2d_tpu_torch.models.collision_model import CollisionProbabilityModel

    seen = {}
    launch = toi_cuda.moving_obb_toi_cuda_t

    def spy(b1, b2, **kw):
        seen.update(b1=b1, b2=b2)
        return launch(b1, b2, **kw)

    toi_cuda.moving_obb_toi_cuda_t = spy
    try:
        CollisionProbabilityModel().time_of_impact(*model_args, impl="auto", **_TOI_KW)
    finally:
        toi_cuda.moving_obb_toi_cuda_t = launch
    return seen["b1"], seen["b2"]


def _toi_cases(cs, other: ctypes.CDLL, model_args, bench) -> list:
    b1, b2 = bench
    rows = []
    odd = tuple(x[:, :, :1001].contiguous() for x in bench)  # 8,008 pairs
    cases = (("bench", b1, b2, _TOI_KW, 1024, True),
             ("model", *_model_toi_rows(cs, model_args), _TOI_KW, 1024, True),
             ("odd_iters1", *odd, dict(_TOI_KW, iters=1), 1, False),
             ("odd_iters0", *odd, dict(_TOI_KW, iters=0), 1, False))
    for tag, a, b, kw, block, timed in cases:
        def fn(a=a, b=b, kw=kw, block=block):
            return toi_cuda.moving_obb_toi_cuda_t(a, b, block=block, **kw)

        row, out = _in_turns(cs, "12", other, fn, 20 if timed else None)
        want, steps = toi_cuda.moving_obb_toi_plain(a, b, return_steps=True, **kw)
        rotating = (a[7] != 0).reshape(-1) | (b[7] != 0).reshape(-1)
        row = dict(kernel="12", case=tag, pairs=out.numel(),
                   rotating_share=float(rotating.float().mean()),
                   plain_equal=bool(torch.equal(out, want.reshape(-1))), **row)
        rows.append(row)
        _print("case", row)
        if tag == "bench":
            work = cs.toi_work(steps.reshape(-1), rotating)
    return rows, work


def _distance_inputs(cs) -> list:
    """Phase 12's kernel-9 cases and 2^20 pairs of the JAX bench's 16-gons
    (the largest bucket)."""
    from collide2d_tpu_torch.ops import polygon_cuda

    g = torch.Generator(device="cuda").manual_seed(16)
    k16 = [polygon_cuda.pack_polygons(cs._bench_polygons(g, 1 << 20, 16)) for _ in "ab"]
    return cs.polygon_distance_inputs() + [("k16", 16, 16, *k16)]


def _distance_cases(cs, other: ctypes.CDLL) -> tuple:
    rows, work = [], {}
    for tag, k1, k2, a, b in _distance_inputs(cs):
        def fn(a=a, b=b, k1=k1, k2=k2):
            return distance_cuda.polygon_distance_cuda_t(a, b, k1=k1, k2=k2)

        row, out = _in_turns(cs, "9", other, fn)
        want = distance_cuda.polygon_distance_plain(a, b, k1, k2).reshape(-1)
        row = dict(kernel="9", case=tag, k1=k1, k2=k2, pairs=out.numel(),
                   overlap_share=float((want < 0).float().mean()),
                   plain_equal=bool(torch.equal(out, want)), **row)
        _, undecided, separated = distance_cuda.polygon_distance_passes(a, b, k1=k1, k2=k2)
        row.update(undecided=undecided, separated=separated)
        work[tag] = (k1, k2, out.numel(), undecided, separated)
        rows.append(row)
        _print("case", row)
        del a, b
    return rows, work


def _big_k_cases(cs, others: dict) -> tuple:
    """Kernels 6 (float32 and bfloat16 planes), 9 and 10 (margin 0) on each
    of phase 24's cases, the other version's library for the case's bucket
    pair; and the work of each case by kernel (the pairs kernel 6's first
    pass leaves; the pairs of each of kernel 9's passes in this version)."""
    rows, work = [], {k: {} for k in _BIG_K}
    for k1, k2, a, b in cs.big_k_inputs():
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        calls = []
        if "6" in others:
            for tag, x, y in (("f32", a, b), ("bf16", a16, b16)):
                calls.append(("6", tag, lambda x=x, y=y: polygon_cuda.sat_polygons_cuda_t(
                    x, y, k1=k1, k2=k2), lambda x=x, y=y: polygon_cuda.sat_polygons_plain(
                    x, y, k1, k2).reshape(-1).to(torch.float32)))
        if "9" in others:
            calls.append(("9", "dist", lambda: distance_cuda.polygon_distance_cuda_t(
                a, b, k1=k1, k2=k2), lambda: distance_cuda.polygon_distance_plain(
                a, b, k1, k2).reshape(-1)))
        if "10" in others:
            calls.append(("10", "m0", lambda: manifold_cuda.polygon_manifold_cuda_t(
                a, b, k1=k1, k2=k2), lambda: manifold_cuda.polygon_manifold_plain(
                a, b, k1, k2)))
        pairs = a.shape[1] * a.shape[2]
        work["6"][k1, k2] = work["10"][k1, k2] = (
            pairs, pairs - int(cs.sat_first_pass(a, b, k1, k2).sum()))
        if "9" in others:
            _, undecided, separated = distance_cuda.polygon_distance_passes(a, b, k1=k1, k2=k2)
            work["9"][k1, k2] = (pairs, undecided, separated)
        for kernel, tag, fn, plain in calls:
            row, out = _in_turns(cs, kernel, _other_lib(others[kernel], k1, k2), fn)
            row = dict(kernel=kernel, case=f"{k1}x{k2}_{tag}", k1=k1, k2=k2, pairs=pairs,
                       plain_equal=bool(torch.equal(out, plain())), **row)
            if kernel == "9":
                row.update(zip(("undecided", "separated"), work["9"][k1, k2][1:]))
            rows.append(row)
            _print("case", row)
        del a, b, a16, b16
        torch.cuda.empty_cache()
    return rows, work


def _sass_by_function(cs, lib: Path) -> dict:
    """Each function's SASS in a library (`chip_smoke._sass_functions`), by
    mangled name from the kernel's own name on (the anonymous namespace's
    name depends on the source file), without addresses."""
    return {re.search(r"polygon_(?:sat|manifold|distance)_\w+|obb_distance_\w+",
                      name).group(0): [x[1:] for x in ins]
            for name, ins in cs._sass_functions(lib).items()}


def _default_sass(cs, kernel: str, other: Path, this: Path) -> dict:
    """Kernel 6's, 9's or 10's default builds: whether every function of the
    other version's at K <= 16 (kernel 8's too, in kernel 9's library) has
    the same SASS in this one, and the SASS instructions of each version's
    functions."""
    a, b = _sass_by_function(cs, other), _sass_by_function(cs, this)
    small = [name for name in a if "big_k" not in name]
    differ = [name for name in small if a[name] != b.get(name)]
    return dict(kernel=kernel, k16_functions=len(small), k16_sass_equal=not differ,
                k16_differ=differ, sass_other={n: len(v) for n, v in a.items()},
                sass_this={n: len(v) for n, v in b.items()})


def _toi_floor_per_thread(cs, lib: Path, work: dict) -> dict:
    """The earlier kernel 12's issue floor (one pair a thread, run to its own
    convergence): the shortest path through one iteration of its
    advancement loop (the largest loop), a distance evaluation; from the
    entry to the rotating pairs' exit (the first after the loop), one
    evaluation's path less, once a rotating pair; from the entry to the
    translating pairs' exit (the last), once a translating pair."""
    ins = cs._sass_function(lib, "moving_obb_toi_kernel")
    loop = cs._loops(ins)[-1]
    per_eval = cs._shortest_iteration(ins, loop["start"], loop["end"])[0]
    exits = [a for a, pred, op, _ in ins if op.startswith("EXIT") and not pred]
    rotating = cs._shortest_iteration(ins, ins[0][0], min(a for a in exits
                                                         if a > loop["end"]))[0]
    window = cs._shortest_iteration(ins, ins[0][0], max(exits))[0]
    setup = rotating - per_eval
    pairs = work["rotating"] * setup + work["translating"] * window
    ms, now, top = cs._issue_ms(work["evals"] * per_eval + pairs)
    return dict(sass_per_evaluation=per_eval, sass_setup=setup, sass_window=window,
                issue_floor_ms=ms,
                issue_floor_ms_at_warp_max=cs._issue_ms(work["warp_max_evals"] * per_eval
                                                        + pairs)[0],
                sm_clock_mhz=now, sm_clock_max_mhz=top)


def _distance_floor_per_thread(cs, lib: Path, k1: int, k2: int, pairs: int) -> dict:
    """The earlier kernel 9's issue floor (one pair a thread, every axis and
    test straight through): the shortest path from the entry to its last
    exit, a pair."""
    ins = cs._sass_function(lib, f"polygon_distance_kernelILi{cs._bucket(k1)}"
                                 f"ELi{cs._bucket(k2)}E")
    exits = [a for a, pred, op, _ in ins if op.startswith("EXIT") and not pred]
    per_pair = cs._shortest_iteration(ins, ins[0][0], max(exits))[0]
    ms, now, top = cs._issue_ms(per_pair * pairs)
    return dict(sass_per_pair=per_pair, sass_per_pair_evaluated=per_pair,
                issue_floor_ms=ms, issue_floor_ms_at_work_evaluated=ms,
                sm_clock_mhz=now, sm_clock_max_mhz=top)


def issue_floor(cs, kernel: str, lib: Path, work, big: dict) -> dict:
    """A version's issue floor at the cases' work (``work``, kernel 12:
    phase 14's 2^21 pairs; kernel 9: each case of `_distance_inputs`; ``big``,
    kernels 6, 9 and 10: each of phase 24's cases above 16 vertices with the
    pairs of the passes of kernel 6 or 9, `chip_smoke.big_k_issue_floor`,
    which reads either design): this design's
    (`chip_smoke.toi_issue_floor`, `chip_smoke.polygon_distance_issue_floor`)
    where the SASS has its warp votes (12) or block barriers (9), else the
    earlier one's (`_toi_floor_per_thread`, `_distance_floor_per_thread`)."""
    floors = {f"{k1}x{k2}": cs.big_k_issue_floor(lib, kernel, k1, k2, *counts)
              for (k1, k2), counts in big.items()}
    if kernel == "12":
        ins = cs._sass_function(lib, "moving_obb_toi_kernel")
        if any(op.startswith("VOTE") for _, _, op, _ in ins):
            return cs.toi_issue_floor(lib, work)
        return _toi_floor_per_thread(cs, lib, work)
    for tag, (k1, k2, pairs, undecided, separated) in (work or {}).items():
        ins = cs._sass_function(lib, f"polygon_distance_kernelILi{cs._bucket(k1)}"
                                     f"ELi{cs._bucket(k2)}E")
        if any(op.startswith("BAR") for _, _, op, _ in ins):
            floors[tag] = cs.polygon_distance_issue_floor(lib, k1, k2, pairs, undecided,
                                                          separated)
        else:
            floors[tag] = _distance_floor_per_thread(cs, lib, k1, k2, pairs)
    return floors


def _end_to_end(cs, others: dict, model_args) -> list:
    from collide2d_tpu_torch.models.collision_model import (
        CollisionProbabilityModel,
        PolygonCollisionProbabilityModel,
        example_polygon_configs,
    )

    import numpy as np

    rows = []
    calls = []  # (kernel, call, fn, the (K1, K2) the call launches)
    if "12" in others:
        model = CollisionProbabilityModel()
        calls.append(("12", "time_of_impact", lambda: model.time_of_impact(
            *model_args, impl="auto", **_TOI_KW), None))
    if "9" in others:
        configs = cs._polygon_workload(1 << 20, seed=12)
        pmodel = PolygonCollisionProbabilityModel(np.asarray(cs.POLY_ROBOT, np.float32))
        calls.append(("9", "polygon_distance", lambda: pmodel.distance(configs, impl="auto"),
                      (len(cs.POLY_ROBOT), cs.POLY_K)))
    big = [k for k in _BIG_K if k in others]
    if big:
        configs20 = example_polygon_configs(cs.BIG_K_ROWS, k=20, seed=25, device="cuda")
        for robot, key in ((np.asarray(cs.POLY_ROBOT, np.float32), (4, 20)),
                           (cs._regular_polygon(20, 1.2), (20, 20))):
            model = PolygonCollisionProbabilityModel(robot)
            shape = f"{key[0]}x{key[1]}"
            if "6" in big:
                calls.append(("6", f"collide_{shape}", lambda m=model: m.collide(configs20),
                              key))
            if "9" in big:
                calls.append(("9", f"distance_{shape}",
                              lambda m=model: m.distance(configs20, impl="auto"), key))
            if "10" in big:
                calls.append(("10", f"contact_manifold_{shape}",
                              lambda m=model: m.contact_manifold(configs20), key))
    for kernel, call, fn, key in calls:
        other = _other_lib(others[kernel], *key) if kernel in _BIG_K else others[kernel]
        row, _ = _in_turns(cs, kernel, other, fn, 5)
        row = dict(call=call, results_equal=row.pop("outputs_equal"), **row)
        rows.append(row)
        _print("e2e", row)
    return rows


def _jobs(kernels: list, other_csrc: Path) -> list:
    """(version, kernel, source, defines) of every build: each version's
    default build; for kernels 6, 9 and 10 the other version also at each
    bucket pair of `_BIG_K_BUCKETS` where its source reads the bucket-pair
    defines (the earlier design)."""
    jobs = []
    for k in kernels:
        for tag, csrc in (("other", other_csrc), ("this", cuda_build.CSRC_DIR)):
            src = csrc / f"{_LIBS[k][0]}.cu"
            buckets = (k in _BIG_K and tag == "other" and "POLY_KB" in src.read_text())
            extra = [_bucket_defines(*kk) for kk in _BIG_K_BUCKETS]
            for defines in [()] + (extra if buckets else []):
                jobs.append((tag, k, src, defines))
    return jobs


def _other_lib(libs: dict, k1: int, k2: int) -> ctypes.CDLL:
    """The other version's library of kernel 6, 9 or 10 for (k1, k2): its
    build for the bucket pair, or its one library."""
    return libs.get(_bucket_defines(k1, k2), libs[()])


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m collide2d_tpu_torch.utils.query_ab")
    parser.add_argument("other_csrc", type=Path,
                        help="the other version's collide2d_tpu_torch/csrc")
    parser.add_argument("--out", type=Path, help="also write query_ab.json here")
    parser.add_argument("--kernels", default="12,9,6,10",
                        help="the kernels to compare, comma-separated (default all four)")
    args = parser.parse_args(argv)
    kernels = [k for k in args.kernels.split(",") if k]
    if not kernels or not set(kernels) <= set(_LIBS):
        parser.error(f"--kernels takes {sorted(_LIBS)}")
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs

    report = dict(card=cs._card(), sm_clock_mhz=[f / 1e6 for f in cs._sm_clock_hz()],
                  builds={}, default_sass=[], cases=[], end_to_end=[])
    print(f"[card] {report['card']}", flush=True)
    jobs = _jobs(kernels, args.other_csrc)
    with tempfile.TemporaryDirectory(prefix="query_ab_") as tmp:
        libs = [Path(tmp) / f"{tag}_{k}_{i}.so" for i, (tag, k, _, _) in enumerate(jobs)]
        with ThreadPoolExecutor(len(jobs) + 1) as pool:
            # this version's build that counts kernel 9's passes
            counting = (pool.submit(cuda_build.build, _LIBS["9"][0],
                                    distance_cuda.distance_defines(count=True))
                        if "9" in kernels else None)
            ptxas = list(pool.map(lambda j, lib: ab.nvcc_report(j[2], j[3], lib), jobs, libs))
            if counting is not None:
                counting.result()
        built = {(tag, k, d): lib for (tag, k, _, d), lib in zip(jobs, libs)}
        others = {}
        for (tag, k, _, d), lib in zip(jobs, libs):
            if tag == "other":
                loaded = _LIBS[k][1].bind(ctypes.CDLL(str(lib)))
                others[k] = others.get(k, {}) | {d: loaded} if k in _BIG_K else loaded
        for k in kernels:
            if k in _BIG_K:
                row = _default_sass(cs, k, built["other", k, ()], built["this", k, ()])
                report["default_sass"].append(row)
                _print("sass", row)
        work, big_work = {}, {}
        if "12" in others:
            model_args, bench = cs.toi_inputs()
            rows, work["12"] = _toi_cases(cs, others["12"], model_args, bench)
            report["cases"] += rows
        if "9" in others:  # at K <= 16: each version's default build
            rows, work["9"] = _distance_cases(cs, others["9"][()])
            report["cases"] += rows
        if set(_BIG_K) & set(others):
            rows, big_work = _big_k_cases(cs, others)
            report["cases"] += rows
        for (tag, k, _, d), lib, rep in zip(jobs, libs, ptxas):
            big = big_work.get(k, {}) if k in others else {}
            if k in _BIG_K and tag == "other" and len(others[k]) > 1:
                # the earlier design: each bucket pair's build at the cases
                # it takes (its default build: the K <= 16 SASS and cases)
                big = {kk: n for kk, n in big.items() if d and _bucket_defines(*kk) == d}
            try:
                floor = issue_floor(cs, k, lib, None if d else work.get(k), big)
            except RuntimeError as err:  # reported, not fatal: a floor is a reading
                floor = dict(error=str(err))
            name = f"{k}_{tag}" + "".join(f"_{v}" for _, v in d)
            report["builds"][name] = dict(ptxas=rep, issue_floor=floor)
            print(f"[ab build] kernel={k} version={tag} defines={d} ptxas={rep} "
                  f"floor={floor}", flush=True)
        report["end_to_end"] = _end_to_end(cs, others, model_args if "12" in others else None)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "query_ab.json").write_text(json.dumps(report, indent=1))
    ok = (all(r["outputs_equal"] and r["plain_equal"] for r in report["cases"])
          and all(r["results_equal"] for r in report["end_to_end"])
          and all(r["k16_sass_equal"] for r in report["default_sass"]))
    print(f"[ab] ok={ok}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
