"""Kernels 12 (time of impact) and 9 (k-gon signed distance) of this
checkout against another version's sources, on one card, in turns.

    git archive <commit> collide2d_tpu_torch/csrc | tar -x -C .chipwork/parent
    python -m collide2d_tpu_torch.utils.query_ab \\
        .chipwork/parent/collide2d_tpu_torch/csrc [--out DIR] [--kernels 12,9]

Run it from the root of a checkout (it uses `chip_smoke.py`'s inputs,
timers, SASS reader and issue floors, and `utils/mc_ab.py`'s ptxas
report) on a machine with a card and ``nvcc``. The other version's
``toi_kernel.cu`` and ``distance_kernel.cu`` must keep the C entry points
of the wrappers (``moving_obb_toi_launch``, ``polygon_distance_launch``).
``--kernels`` keeps one of the two (default both). A variant sweep is the
same run against a copy of this checkout's csrc with one constant edited
(kernel 12's ``kPairsPerLane`` or ``kRefillAt``, kernel 9's
``kMinBlocks``). It prints (and with ``--out`` writes to
``DIR/query_ab.json``):

- ptxas registers, spill bytes and stack frame of each version's kernels,
  and each version's issue floor at the cases' work (`issue_floor`);
- for each case, ms by CUDA events (20 launches after a warm-up) in turns
  (other, this, this, other), whether every output is ``torch.equal`` row by
  row across the turns and to the plain version, and the outputs'
  fingerprint (`chip_smoke.output_fingerprint`): kernel 12 on phase 14's
  2^21 rotating pairs (`chip_smoke.toi_inputs`), on the model's rows of
  phase 14 (a quarter translating) as the model packs them, and on 8,008
  of the rotating pairs at one and at zero steps; kernel 9 on phase 12's
  ``k8`` and ``k4_k8`` cases (`chip_smoke.polygon_distance_inputs`), with
  the pairs each pass of this version takes (its counting build), and on
  2^20 pairs of the bench's 16-gons (the largest bucket);
- end to end, in turns with the other version's library swapped into the
  wrapper: phase 14's ``time_of_impact`` call and phase 12's k-gon
  ``distance`` call (CUDA events, 5 calls after a warm-up), and whether
  their results are equal.

It exits non-zero when any output or result differs."""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from collide2d_tpu_torch.ops import distance_cuda, toi_cuda
from collide2d_tpu_torch.utils import cuda_build
from collide2d_tpu_torch.utils.mc_ab import _nvcc_report

_TURNS = ("other", "this", "this", "other")
_TOI_KW = dict(t_max=8.0, iters=64, tol=1e-4)
# kernel -> (library, wrapper module)
_LIBS = {"12": ("toi_kernel", toi_cuda), "9": ("distance_kernel", distance_cuda)}


@contextlib.contextmanager
def _swapped(kernel: str, lib: ctypes.CDLL | None):
    """The kernel's wrapper launches ``lib`` inside (None: its own)."""
    mod = _LIBS[kernel][1]
    saved = mod._kernel_lib
    if lib is not None:
        mod._kernel_lib = lambda *_, **__: lib
    try:
        yield
    finally:
        mod._kernel_lib = saved


def _in_turns(cs, kernel: str, other: ctypes.CDLL, fn, reps: int | None = 20) -> dict:
    """``fn()`` in turns with each version: its ms (CUDA events; None: not
    timed), whether the outputs of every turn are equal, their fingerprint."""
    outs, ms = [], {"other": [], "this": []}
    for tag in _TURNS:
        with _swapped(kernel, other if tag == "other" else None):
            outs.append(fn())
            if reps:
                ms[tag].append(cs._events_ms(fn, reps))
    equal = all(torch.equal(o, outs[0]) for o in outs[1:])
    row = dict(outputs_equal=equal, fingerprint=cs.output_fingerprint(outs[0]))
    if reps:
        row.update(ms_other=ms["other"], ms_this=ms["this"],
                   speedup=sum(ms["other"]) / sum(ms["this"]))
    return row, outs[0]


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


def issue_floor(cs, kernel: str, lib: Path, work) -> dict:
    """A version's issue floor at the cases' work (kernel 12: phase 14's
    2^21 pairs; kernel 9: each case of `_distance_inputs`): this design's
    (`chip_smoke.toi_issue_floor`, `chip_smoke.polygon_distance_issue_floor`)
    where the SASS has its warp votes (12) or block barriers (9), else the
    earlier one's (`_toi_floor_per_thread`, `_distance_floor_per_thread`)."""
    if kernel == "12":
        ins = cs._sass_function(lib, "moving_obb_toi_kernel")
        if any(op.startswith("VOTE") for _, _, op, _ in ins):
            return cs.toi_issue_floor(lib, work)
        return _toi_floor_per_thread(cs, lib, work)
    floors = {}
    for tag, (k1, k2, pairs, undecided, separated) in work.items():
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
    )

    import numpy as np

    rows = []
    calls = []
    if "12" in others:
        model = CollisionProbabilityModel()
        calls.append(("12", "time_of_impact", lambda: model.time_of_impact(
            *model_args, impl="auto", **_TOI_KW)))
    if "9" in others:
        configs = cs._polygon_workload(1 << 20, seed=12)
        pmodel = PolygonCollisionProbabilityModel(np.asarray(cs.POLY_ROBOT, np.float32))
        calls.append(("9", "polygon_distance", lambda: pmodel.distance(configs,
                                                                       impl="auto")))
    for kernel, call, fn in calls:
        row, _ = _in_turns(cs, kernel, others[kernel], fn, 5)
        row = dict(call=call, results_equal=row.pop("outputs_equal"), **row)
        rows.append(row)
        _print("e2e", row)
    return rows


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m collide2d_tpu_torch.utils.query_ab")
    parser.add_argument("other_csrc", type=Path,
                        help="the other version's collide2d_tpu_torch/csrc")
    parser.add_argument("--out", type=Path, help="also write query_ab.json here")
    parser.add_argument("--kernels", default="12,9",
                        help="the kernels to compare, comma-separated (default both)")
    args = parser.parse_args(argv)
    kernels = [k for k in args.kernels.split(",") if k]
    if not kernels or not set(kernels) <= set(_LIBS):
        parser.error(f"--kernels takes {sorted(_LIBS)}")
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs

    report = dict(card=cs._card(), sm_clock_mhz=[f / 1e6 for f in cs._sm_clock_hz()],
                  builds={}, cases=[], end_to_end=[])
    print(f"[card] {report['card']}", flush=True)
    jobs = [(tag, k, csrc / f"{_LIBS[k][0]}.cu")
            for k in kernels
            for tag, csrc in (("other", args.other_csrc), ("this", cuda_build.CSRC_DIR))]
    model_args, bench = cs.toi_inputs()
    with tempfile.TemporaryDirectory(prefix="query_ab_") as tmp:
        libs = [Path(tmp) / f"{tag}_{k}.so" for tag, k, _ in jobs]
        with ThreadPoolExecutor(len(jobs)) as pool:
            ptxas = list(pool.map(lambda j, lib: _nvcc_report(j[2], (), lib), jobs, libs))
        built = {(tag, k): lib for (tag, k, _), lib in zip(jobs, libs)}
        others = {k: _LIBS[k][1].bind(ctypes.CDLL(str(built["other", k]))) for k in kernels}
        work = {}
        if "12" in others:
            rows, work["12"] = _toi_cases(cs, others["12"], model_args, bench)
            report["cases"] += rows
        if "9" in others:
            rows, work["9"] = _distance_cases(cs, others["9"])
            report["cases"] += rows
        for (tag, k, _), lib, rep in zip(jobs, libs, ptxas):
            floor = issue_floor(cs, k, lib, work[k])
            report["builds"][f"{k}_{tag}"] = dict(ptxas=rep, issue_floor=floor)
            print(f"[ab build] kernel={k} version={tag} ptxas={rep} floor={floor}", flush=True)
        report["end_to_end"] = _end_to_end(cs, others, model_args)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "query_ab.json").write_text(json.dumps(report, indent=1))
    ok = (all(r["outputs_equal"] and r["plain_equal"] for r in report["cases"])
          and all(r["results_equal"] for r in report["end_to_end"]))
    print(f"[ab] ok={ok}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
