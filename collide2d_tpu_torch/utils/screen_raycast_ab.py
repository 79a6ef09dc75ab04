"""Kernels 15 (the rotating screen) and 11 (the scene raycast) of this
checkout against another version's sources, on one card, in turns.

    git archive <commit> collide2d_tpu_torch/csrc | tar -x -C .chipwork/parent
    python -m collide2d_tpu_torch.utils.screen_raycast_ab \\
        .chipwork/parent/collide2d_tpu_torch/csrc [--out DIR] [--kernels 15,11]

Run it from the root of a checkout (it uses `chip_smoke.py`'s inputs,
timers, SASS reader and issue floors, and `utils/ab.py`'s ptxas report
and turns) on a machine with a card and ``nvcc``. The other version's
``screen_kernel.cu`` and ``raycast_kernel.cu`` must keep the C entry
points of the wrappers (``rotating_screen_launch``,
``scene_raycast_launch``); both versions build with this checkout's
defines for 8 segments and 8 faces a shape (a version that does not read
them ignores them). ``--kernels`` keeps one of the two (default both). A
variant sweep is the same run against a copy of this checkout's csrc with
one constant edited (kernel 15's ``kMinBlocks`` or ``kLanes``, kernel 11's
``kTwoRaysFrom``, ``kThreads`` or ``kCheck``, the faces between the early
exit's votes). It prints (and with ``--out`` writes to
``DIR/screen_raycast_ab.json``):

- ptxas registers and spill bytes of each version's kernels, and each
  version's issue floor (`issue_floor`: SASS a lane, a (ray, shape));
- for each case, ms by CUDA events (20 launches after a warm-up) in turns
  (other, this, this, other), whether every output is ``torch.equal`` row by
  row across the turns, and the outputs' fingerprint
  (`chip_smoke.output_fingerprint`): kernel 15 on phase 18's inputs (8,192
  rotating rows x 512 lanes) and on 4,096 x 513 of them; kernel 11 on each
  of phase 19's cases (`chip_smoke.raycast_inputs`) and on the bench's
  scene at its first 2^18 and 2^20 rays, timed on the bench's scene at
  each ray count and on the 4,096-shape one, with the share of (ray, face)
  pairs this version evaluates on the bench's scene (the build that counts
  them);
- end to end, in turns with the other version's library swapped into the
  wrapper: phase 18's threefry cascade step (``counts_chunk_moving`` with
  ``screen_impl='cuda'``, host clock, 3 calls after a warm-up) and one
  ``scene_raycast`` call on the bench's 2^22 rays (host clock, 5 calls),
  and whether their results are equal.

It exits non-zero when any output or result differs."""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from collide2d_tpu_torch.ops import raycast_cuda, screen_cuda
from collide2d_tpu_torch.utils import ab, cuda_build

_N_SEG, _KP = 8, 8
# kernel -> (library, wrapper module, defines)
_LIBS = {
    "15": ("screen_kernel", screen_cuda, screen_cuda.screen_defines(_N_SEG)),
    "11": ("raycast_kernel", raycast_cuda, raycast_cuda.raycast_defines(_KP)),
}


def _in_turns(cs, kernel: str, other: ctypes.CDLL, fn, reps: int | None = 20) -> dict:
    """`ab.in_turns` with the other version's library of ``kernel``."""
    return ab.in_turns(cs, {_LIBS[kernel][1]: other}, fn, reps)[0]


def _screen_cases(cs, other: ctypes.CDLL) -> list:
    z, params = cs.screen_inputs()
    rows = []
    odd = torch.cat([z[:4096], z[4096:, :1]], 1).contiguous()  # 4,096 x 513
    for case, zz, pp in (("phase18", z, params), ("odd_lanes", odd, params[:4096])):
        row = dict(kernel="15", case=case, C=zz.shape[0], S=zz.shape[1],
                   **_in_turns(cs, "15", other,
                               lambda zz=zz, pp=pp: screen_cuda.rotating_screen(zz, pp)))
        if case == "phase18":
            want = screen_cuda.rotating_screen_plain(zz, pp)
            row["plain_equal"] = all(map(torch.equal, screen_cuda.rotating_screen(zz, pp),
                                         want))
        rows.append(row)
        print("[ab case] " + " ".join(f"{a}={b}" for a, b in row.items()), flush=True)
    return rows


_RAYCAST_TIMED = ("bench", "bench_2^18", "bench_2^20", "tiled_4096")


def _raycast_cases(cs, other: ctypes.CDLL, cases) -> list:
    rows = []
    for tag, table, o, d, t_max, tile in cases:
        timed = tag in _RAYCAST_TIMED

        def fn(table=table, o=o, d=d, t_max=t_max, tile=tile):
            return raycast_cuda.scene_raycast_cuda_t(o, d, table, t_max=t_max,
                                                     tile_shapes=tile)

        row = dict(kernel="11", case=tag, rays=o.shape[0], shapes=table.shape[0],
                   faces=table.shape[1], **_in_turns(cs, "11", other, fn,
                                                     20 if timed else None))
        if tag == "bench":
            faces = raycast_cuda.scene_raycast_faces(o, d, table, t_max=t_max)[1]
            row["faces_evaluated_share"] = faces / (o.shape[0] * table.shape[0] * table.shape[1])
        rows.append(row)
        print("[ab case] " + " ".join(f"{a}={b}" for a, b in row.items()), flush=True)
    return rows


def issue_floor(cs, kernel: str, lib: Path, rays: int, shapes: int) -> dict:
    """A version's issue floor at the cases' shapes: this design's
    (`chip_smoke.screen_issue_floor`, `chip_smoke.raycast_issue_floor`), or
    the earlier one's, whose loops ran at run time. Kernel 15 then took one
    lane a thread and its segment loop ``_N_SEG`` times (a segment holds one
    ``I2F``, the segment index as a float); kernel 11 one ray a thread, its
    face loop run until the path divides for every face."""
    handle = ctypes.CDLL(str(lib))
    if kernel == "15":
        lanes = cs.ROT_ROWS * cs.SCREEN_LANES
        if hasattr(handle, "rotating_screen_segments"):
            return cs.screen_issue_floor(lib, lanes)
        ins = cs._sass_function(lib, "rotating_screen_kernel")
        start = max(a for a, _, op, _ in ins if op.startswith("BAR"))
        start = next(a for a, _, _, _ in ins if a > start)
        end = max(a for a, _, op, _ in ins if op.startswith("EXIT"))
        seg = [x for x in cs._loops(ins) if start <= x["start"] and x["end"] <= end][-1]
        after = next(a for a, _, _, _ in ins if a > seg["end"])
        pre = cs._shortest_iteration(ins, start, seg["start"])
        body = cs._shortest_iteration(ins, seg["start"], seg["end"], also=("I2F",))
        post = cs._shortest_iteration(ins, after, end)
        per_seg = [x / max(body[2], 1) for x in body[:2]]
        # pre ends on the loop's first instruction, which body counts again
        path = [pre[i] - (1, 0)[i] + _N_SEG * per_seg[i] + post[i] for i in range(2)]
        ms, now, top = cs._issue_ms(path[0] * lanes)
        return dict(sass_per_lane=path[0], lds_per_lane=path[1], lanes_per_thread=1,
                    issue_floor_ms=ms, sm_clock_mhz=now, sm_clock_max_mhz=top)
    if hasattr(handle, "scene_raycast_thread_rays"):
        return cs.raycast_issue_floor(lib, rays, shapes, _KP)
    ins = cs._sass_function(lib, "scene_raycast_kernel")
    shape = cs.raycast_shape_loop(ins)
    inner = [x for x in cs._loops(ins) if x != shape and shape["start"] <= x["start"]
             and x["end"] <= shape["end"] and any(op.startswith("MUFU.RCP") for a, _, op, _
                                                  in ins if x["start"] <= a <= x["end"])]
    path = list(cs._shortest_iteration(ins, shape["start"], shape["end"], also=("MUFU.RCP",)))
    if inner and path[2] < _KP:
        body = cs._shortest_iteration(ins, inner[-1]["start"], inner[-1]["end"],
                                      also=("MUFU.RCP",))
        extra = (_KP - path[2]) / body[2]
        path = [path[i] + extra * body[i] for i in range(2)]
    ms, now, top = cs._issue_ms(path[0] * rays * shapes)
    return dict(sass_per_ray_shape=path[0], sass_per_ray_face=path[0] / _KP,
                lds_per_ray_shape=path[1], rays_per_thread=1, issue_floor_ms=ms,
                sm_clock_mhz=now, sm_clock_max_mhz=top)


def _host_in_turns(cs, kernel: str, other: ctypes.CDLL, fn, reps: int) -> dict:
    """``fn()`` on the host clock in turns (ms of each turn), and whether the
    results of every turn are equal."""
    outs, ms = [], {"other": [], "this": []}
    for tag in ab.TURNS:
        with ab.swapped({_LIBS[kernel][1]: other} if tag == "other" else {}):
            outs.append(fn())
            ms[tag].append(cs._host_ms(fn, reps))
    flat = [o if isinstance(o, (tuple, list)) else (o,) for o in outs]
    equal = all(all(map(torch.equal, o, flat[0])) for o in flat[1:])
    return dict(results_equal=equal, ms_other=ms["other"], ms_this=ms["this"])


def _end_to_end(cs, others: dict, polys_rays) -> list:
    from collide2d_tpu_torch.mc import moving, prng
    from collide2d_tpu_torch.ops import raycast

    rows = []
    if "15" in others:
        c, s = cs.ROT_ROWS, cs.SCREEN_LANES
        configs = cs._moving_rects(c, rotating=True)
        keys = prng.fold_in_many(prng.PRNGKey(3), torch.arange(c, dtype=torch.int32,
                                                               device="cuda"))
        rows.append(dict(call="cascade_step", C=c, S=s, **_host_in_turns(
            cs, "15", others["15"], lambda: moving.counts_chunk_moving(
                keys, configs, cs.ROBOT_WH, s, screen_impl="cuda"), 3)))
    if "11" in others:
        origin, direction, polys = polys_rays
        rows.append(dict(call="scene_raycast", rays=origin.shape[0], shapes=polys.shape[0],
                         **_host_in_turns(cs, "11", others["11"],
                                          lambda: raycast.scene_raycast(origin, direction,
                                                                        polys), 5)))
    for row in rows:
        print("[ab e2e] " + " ".join(f"{a}={b}" for a, b in row.items()), flush=True)
    return rows


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m collide2d_tpu_torch.utils.screen_raycast_ab")
    parser.add_argument("other_csrc", type=Path,
                        help="the other version's collide2d_tpu_torch/csrc")
    parser.add_argument("--out", type=Path, help="also write screen_raycast_ab.json here")
    parser.add_argument("--kernels", default="15,11",
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
    polys_rays, cases = cs.raycast_inputs()
    bench = cases[0]
    cases = cases[:1] + tuple((f"bench_2^{n}", bench[1], bench[2][:1 << n], bench[3][:1 << n],
                               *bench[4:]) for n in (18, 20)) + cases[1:]
    with tempfile.TemporaryDirectory(prefix="screen_raycast_ab_") as tmp:
        libs = [Path(tmp) / f"{tag}_{k}.so" for tag, k, _ in jobs]
        with ThreadPoolExecutor(len(jobs)) as pool:
            ptxas = list(pool.map(lambda j, lib: ab.nvcc_report(j[2], _LIBS[j[1]][2], lib),
                                  jobs, libs))
        built = {(tag, k): lib for (tag, k, _), lib in zip(jobs, libs)}
        for (tag, k, _), lib, rep in zip(jobs, libs, ptxas):
            floor = issue_floor(cs, k, lib, bench[2].shape[0], bench[1].shape[0])
            report["builds"][f"{k}_{tag}"] = dict(ptxas=rep, issue_floor=floor)
            print(f"[ab build] kernel={k} version={tag} ptxas={rep} floor={floor}", flush=True)
        others = {k: _LIBS[k][1].bind(ctypes.CDLL(str(built["other", k]))) for k in kernels}
        if "15" in others:
            report["cases"] += _screen_cases(cs, others["15"])
        if "11" in others:
            report["cases"] += _raycast_cases(cs, others["11"], cases)
        report["end_to_end"] = _end_to_end(cs, others, polys_rays)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "screen_raycast_ab.json").write_text(json.dumps(report, indent=1))
    ok = (all(r["outputs_equal"] for r in report["cases"])
          and all(r.get("plain_equal", True) for r in report["cases"])
          and all(r["results_equal"] for r in report["end_to_end"]))
    print(f"[ab] ok={ok}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
