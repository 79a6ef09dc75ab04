"""The bench on one card: ``python -m collide2d_tpu_torch.bench``.

The counterpart of the repository's root ``bench.py``, leg for leg, at its
sizes and under its metric names (``pallas`` becomes ``cuda``):

- the two bandwidth probes run first: kernel 16, the SAT count's exact
  memory pattern with trivial math (`bench_stream_bandwidth_cuda`), then
  torch's own reduction (`bench_reduce_bandwidth`); each prints
  '# '-prefixed on stderr;
- the headline is the SAT count kernel (kernel 3) at 2^23 pairs x 100
  calls: ``sat_rect_pairs_per_sec`` with ``effective_gbps`` (the 64 B a
  pair it reads) and ``hbm_read_gbps`` (the larger probe); an implied
  bandwidth above 1.15 x the probe marks ``bandwidth_check`` FAILED (the
  timing, not the card, would be at fault), else ``ok``;
- the headline JSON prints at once, then every secondary leg of the root
  bench in its order (`secondary_legs`), '# '-prefixed on stderr; the
  rotating threefry cascade pair, the rotating k-gon cascade,
  `bench_scene` and the five end-to-end legs as medians of 3 with their
  ``spread`` (`median_of`);
- then one stdout line, the digest: every measured metric's value (and a
  few qualitative extras) in at most `DIGEST_BUDGET` characters
  (`digest_add`, `build_digest_line`), and the headline once more as the
  last stdout line, so that the last 2,000 characters of the output hold
  the whole measured set.

A leg that fails prints its traceback on stderr and the others go on; the
exit code is then 1 (the digest and the headline still print). Just before
the digest, one stderr line ``# launches {...}`` records each kernel's
launches during the run (`launch_counts`) and the failed legs. It needs a
card: without one it exits 2 before measuring anything. On an NVIDIA H100
80GB HBM3 at 700 W the whole run takes a few minutes (PERF.md gives the
measured wall time).
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import traceback

import torch

from collide2d_tpu_torch.utils import benchmarks as bm

BANDWIDTH_SLACK = 1.15  # as bench.py: noise on the probe, not a real excess

# A harness that keeps only the last ~2,000 characters of stdout and
# stderr must find the digest line and the ~230-character headline there.
DIGEST_BUDGET = 1750

# Metrics that stay on stderr only, never in the digest line (the root
# bench's list under the ``cuda`` names): the batched-product pair, the
# torch reduction probe, the Box-Muller A/B baseline, the plain torch twins
# of kernels whose ``cuda`` number is the production path, the
# time-of-impact kernel and the pure-advancement k-gon baseline.
DIGEST_STDERR_ONLY = (
    "hbm_read_gbps_xla",
    "mc_samples_per_sec_cuda_noshape_box_muller",
    "sat_polygon_pairs_per_sec_mxu_dot",
    "sat_polygon_pairs_per_sec_mxu_dot_bf16",
    "sat_rect_pairs_per_sec_xla",
    "mc_samples_per_sec",
    "rect_distance_pairs_per_sec",
    "polygon_distance_pairs_per_sec",
    "manifold_pairs_per_sec",
    "scene_rays_per_sec",
    "rect_toi_queries_per_sec_cuda",
    "mc_moving_polygon_samples_per_sec_jnp_rotating_noscreen",
)


def digest_add(digest: dict, res: dict) -> None:
    """Fold one result into the digest: one compact (name -> value) pair a
    measured metric, plus a short list of qualitative extras. Names drop
    ``_per_sec``, the unit words and ``_jnp`` (the default path; only the
    ``_cuda`` variants need a tag), and ``cuda_vs_jnp_agreement`` becomes
    ``rect_agreement``; values keep 3 significant digits, integral rates
    without ``.0``."""
    name = res.get("metric")
    if not name or name in DIGEST_STDERR_ONLY:
        return
    key = name.replace("_per_sec", "")
    key = key.replace("cuda_vs_jnp_agreement", "rect_agreement")
    for unit in ("_samples", "_pairs", "_queries", "_rows"):
        key = key.replace(unit, "")
    key = key.replace("_jnp", "")

    def compact(v):
        v = float(f"{float(v):.3g}")
        return int(v) if abs(v) >= 1e4 and v == int(v) else v

    try:
        digest[key] = compact(res["value"])
    except (KeyError, TypeError, ValueError):
        return
    for extra, short in (
        ("ok", "ok"),
        ("frac_within_005", "frac005"),
        ("frac_ambiguous_ca", "amb"),
        ("window_exceeded", "wex"),
        ("steady_state_configs_per_sec", "steady"),
        ("spread", "spr"),
    ):
        if extra == "frac_within_005" and name != "cuda_vs_jnp_agreement":
            continue  # the k-gon agreements keep theirs on stderr
        if extra in res:
            v = res[extra]
            digest[f"{key}.{short}"] = bool(v) if isinstance(v, bool) else compact(v)


def build_digest_line(digest: dict) -> str:
    """The one-line digest, trimmed under `DIGEST_BUDGET` by dropping the
    longest names first should a metric set overflow (mutates
    ``digest``)."""
    def line() -> str:
        return json.dumps({"metric": "digest", "n": len(digest), "metrics": digest},
                          separators=(",", ":"))

    out = line()
    while len(out) > DIGEST_BUDGET and digest:
        digest.pop(max(digest, key=len))
        out = line()
    return out


def median_of(fn, n: int = 3):
    """``fn`` as the median of ``n`` draws by ``value``, with ``spread`` =
    (max - min) / median and ``n_draws``; a ``steady_state_configs_per_sec``
    field is the median of its own draws."""
    def run():
        runs = sorted((fn() for _ in range(n)), key=lambda r: float(r.get("value", 0.0)))
        med = dict(runs[len(runs) // 2])
        vals = [float(r.get("value", 0.0)) for r in runs]
        v_med = vals[len(runs) // 2]
        if v_med:
            med["spread"] = float(f"{(vals[-1] - vals[0]) / v_med:.2g}")
        steadies = sorted(float(r["steady_state_configs_per_sec"]) for r in runs
                          if "steady_state_configs_per_sec" in r)
        if steadies:
            med["steady_state_configs_per_sec"] = steadies[len(steadies) // 2]
        med["n_draws"] = len(runs)
        return med

    run.__name__ = getattr(fn, "__name__", "bench") + "_median"
    return run


def _named(fn, name: str, **kw):
    leg = functools.partial(fn, **kw)
    leg.__name__ = name
    return leg


def secondary_legs() -> list:
    """The root bench's secondary legs in its order (bench.py:383-446), each
    a no-argument callable with a ``__name__``."""
    return [
        bm.bench_sat,
        bm.bench_obb_cuda,
        bm.bench_distance,
        bm.bench_distance_cuda,
        bm.bench_polygon_distance,
        bm.bench_polygon_distance_cuda,
        bm.bench_manifold,
        bm.bench_manifold_cuda,
        median_of(bm.bench_scene),
        bm.bench_scene_swept,
        bm.bench_scene_raycast,
        bm.bench_scene_raycast_cuda,
        bm.bench_toi_cuda,
        bm.bench_mc,
        bm.bench_mc_cuda,
        _named(bm.bench_mc_cuda, "bench_mc_cuda_noshape", shape_noise=False),
        # the A/B record of the normal draw: kernel 1's Box-Muller build
        _named(bm.bench_mc_cuda, "bench_mc_cuda_noshape_box_muller", shape_noise=False,
               normal_method="box_muller"),
        bm.bench_mc_polygons_cuda,
        # trajectories: the fused kernel and the threefry path, translation
        # and rotating
        bm.bench_mc_moving_cuda,
        bm.bench_mc_moving,
        _named(bm.bench_mc_moving_cuda, "bench_mc_moving_cuda_rotating", rotating=True),
        median_of(_named(bm.bench_mc_moving, "bench_mc_moving_jnp_rotating",
                         rotating=True)),
        median_of(_named(bm.bench_mc_moving, "bench_mc_moving_jnp_rotating_noscreen",
                         rotating=True, screen=False)),
        bm.bench_mc_moving_polygons,
        bm.bench_mc_moving_polygons_cuda,
        median_of(_named(bm.bench_mc_moving_polygons, "bench_mc_moving_polygons_rotating",
                         rotating=True)),
        _named(bm.bench_mc_moving_polygons, "bench_mc_moving_polygons_rotating_noscreen",
               rotating=True, screen=False),
        bm.bench_sat_cuda_bf16,
        bm.bench_sat_polygons_cuda,
        _named(bm.bench_sat_polygons_cuda, "bench_sat_polygons_cuda_bf16",
               precision="bf16"),
        bm.bench_sat_polygons_mxu,
        _named(bm.bench_sat_polygons_mxu, "bench_sat_polygons_mxu_bf16", dtype="bf16"),
        # the fused kernels against the threefry path (ok must be true)
        bm.bench_agreement,
        bm.bench_agreement_polygons,
        _named(bm.bench_agreement_polygons, "bench_agreement_polygons_moving",
               moving=True),
        bm.bench_learned_train,
        # last, as in the root bench: the adaptive driver end to end
        median_of(_named(bm.bench_e2e, "bench_e2e", configs=65536)),
        median_of(_named(bm.bench_e2e, "bench_e2e_tuned", configs=65536,
                         schedule="tuned")),
        median_of(_named(bm.bench_e2e, "bench_e2e_opt", configs=65536, schedule="opt")),
        median_of(_named(bm.bench_e2e_polygons, "bench_e2e_polygons", configs=32768)),
        median_of(_named(bm.bench_e2e_polygons, "bench_e2e_polygons_opt", configs=32768,
                         schedule="opt")),
    ]


def _log(obj) -> None:
    print("# " + json.dumps(obj), file=sys.stderr, flush=True)


def headline(log=_log) -> dict:
    """Run the probes, then the SAT headline, and check the headline's
    implied bandwidth against the larger probe."""
    hbm_gbps = 0.0
    for probe in (bm.bench_stream_bandwidth_cuda, bm.bench_reduce_bandwidth):
        res = probe()
        log(res)
        hbm_gbps = max(hbm_gbps, res["value"])
    sat = bm.bench_sat_cuda(pairs=1 << 23, iters=100)
    out = {
        "metric": "sat_rect_pairs_per_sec",
        "value": sat["value"],
        "unit": "pairs/s",
        "vs_baseline": sat["vs_baseline"],
        "effective_gbps": sat["effective_gbps"],
        "hbm_read_gbps": hbm_gbps,
    }
    if sat["effective_gbps"] > BANDWIDTH_SLACK * hbm_gbps:
        print(f"# WARNING: implied bandwidth {sat['effective_gbps']:.0f} GB/s "
              f"exceeds measured streaming bandwidth {hbm_gbps:.0f} GB/s - "
              "timing methodology suspect", file=sys.stderr, flush=True)
        out["bandwidth_check"] = "FAILED"
    else:
        out["bandwidth_check"] = "ok"
    out["device"] = sat["device"]
    return out


def _counted_modules() -> dict:
    from collide2d_tpu_torch.ops import (distance_cuda, manifold_cuda, mc_cuda,
                                         mc_moving_polygon_cuda, mc_polygon_cuda,
                                         mc_toi_cuda, polygon_cuda, raycast_cuda,
                                         sat_cuda, screen_cuda, stream_cuda, toi_cuda)

    return {"distance": distance_cuda, "manifold": manifold_cuda, "mc": mc_cuda,
            "mc_moving_polygon": mc_moving_polygon_cuda, "mc_polygon": mc_polygon_cuda,
            "mc_toi": mc_toi_cuda, "polygon": polygon_cuda, "raycast": raycast_cuda,
            "sat": sat_cuda, "screen": screen_cuda, "stream": stream_cuda,
            "toi": toi_cuda}


def reset_launch_counts() -> None:
    for mod in _counted_modules().values():
        mod.reset_launches()


def launch_counts() -> dict:
    """Each kernel's launches since `reset_launch_counts`, by its number
    (the Box-Muller builds of kernels 1, 7 and 14 as ``1bm``, ``7bm``,
    ``14bm``)."""
    m = _counted_modules()
    sat, dist = m["sat"].LAUNCHES, m["distance"].LAUNCHES
    return {
        "1": m["mc"].LAUNCHES, "1bm": m["mc"].BOX_MULLER_LAUNCHES,
        "2": sat["sat_label"], "3": sat["sat_count"], "4": sat["obb_label"],
        "5": sat["obb_count"], "6": m["polygon"].LAUNCHES,
        "7": m["mc_polygon"].LAUNCHES, "7bm": m["mc_polygon"].BOX_MULLER_LAUNCHES,
        "8": dist["obb_distance"], "9": dist["polygon_distance"],
        "10": m["manifold"].LAUNCHES, "11": m["raycast"].LAUNCHES,
        "12": m["toi"].LAUNCHES, "13": m["mc_toi"].LAUNCHES,
        "14": m["mc_moving_polygon"].LAUNCHES,
        "14bm": m["mc_moving_polygon"].BOX_MULLER_LAUNCHES,
        "15": m["screen"].LAUNCHES, "16": m["stream"].LAUNCHES,
    }


def main(argv=()) -> int:
    parser = argparse.ArgumentParser(prog="python -m collide2d_tpu_torch.bench",
                                     description=__doc__.splitlines()[0])
    parser.parse_args(list(argv))
    if not torch.cuda.is_available():
        print("collide2d_tpu_torch.bench: no CUDA device (the bench measures "
              "the card; the CPU legs run through `collide2d-torch bench "
              "--device cpu`)", file=sys.stderr)
        return 2
    reset_launch_counts()
    digest: dict = {}

    def log(obj) -> None:
        _log(obj)
        digest_add(digest, obj)

    head = headline(log=log)
    digest_add(digest, head)
    line = json.dumps(head)
    print(line, flush=True)  # at once, in case a later leg is cut off
    failed = []
    for fn in secondary_legs():
        try:
            log(fn())
        except Exception:  # noqa: BLE001 — reported, the others go on, exit 1
            failed.append(fn.__name__)
            trace = traceback.format_exc().rstrip().replace("\n", "\n# ")
            print(f"# {fn.__name__} failed:\n# {trace}", file=sys.stderr, flush=True)
    if failed:
        print(f"# failed legs: {', '.join(failed)}", file=sys.stderr, flush=True)
    print("# launches " + json.dumps({"launches": launch_counts(), "failed": failed}),
          file=sys.stderr, flush=True)
    print(build_digest_line(digest), flush=True)
    print(line, flush=True)  # the contract: the headline is the last line
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
