"""The port's bench entry points against the JAX package's, on the CPU.

(a) the legs' inputs: `_random_pairs`, the Monte Carlo and end-to-end
    tables and the k-gons draw what the JAX helpers draw from the same
    seeds: the uniform draws bitwise; the rectangles and k-gons bitwise
    wherever torch's and XLA's CPU cos and sin round alike (the share is
    printed), else within 2 ulp of their size;
(b) kernel 16's plain version (`ops.stream_cuda.stream_sum_plain`) on the
    JAX package's own `pack_rects` rows against a float64 numpy sum of the
    same tiles, within 1e-5 x (sum|r1| * s + sum|r2|) (float32 sums of up
    to 2^16 terms against float64). The JAX probe is a closure over TPU
    memory spaces with no interpret path, so it cannot run here;
(c) `bench_sat`'s per-iteration count equals JAX's `_sat_loop` on the same
    pairs (exact);
(d) `run_all(device="cpu")` runs the legs the JAX bench runs on a CPU host,
    at its CPU sizes, under its metric names (``_pallas`` -> ``_cuda``),
    with its fields, and ends with the learned model's training leg
    (`bench_learned_train`, measured: 2^15 rows, batch 1,024, 2 epochs);
    ``collide2d-torch bench --device cpu`` prints only JSON lines;
(e) the headline builder of ``python -m collide2d_tpu_torch.bench`` marks
    ``bandwidth_check`` FAILED above 1.15 x the larger probe and ok below;
(f) without a card, the bench entry point exits non-zero and every leg
    asked for ``device="cuda"`` raises.

(g) every public ``bench_*`` of the JAX bench has its counterpart under the
    ``pallas`` -> ``cuda`` rule, and each leg, run on the CPU at a small
    size, returns the JAX leg's metric name (spelled from the JAX source's
    string constants) and exactly the fields the JAX source can return
    (read from it), plus ``device``;
(h) the legs' inputs: the trajectory rows, the k-gon trajectory rows (the
    JAX legs' inline draws), the sparse scene, the agreement rows and
    `bench_e2e_polygons`' batches are JAX's on the same seeds (bitwise,
    cos/sin-derived values within 2 ulp of their size);
(i) `agreement_stats` gives the JAX agreement legs' fields to the last bit
    on the cps their samplers are stubbed to return, ``ok`` both ways;
(j) `bench_e2e(schedule="tuned"|"opt")` and `bench_e2e_polygons` return
    their fields at a 4,000-sample cap;
(k) the bench module: `digest_add`, `build_digest_line` and `median_of`
    give the root ``bench.py``'s outputs under the ``cuda`` names (loaded
    as tests/test_aux.py loads it), the real metric set makes a digest of
    at least 25 metrics that fits the last 2,000 characters with the
    headline, `secondary_legs` are the root bench's legs in its order, and
    a failing leg prints its traceback, the others go on, the digest and
    the headline end stdout and the exit code is 1.

`bench_mc` and `bench_e2e` are stubbed where `run_all` runs (at the JAX
bench's sizes they take minutes on a CPU); `bench_e2e` itself runs once
with a 4,000-sample cap.
"""

import functools
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collide2d_tpu.ops.sat_pallas import pack_rects as jpack_rects
from collide2d_tpu.utils import benchmarks as jbm
from collide2d_tpu_torch import bench as tbench
from collide2d_tpu_torch import cli as tcli
from collide2d_tpu_torch.mc import estimator as test
from collide2d_tpu_torch.ops import stream_cuda
from collide2d_tpu_torch.utils import benchmarks as tbm

# The suite runs one xdist worker per core: one torch thread each keeps
# the workers from oversubscribing the host.
torch.set_num_threads(1)


def _np(t) -> np.ndarray:
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_cos_sin_bitwise(got, want, angles, size: float) -> None:
    """Equal where torch and XLA round cos and sin of ``angles`` alike;
    elsewhere within 2 ulp of ``size``."""
    a = jnp.asarray(angles)
    t = torch.from_numpy(np.array(angles))
    agree = (np.asarray(jnp.cos(a)) == torch.cos(t).numpy()) & (
        np.asarray(jnp.sin(a)) == torch.sin(t).numpy())
    print(f"cos/sin agree bitwise on {agree.mean():.2%} of angles")
    agree = agree.reshape(agree.shape[0], -1).all(axis=1)
    got, want = _np(got), _np(want)
    np.testing.assert_array_equal(got[agree], want[agree])
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * np.spacing(np.float32(size)))


def test_random_pairs_are_jax_draws():
    n, seed = 4096, 3
    ks = jax.random.split(jax.random.PRNGKey(seed), 6)
    bounds = [(-6, 6, (n, 2)), (0.1, 5, (n, 2)), (0, 2 * np.pi, (n,))] * 2
    want = [jax.random.uniform(ks[i], shape, jnp.float32, lo, hi)
            for i, (lo, hi, shape) in enumerate(bounds)]
    got = tbm._pair_params(n, seed, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    r1, r2 = tbm._random_pairs(n, seed, device="cpu")
    j1, j2 = jbm._random_pairs(n, seed)
    _assert_cos_sin_bitwise(r1, j1, _np(got[2]), 16.0)
    _assert_cos_sin_bitwise(r2, j2, _np(got[5]), 16.0)


def test_bench_tables_are_jax_draws():
    cfg = tbm._bench_configs(512, device="cpu")
    for g, w in zip(cfg, jbm._bench_configs(512)):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    # bench_e2e's tables (utils/benchmarks.py:1436-1443)
    k_tab = jax.random.split(jax.random.PRNGKey(0), 3)[0]
    rngs = jax.random.split(k_tab, 2)
    poses = jax.random.uniform(rngs[0], (4096, 3), jnp.float32,
                               jnp.asarray([0.1, 0.1, 0.0]),
                               jnp.asarray([5.0, 5.0, 2 * np.pi]))
    std_devs = jnp.sqrt(jax.random.uniform(rngs[1], (4096, 5), jnp.float32, 0.0, 0.3)
                        .at[:, 3:].set(0.0))
    t_tab = tbm.prng.split(tbm.prng.PRNGKey(0), 3)[0]
    got_poses, got_sd = tbm._e2e_tables(t_tab, device="cpu")
    np.testing.assert_array_equal(got_poses.numpy(), np.asarray(poses))
    np.testing.assert_array_equal(got_sd.numpy(), np.asarray(std_devs))


def test_random_convex_polygons_are_jax_draws():
    n, k = 256, 8
    got = tbm._random_convex_polygons(n, k, 3, 40.0, device="cpu")
    want = jbm._random_convex_polygons(n, k, 3, 40.0)
    _, _, ka = jax.random.split(jax.random.PRNGKey(3), 3)
    rot = jax.random.uniform(ka, (n, 1), jnp.float32, 0.0, 2 * np.pi)
    ang = np.asarray(rot + jnp.arange(k, dtype=jnp.float32) * (2 * np.pi / k))
    _assert_cos_sin_bitwise(got, want, ang, 41.0)


@functools.cache
def _jax_packed(pairs: int):
    r1, r2 = jbm._random_pairs(pairs, seed=5)
    return np.array(jpack_rects(r1)), np.array(jpack_rects(r2))


@pytest.mark.parametrize("pairs", [8, 8 * 4097, 8 * 3 * 4096])
@pytest.mark.parametrize("s", [1.0, 1.0 + 37e-9, 0.5])
def test_stream_sum_plain_against_float64_tile_sums(pairs, s):
    a, b = _jax_packed(pairs)
    m = a.shape[2]
    s32 = np.float32(s)
    want = sum(a[:, :, j:j + stream_cuda.TILE].astype(np.float64).sum() * np.float64(s32)
               + b[:, :, j:j + stream_cuda.TILE].astype(np.float64).sum()
               for j in range(0, m, stream_cuda.TILE))
    scale = np.abs(a).astype(np.float64).sum() * np.float64(s32) + np.abs(b).sum()
    before = stream_cuda.LAUNCHES
    got = stream_cuda.stream_sum(torch.from_numpy(a), torch.from_numpy(b), s)
    assert stream_cuda.LAUNCHES == before  # a CPU tensor runs the plain version
    assert got.dtype == torch.float32 and got.shape == ()
    assert got.item() == stream_cuda.stream_sum_plain(
        torch.from_numpy(a), torch.from_numpy(b), s).item()
    assert abs(got.item() - want) <= 1e-5 * scale
    assert stream_cuda.bytes_read(torch.from_numpy(a), torch.from_numpy(b)) == 64 * pairs


def test_stream_sum_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((8, 8, 4))
    with pytest.raises(ValueError):
        stream_cuda.stream_sum(x, x.double(), 1.0)
    with pytest.raises(ValueError):
        stream_cuda.stream_sum(x, torch.zeros((8, 8, 5)), 1.0)
    with pytest.raises(ValueError):
        stream_cuda.stream_sum(x.reshape(64, 4), x.reshape(64, 4), 1.0)


def test_bench_sat_counts_equal_jax_sat_loop():
    r1, r2 = jbm._random_pairs(8192, seed=1)
    t1, t2 = torch.from_numpy(np.asarray(r1)), torch.from_numpy(np.asarray(r2))
    assert int(tbm._sat_step(t1, t2, 0)) == int(jbm._sat_loop(r1, r2, jnp.int32(1)))
    got = sum(int(tbm._sat_step(t1, t2, i)) for i in range(3))
    assert got == int(jbm._sat_loop(r1, r2, jnp.int32(3)))
    assert 0 < got < 3 * 8192


# The JAX legs' metric names and fields on a CPU host (run_all, :2004-2055;
# each leg's return dict), "device" added by the port.
CPU_LEGS = {
    "sat_rect_pairs_per_sec_xla": {"pairs", "seconds_per_iter"},
    "manifold_pairs_per_sec": {"k", "pairs", "seconds_per_iter"},
    "scene_pairs_per_sec": {"n_shapes", "k", "row_tile", "seconds_per_iter"},
    "scene_swept_pairs_per_sec_effective": {
        "narrow_pairs_per_sec", "n_shapes", "k", "window", "colliding_pairs",
        "window_exceeded", "capacity_overflow", "seconds_per_iter"},
    "scene_rays_per_sec": {"rays", "n_shapes", "k", "seconds_per_iter"},
    "mc_samples_per_sec": {"seconds_per_step", "configs", "step_samples"},
    "configs_labeled_per_sec": {
        "configs", "batches", "overlap", "seconds", "configs_per_hour",
        "steady_state_configs_per_sec", "converged_frac",
        "mean_samples_per_config", "mean_cp", "dispatched_slots_per_sec",
        "slot_efficiency"},
    "learned_train_rows_per_sec": {
        "seconds_per_epoch", "rows_per_epoch", "batch", "hidden", "model_tflops"},
}
COMMON_FIELDS = {"metric", "value", "unit", "vs_baseline", "device"}
# The JAX bench's CPU sizes (run_all): manifold pairs, scene N, swept N,
# window and capacity, raycast rays and shapes, e2e configurations.
CPU_SIZES = {"manifold_pairs_per_sec": {"pairs": 1 << 14},
             "scene_pairs_per_sec": {"n_shapes": 256},
             "scene_swept_pairs_per_sec_effective": {"n_shapes": 256, "window": 64},
             "scene_rays_per_sec": {"rays": 1 << 12, "n_shapes": 16},
             "learned_train_rows_per_sec": {"rows_per_epoch": 1 << 15, "batch": 1024,
                                            "hidden": [256, 256, 256]}}


@pytest.fixture
def stubbed_slow_legs(monkeypatch):
    """`bench_mc` and `bench_e2e` replaced by stubs that record their
    arguments; returns the record."""
    calls = {}

    def stub(name, metric):
        def fn(**kw):
            calls[name] = kw
            return {"metric": metric, "value": 1.0, "stub": True}
        return fn

    monkeypatch.setattr(tbm, "bench_mc", stub("bench_mc", "mc_samples_per_sec"))
    monkeypatch.setattr(tbm, "bench_e2e", stub("bench_e2e", "configs_labeled_per_sec"))
    return calls


def test_run_all_on_cpu_emits_the_jax_cpu_legs(stubbed_slow_legs):
    out = [json.loads(s) for s in tbm.run_all(pairs=1024, iters=1, device="cpu")]
    assert [o["metric"] for o in out] == list(CPU_LEGS)
    for o in out:
        if o.get("stub"):
            continue
        assert set(o) == COMMON_FIELDS | CPU_LEGS[o["metric"]], o["metric"]
        assert o["device"] == "cpu" and o["value"] > 0
        for field, size in CPU_SIZES.get(o["metric"], {}).items():
            assert o[field] == size, (o["metric"], field)
    assert out[0]["pairs"] == 1024
    assert out[3]["window_exceeded"] is False and out[3]["colliding_pairs"] > 0
    assert stubbed_slow_legs["bench_e2e"] == {"device": torch.device("cpu"),
                                              "configs": 256}
    assert stubbed_slow_legs["bench_mc"] == {"device": torch.device("cpu")}


def _public_legs(mod) -> set:
    return {name for name in dir(mod) if name.startswith("bench_")}


def test_kernel_legs_are_the_jax_pallas_legs():
    """Every public leg of the JAX bench has its counterpart under the
    ``pallas`` -> ``cuda`` rule, and the port has no other."""
    jax_legs = _public_legs(jbm)
    assert len(jax_legs) == 33
    assert _public_legs(tbm) == {name.replace("pallas", "cuda") for name in jax_legs}
    cuda_legs = [name for name in _public_legs(tbm) if "_cuda" in name]
    assert len(cuda_legs) == 14
    for name in cuda_legs:
        assert hasattr(jbm, name.replace("_cuda", "_pallas")), name


def test_cli_bench_on_cpu_prints_json_lines(stubbed_slow_legs, capsys):
    assert tcli.main(["bench", "--device", "cpu", "--pairs", "512", "--iters", "1"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(CPU_LEGS)
    assert [json.loads(line)["metric"] for line in lines] == list(CPU_LEGS)


def test_bench_e2e_fields_at_a_small_cap(monkeypatch):
    monkeypatch.setattr(test, "AdaptiveConfig",
                        functools.partial(test.AdaptiveConfig, max_samples=4000))
    out = tbm.bench_e2e(configs=64, batches=3, device="cpu")
    assert set(out) == COMMON_FIELDS | CPU_LEGS["configs_labeled_per_sec"]
    assert out["configs"] == 192 and out["batches"] == 3 and out["overlap"] == 3
    assert 0.0 <= out["mean_cp"] <= 1.0 and 0.0 < out["slot_efficiency"] <= 1.0
    assert 1000 <= out["mean_samples_per_config"] <= 4096


def test_bench_learned_train_fields_are_the_jax_legs():
    """The learned leg at a toy size: JAX's fields plus ``device``, the
    same rows an epoch, and a finite positive rate on both."""
    kw = dict(rows=2048, batch=256, hidden=(16,), epochs=1)
    want = jbm.bench_learned_train(**kw)
    got = tbm.bench_learned_train(**kw, device="cpu")
    assert set(got) == set(want) | {"device"}
    assert got["metric"] == want["metric"] == "learned_train_rows_per_sec"
    for field in ("rows_per_epoch", "batch", "hidden", "unit"):
        assert got[field] == want[field], field
    assert 0 < got["value"] < float("inf") and got["device"] == "cpu"
    assert got["model_tflops"] == pytest.approx(
        got["value"] * (13 * 16 + 16) * 6 / 1e12, rel=1e-12)


def _patch_headline(monkeypatch, stream_gbps, reduce_gbps, sat_gbps):
    def leg(value, **extra):
        return lambda **kw: {"metric": "m", "value": value, "device": "card", **extra}

    monkeypatch.setattr(tbm, "bench_stream_bandwidth_cuda", leg(stream_gbps))
    monkeypatch.setattr(tbm, "bench_reduce_bandwidth", leg(reduce_gbps))
    monkeypatch.setattr(tbm, "bench_sat_cuda", leg(
        sat_gbps / 64 * 1e9, vs_baseline=sat_gbps / 64, effective_gbps=sat_gbps))


@pytest.mark.parametrize("stream,reduce,sat,check", [
    (3000.0, 1500.0, 3000.0 * 1.15 - 1.0, "ok"),
    (3000.0, 1500.0, 3000.0 * 1.15 + 1.0, "FAILED"),
    (1000.0, 2000.0, 2250.0, "ok"),  # the larger probe is the ceiling
    (1000.0, 2000.0, 2350.0, "FAILED"),
])
def test_headline_bandwidth_check(monkeypatch, stream, reduce, sat, check):
    _patch_headline(monkeypatch, stream, reduce, sat)
    logged = []
    head = tbench.headline(log=logged.append)
    assert [o["value"] for o in logged] == [stream, reduce]  # probes first
    assert head["metric"] == "sat_rect_pairs_per_sec"
    assert head["hbm_read_gbps"] == max(stream, reduce)
    assert head["effective_gbps"] == sat
    assert head["bandwidth_check"] == check


def test_bench_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tbench.main() != 0
    assert capsys.readouterr().out == ""  # no headline
    for leg in (tbm.bench_sat, tbm.bench_stream_bandwidth_cuda, tbm.bench_e2e,
                tbm.bench_learned_train):
        with pytest.raises(RuntimeError, match="CUDA"):
            leg(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        tbm.run_all(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["bench"])


def test_bench_module_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    proc = subprocess.run([sys.executable, "-m", "collide2d_tpu_torch.bench"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""


# ---- every leg of the JAX bench: metric names and fields ----


def _jax_function(name: str):
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(jbm))
    return next(f for f in tree.body if isinstance(f, ast.FunctionDef) and f.name == name)


def _jax_fields(name: str) -> set:
    """The string keys of every dict literal and subscript assignment in the
    JAX leg's source: the fields it can return."""
    import ast

    keys = set()
    for node in ast.walk(_jax_function(name)):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys
                     if isinstance(k, ast.Constant) and isinstance(k.value, str)}
        if isinstance(node, ast.Assign):
            keys |= {t.slice.value for t in node.targets if isinstance(t, ast.Subscript)
                     and isinstance(t.slice, ast.Constant)
                     and isinstance(t.slice.value, str)}
    return keys


def _jax_builds_metric(name: str, metric: str, kw: dict) -> bool:
    """Whether the JAX leg's source spells ``metric`` as a concatenation of
    its string constants (and the case's keyword values, for f-strings)."""
    import ast

    pieces = {n.value for n in ast.walk(_jax_function(name))
              if isinstance(n, ast.Constant) and isinstance(n.value, str) and n.value}
    pieces |= {v for v in kw.values() if isinstance(v, str)}

    def spell(rest: str) -> bool:
        return rest == "" or any(rest.startswith(p) and spell(rest[len(p):])
                                 for p in pieces)

    return spell(metric)


# (port leg, keyword arguments at a CPU size, the JAX leg's metric name,
# fields the JAX leg adds only in other cases)
SCREEN = {"frac_definite_miss", "frac_probe_hit", "frac_ambiguous_ca"}
LEG_CASES = [
    ("bench_sat_cuda", dict(pairs=8192, iters=1), "sat_rect_pairs_per_sec_pallas", set()),
    ("bench_sat_cuda_bf16", dict(pairs=8192, iters=1),
     "sat_rect_pairs_per_sec_pallas_bf16", set()),
    ("bench_obb_cuda", dict(pairs=8192, iters=1), "obb_param_pairs_per_sec_pallas", set()),
    ("bench_stream_bandwidth_cuda", dict(pairs=8192, iters=1), "hbm_stream_gbps_pallas",
     set()),
    ("bench_sat_polygons_cuda", dict(pairs=4096, iters=1),
     "sat_polygon_pairs_per_sec_pallas", set()),
    ("bench_sat_polygons_cuda", dict(pairs=4096, iters=1, precision="bf16"),
     "sat_polygon_pairs_per_sec_pallas_bf16", set()),
    ("bench_sat_polygons_mxu", dict(pairs=4096, iters=1),
     "sat_polygon_pairs_per_sec_mxu_dot", set()),
    ("bench_sat_polygons_mxu", dict(pairs=4096, iters=1, dtype="bf16"),
     "sat_polygon_pairs_per_sec_mxu_dot_bf16", set()),
    ("bench_broad_phase_sat", dict(pairs=4096, iters=1), "broad_phase_sat_speedup", set()),
    ("bench_distance", dict(pairs=4096, iters=1), "rect_distance_pairs_per_sec", set()),
    ("bench_distance_cuda", dict(pairs=8192, iters=1),
     "rect_distance_pairs_per_sec_pallas", set()),
    ("bench_polygon_distance", dict(pairs=2048, iters=1),
     "polygon_distance_pairs_per_sec", set()),
    ("bench_polygon_distance_cuda", dict(pairs=4096, iters=1),
     "polygon_distance_pairs_per_sec_pallas", set()),
    ("bench_manifold_cuda", dict(pairs=4096, iters=1), "manifold_pairs_per_sec_pallas",
     set()),
    ("bench_scene_raycast_cuda", dict(rays=512, n_shapes=8, iters=1),
     "scene_rays_per_sec_pallas", set()),
    ("bench_toi_cuda", dict(pairs=8192, toi_iters=8, iters=1),
     "rect_toi_queries_per_sec_pallas", set()),
    ("bench_mc_cuda", dict(configs=128, iters=1), "mc_samples_per_sec_pallas", set()),
    ("bench_mc_cuda", dict(configs=128, iters=1, shape_noise=False,
                           normal_method="box_muller"),
     "mc_samples_per_sec_pallas_noshape_box_muller", set()),
    ("bench_mc_polygons_cuda", dict(configs=64, iters=1),
     "mc_polygon_samples_per_sec_pallas", set()),
    ("bench_mc_polygons_cuda", dict(configs=64, iters=1, normal_method="box_muller"),
     "mc_polygon_samples_per_sec_pallas_box_muller", set()),
    ("bench_mc_moving_cuda", dict(configs=64, step_samples=64, iters=1),
     "mc_moving_samples_per_sec_pallas", set()),
    ("bench_mc_moving_cuda", dict(configs=64, step_samples=64, iters=1, rotating=True),
     "mc_moving_samples_per_sec_pallas_rotating", set()),
    ("bench_mc_moving", dict(configs=64, step_samples=32, iters=1),
     "mc_moving_samples_per_sec_jnp", SCREEN),
    ("bench_mc_moving", dict(configs=64, step_samples=32, iters=1, rotating=True),
     "mc_moving_samples_per_sec_jnp_rotating", set()),
    ("bench_mc_moving", dict(configs=64, step_samples=32, iters=1, rotating=True,
                             screen=False),
     "mc_moving_samples_per_sec_jnp_rotating_noscreen", SCREEN),
    ("bench_mc_moving_polygons", dict(configs=32, step_samples=16, iters=1),
     "mc_moving_polygon_samples_per_sec_jnp", SCREEN),
    ("bench_mc_moving_polygons", dict(configs=32, step_samples=16, iters=1,
                                      rotating=True),
     "mc_moving_polygon_samples_per_sec_jnp_rotating", set()),
    ("bench_mc_moving_polygons", dict(configs=32, step_samples=16, iters=1,
                                      rotating=True, screen=False),
     "mc_moving_polygon_samples_per_sec_jnp_rotating_noscreen", SCREEN),
    ("bench_mc_moving_polygons_cuda", dict(configs=64, iters=1),
     "mc_moving_polygon_samples_per_sec_pallas", set()),
    ("bench_broad_phase", dict(configs=1024, n_samples=128, reps=1),
     "broad_phase_speedup", set()),
    ("bench_agreement", dict(configs=64, n_samples=1024), "pallas_vs_jnp_agreement",
     set()),
    ("bench_agreement_polygons", dict(configs=64, n_samples=1024), "polygon_agreement",
     set()),
    ("bench_agreement_polygons", dict(configs=64, n_samples=1024, moving=True),
     "moving_polygon_agreement", set()),
]


@pytest.mark.parametrize("leg,kw,jax_metric,absent", LEG_CASES,
                         ids=[f"{c[0]}-{c[2]}" for c in LEG_CASES])
def test_leg_has_the_jax_metric_and_fields(leg, kw, jax_metric, absent):
    jax_leg = leg.replace("cuda", "pallas")
    assert _jax_builds_metric(jax_leg, jax_metric, kw)
    out = getattr(tbm, leg)(device="cpu", **kw)
    assert out["metric"] == jax_metric.replace("pallas", "cuda")
    assert set(out) == (_jax_fields(jax_leg) - absent) | {"device"}
    assert out["device"] == "cpu"
    assert 0 < out["value"] < float("inf") or out["unit"] == "max_zscore"
    if out["unit"] == "max_zscore":
        assert out["ok"] is True and out["configs"] == kw["configs"]


# ---- the legs' inputs against the JAX builders ----


def test_bench_moving_configs_are_jax_rows():
    for rotating in (False, True):
        got = tbm._bench_moving_configs(96, rotating, device="cpu")
        want = jbm._bench_moving_configs(96, rotating)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), np.asarray(w))


def _jax_moving_polygon_rows(configs: int, k: int, rotating):
    """The JAX k-gon trajectory legs' rows, as their inline code draws them
    (utils/benchmarks.py:667-679; ``rotating=None`` the fused leg's,
    :740-749, without the omega draw)."""
    from collide2d_tpu.mc.moving import moving_polygon_configs

    rng = np.random.default_rng(7)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return moving_polygon_configs(
        f32(rng.uniform(-6, 6, (configs, 2))),
        f32(rng.uniform(0, 2 * np.pi, configs)),
        np.asarray(jbm._random_convex_polygons(configs, k, 2, 10.0)),
        f32(rng.uniform(0, 0.3, (configs, 3))),
        f32(rng.uniform(-2, 2, (configs, 2))),
        0.0 if rotating is None else f32(rng.uniform(-0.5, 0.5, configs)
                                         * (1.0 if rotating else 0.0)),
        f32(rng.uniform(0.5, 3, configs)),
    )


@pytest.mark.parametrize("rotating", [False, True, None])
def test_bench_moving_polygon_configs_are_jax_rows(rotating):
    n, k = 128, 6
    got = tbm._bench_moving_polygon_configs(n, k, rotating, device="cpu")
    want = _jax_moving_polygon_rows(n, k, rotating)
    for field, g, w in zip(got._fields, got, want):
        if field == "obstacle_verts":
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0,
                                       atol=2 * np.spacing(np.float32(11.0)))
        else:
            np.testing.assert_array_equal(_np(g), np.asarray(w), err_msg=field)


def test_sparse_scene_and_agreement_rows_are_jax_rows():
    got = tbm._sparse_scene_configs(512, device="cpu")
    for g, w in zip(got, jbm._sparse_scene_configs(512)):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    from collide2d_tpu.models.collision_model import example_polygon_configs

    static = tbm._agreement_polygon_configs(64, 7, 6, False, "cpu")
    for g, w in zip(static, example_polygon_configs(n=64, k=6, seed=7)):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=4e-7)
    # the moving rows (utils/benchmarks.py:1352-1365), drawn inline there
    from collide2d_tpu.mc.moving import moving_polygon_configs

    rng = np.random.default_rng(7)
    ang = np.sort(rng.uniform(0, 2 * np.pi, (64, 6)), axis=-1)
    ab = rng.uniform(0.5, 3.0, (64, 1, 2))
    verts = (np.stack([np.cos(ang), np.sin(ang)], -1) * ab).astype(np.float32)
    want = moving_polygon_configs(
        rng.uniform(-6, 6, (64, 2)).astype(np.float32),
        rng.uniform(0, 2 * np.pi, 64).astype(np.float32), verts,
        rng.uniform(0, 0.3, (64, 3)).astype(np.float32),
        rng.uniform(-2, 2, (64, 2)).astype(np.float32), 0.0,
        rng.uniform(0.5, 3, 64).astype(np.float32))
    got = tbm._agreement_polygon_configs(64, 7, 6, True, "cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_e2e_polygon_batch_is_the_jax_batch():
    """`bench_e2e_polygons`' batch i against the JAX leg's inline
    ``batch_cfgs`` (utils/benchmarks.py:1590-1611): indices, sigmas and
    angles' order bitwise; positions within 2 ulp of their ring (< 16) and
    vertices within 2 ulp of their size (< 2.5), where the two libraries'
    cos and sin round apart."""
    from collide2d_tpu.mc.noise import sample_configurations

    configs, k, i = 256, 6, 2
    key = jax.random.PRNGKey(0)
    k_tab, k_cfg, _, k_geo = jax.random.split(key, 4)
    rngs = jax.random.split(k_tab, 2)
    poses = jax.random.uniform(rngs[0], (4096, 3), jnp.float32,
                               jnp.asarray([0.1, 0.1, 0.0]),
                               jnp.asarray([5.0, 5.0, 2 * np.pi]))
    std_devs = jnp.sqrt(jax.random.uniform(rngs[1], (4096, 5), jnp.float32, 0.0, 0.3)
                        .at[:, 3:].set(0.0))
    positions, pose_idx, var_idx = sample_configurations(
        jax.random.fold_in(k_cfg, i), configs, poses, std_devs,
        r_offset=(4.07 + 1.74) / 4, spread=4.0)
    ka, kb = jax.random.split(jax.random.fold_in(k_geo, i))
    ang = jnp.sort(jax.random.uniform(ka, (configs, k), jnp.float32, 0.0, 2.0 * jnp.pi),
                   axis=-1)
    ab = jax.random.uniform(kb, (configs, 1, 2), jnp.float32, 0.5, 2.5)
    verts = jnp.stack([jnp.cos(ang), jnp.sin(ang)], axis=-1) * ab

    t_tab, t_cfg, _, t_geo = tbm.prng.split(tbm.prng.PRNGKey(0), 4)
    t_poses, t_sd = tbm._e2e_tables(t_tab, device="cpu")
    got = tbm._e2e_polygon_batch(t_cfg, t_geo, i, configs, k, t_poses, t_sd)
    np.testing.assert_array_equal(got.pose_theta.numpy(), np.asarray(poses[pose_idx, 2]))
    np.testing.assert_array_equal(got.std_dev.numpy(), np.asarray(std_devs[var_idx][:, :3]))
    np.testing.assert_allclose(got.position.numpy(), np.asarray(positions), rtol=0,
                               atol=2 * np.spacing(np.float32(16.0)))
    np.testing.assert_allclose(got.obstacle_verts.numpy(), np.asarray(verts), rtol=0,
                               atol=2 * np.spacing(np.float32(2.5)))


# ---- the agreement statistic against the JAX legs' arithmetic ----


def _cp_pairs(rng, n_rows, n_samples, far: bool):
    """Two estimates a row a sample apart on every third row (pooled p 0
    and 1 among them), and with ``far`` one row 0.2 apart (z above 6); all
    on the 1/n grid, as counts over n give them."""
    a = rng.binomial(n_samples, rng.uniform(0, 1, n_rows)) / n_samples
    a[:3] = [0.0, 1.0, 0.5]
    b = np.clip(a + (np.arange(n_rows) % 3 == 0) / n_samples, 0.0, 1.0)
    if far:
        b[7] = a[7] + 205 / n_samples if a[7] < 0.5 else a[7] - 205 / n_samples
    return a, b


@pytest.mark.parametrize("far", [False, True])
def test_agreement_stats_are_the_jax_legs_arithmetic(monkeypatch, far):
    """`agreement_stats` on the cps JAX's `bench_agreement` and
    `bench_agreement_polygons` are handed (their samplers stubbed to return
    them) gives their fields, ``ok`` included, to the last bit."""
    import collide2d_tpu.mc.estimator as jest

    n_rows, n = 64, 1024
    a, b = _cp_pairs(np.random.default_rng(3), n_rows, n, far)
    cps = {"pallas": a, "jnp": b}
    monkeypatch.setattr(jest, "collision_probability",
                        lambda key, cfgs, robot, n_samples, impl: jnp.asarray(
                            cps[impl].astype(np.float32)))
    monkeypatch.setattr(jest, "mc_round",
                        lambda *args, n_batch, impl, **kw: jnp.asarray(
                            np.rint(cps[impl] * n_batch).astype(np.int32)))
    got = tbm.agreement_stats(a.astype(np.float32), b.astype(np.float32), n)
    for want in (jbm.bench_agreement(configs=n_rows, n_samples=n),
                 jbm.bench_agreement_polygons(configs=n_rows, n_samples=n)):
        for field in ("value", "unit", "vs_baseline", "ok", "n_samples", "frac_z_gt3",
                      "mean_abs_diff", "max_abs_diff", "frac_within_005"):
            assert got[field] == want[field], field
    assert got["ok"] is (not far)


# ---- the end-to-end legs' schedules and the k-gon leg ----


@pytest.fixture
def small_cap(monkeypatch):
    """A 4,000-sample cap and 2,000-sample rounds past the schedule (the
    reference's 100,000 would overrun the cap at once)."""
    monkeypatch.setattr(test, "AdaptiveConfig",
                        functools.partial(test.AdaptiveConfig, max_samples=4000,
                                          later_batch=2000))


@pytest.mark.parametrize("schedule", ["tuned", "opt"])
def test_bench_e2e_schedules_at_a_small_cap(small_cap, schedule):
    out = tbm.bench_e2e(configs=64, batches=3, schedule=schedule, device="cpu")
    want = _jax_fields("bench_e2e") - ({"n_checkpoints"} if schedule == "tuned" else set())
    assert set(out) == want | {"device"}
    assert out["metric"] == f"configs_labeled_per_sec_{schedule}"
    assert _jax_builds_metric("bench_e2e", out["metric"], {"schedule": schedule})
    assert out["configs"] == 192 and 0.0 < out["slot_efficiency"] <= 1.0
    if schedule == "opt":
        assert isinstance(out["n_checkpoints"], int) and 0 <= out["n_checkpoints"] <= 24


@pytest.mark.parametrize("schedule", [None, "opt"])
def test_bench_e2e_polygons_at_a_small_cap(small_cap, schedule):
    out = tbm.bench_e2e_polygons(configs=64, batches=3, schedule=schedule, device="cpu")
    want = _jax_fields("bench_e2e_polygons") - (
        set() if schedule else {"n_checkpoints"})
    assert set(out) == want | {"device"}
    assert out["metric"] == "polygon_configs_labeled_per_sec" + (
        f"_{schedule}" if schedule else "")
    assert out["configs"] == 192 and out["k"] == 6 and out["batches"] == 3
    assert 0.0 < out["converged_frac"] <= 1.0
    assert 0 < out["mean_samples_per_config"] <= 4096


# ---- the bench's digest and leg order against the root bench.py ----


def _root_bench():
    """The root ``bench.py``, loaded as tests/test_aux.py loads it (import
    only; its main is not called)."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "root_bench", Path(__file__).parent.parent / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _to_port(name: str) -> str:
    return name.replace("pallas", "cuda")


# every metric the root bench prints, as its legs name them
ROOT_METRICS = [
    "hbm_stream_gbps_pallas", "hbm_read_gbps_xla", "sat_rect_pairs_per_sec",
    "sat_rect_pairs_per_sec_xla", "obb_param_pairs_per_sec_pallas",
    "rect_distance_pairs_per_sec", "rect_distance_pairs_per_sec_pallas",
    "polygon_distance_pairs_per_sec", "polygon_distance_pairs_per_sec_pallas",
    "manifold_pairs_per_sec", "manifold_pairs_per_sec_pallas", "scene_pairs_per_sec",
    "scene_swept_pairs_per_sec_effective", "scene_rays_per_sec",
    "scene_rays_per_sec_pallas", "rect_toi_queries_per_sec_pallas", "mc_samples_per_sec",
    "mc_samples_per_sec_pallas", "mc_samples_per_sec_pallas_noshape",
    "mc_samples_per_sec_pallas_noshape_box_muller", "mc_polygon_samples_per_sec_pallas",
    "mc_moving_samples_per_sec_pallas", "mc_moving_samples_per_sec_jnp",
    "mc_moving_samples_per_sec_pallas_rotating", "mc_moving_samples_per_sec_jnp_rotating",
    "mc_moving_samples_per_sec_jnp_rotating_noscreen",
    "mc_moving_polygon_samples_per_sec_jnp", "mc_moving_polygon_samples_per_sec_pallas",
    "mc_moving_polygon_samples_per_sec_jnp_rotating",
    "mc_moving_polygon_samples_per_sec_jnp_rotating_noscreen",
    "sat_rect_pairs_per_sec_pallas_bf16", "sat_polygon_pairs_per_sec_pallas",
    "sat_polygon_pairs_per_sec_pallas_bf16", "sat_polygon_pairs_per_sec_mxu_dot",
    "sat_polygon_pairs_per_sec_mxu_dot_bf16", "pallas_vs_jnp_agreement",
    "polygon_agreement", "moving_polygon_agreement", "learned_train_rows_per_sec",
    "configs_labeled_per_sec", "configs_labeled_per_sec_tuned",
    "configs_labeled_per_sec_opt", "polygon_configs_labeled_per_sec",
    "polygon_configs_labeled_per_sec_opt",
]


def _surface(rng, names):
    """A result for each metric, with the extras the real legs carry."""
    out = []
    for name in names:
        res = {"metric": name, "value": float(rng.choice([3.0, 0.37, 1.23456789e10,
                                                          6.5e5, 47.5]))}
        if "agreement" in name:
            res.update(ok=True, frac_within_005=0.9978, value=3.27)
        if name.endswith("rotating"):
            res.update(frac_ambiguous_ca=0.028, spread=0.14)
        if "labeled" in name:
            res.update(steady_state_configs_per_sec=6.65e5, spread=0.084)
        if "swept" in name:
            res["window_exceeded"] = False
        out.append(res)
    return out


def _port_result(res: dict) -> dict:
    return {**res, "metric": _to_port(res["metric"])}


def test_digest_is_the_root_bench_digest_under_the_cuda_names():
    """`digest_add` and `build_digest_line` on the real metric set, and on
    test_aux's oversized synthetic surface (trimmed), give the root
    bench's digest with ``pallas`` read as ``cuda``, within the same
    budget and stderr-only list."""
    root = _root_bench()
    assert tbench.DIGEST_BUDGET == root.DIGEST_BUDGET == 1750
    assert tbench.DIGEST_STDERR_ONLY == tuple(map(_to_port, root.DIGEST_STDERR_ONLY))
    rng = np.random.default_rng(0)
    synthetic = []
    for i in range(40):
        res = {"metric": f"mc_family_{i:02d}_samples_per_sec_pallas",
               "value": 1.23456789e10 * (i + 1)}
        if i % 6 == 0:
            res.update(ok=True, steady_state_configs_per_sec=2.345e5)
        if i % 5 == 0:
            res["spread"] = 0.084
        synthetic.append(res)
    for surface in (_surface(rng, ROOT_METRICS), synthetic):
        want, got = {}, {}
        for res in surface:
            root.digest_add(want, res)
            tbench.digest_add(got, _port_result(res))
        assert got == {_to_port(k): v for k, v in want.items()}
        want_line = root.build_digest_line(want)
        got_line = tbench.build_digest_line(got)
        assert len(got_line) <= tbench.DIGEST_BUDGET
        parsed = json.loads(got_line)
        assert parsed["metric"] == "digest" and len(parsed["metrics"]) >= 25
        if len(want_line) <= root.DIGEST_BUDGET and surface is not synthetic:
            assert got_line == _to_port(want_line)
    assert "rect_agreement" in parsed["metrics"] or surface is synthetic


def test_real_metric_set_fits_the_tail():
    """The real metric set: every metric that is not stderr-only lands in
    the digest (n >= 25), and the digest and a headline fit the last 2,000
    characters together."""
    digest = {}
    for res in _surface(np.random.default_rng(1), ROOT_METRICS):
        tbench.digest_add(digest, _port_result(res))
    line = tbench.build_digest_line(dict(digest))
    parsed = json.loads(line)
    kept = [m for m in ROOT_METRICS if _to_port(m) not in tbench.DIGEST_STDERR_ONLY]
    assert parsed["n"] == len(digest) >= 25 and len(kept) >= 25
    assert parsed["metrics"]["rect_agreement.frac005"] == 0.998  # 3 digits
    head = json.dumps({"metric": "sat_rect_pairs_per_sec", "value": 47488994785.919,
                       "unit": "pairs/s", "vs_baseline": 47.488994785919,
                       "effective_gbps": 3039.295666298816,
                       "hbm_read_gbps": 3020.7663331006584, "bandwidth_check": "ok",
                       "device": "NVIDIA H100 80GB HBM3"})
    assert len(line) + len(head) + 2 <= 2000


@pytest.mark.parametrize("values", [[5.0, 1.0, 3.0], [2.0, 2.0, 2.0], [0.0, 0.0, 4.0]])
def test_median_of_is_the_root_benchs(values):
    root = _root_bench()

    def draws():
        it = iter(values)
        return lambda: {"metric": "m", "value": next(it),
                        "steady_state_configs_per_sec": 10.0 * next(iter(values))}

    want = root.median_of(draws())()
    got = tbench.median_of(draws())()
    assert got == want
    assert tbench.median_of(draws()).__name__ == "<lambda>_median"


def _root_leg_names() -> list:
    """The names of the root bench's secondary legs in its order
    (bench.py:383-446): each loop element's ``__name__``, ``_median`` added
    for the medians of 3."""
    import ast
    from pathlib import Path

    tree = ast.parse((Path(__file__).parent.parent / "bench.py").read_text())
    main = next(f for f in tree.body if isinstance(f, ast.FunctionDef) and f.name == "main")
    names, medians = {}, set()
    for node in ast.walk(main):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Attribute) \
                and node.targets[0].attr == "__name__":
            names[node.targets[0].value.id] = node.value.value
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) and \
                getattr(node.value.func, "id", "") == "median_of":
            medians.add(node.targets[0].id)
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Name) and \
                isinstance(node.targets[0], ast.Name):  # an alias of a leg
            names.setdefault(node.targets[0].id, node.value.id)
    loop = max((n for n in ast.walk(main)
                if isinstance(n, ast.For) and isinstance(n.iter, ast.Tuple)),
               key=lambda n: len(n.iter.elts))
    out = []
    for elt in loop.iter.elts:
        name = names.get(elt.id, elt.id)
        if elt.id == "scene_med":
            name = "bench_scene"
        out.append(name + ("_median" if elt.id in medians else ""))
    return out


def test_secondary_legs_are_the_root_benchs_in_its_order():
    got = [fn.__name__ for fn in tbench.secondary_legs()]
    assert got == [_to_port(name) for name in _root_leg_names()]
    assert len(got) == 41


def test_bench_main_reports_a_failed_leg_and_ends_with_digest_and_headline(
        monkeypatch, capsys):
    head = {"metric": "sat_rect_pairs_per_sec", "value": 4.75e10, "unit": "pairs/s",
            "vs_baseline": 47.5, "effective_gbps": 3039.0, "hbm_read_gbps": 3020.0,
            "bandwidth_check": "ok", "device": "card"}

    def broken():
        raise RuntimeError("leg broke")

    legs = [lambda i=i: {"metric": f"leg_{i}_pairs_per_sec_cuda", "value": 1e9 * (i + 1)}
            for i in range(3)]
    for i, leg in enumerate(legs):
        leg.__name__ = f"bench_leg_{i}"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tbench, "headline", lambda log: dict(head))
    monkeypatch.setattr(tbench, "secondary_legs", lambda: [legs[0], broken, *legs[1:]])
    assert tbench.main() == 1
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert json.loads(lines[-1]) == head and json.loads(lines[0]) == head
    digest = json.loads(lines[-2])
    assert digest["metric"] == "digest" and digest["n"] == 4
    assert digest["metrics"]["leg_2_cuda"] == 3000000000
    assert "# broken failed:" in err and "RuntimeError: leg broke" in err
    assert len(out[-2000:].splitlines()) >= 2
    (record,) = [json.loads(line[len("# launches "):]) for line in err.splitlines()
                 if line.startswith("# launches ")]
    assert err.rindex("# launches ") > err.rindex("# broken failed:")
    assert record["failed"] == ["broken"]
    assert set(record["launches"]) == {"1", "1bm", *map(str, range(2, 7)), "7", "7bm",
                                       *map(str, range(8, 14)), "14", "14bm", "15", "16"}
    # and every leg passing: exit 0
    monkeypatch.setattr(tbench, "secondary_legs", lambda: legs)
    assert tbench.main() == 0
