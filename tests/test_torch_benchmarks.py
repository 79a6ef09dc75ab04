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


def test_kernel_legs_are_the_jax_pallas_legs():
    cuda_legs = [name for name in dir(tbm)
                 if name.startswith("bench_") and name.endswith("_cuda")]
    assert len(cuda_legs) == 6
    for name in cuda_legs:
        assert hasattr(jbm, name[:-len("_cuda")] + "_pallas"), name


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
