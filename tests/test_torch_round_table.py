"""The fused kernel's parameter table, packed once a buffer, on the CPU.

The adaptive driver packs the table of kernel 1 (rectangles), 7 (k-gons),
13 (trajectory rectangles) or 14 (translation-only trajectory k-gons) once
when a run's buffer is built (`estimator.pack_round_table`) and gathers it
at each repack with the order of the other fields (`driver._pack_active`),
instead of packing it again every round. This holds for each class:

- the gathered table is bitwise the table packed from the gathered
  configurations (a row's table depends on that row alone);
- a driver run that crosses several repacks gives the labels of the same
  run with a table packed every round (patched in here), and builds its
  table 1 + repacks times (``driver/table`` spans), where the other path
  builds one every round.
"""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from collide2d_tpu_torch.mc import driver, prng
from collide2d_tpu_torch.mc import estimator as est
from collide2d_tpu_torch.mc.moving import moving_configs, moving_polygon_configs
from collide2d_tpu_torch.ops.mc_polygon_cuda import dedup_robot_axes
from collide2d_tpu_torch.utils import profiling

# The suite runs one xdist worker per core: one torch thread each keeps
# the workers from oversubscribing the host.
torch.set_num_threads(1)

RECT_ROBOT = (4.07, 1.74)
KGON_ROBOT = np.array([[-2.035, -0.87], [2.035, -0.87], [2.035, 0.87], [-2.035, 0.87]],
                      np.float32)


# The four fused-kernel classes; the trajectory ones translation-only.
KINDS = ["rect", "kgon", "moving_rect", "moving_kgon"]


def _configs(kind: str, c: int, seed: int):
    """``kind``'s configs on the CPU and its robot. The trajectory kinds
    are the static kind's rows plus a velocity and a horizon."""
    if kind.startswith("moving_"):
        configs, robot = _configs(kind[7:], c, seed)
        rng = np.random.default_rng(seed + 1000)
        make = moving_configs if kind == "moving_rect" else moving_polygon_configs
        return make(*configs, rng.uniform(-3, 3, (c, 2)), 0.0,
                    rng.uniform(0.5, 2, c)), robot
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-5, 5, (c, 2))
    theta = rng.uniform(0, 2 * np.pi, c)
    if kind == "rect":
        sd = np.c_[rng.uniform(0.02, 0.4, (c, 3)), rng.uniform(0, 0.1, (c, 2))]
        return est.configs_from_numpy((pos, theta, rng.uniform(0.5, 5, (c, 2)), sd),
                                      "cpu"), RECT_ROBOT
    ang = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    verts = (np.stack([np.cos(ang), 0.6 * np.sin(ang)], -1)[None]
             * rng.uniform(0.5, 2.5, (c, 1, 1)))
    return est.polygon_configs_from_numpy(
        (pos, theta, verts, rng.uniform(0.02, 0.4, (c, 3))), "cpu"), KGON_ROBOT


def _a_keep(kind):
    return dedup_robot_axes(KGON_ROBOT) if kind.endswith("kgon") else None


@pytest.mark.parametrize("bucket", [64, 160, 300])
@pytest.mark.parametrize("kind", KINDS)
def test_gathered_table_is_the_table_of_the_gathered_configs(kind, bucket):
    c = 300
    rng = np.random.default_rng(bucket)
    configs, robot = _configs(kind, c, seed=bucket)
    state = est._LoopState(
        uids=torch.from_numpy(np.where(rng.random(c) < 0.9, np.arange(c), -1)
                              .astype(np.int32)),
        active=configs,
        n_true=torch.from_numpy(rng.integers(0, 9000, c).astype(np.int32)),
        done=torch.from_numpy(rng.random(c) < 0.5),
        k_frozen=torch.zeros(c, dtype=torch.int32),
        n_frozen=torch.ones(c, dtype=torch.int32))
    robot_t = torch.as_tensor(robot, dtype=torch.float32)
    table = est.pack_round_table(configs, robot_t, impl="cuda", poly_a_keep=_a_keep(kind))
    new_state, _, gathered = driver._pack_active(state, bucket=bucket, table=table)
    packed = est.pack_round_table(new_state.active, robot_t, impl="cuda",
                                  poly_a_keep=_a_keep(kind))
    assert gathered.shape == (bucket, table.shape[1])
    np.testing.assert_array_equal(gathered.numpy().view(np.int32),
                                  packed.numpy().view(np.int32))
    # and the rest of the state is gathered as without a table
    plain_state, _, none = driver._pack_active(state, bucket=bucket)
    assert none is None
    flat = lambda s: [s.uids, *s.active, s.n_true, s.done, s.k_frozen, s.n_frozen]  # noqa: E731
    for got, want in zip(flat(new_state), flat(plain_state)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_only_the_unsharded_kernel_path_has_a_table(kind):
    # the threefry path and a mesh's shards pack their own every round;
    # 'auto' resolves to the kernel path, which packs once
    from collide2d_tpu_torch.parallel import make_mesh

    configs, robot = _configs(kind, 8, seed=2)
    robot_t = torch.as_tensor(robot, dtype=torch.float32)
    mesh = make_mesh([torch.device("cpu")] * 2)
    assert est.pack_round_table(configs, robot_t, impl="threefry") is None
    assert est.pack_round_table(configs, robot_t, impl="cuda", mesh=mesh) is None
    got = est.pack_round_table(configs, robot_t, impl="auto")
    want = est._round_table(configs, robot_t, _a_keep(kind))
    assert got.shape[0] == 8 and torch.equal(got, want)


def _labels(kind, monkeypatch, per_round: bool):
    """One traced adaptive run of 200 rows, one round a sync group: its
    labels, the repacks it made, its rounds and its ``driver/table``
    spans. ``per_round`` patches the table out, so each round packs its
    own."""
    with monkeypatch.context() as m:
        m.setattr(driver, "SYNC_SAMPLES", 1)
        if per_round:
            m.setattr(est, "pack_round_table", lambda *a, **k: None)
        packs = []
        orig = driver._pack_active

        def counting(state, **kw):
            packs.append(kw["bucket"])
            return orig(state, **kw)

        m.setattr(driver, "_pack_active", counting)
        configs, robot = _configs(kind, 200, seed=21)
        cfg = est.AdaptiveConfig(
            max_samples=24_000, initial_batch=1_000, initial_phase_samples=4_000,
            later_batch=4_000, bin_accuracy=(0.001, 0.003, 0.01), min_active=16)
        profiling.clear()
        prof = profile(activities=[ProfilerActivity.CPU])
        prof.start()
        try:
            run = driver.AdaptiveRun(prng.PRNGKey(5), configs, robot, cfg)
            run.scheduler.run()
            out = run.materialize()
        finally:
            prof.stop()
        spans = profiling.spans()
        profiling.clear()
    names = collections.Counter(s.name for s in spans)
    assert all(s.count == 1 for s in spans if s.name == "driver/table")
    return out, len(packs), run.scheduler.rnd, names["driver/table"]


@pytest.mark.parametrize("kind", KINDS)
def test_driver_labels_across_repacks_match_a_table_packed_every_round(kind, monkeypatch):
    got, repacks, rounds, tables = _labels(kind, monkeypatch, per_round=False)
    want, repacks_w, rounds_w, tables_w = _labels(kind, monkeypatch, per_round=True)
    assert repacks >= 2 and (repacks, rounds) == (repacks_w, rounds_w)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[2].any() and not got[2].all()  # some rows stopped at the cap
    # table builds: once for the buffer and once a repack, against every round
    assert tables == 1 + repacks
    assert tables_w == rounds > tables


def test_fused_round_runs_at_least_one_round():
    configs, robot = _configs("rect", 8, seed=3)
    state = est._LoopState(torch.arange(8, dtype=torch.int32), configs,
                           torch.zeros(8, dtype=torch.int32), torch.zeros(8, dtype=torch.bool),
                           torch.zeros(8, dtype=torch.int32), torch.ones(8, dtype=torch.int32))
    with pytest.raises(ValueError, match="n_rounds must be at least 1"):
        est._fused_round(prng.PRNGKey(1), state, torch.tensor(robot), 0, 64, 0, 64, 1,
                         step_samples=64, impl="cuda", accuracy_bins=(0.0, 1.0),
                         bin_accuracy=(0.01,))
