"""The port's adaptive driver against the JAX package's.

- `AdaptiveScheduler`: both schedulers driven by the same `FakeOps`
  scenarios as tests/test_driver.py must produce identical call logs.
- `_emit_to_out`, `_flush_to_out`, `_pack_active`: bitwise against JAX's
  on the same numpy state (the port's output buffers carry one extra
  discard slot, which is not compared).
- One `_fused_round` group on the threefry impl against JAX's
  ``impl='jnp'``: at least 99% of rows identical (a sample within an ulp
  of a separation boundary may flip a count; see test_torch_prng).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from collide2d_tpu.mc import driver as jdrv
from collide2d_tpu.mc import estimator as jest
from collide2d_tpu_torch.mc import driver as tdrv
from collide2d_tpu_torch.mc import estimator as est_t
from collide2d_tpu_torch.mc import prng
from tests.test_driver import FakeOps

# The suite runs one xdist worker per core: one torch thread each keeps
# the workers from oversubscribing the host.
torch.set_num_threads(1)

_SMALL = dict(fixed_batch=1000, max_samples=10_000, min_active=64, step_samples=100)
_CLIFF = dict(initial_batch=1000, initial_phase_samples=2000, later_batch=100_000,
              max_samples=202_000, min_active=64, step_samples=100)
_RESUME = dict(initial_batch=1000, initial_phase_samples=20_000, later_batch=100_000,
               max_samples=220_000, min_active=64, step_samples=100)

# name -> (cfg kwargs, FakeOps kwargs, scheduler kwargs): the scenarios of
# tests/test_driver.py.
SCENARIOS = {
    "pipelined": (_SMALL, dict(buffer_len=1000),
                  dict(sync_samples=10**6, pipeline_work=10**8)),
    "big_groups_sync": (_SMALL, dict(buffer_len=1000),
                        dict(sync_samples=10**6, pipeline_work=10**6)),
    "stale_repacks": (_SMALL, dict(
        buffer_len=1000,
        done_for=lambda rnd, n: {1: 0, 2: 300, 3: 880, 4: 960, 5: 990, 6: 1000}.get(rnd + 1, 0)),
        dict(sync_samples=10**6, pipeline_work=10**8)),
    "repack_discard": (dict(_SMALL, max_samples=5000), dict(
        buffer_len=1000, done_for=lambda rnd, n: 900 if rnd == 0 else 0),
        dict(sync_samples=10**6, pipeline_work=10**8)),
    "eager": (_SMALL, dict(buffer_len=1000),
              dict(sync_samples=10**6, pipeline_work=10**8, eager_resolve=True)),
    "eager_repack": (dict(_SMALL, max_samples=5000), dict(
        buffer_len=1000, done_for=lambda rnd, n: 900 if rnd == 0 else 0),
        dict(sync_samples=10**6, pipeline_work=10**8, eager_resolve=True)),
    "cliff": (_CLIFF, dict(buffer_len=1000),
              dict(sync_samples=10**6, pipeline_work=5 * 10**7)),
    "at_cap": (dict(_SMALL, max_samples=3000), dict(buffer_len=1000),
               dict(sync_samples=10**6, pipeline_work=10**8)),
    "drain_after_pack": (dict(_SMALL, max_samples=3000), dict(
        buffer_len=1000, done_for=lambda rnd, n: 900 if rnd == 1 else 0),
        dict(sync_samples=10**6, pipeline_work=10**8)),
    "pool_empties": (_SMALL, dict(
        buffer_len=1000, done_for=lambda rnd, n: 1000 if rnd == 0 else 0,
        active_for=lambda bucket: ("active", 0)),
        dict(sync_samples=10**6, pipeline_work=10**8)),
    "resume": (_RESUME, dict(buffer_len=512),
               dict(n_samples=120_000, chunk_offset=1200, rnd=30,
                    sync_samples=10**12, pipeline_work=10**13)),
    "checkpoint_cadence": (dict(_SMALL, max_samples=6000), dict(buffer_len=10),
                           dict(checkpoint_every=2, sync_samples=10**12,
                                pipeline_work=10**13)),
    "bucket_shrinks": (_SMALL, dict(
        buffer_len=1024, done_for=lambda rnd, n: {0: 50, 1: 200, 2: 824}.get(rnd, 0),
        active_for=lambda bucket: ("active", 824)),
        dict(sync_samples=1000 * 1024, pipeline_work=1)),
    "tuned_schedule": (dict(max_samples=400_000, min_active=64, schedule="tuned"),
                       dict(buffer_len=4096, done_for=lambda rnd, n: min(4096, 40 * rnd)),
                       dict()),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
@pytest.mark.parametrize("impl", [("jnp", "threefry"), ("pallas", "cuda")])
def test_scheduler_call_log_identical(name, impl):
    cfg_kw, ops_kw, sched_kw = SCENARIOS[name]
    logs = []
    for est_mod, drv, impl_name in ((jest, jdrv, impl[0]), (est_t, tdrv, impl[1])):
        ops = FakeOps(**ops_kw)
        s = drv.AdaptiveScheduler(
            est_mod.AdaptiveConfig(**cfg_kw), ops, num_real=ops.buffer_len(),
            impl=impl_name, **sched_kw)
        s.run()
        logs.append((ops.log, s.n_samples, s.chunk_offset, s.rnd, s.num_real))
    assert logs[0] == logs[1]
    assert any(e[0] == "run_round" for e in logs[0][0])


def test_round_up_bucket_and_ladder_match():
    for ladder in ("half", "quarter", "eighth", "sixteenth"):
        for n in list(range(1, 600)) + [1000, 4097, 65_537, 100_000]:
            assert tdrv._round_up_bucket(n, 64, ladder) == jdrv._round_up_bucket(n, 64, ladder)
        assert tdrv._ladder_buckets(100_000, 256, ladder) == jdrv._ladder_buckets(100_000, 256, ladder)


def test_plan_round_matches():
    for schedule in (None, "tuned"):
        for fixed in (None, 10_000, 997):
            jc = jest.AdaptiveConfig(schedule=schedule, fixed_batch=fixed)
            tc = est_t.AdaptiveConfig(schedule=schedule, fixed_batch=fixed)
            for n in (0, 1000, 19_000, 20_000, 36_000, 120_000, 3_900_000):
                assert est_t._plan_round(tc, n, 1, "threefry") == jest._plan_round(jc, n, 1, "jnp")
                assert est_t._plan_round(tc, n, 1, "cuda") == jest._plan_round(jc, n, 1, "pallas")


def _random_state(rng, c):
    uids = rng.permutation(3 * c)[:c].astype(np.int32)
    uids[rng.random(c) < 0.1] = -1
    done = rng.random(c) < 0.5
    done[uids < 0] = True
    cfg = (rng.uniform(-6, 6, (c, 2)), rng.uniform(0, 6, c),
           rng.uniform(0.5, 5, (c, 2)), rng.uniform(0, 0.5, (c, 5)))
    cfg = tuple(a.astype(np.float32) for a in cfg)
    return dict(uids=uids, active=cfg,
                n_true=rng.integers(0, 5000, c).astype(np.int32), done=done,
                k_frozen=rng.integers(0, 5000, c).astype(np.int32),
                n_frozen=rng.integers(1, 9000, c).astype(np.int32))


def _jstate(s):
    return jest._LoopState(
        uids=jnp.asarray(s["uids"]), active=jest.Configs(*map(jnp.asarray, s["active"])),
        n_true=jnp.asarray(s["n_true"]), done=jnp.asarray(s["done"]),
        k_frozen=jnp.asarray(s["k_frozen"]), n_frozen=jnp.asarray(s["n_frozen"]))


def _tstate(s):
    t = torch.from_numpy
    return est_t._LoopState(
        uids=t(s["uids"]), active=est_t.Configs(*map(t, s["active"])),
        n_true=t(s["n_true"]), done=t(s["done"]), k_frozen=t(s["k_frozen"]),
        n_frozen=t(s["n_frozen"]))


def _outs(rng, c_out):
    k = rng.integers(0, 100, c_out).astype(np.int32)
    n = rng.integers(0, 100, c_out).astype(np.int32)
    f = rng.random(c_out) < 0.3
    j = jdrv._OutState(jnp.asarray(k), jnp.asarray(n), jnp.asarray(f))
    pad = lambda a, v: torch.from_numpy(np.concatenate([a, np.asarray([v], a.dtype)]))  # noqa: E731
    return j, tdrv._OutState(pad(k, 0), pad(n, 0), pad(f, False))


def test_emit_and_flush_bitwise():
    rng = np.random.default_rng(9)
    s = _random_state(rng, 300)
    jo, to = _outs(rng, 900)
    want = jdrv._emit_to_out(_jstate(s), jo)
    got = tdrv._emit_to_out(_tstate(s), to)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy()[:-1], np.asarray(w))
    want = jdrv._flush_to_out(_jstate(s), jo, jnp.int32(7777))
    got = tdrv._flush_to_out(_tstate(s), to, 7777)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy()[:-1], np.asarray(w))


@pytest.mark.parametrize("bucket", [64, 160, 300])
def test_pack_active_bitwise(bucket):
    rng = np.random.default_rng(bucket)
    s = _random_state(rng, 300)
    want_state, want_n = jdrv._pack_active(_jstate(s), bucket=bucket)
    got_state, got_n, no_table = tdrv._pack_active(_tstate(s), bucket=bucket)
    assert no_table is None
    assert int(got_n) == int(want_n)
    for g, w in zip(jax.tree.leaves(tuple(got_state)), jax.tree.leaves(tuple(want_state))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_fused_round_group_matches_jax_jnp():
    rng = np.random.default_rng(12)
    c = 192
    s = _random_state(rng, c)
    s["uids"] = np.arange(c, dtype=np.int32)
    s["done"] = np.zeros(c, bool)
    s["n_true"] = np.zeros(c, np.int32)
    s["active"] = (rng.uniform(-4.5, 4.5, (c, 2)).astype(np.float32),) + s["active"][1:]
    robot = np.asarray([4.07, 1.74], np.float32)
    acc = (0.0, 0.01, 0.1, 1.0)
    bins = (0.002, 0.005, 0.02)
    key = jax.random.PRNGKey(31)
    want_state, want_done = jest._fused_round(
        key, _jstate(s), jnp.asarray(robot), jnp.int32(40), jnp.int32(1000),
        jnp.int32(1000 // 200), jnp.int32(3), jnp.int32(1000), jnp.int32(5),
        step_samples=200, sub=0, use_vertices=False, impl="jnp",
        accuracy_bins=acc, bin_accuracy=bins)
    got_state, got_done = est_t._fused_round(
        prng.PRNGKey(31), _tstate(s), torch.from_numpy(robot), 40, 1000, 3, 1000, 5,
        step_samples=200, impl="threefry", accuracy_bins=acc, bin_accuracy=bins)
    same = np.ones(c, bool)
    for name in ("n_true", "done", "k_frozen", "n_frozen"):
        same &= getattr(got_state, name).numpy() == np.asarray(getattr(want_state, name))
    print(f"{same.mean():.2%} of rows identical; done {int(got_done)} vs {int(want_done)}")
    assert same.mean() >= 0.99
    assert 0 < int(want_done) < c and abs(int(got_done) - int(want_done)) <= c // 100
    np.testing.assert_array_equal(got_state.uids.numpy(), s["uids"])


def test_adaptive_run_end_to_end_on_cpu():
    # the kernel's plain version through the whole driver (CPU tensors)
    rng = np.random.default_rng(13)
    c = 130
    cfg = est_t.configs_from_numpy(
        (rng.uniform(-5, 5, (c, 2)), rng.uniform(0, 6, c),
         rng.uniform(0.5, 5, (c, 2)), np.c_[rng.uniform(0, 0.4, (c, 3)), np.zeros((c, 2))]),
        "cpu")
    acfg = est_t.AdaptiveConfig(max_samples=4000, initial_batch=1000,
                                initial_phase_samples=2000, later_batch=2000,
                                bin_accuracy=(0.02, 0.02, 0.05), min_active=64)
    run = tdrv.AdaptiveRun(prng.PRNGKey(2), cfg, (4.07, 1.74), acfg)
    assert run.ops.shape_noise is False and run.ops.impl == "cuda"
    run.scheduler.run()
    cp, n_used, done = run.materialize()
    assert cp.shape == (c,) and np.isfinite(cp).all() and (0 <= cp).all() and (cp <= 1).all()
    assert (n_used > 0).all() and done.any()
    assert run.ops.dispatched_slots >= int(n_used.sum())
