"""A run's comparison catches a broken timed path.

Each test skips the harness's look for a card and drives the rest of a run
(`run.execute` on the CPU, where the program's kernels run their plain
versions) at a size a test can hold, with the program broken underneath,
and sees ``correct`` come out false; a sound run beside them comes out
true. The faults a labeling cell can have: an answer altered where it is
produced; half of a batch left unlabeled, given the mean of the rest; a
round that returns its state unchanged (its counts dropped). A one-card
cell has no exchange between cards to leave out.
"""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import run
from benchmark.tests.conftest import tiny

SEED = 2**31 + 977
CELLS = ["rect_ref.generate", "kgon8.polylabel"]


def _execute(name: str) -> dict:
    return run.execute(tiny(name), SEED, 0.5, False, device="cpu")


def _patch_outputs(monkeypatch, change):
    """Rewrite every (cp, n, converged) the adaptive driver hands out."""
    from collide2d_tpu_torch.mc import driver

    orig = driver.AdaptiveRun.materialize

    def materialize(self):
        cp, n, done = orig(self)
        return change(cp.copy(), n, done)

    monkeypatch.setattr(driver.AdaptiveRun, "materialize", materialize)


def _altered(cp, n, done):
    k = np.round(cp.astype(np.float64) * n)
    inner = (k > 0) & (k < n)
    k[inner] = np.minimum(n[inner], k[inner] + 1 + k[inner] // 4)
    return (k / n).astype(np.float32), n, done


def _half_left_out(cp, n, done):
    half = len(cp) // 2
    mean = cp[:half].astype(np.float64).mean()
    cp[half:] = (np.round(mean * n[half:]) / n[half:]).astype(np.float32)
    return cp, n, done


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = _execute(name)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [_altered, _half_left_out], ids=["altered", "half"])
def test_output_faults_are_caught(monkeypatch, name, fault):
    _patch_outputs(monkeypatch, fault)
    res = _execute(name)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_round_with_unchanged_state_is_caught(monkeypatch, name):
    from collide2d_tpu_torch.ops import mc_cuda, mc_polygon_cuda

    calls = {"n": 0}

    def dropping(orig):
        def counts(*args, **kwargs):
            out = orig(*args, **kwargs)
            calls["n"] += 1
            return out * 0 if calls["n"] % 2 else out
        return counts

    monkeypatch.setattr(mc_cuda, "mc_counts_plain", dropping(mc_cuda.mc_counts_plain))
    monkeypatch.setattr(mc_polygon_cuda, "mc_poly_counts_plain",
                        dropping(mc_polygon_cuda.mc_poly_counts_plain))
    res = _execute(name)
    assert calls["n"] > 0
    assert not res["correct"], res["checks"]
