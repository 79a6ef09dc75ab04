"""The PyTorch examples (``examples/*_torch.py``) on the CPU.

Each example's ``main(device="cpu", ...)`` runs at small sizes; its
deterministic numbers are held to the JAX package's functions on the same
inputs (quickstart's SAT and k-gon labels, polygon_labeling's zero-noise
labels, contact_queries' labels, distances, manifolds, scene pairs and ray,
trajectory_validation's times of impact), and its Monte Carlo numbers must
be finite probabilities. One example runs as a script with ``jax`` and
``collide2d_tpu`` made unimportable, and every example refuses to run
without a card unless ``--device cpu`` is given. The examples run on the
card in ``chip_smoke.py``.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from collide2d_tpu import (
    CollisionProbabilityModel as JModel,
    PolygonCollisionProbabilityModel as JPolygonModel,
    PolygonConfigs as JPolygonConfigs,
    sat_polygons as j_sat_polygons,
    scene_collision_matrix as j_scene_collision_matrix,
    scene_raycast as j_scene_raycast,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "polygon_labeling", "contact_queries", "trajectory_validation",
            "train_model")


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch", ROOT / "examples" / f"{name}_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _probabilities(*arrays):
    for a in arrays:
        a = np.asarray(a)
        assert np.isfinite(a).all() and (a >= 0).all() and (a <= 1).all()


def test_quickstart_labels_match_jax():
    out = _load("quickstart").main(device="cpu", max_samples=40_000, n_samples=2_000)
    want = jax.jit(JModel().collide)(jnp.asarray([[0.0, 0.0], [1.5, 0.5], [8.0, 8.0]]),
                                     jnp.asarray([0.0, 0.7, 0.3]),
                                     jnp.broadcast_to(jnp.asarray([2.0, 3.0]), (3, 2)))
    np.testing.assert_array_equal(out["labels"], np.asarray(want))
    np.testing.assert_array_equal(out["labels"], [1, 1, 0])
    tri = jnp.asarray([[[0, 0], [2, 0], [1, 2]]], jnp.float32)
    hexa = jnp.asarray([[[1.5, 0.5], [2.5, 0.5], [3.0, 1.4], [2.5, 2.3], [1.5, 2.3],
                         [1.0, 1.4]]], jnp.float32)
    assert out["kgon_label"] == int(j_sat_polygons(tri, hexa)[0])
    _probabilities(out["cp_fixed"], out["cp_adaptive"], out["cp_pruned"])
    # rows 0 and 1 overlap deeply, row 2 is out of reach
    np.testing.assert_array_equal(out["cp_pruned"], [1, 1, 0])
    assert out["converged"].all()


def test_polygon_labeling_zero_noise_labels_match_jax():
    module = _load("polygon_labeling")
    out = module.main(device="cpu", configs=64, n_samples=500, max_samples=2_000)
    rows = module.example_rows(64, 6)
    jcfgs = JPolygonConfigs.from_padded(**rows)
    want = np.asarray(jax.jit(JPolygonModel(module.ROBOT).collide)(jcfgs))
    np.testing.assert_array_equal(out["labels"], want)
    assert out["collision_rate"] == pytest.approx(float(want.mean()))
    assert 0 < want.mean() < 1
    _probabilities(out["cp_fixed"], out["cp"])
    assert (out["n_used"] > 0).all()


def test_contact_queries_match_jax():
    module = _load("contact_queries")
    out = module.main(device="cpu")
    model = JModel()
    args = (jnp.asarray([[0.5, 0.2], [3.5, 0.0], [9.0, 9.0]]), jnp.asarray([0.3, 0.0, 1.0]),
            jnp.asarray([2.0, 3.0]))
    np.testing.assert_array_equal(out["labels"], np.asarray(jax.jit(model.collide)(*args)))
    np.testing.assert_allclose(out["distance"], np.asarray(jax.jit(model.distance)(*args)),
                               rtol=0, atol=2e-5)
    count, _, depths, _ = jax.jit(model.contact_manifold)(*args)
    np.testing.assert_array_equal(out["manifold_counts"], np.asarray(count))
    valid = np.arange(2)[None] < np.asarray(count)[:, None]
    np.testing.assert_allclose(out["manifold_depths"][valid], np.asarray(depths)[valid],
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(out["toi_model"], out["toi"], rtol=0, atol=1e-3)
    scene = jnp.asarray(module.hexagon_scene(32))
    matrix = np.asarray(jax.jit(j_scene_collision_matrix)(scene))
    np.testing.assert_array_equal(out["matrix"], matrix)
    assert out["n_pairs"] == int(np.triu(matrix).sum()) > 0
    t, idx, normal = jax.jit(j_scene_raycast)(jnp.asarray([-6.0, 0.0]),
                                              jnp.asarray([1.0, 0.0]), scene)
    assert out["ray"][1] == int(idx)
    assert out["ray"][0] == pytest.approx(float(t), abs=1e-5)
    np.testing.assert_allclose(out["ray"][2], np.asarray(normal), rtol=0, atol=1e-5)


def test_trajectory_validation_runs_and_matches_jax_toi():
    out = _load("trajectory_validation").main(
        device="cpu", n_samples=1_000, edges=32, max_samples=4_000, kgon_rows=8,
        kgon_max_samples=1_000)
    toi = jax.jit(lambda *a: JModel().time_of_impact(*a, t_max=20.0))
    want = toi(jnp.asarray([[10.0, 0.0], [10.0, 1.6], [10.0, 6.0]]), jnp.zeros(3),
               jnp.asarray([2.0, 2.0]), jnp.asarray([[-1.0, 0.0]] * 3))
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isinf(out["toi"]), np.isinf(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(out["toi"][finite], want[finite], rtol=0, atol=1e-3)
    _probabilities(out["cp_fixed"], out["cp"], out["cp_kgon"])
    assert out["cp_fixed"][0] == 1.0 and out["cp_fixed"][2] == 0.0
    assert out["pruned"] > 0


def test_train_model_runs_on_a_generated_dataset():
    out = _load("train_model").main(device="cpu", batches=2, batch_size=256, tables=64,
                                    max_samples=2_000, hidden=(16, 16), epochs=2,
                                    train_batch=128)
    assert out["rows"] == 512
    assert np.isfinite(out["history"]).all() and len(out["history"]) == 2
    _probabilities(out["pred"], out["mean_cp"], out["val_mae"], out["batch0_mae"])


def test_quickstart_script_needs_no_jax():
    code = ("import sys, runpy; sys.modules['jax'] = None; "
            "sys.modules['collide2d_tpu'] = None; "
            "sys.argv = ['quickstart_torch.py', '--device', 'cpu']; "
            "runpy.run_path('examples/quickstart_torch.py', run_name='__main__')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="1",
                                   PYTHONPATH=os.pathsep.join(
                                       [str(ROOT), os.environ.get("PYTHONPATH", "")])))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "SAT labels: [1 1 0]" in proc.stdout and proc.stdout.rstrip().endswith("ok")


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_refuse_to_run_without_a_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = _load(name)
    with pytest.raises(RuntimeError, match="--device cpu"):
        module.main()
