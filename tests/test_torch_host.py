"""The port's copies of the JAX package's numpy-only host modules, pinned
to the originals: the same inputs must give identical outputs (exact)."""

import time
from dataclasses import astuple

import numpy as np
import pytest

from collide2d_tpu.data import pipeline as jpipe
from collide2d_tpu.data import schemas as jschemas
from collide2d_tpu.data import validate as jvalidate
from collide2d_tpu.utils import io_npy as jio
from collide2d_tpu.utils import native as jnative
from collide2d_tpu.utils import profiling as jprof
from collide2d_tpu_torch.data import pipeline as tpipe
from collide2d_tpu_torch.data import schemas as tschemas
from collide2d_tpu_torch.data import validate as tvalidate
from collide2d_tpu_torch.utils import io_npy as tio
from collide2d_tpu_torch.utils import native as tnative
from collide2d_tpu_torch.utils import profiling as tprof


def test_schemas_pack_unpack():
    rng = np.random.default_rng(0)
    pos = rng.normal(size=(50, 2)).astype(np.float32)
    cp = rng.random(50).astype(np.float32)
    vi, pi = rng.integers(0, 9, 50), rng.integers(0, 9, 50)
    rows = tschemas.pack_dataset_rows(pos, cp, vi, pi)
    np.testing.assert_array_equal(rows, jschemas.pack_dataset_rows(pos, cp, vi, pi))
    for a, b in zip(tschemas.unpack_dataset_rows(rows), jschemas.unpack_dataset_rows(rows)):
        np.testing.assert_array_equal(a, b)
    rel = rows[:, [0, 1, 3, 4]]
    for a, b in zip(tschemas.unpack_relabel_rows(rel), jschemas.unpack_relabel_rows(rel)):
        np.testing.assert_array_equal(a, b)
    assert tschemas.DATASET_FIELDS == jschemas.DATASET_FIELDS
    with pytest.raises(ValueError):
        tschemas.validate_poses(np.zeros((3, 4)))


def test_io_npy(tmp_path):
    for mod in (jio, tio):
        d = tmp_path / mod.__name__
        mod.save_npy(mod.batch_path(d, 3), np.arange(6, dtype=np.float32))
        mod.save_npy(d / "poses.npy", np.zeros(2))
    a, b = (tmp_path / jio.__name__), (tmp_path / tio.__name__)
    assert (a / "3.npy").read_bytes() == (b / "3.npy").read_bytes()
    assert tio.get_num_batches_in_dir(b) == jio.get_num_batches_in_dir(a) == 1
    np.testing.assert_array_equal(tio.load_npy(b / "3.npy"), jio.load_npy(a / "3.npy"))


def test_compare_labels():
    rng = np.random.default_rng(1)
    a = rng.random(400)
    b = np.clip(a + rng.normal(0, 0.003, 400), 0, 1)
    assert astuple(tvalidate.compare_labels(a, b, n_samples_a=1e5)) == astuple(
        jvalidate.compare_labels(a, b, n_samples_a=1e5))
    assert str(tvalidate.compare_labels(a, b)) == str(jvalidate.compare_labels(a, b))


def _jax_native_loaded(tries: int = 5) -> bool:
    """Whether the JAX package's native library loads. Its g++ build
    writes the library in place, so a test worker that loads it while
    another worker is still writing it caches a failed load; clear that
    and load afresh a few times before calling the library missing."""
    for attempt in range(tries):
        if jnative.available():
            return True
        jnative._lib.cache_clear()
        time.sleep(0.5 * (attempt + 1))
    return jnative.available()


def test_native_runtime_matches():
    # the port's own build: std::shuffle(10 rows, engine(0)) as libstdc++
    # gives it (the list of tests/test_native.py)
    assert tnative.available()
    assert tnative.std_shuffle_perm(10, 0).tolist() == [2, 7, 1, 6, 8, 0, 4, 9, 5, 3]
    assert tnative._LIB != jnative._LIB  # separate build outputs
    assert _jax_native_loaded()
    np.testing.assert_array_equal(tnative.std_shuffle_perm(1000, 0),
                                  jnative.std_shuffle_perm(1000, 0))
    lo, hi = [0.0, 1.0, -2.0], [1.0, 3.0, 2.0]
    np.testing.assert_array_equal(
        tnative.RefEngine(None).uniform_table(500, lo, hi),
        jnative.RefEngine(None).uniform_table(500, lo, hi))


def test_async_writer_output_identical(tmp_path):
    rows = np.random.default_rng(2).random((64, 5)).astype(np.float32)
    for mod in (jnative, tnative):
        with mod.AsyncNpyWriter() as w:
            w.submit(tmp_path / f"{mod.__name__}.npy", rows)
            assert w.flush() == 0
    assert (tmp_path / f"{jnative.__name__}.npy").read_bytes() == (
        tmp_path / f"{tnative.__name__}.npy").read_bytes()


@pytest.mark.parametrize("refcompat", [False, True])
def test_sample_tables_identical(refcompat):
    kw = dict(num_poses=300, num_variances=200, refcompat_tables=refcompat)
    tp, tv = tpipe._sample_tables(tpipe.GenerateConfig(**kw))
    jp, jv = jpipe._sample_tables(jpipe.GenerateConfig(**kw))
    assert tp.tobytes() == jp.tobytes() and tv.tobytes() == jv.tobytes()


def test_step_timer_lines():
    lines = {}
    for mod in (jprof, tprof):
        out = []
        t = mod.StepTimer(log_every=1, log_fn=out.append)
        t.round_done(n_batch=1000, active=50, done_total=10)
        t.round_done(n_batch=2000, active=40, done_total=30)
        s = t.summary()
        lines[mod] = ([line.split(" done=")[0] for line in out],
                      s["rounds"], s["samples_drawn"], s["configs_done"])
    assert lines[jprof] == lines[tprof]


def test_check_table_idx():
    tpipe._check_table_idx(np.arange(5), 5, "pose_idx")
    with pytest.raises(ValueError, match="pose_idx"):
        tpipe._check_table_idx(np.asarray([-1, 2]), 5, "pose_idx")
    with pytest.raises(ValueError, match="var_idx"):
        tpipe._check_table_idx(np.asarray([5]), 5, "var_idx")
