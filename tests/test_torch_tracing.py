"""The port's own spans (`utils.profiling.span`) on the CPU: off they record
nothing; under a ``torch.profiler`` the labeling paths record their
layers' spans with the right parents and counts, on the profiler's
clock; tracing leaves every label and file byte for byte as it was."""

import collections
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from collide2d_tpu_torch import cli
from collide2d_tpu_torch.data import pipeline
from collide2d_tpu_torch.mc import driver, prng
from collide2d_tpu_torch.mc.estimator import AdaptiveConfig, Configs
from collide2d_tpu_torch.parallel.sharding import make_mesh
from collide2d_tpu_torch.utils import profiling

# The suite runs one xdist worker per core: one torch thread each keeps
# the workers from oversubscribing the host.
torch.set_num_threads(1)

GENERATE = ["generate", "--device", "cpu", "-n", "3", "-b", "200", "--num_poses", "64",
            "--num_variances", "64", "--max_samples", "20000", "--seed", "5",
            "--verbose", "false", "--bin_accuracy", "0.003", "0.01", "0.03"]
ROBOT = np.array([[-2.035, -0.87], [2.035, -0.87], [2.035, 0.87], [-2.035, 0.87]],
                 np.float32)


@pytest.fixture(autouse=True)
def _empty_record():
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture
def small_groups(monkeypatch):
    """One round a sync group, so a few hundred rows take many steps,
    repacks among them."""
    monkeypatch.setattr(driver, "SYNC_SAMPLES", 1)


def traced(fn):
    """``fn()`` under a CPU ``torch.profiler``; (its result, the spans)."""
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        out = fn()
    finally:
        prof.stop()
    return out, profiling.spans()


def _rounds_of_runs(monkeypatch):
    """Each finished `AdaptiveRun`'s scheduler rounds, in finishing order."""
    rounds = []
    orig = driver.AdaptiveRun.materialize

    def materialize(run):
        rounds.append(run.scheduler.rnd)
        return orig(run)

    monkeypatch.setattr(driver.AdaptiveRun, "materialize", materialize)
    return rounds


def _polylabel_input(path, n=24, seed=3):
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 2 * np.pi, 6, endpoint=False)
    verts = np.stack([np.cos(ang), np.sin(ang)], -1)[None] * rng.uniform(0.5, 2, (n, 1, 1))
    np.savez(path, obstacle_verts=verts.astype(np.float32),
             position=rng.uniform(-3, 3, (n, 2)).astype(np.float32),
             pose_theta=rng.uniform(0, 6.28, n).astype(np.float32),
             std_dev=rng.uniform(0.05, 0.3, (n, 3)).astype(np.float32),
             robot_verts=ROBOT)
    return path


def _movelabel_input(path, n=24, seed=4):
    rng = np.random.default_rng(seed)
    np.savez(path, position=rng.uniform(-4, 4, (n, 2)).astype(np.float32),
             pose_theta=rng.uniform(0, 6.28, n).astype(np.float32),
             obstacle_wh=rng.uniform(0.5, 2, (n, 2)).astype(np.float32),
             std_dev=rng.uniform(0.0, 0.2, (n, 5)).astype(np.float32),
             velocity=rng.uniform(-2, 2, (n, 2)).astype(np.float32))
    return path


def _label_argv(command, tmp_path, out):
    data = (_polylabel_input if command == "polylabel" else _movelabel_input)(
        tmp_path / "in.npz")
    return [command, "--device", "cpu", "--data_in", str(data), "--data_out",
            str(out), "--seed", "7", "--max_samples", "4000"]


def test_span_off_records_nothing_and_is_the_shared_null():
    s = profiling.span("driver/plan", count=3)
    assert s is profiling.span("pipeline/pack")
    with s:
        pass
    assert profiling.spans() == []


def test_the_record_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "LIMIT", 3)

    def work():
        for _ in range(5):
            with profiling.span("round/dispatch", count=1):
                pass

    _, spans = traced(work)
    assert len(spans) == 3


def test_generate_records_the_layers_spans(tmp_path, monkeypatch, small_groups):
    rounds = _rounds_of_runs(monkeypatch)
    assert cli.main([*GENERATE, "--data_dir", str(tmp_path / "d")]) == 0  # warm
    profiling.clear()
    rounds.clear()
    _, spans = traced(lambda: cli.main([*GENERATE, "--data_dir", str(tmp_path / "t")]))
    by_id = {s.id: s for s in spans}
    parent = lambda s: by_id[s.parent].name if s.parent is not None else None  # noqa: E731
    names = collections.Counter(s.name for s in spans)
    for name in ("pipeline/cli_parse", "pipeline/load_tables", "pipeline/upload",
                 "pipeline/make_batch", "pipeline/admit_wait", "pipeline/finish",
                 "pipeline/pack", "pipeline/shuffle", "pipeline/write_submit",
                 "pipeline/write_flush", "driver/step", "driver/plan",
                 "round/dispatch", "driver/readback", "driver/repack"):
        assert names[name] > 0, name
    assert names["pipeline/finish"] == 3 and names["pipeline/make_batch"] == 3
    for s in spans:
        if s.name in ("driver/plan", "round/dispatch"):
            assert parent(s) == "driver/step"
        if s.name in ("pipeline/pack", "pipeline/shuffle", "pipeline/write_submit"):
            assert parent(s) == "pipeline/finish"
        if s.name == "driver/repack":  # in a step, or in the drain after it
            assert parent(s) in ("driver/step", None)
        if s.name == "driver/readback":
            assert s.count == 1
            assert parent(s) in ("driver/step", None, "pipeline/finish",
                                 "pipeline/make_batch")
    # round/dispatch counts the runs' rounds; write_submit the rows
    assert len(rounds) == 3 and min(rounds) > 0
    assert sum(s.count for s in spans if s.name == "round/dispatch") == sum(rounds)
    assert sum(s.count for s in spans if s.name == "pipeline/write_submit") == 600
    # spans nest in time on their thread
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.thread == s.thread
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_mesh_rounds_record_stage_launch_and_reduce(tmp_path, small_groups):
    mesh = make_mesh([torch.device("cpu")] * 2)
    cfg = pipeline.GenerateConfig(
        data_dir=str(tmp_path / "m"), num_batches=1, batch_size=128, num_poses=64,
        num_variances=64, max_samples=8000, seed=5, verbose=False, device="cpu",
        bin_accuracy=(0.003, 0.01, 0.03), mesh=mesh)
    _, spans = traced(lambda: pipeline.generate_dataset(cfg))
    by_id = {s.id: s for s in spans}
    names = collections.Counter(s.name for s in spans)
    stages = [s for s in spans if s.name == "round/stage"]
    assert stages and names["round/reduce"] == len(stages)
    assert names["round/launch"] == 2 * len(stages)  # a launch for each shard
    assert sum(s.count for s in spans if s.name == "round/dispatch") == len(stages)
    for s in spans:
        if s.name.startswith("round/") and s.name != "round/dispatch":
            assert by_id[s.parent].name == "round/dispatch"


@pytest.mark.parametrize("command", ["polylabel", "movelabel"])
def test_label_commands_record_load_upload_and_save(tmp_path, command):
    argv = _label_argv(command, tmp_path, tmp_path / "out.npz")
    assert cli.main(argv) == 0  # warm
    profiling.clear()
    _, spans = traced(lambda: cli.main(argv))
    names = collections.Counter(s.name for s in spans)
    for name in ("pipeline/cli_parse", "pipeline/load_input", "pipeline/upload",
                 "pipeline/save_output", "driver/step", "round/dispatch",
                 "driver/readback"):
        assert names[name] >= 1, name
    assert names["pipeline/load_input"] == names["pipeline/upload"] == 1
    assert names["pipeline/save_output"] == 1


@pytest.mark.parametrize("command", ["polylabel", "movelabel"])
def test_label_commands_write_a_trace_with_their_spans(tmp_path, command):
    argv = _label_argv(command, tmp_path, tmp_path / "out.npz")
    assert cli.main([*argv, "--trace_dir", str(tmp_path / "t")]) == 0
    traces = list((tmp_path / "t").glob("trace_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"pipeline/save_output", "driver/step", "round/dispatch"} <= names
    assert profiling.spans() == []  # the trace holds them; the record is emptied


def test_span_times_are_the_profilers_clock():
    def work():
        for i in range(8):
            with profiling.span(f"test/clock{i}"):
                torch.ones(64).sum()

    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    work()
    prof.stop()
    mine = {s.name: s for s in profiling.spans()}
    seen = 0
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if name in mine:
            start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
            assert abs(start - mine[name].start_ns) < 200_000, name
            assert abs(end - mine[name].end_ns) < 200_000, name
            seen += 1
    assert seen == 8


def test_generate_files_are_the_same_traced(tmp_path, small_groups):
    assert cli.main([*GENERATE, "--data_dir", str(tmp_path / "off")]) == 0
    traced(lambda: cli.main([*GENERATE, "--data_dir", str(tmp_path / "on")]))
    files = sorted(p.name for p in (tmp_path / "off").glob("*.npy"))
    assert files == sorted(p.name for p in (tmp_path / "on").glob("*.npy"))
    assert {"0.npy", "1.npy", "2.npy"} <= set(files)
    for name in files:
        assert (tmp_path / "on" / name).read_bytes() == (tmp_path / "off" / name).read_bytes()


@pytest.mark.parametrize("command", ["polylabel", "movelabel"])
def test_labels_are_the_same_traced(tmp_path, command):
    off, on = tmp_path / "off.npz", tmp_path / "on.npz"
    assert cli.main(_label_argv(command, tmp_path, off)) == 0
    traced(lambda: cli.main(_label_argv(command, tmp_path, on)))
    with np.load(off) as a, np.load(on) as b:
        for field in ("cp", "n_samples", "converged"):
            assert a[field].tobytes() == b[field].tobytes()


def test_torch_ops_keep_no_checkpoint_timings():
    n = 16
    g = torch.Generator().manual_seed(0)
    configs = Configs(position=torch.rand(n, 2, generator=g) * 4,
                      pose_theta=torch.rand(n, generator=g),
                      obstacle_wh=torch.ones(n, 2), std_dev=torch.full((n, 5), 0.1))
    run = driver.AdaptiveRun(prng.PRNGKey(1), configs, (4.07, 1.74),
                             AdaptiveConfig(max_samples=2000))
    assert not hasattr(run.ops, "checkpoint_ms")
