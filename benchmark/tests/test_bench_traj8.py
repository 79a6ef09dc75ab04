"""The trajectory cell ``traj8.movelabel``: its files, a sound run judged
correct on the CPU (the program's plain versions in the kernels' place),
the faults its comparison has to catch, the same labels failing against
the static robot, the control, and kernel 14's frozen count and reader."""

from __future__ import annotations

import json

import numpy as np
import pytest

from benchmark import control, run
from benchmark.core import compare, spec
from benchmark.core import trace as tr
from benchmark.gen import motion, rows
from benchmark.reference import exact
from benchmark.roofline import counts, window
from benchmark.run import Context
from benchmark.tests.conftest import tiny
from benchmark.tests.test_bench_faults import _altered, _half_left_out, _patch_outputs

CELL = "traj8.movelabel"
SEED = 2**31 + 1977


def _execute() -> dict:
    return run.execute(tiny(CELL), SEED, 0.5, False, device="cpu")


def test_cell_finds_every_file():
    cell = spec.resolve(CELL)
    assert cell.chips == 1 and cell.config_name == "traj8"
    assert cell.traffic_name == "movelabel" and cell.traffic["entry"] == "movelabel"
    entry = spec.entry(cell)
    assert hasattr(entry, "Run") and callable(entry.control_rows)
    assert cell.workload["limits"] == {"rows_bad": 0, "stop_faults": 0,
                                       "miss_share": 0.12, "z2_mean": 6.0}
    assert {m["name"] for m in cell.per_layer} == {
        "mc_roofline.traj8", "idle_ms_per_100k.driver", "idle_ms_per_100k.pipeline",
        "dispatch_us_per_round", "readbacks_per_100k"}
    assert all(callable(spec.reader(m["name"])) for m in cell.per_layer)
    entry_json = next(c for c in spec.benchmark()["configs"] if c["name"] == "traj8")
    assert json.loads((spec.ROOT / entry_json["file"]).read_text()) == cell.config
    assert cell.config["omega"] == 0.0 and cell.config["reduced"] == {}
    # the obstacle part is kgon8's deployment, key for key
    kgon8 = spec.resolve("kgon8.polylabel").config
    for key in ("k", "rows_per_file", "semi_axes", "max_samples", "min_variance",
                "max_variance", "min_pose", "max_pose", "accuracy_bins",
                "bin_accuracy", "robot_width", "robot_height", "spread", "precision"):
        assert cell.config[key] == kgon8[key], key


def test_files_carry_the_configurations_motion():
    cfg = dict(spec.resolve(CELL).config, rows_per_file=4096)
    f = motion.trajectory_file(cfg, SEED, 3, "cpu")
    assert set(f) == {"position", "pose_theta", "obstacle_verts", "std_dev",
                      "robot_verts", "velocity", "t_max", "omega"}
    assert all(a.dtype == np.float32 for a in f.values())
    assert f["velocity"].shape == (4096, 2) and f["t_max"].shape == (4096,)
    assert np.all(f["omega"] == 0.0) and f["omega"].shape == (4096,)
    lo, hi = cfg["velocity_range"]
    assert lo <= f["velocity"].min() < -1.9 and 1.9 < f["velocity"].max() <= hi
    lo, hi = cfg["t_max_range"]
    assert lo <= f["t_max"].min() < 0.55 and 2.95 < f["t_max"].max() <= hi
    static = rows.kgon_file(cfg, SEED, 3, "cpu")
    assert all(np.array_equal(f[k], static[k]) for k in static)
    other = motion.trajectory_file(cfg, SEED + 1, 3, "cpu")
    assert not np.array_equal(f["velocity"], other["velocity"])
    assert not np.array_equal(f["t_max"], other["t_max"])
    assert not np.array_equal(f["position"], other["position"])
    again = motion.trajectory_file(cfg, SEED, 3, "cpu")
    assert all(np.array_equal(f[k], again[k]) for k in f)


def test_sound_run_is_correct():
    res = _execute()
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0


@pytest.mark.parametrize("fault", [_altered, _half_left_out], ids=["altered", "half"])
def test_output_faults_are_caught(monkeypatch, fault):
    _patch_outputs(monkeypatch, fault)
    res = _execute()
    assert not res["correct"], res["checks"]


def test_round_with_unchanged_state_is_caught(monkeypatch):
    from collide2d_tpu_torch.ops import mc_moving_polygon_cuda

    calls = {"n": 0}
    orig = mc_moving_polygon_cuda.mc_moving_poly_counts_plain

    def counts_(*args, **kwargs):
        out = orig(*args, **kwargs)
        calls["n"] += 1
        return out * 0 if calls["n"] % 2 else out

    monkeypatch.setattr(mc_moving_polygon_cuda, "mc_moving_poly_counts_plain", counts_)
    res = _execute()
    assert calls["n"] > 0
    assert not res["correct"], res["checks"]


def test_labels_judged_by_the_static_robot_are_not_correct(tmp_path):
    cell = tiny(CELL)
    w = cell.workload
    r = spec.entry(cell).Run(cell, SEED, "cpu", tmp_path, tr.Spans(False), 0.5)
    r.drive(0.5)
    lab = r.labeled()
    idx = compare.sample(lab, SEED, w["sample_rows"], w["top_rows"])
    theta, velocity, t_max = r._columns(idx, ("pose_theta", "velocity", "t_max"))
    want = exact.swept_robot(rows.robot_vertices(cell.config),
                             exact.displacement(theta, velocity, t_max))
    assert np.array_equal(lab.robot_verts[idx], want)
    judge = lambda: compare.verdict(  # noqa: E731
        compare.compare(lab, cell.config, SEED, w["sample_rows"], w["top_rows"]),
        w["limits"])
    ok, checks = judge()
    assert ok, checks
    lab.robot_verts = rows.robot_vertices(cell.config)
    ok, checks = judge()
    assert not ok, checks


def test_control_rows_are_the_first_files_swept_rows():
    cell = tiny(CELL)
    position, theta, robot, obstacle, sd = control.inputs(cell, 5, 16, "cpu")
    f = motion.trajectory_file(cell.config, 5, 0, "cpu")
    assert robot.shape == (16, 6, 2) and robot.dtype == np.float32
    want = exact.swept_robot(f["robot_verts"], exact.displacement(
        f["pose_theta"][:16], f["velocity"][:16], f["t_max"][:16]))
    np.testing.assert_array_equal(robot, want.astype(np.float32))
    for got, key in ((position, "position"), (theta, "pose_theta"),
                     (obstacle, "obstacle_verts"), (sd, "std_dev")):
        np.testing.assert_array_equal(got, f[key][:16])


def test_control_fails_and_witness_passes():
    cell = spec.resolve(CELL)
    cell.workload.update(sample_rows=160, top_rows=8)
    limits = cell.workload["limits"]
    low = control.measure(cell, 2**31 + 31, "bfloat16", "cpu")
    ok_low, checks = compare.verdict(low, limits)
    assert not ok_low, checks
    sound = control.measure(cell, 2**31 + 31, "float32", "cpu")
    ok, checks = compare.verdict(sound, limits)
    assert ok, checks


def test_window_count_by_hand():
    k, k2, axes = 8, 4, 2
    # kernel 7's projections and shifted ends on an axis, then the window:
    # two ends (subtract, divide) 4, min and max 2, running max and min 2
    per_robot_axis = 3 * k + 3 + 2 * (k - 1) + 2 + 8                # 51
    per_obstacle_normal = 3 * k2 + 3 + 2 * (k2 - 1) + 2 + 3 + 8      # 34: speed 3
    assert per_robot_axis == 51 and per_obstacle_normal == 34
    assert window.window_test_ops(k, axes, k2) == 11 + 2 * 51 + 8 * 34 + 3 == 388
    assert window.window_ops_per_sample(k, axes, k2) == 18 + 388 == 406
    # the window does at least the static test's work (its zero-velocity case)
    for kk, kk2, aa in ((8, 4, 2), (3, 3, 3), (6, 8, 4), (20, 4, 2)):
        assert (window.window_ops_per_sample(kk, aa, kk2)
                >= counts.kgon_ops_per_sample(kk, aa, kk2))
    assert window.window_row_bytes(8) == counts.row_bytes(8) + 12 == 108
    robot = rows.robot_vertices(spec.resolve(CELL).config)
    assert window.distinct_axes(robot) == 2


def test_reader_reads_kernel_14_alone():
    cell = spec.resolve(CELL)
    ops = [("void mc_moving_poly_counts_kernel(float const*, int const*)", 0, 1.0, 3.0),
           ("void mc_poly_counts_kernel<false>(float const*)", 0, 3.0, 7.0),
           ("round_epilogue_kernel", 0, 7.0, 7.5)]
    t = tr.TraceTable([o[0] for o in ops], np.zeros(3, np.int64),
                      np.array([o[2] for o in ops]), np.array([o[3] for o in ops]),
                      ["window"], np.array([0.0]), np.array([10.0]), (0.0, 10.0))
    counters = {"rows": 200_000, "samples_used": 4_000_000_000}
    read = spec.reader("mc_roofline.traj8")
    want = 100 * 4e9 * 406 / 67e12 / 2.0
    assert read(Context(cell, counters, t)) == pytest.approx(want)
    assert read(Context(cell, counters, None)) is None
    t.op_name[0] = "void mc_poly_counts_kernel<true>(float const*)"
    assert read(Context(cell, counters, t)) is None  # kernel 14 never ran
