"""The control: the plain labeler put in the program's place in bfloat16
(the precision below the configurations' float32) fails the cell's
comparison; in float32 it passes. The cell's own accuracy targets and cap,
on fewer rows than a run compares."""

from __future__ import annotations

import pytest

from benchmark import control
from benchmark.core import compare, spec


def _cell(name: str):
    cell = spec.resolve(name)
    if "num_poses" in cell.config:
        cell.config.update(num_poses=4096, num_variances=4096)
    cell.workload.update(sample_rows=160, top_rows=8)
    return cell


@pytest.mark.parametrize("name", ["rect_ref.generate", "kgon8.polylabel"])
def test_control_fails_and_witness_passes(name):
    cell = _cell(name)
    limits = cell.workload["limits"]
    low = control.measure(cell, 2**31 + 31, "bfloat16", "cpu")
    ok_low, checks = compare.verdict(low, limits)
    assert not ok_low, checks
    sound = control.measure(cell, 2**31 + 31, "float32", "cpu")
    ok, checks = compare.verdict(sound, limits)
    assert ok, checks
