"""Shared helpers of the benchmark's own tests (run them with
``python -m pytest benchmark/tests -q`` from the checkout's root)."""

from __future__ import annotations

import pytest
import torch

from benchmark.core import spec


def tiny(name: str):
    """The cell at a size a CPU test can hold: small tables and files,
    coarse accuracy targets and a low cap (the program's plain versions
    run it); its limits are the cell's own."""
    cell = spec.resolve(name)
    cfg = cell.config
    if "num_poses" in cfg:
        cfg.update(num_poses=2048, num_variances=2048, batch_size=192)
    else:
        cfg.update(rows_per_file=192)
    cfg.update(max_samples=40_000, bin_accuracy=[0.003, 0.01, 0.03])
    cell.workload.update(sample_rows=128, top_rows=8)
    return cell


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
