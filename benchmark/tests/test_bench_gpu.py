"""A short run of every cell on the card, as the driver starts one (run
on a machine with a card: ``python -m pytest benchmark/tests -q -m gpu``).
Skips where there is none, deciding inside the test."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from benchmark.core import spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_short_run_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", name, "--seed",
         str(2**31 + 5), "--seconds", "3", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0, result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert result["metrics"]["configs_per_s"]["value"] > 0


def test_no_card_means_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", CELLS[0], "--seed", "1",
         "--seconds", "1"], cwd=spec.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 3 and out.stdout.strip() == ""
