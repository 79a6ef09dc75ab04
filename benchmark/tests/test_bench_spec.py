"""BENCHMARK.json against the contract's form, and every cell resolving
to its configuration, mix, entry, limits and readers."""

from __future__ import annotations

import json
import re

import pytest

from benchmark.core import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(_line(w) for w in BENCH["command"]) and len(BENCH["command"]) <= 32
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/")
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert all(NAME.match(k) for k in c["reduced"])
        assert set(c["reduced"]) == set(cfg["reduced"])


def test_workloads_and_metrics():
    seen = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert m["moves"] in e2e and _line(m["layer"]) and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = spec.resolve(name)
    entry = spec.entry(cell)
    assert hasattr(entry, "Run")
    assert set(cell.workload["limits"]) == {"rows_bad", "stop_faults", "miss_share",
                                            "z2_mean"}
    assert cell.workload["limits"]["rows_bad"] == 0
    assert cell.workload["limits"]["stop_faults"] == 0
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert callable(spec.reader(m["name"]))
