"""Finding a cell's parts by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic. The rest is found by those names:

- ``benchmark/configs/<config>.json``: the deployment's sizes and
  guarantees (the file ``BENCHMARK.json`` gives);
- ``benchmark/traffic/<traffic>.json``: the mix, with the ``entry`` that
  drives it (``benchmark/entries/<entry>.py``);
- ``benchmark/workloads/<cell>.json``: what the cell's comparison samples
  and the limit of each number compared;
- ``benchmark/readers/<metric>.py``: each per-layer metric's reader, a
  ``read(ctx)`` that returns a number or None.

A later cell, configuration, mix or metric is new files and new entries,
never an edit of a file that is here. That holds for labels of a robot that
translates too (a trajectory cell): the comparison judges a row against a
robot of its own, and the cell's new entry module fills two hooks:

- ``labeled()`` gives `core.compare.Labeled` a robot per row,
  ``robot_verts`` of shape (N, K2', 2): each row's swept robot
  (`reference.exact.swept_robot`);
- ``control_rows(cell, seed, count, device)``, which every entry defines,
  gives the control (`benchmark.control`) the cell's rows with that robot
  per row.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    workload: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str) -> Cell:
    bench = benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config_name=w["config"],
        config=_json(ROOT / configs[w["config"]]["file"]),
        traffic_name=w["traffic"],
        traffic=_json(HERE / "traffic" / f"{w['traffic']}.json"),
        workload=_json(HERE / "workloads" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def entry(cell: Cell):
    """The module that drives the cell's traffic."""
    return importlib.import_module(f"benchmark.entries.{cell.traffic['entry']}")


def reader(metric: str):
    """``read`` of ``benchmark/readers/<metric>.py`` (names may hold dots)."""
    path = HERE / "readers" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.readers.{metric}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
