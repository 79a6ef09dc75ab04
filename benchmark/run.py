"""The benchmark of ``collide2d_tpu_torch``: one run of one cell.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the checkout's root. The run reads the cell in ``BENCHMARK.json`` and
its files (`core.spec`), makes its inputs from the seed, warms up on the
cell's own shapes, drives the program for ``--seconds``, then checks what
the timed path wrote against the plain reference (`core.compare`) and
prints one JSON line: ``correct``, ``attempted``, ``failed``, ``metrics``
(the end-to-end metrics, or with ``--trace 1`` the per-layer ones),
``device`` and, traced, ``breakdown``; last, under ``checks``, each number
compared beside its limit (also the last lines on standard error).

It exits with 3 and prints no result when the cards the cell asks for are
not there, and with 4 when JAX or the JAX package is loaded once the
window has closed. Data the run makes goes to a directory under
``TMPDIR`` that the run removes; the program builds its kernels into its
own directory in the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

_IMPORTED = time.time()
# Host threads of the run's own CPU work: the card's host is shared, and a
# run's time on the host clock spreads less with fewer threads of its own.
THREADS = 2


def process_age() -> float:
    """Seconds since this process started (its import time if /proc is
    not there)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time() - _IMPORTED


class Context:
    """What a per-layer reader reads."""

    def __init__(self, cell, counters: dict, table) -> None:
        self.cell, self.counters, self.trace = cell, counters, table


def execute(cell, seed: int, seconds: float, traced: bool, device: str = "cuda") -> dict:
    """One run of ``cell``; the result line as a dict. ``device="cpu"``
    runs the program's plain versions (tests); it is never measured."""
    from benchmark.core import compare, spec
    from benchmark.core import device as dev
    from benchmark.core import trace as tr

    age0 = process_age()
    t_setup0 = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix=f"bench-{cell.name}-")
    try:
        spans = tr.Spans(traced)
        run = spec.entry(cell).Run(cell, seed, device, Path(workdir), spans, seconds)
        setup_s = age0 + (time.perf_counter() - t_setup0)
        prof = None
        if traced:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if device != "cpu":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.start()
        try:
            with spans.span(tr.WINDOW):
                window = run.drive(seconds)
        finally:
            if prof is not None:
                prof.stop()
        table = tr.capture(prof) if prof is not None else None
        if table is not None:
            table.devices = list(range(cell.chips))
        info = dev.describe(device, cell.chips)
        info["memory_peak_bytes"] = dev.memory_peak(device, cell.chips)
        labeled = run.labeled()
        numbers = compare.compare(labeled, cell.config, seed,
                                  cell.workload["sample_rows"],
                                  cell.workload["top_rows"])
        ok, checks = compare.verdict(numbers, cell.workload["limits"])
        written = int(len(labeled.cp) - numbers["rows_bad"])
        result = {"correct": ok, "attempted": int(window["attempted"]),
                  "failed": int(window["attempted"] - max(0, written))}
        if traced:
            ctx = Context(cell, run.counters(), table)
            metrics = {}
            for m in cell.per_layer:
                value = spec.reader(m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
            shares = [tr.busy_seconds(table, d) / table.window_s for d in table.devices]
            print(f"benchmark: busy share by card {shares}", file=sys.stderr)
            info["busy_s"] = tr.mean_busy_seconds(table)
            info["window_s"] = table.window_s
            result["metrics"] = metrics
            result["device"] = info
            result["breakdown"] = tr.breakdown(table)
        else:
            values = {"configs_per_s": max(0, written) / window["seconds"],
                      "setup_s": setup_s}
            result["metrics"] = {m["name"]: {"value": float(values[m["name"]]),
                                             "unit": m["unit"]}
                                 for m in cell.end_to_end}
            result["device"] = info
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark.core import device as dev
    from benchmark.core import guard, spec

    cell = spec.resolve(args.workload)
    torch.set_num_threads(THREADS)
    try:
        dev.require_cuda(cell.chips)
    except dev.NoDevice as e:
        print(f"benchmark: {e}; no result", file=sys.stderr)
        return 3
    result = execute(cell, args.seed, args.seconds, bool(args.trace))
    found = guard.forbidden_loaded()
    if found:
        print(f"benchmark: modules loaded that the port may not use: {found}; "
              "no result", file=sys.stderr)
        return 4
    limit = dev.power_limit()
    print(f"benchmark: {cell.name} seed {args.seed} on {limit or 'unknown card'}",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
