"""The control of the comparison, and a sound witness beside it.

    python -m benchmark.control --workload <cell> --seeds 11 12 13 [--out f.jsonl]

For each seed it makes the cell's inputs as a run does, by its entry's
``control_rows`` (the rectangle tables and rows drawn as the generator
draws them, or the k-gon traffic's first file), takes as many rows as a
run compares, and labels them with the plain labeler
(`reference.labeler`) put in the program's place: in bfloat16, the
precision below the float32 the configuration states (the control, which
has to come out as not correct), and in float32 (a sound witness). Each
labeling goes through the same comparison as a run (`core.compare`) and
prints one JSON line with its numbers. The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark.core import compare, spec
from benchmark.gen import rows
from benchmark.reference import labeler

PRECISIONS = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def inputs(cell, seed: int, count: int, device) -> tuple:
    """(position, robot_theta, robot, obstacle_verts, sd) of ``count`` rows
    of the cell's traffic, host float32, from its entry's ``control_rows``.
    ``robot`` is the configuration's robot (K2, 2), or each row's
    (count, K2', 2) (a moving robot's swept region,
    `reference.exact.swept_robot`)."""
    return spec.entry(cell).control_rows(cell, seed, count, device)


def measure(cell, seed: int, precision: str, device) -> dict:
    cfg, w = cell.config, cell.workload
    count = w["sample_rows"]
    position, theta, robot, obstacle, sd = inputs(cell, seed, count, device)
    t0 = time.perf_counter()
    cp, n, done = labeler.label(
        position, theta, robot, obstacle, sd, seed=rows.sub_seed(seed, "labeler"),
        accuracy_bins=cfg["accuracy_bins"], bin_accuracy=cfg["bin_accuracy"],
        max_samples=cfg["max_samples"], device=device, dtype=PRECISIONS[precision])
    lab = compare.Labeled(cp=cp, n=n, converged=done, rows_bad=0, robot_verts=robot,
                          geometry=lambda idx: (position[idx], theta[idx],
                                                obstacle[idx], sd[idx]))
    numbers = compare.compare(lab, cfg, seed, count, w["top_rows"])
    return {"workload": cell.name, "seed": seed, "precision": precision,
            "label_s": time.perf_counter() - t0, **numbers,
            "samples_per_config": float(n.mean())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--precisions", nargs="+", default=list(PRECISIONS))
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    cell = spec.resolve(args.workload)
    for seed in args.seeds:
        for precision in args.precisions:
            line = json.dumps(measure(cell, seed, precision, args.device))
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
