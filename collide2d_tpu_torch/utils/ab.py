"""What the A/B tools share (`utils/mc_ab.py`, `utils/screen_raycast_ab.py`,
`utils/query_ab.py`): building a version's source with ptxas's report,
swapping another version's library into a wrapper, and timing a call in
turns (other, this, this, other) on one card."""

from __future__ import annotations

import contextlib
import re
import subprocess
from pathlib import Path

import torch

from collide2d_tpu_torch.utils import cuda_build

TURNS = ("other", "this", "this", "other")


def nvcc_report(src: Path, defines, out: Path) -> dict:
    """Build ``src`` with the wrappers' flags and ``defines`` into ``out``;
    ptxas's registers, stack frame and spill bytes of each kernel, by
    mangled name."""
    cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
           *cuda_build.define_flags(defines), "-Xptxas", "-v", "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    props = dict(re.findall(r"Function properties for (\S+)\s+(\d+ bytes stack frame, "
                            r"\d+ bytes spill stores, \d+) bytes spill loads", proc.stderr))
    report = {}
    for name, regs in re.findall(r"Compiling entry function '([^']+)'.*?Used (\d+) "
                                 r"registers", proc.stderr, re.S):
        stack, stores, loads = (int(x) for x in re.findall(r"\d+", props[name]))
        report[name] = dict(registers=int(regs), stack_frame=stack, spill_stores=stores,
                            spill_loads=loads)
    return report


@contextlib.contextmanager
def swapped(libs: dict):
    """Inside, each wrapper module of ``libs`` (module -> loaded library)
    launches that library; an empty dict leaves every wrapper its own."""
    saved = {mod: mod._kernel_lib for mod in libs}
    for mod, lib in libs.items():
        mod._kernel_lib = lambda *_, lib=lib, **__: lib
    try:
        yield
    finally:
        for mod, fn in saved.items():
            mod._kernel_lib = fn


def in_turns(cs, libs: dict, fn, reps: int | None = 20) -> tuple[dict, object]:
    """``fn()`` in turns, the other version's ``libs`` swapped in on its
    turns (`swapped`): each version's ms (`chip_smoke._events_ms` over
    ``reps`` calls; None: not timed), whether the outputs (a tensor or a
    tuple of them) of every turn are equal, their fingerprint
    (`chip_smoke.output_fingerprint`); and the first turn's output."""
    outs, ms = [], {"other": [], "this": []}
    for tag in TURNS:
        with swapped(libs if tag == "other" else {}):
            outs.append(fn())
            if reps:
                ms[tag].append(cs._events_ms(fn, reps))
    seq = [o if isinstance(o, tuple) else (o,) for o in outs]
    equal = all(all(map(torch.equal, o, seq[0])) for o in seq[1:])
    row = dict(outputs_equal=equal, fingerprint=cs.output_fingerprint(*seq[0]))
    if reps:
        row.update(ms_other=ms["other"], ms_this=ms["this"],
                   speedup=sum(ms["other"]) / sum(ms["this"]))
    return row, outs[0]
