"""The program's own spans against a traced window's device operations.

The program records a span (``<layer>/<what>``: ``pipeline/``,
``driver/``, ``round/``) at each layer's boundary while a
``torch.profiler`` records (`collide2d_tpu_torch.utils.profiling.span`);
its times are on the clock of the profiler's events, so they line up with
the `TraceTable`'s device operations. `charge` puts each idle instant of
each card down to the innermost span open at that instant on the thread
that drives the program (the process's main thread), and averages over
the cell's cards as ``device_idle_share`` does. The readers of the
``program_span`` metrics read `charged`; a program without the record (one
from before it) gives None, and so do they.

    python -m benchmark.core.program_spans --workload <cell> --seed <n> \\
        --seconds <s> [--out <file.json>]

runs one traced run of the cell and prints its result line, then the
per-span table (`table`): for each span name the card-idle seconds charged
to it (by card too), its seconds as the main thread's innermost span, and
how many spans of the name the window held (on any thread).
"""

from __future__ import annotations

import threading

import numpy as np

from benchmark.core import trace as tr

DRIVER, PIPELINE = "driver", "pipeline"


def record():
    """The program's span record, or None where the program keeps none."""
    try:
        from collide2d_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    return read() or None


def in_window(spans, window) -> list:
    """The spans that start inside ``window`` (seconds), on any thread."""
    lo, hi = window
    return [s for s in spans if lo <= s.start_ns * 1e-9 < hi]


def _innermost(spans, lo: float, hi: float):
    """The window cut into stretches, each with the index (into ``spans``,
    one thread's, properly nested) of the innermost span open there, or
    -1: (starts, ends, who)."""
    start = np.clip(np.array([s.start_ns for s in spans], float) * 1e-9, lo, hi)
    end = np.clip(np.array([s.end_ns for s in spans], float) * 1e-9, lo, hi)
    order = sorted(range(len(spans)), key=lambda i: (start[i], -end[i], spans[i].id))
    seg_lo, seg_hi, who = [], [], []

    def emit(a, b, i):
        if b > a:
            seg_lo.append(a)
            seg_hi.append(b)
            who.append(i)

    stack, cur = [], lo
    for i in order:
        while stack and end[stack[-1]] <= start[i]:
            top = stack.pop()
            emit(cur, end[top], top)
            cur = max(cur, end[top])
        emit(cur, start[i], stack[-1] if stack else -1)
        cur = max(cur, start[i])
        stack.append(i)
    while stack:
        top = stack.pop()
        emit(cur, end[top], top)
        cur = max(cur, end[top])
    emit(cur, hi, -1)
    return np.array(seg_lo), np.array(seg_hi), np.array(who, np.int64)


def _idle_upto(t: np.ndarray, gs: np.ndarray, ge: np.ndarray) -> np.ndarray:
    """Idle seconds in [window start, t] for sorted disjoint gaps."""
    if len(gs) == 0:
        return np.zeros(len(t))
    dur = ge - gs
    cum = np.r_[0.0, np.cumsum(dur)]
    k = np.searchsorted(gs, t, side="right")
    last = np.maximum(k - 1, 0)
    part = np.where(k > 0, np.clip(t - gs[last], 0.0, dur[last]), 0.0)
    return cum[last] + part


def _layer(span, by_id) -> str | None:
    """``driver`` for driver/* spans and round/* spans inside one,
    ``pipeline`` for pipeline/* spans, else None."""
    if span.name.startswith("driver/"):
        return DRIVER
    if span.name.startswith("pipeline/"):
        return PIPELINE
    if span.name.startswith("round/"):
        p = span.parent
        while p is not None and p in by_id:
            if by_id[p].name.startswith("driver/"):
                return DRIVER
            p = by_id[p].parent
    return None


def charge(table, spans, main_thread: int | None = None) -> dict:
    """Each card's idle seconds in the window, by the innermost span of
    ``main_thread`` (default: this process's main thread) open at the
    time. Returns ``cards``, ``idle_s`` (by card), ``by_name`` (name ->
    ``idle_s`` averaged over the cards, ``idle_s_by_card``, ``self_s`` and
    ``count``), ``layers`` (``driver`` / ``pipeline`` -> idle seconds
    averaged over the cards) and ``covered`` (by card: the share of its
    idle seconds that fell in a span)."""
    lo, hi = table.window
    main = threading.main_thread().ident if main_thread is None else main_thread
    by_id = {s.id: s for s in spans}
    mine = [s for s in spans if s.thread == main
            and s.end_ns * 1e-9 > lo and s.start_ns * 1e-9 < hi]
    seg_lo, seg_hi, who = _innermost(mine, lo, hi)
    names = sorted({s.name for s in spans})
    slot = {n: i for i, n in enumerate(names)}
    seg_name = np.array([slot[mine[i].name] if i >= 0 else -1 for i in who], np.int64)
    seg_layer = [(_layer(mine[i], by_id) if i >= 0 else None) for i in who]
    in_layer = {x: np.array([y == x for y in seg_layer], bool) for x in (DRIVER, PIPELINE)}
    cards = list(table.devices)
    idle_by = np.zeros((len(cards), len(names)))
    idle_total, covered = [], []
    layers = dict.fromkeys(in_layer, 0.0)
    for c, d in enumerate(cards):
        gs, ge = tr.idle_gaps(table, d)
        idle = _idle_upto(seg_hi, gs, ge) - _idle_upto(seg_lo, gs, ge)
        inside = seg_name >= 0
        np.add.at(idle_by[c], seg_name[inside], idle[inside])
        total = float((ge - gs).sum())
        idle_total.append(total)
        covered.append(float(idle[inside].sum()) / total if total > 0 else 1.0)
        for layer, sel in in_layer.items():
            layers[layer] += float(idle[sel].sum()) / len(cards) if sel.size else 0.0
    self_s = np.zeros(len(names))
    inside = seg_name >= 0
    np.add.at(self_s, seg_name[inside], (seg_hi - seg_lo)[inside])
    count = dict.fromkeys(names, 0)
    for s in in_window(spans, (lo, hi)):
        count[s.name] += 1
    by_name = {n: {"idle_s": float(idle_by[:, i].mean()),
                   "idle_s_by_card": [float(x) for x in idle_by[:, i]],
                   "self_s": float(self_s[i]), "count": count[n]}
               for i, n in enumerate(names)}
    return {"cards": cards, "idle_s": idle_total, "by_name": by_name,
            "layers": layers, "covered": covered}


def charged(ctx) -> dict | None:
    """`charge` of a reader's context (kept on it for the other readers),
    or None without a trace or a span record."""
    if ctx.trace is None:
        return None
    if not hasattr(ctx, "_program_spans"):
        spans = record()
        ctx._program_spans = None if spans is None else charge(ctx.trace, spans)
    return ctx._program_spans


def table(ctx) -> dict | None:
    """`charged` with each span's share of the idle seconds, for the
    records: the names by idle seconds, most first."""
    c = charged(ctx)
    if c is None:
        return None
    idle = float(np.mean(c["idle_s"]))
    rows = sorted(c["by_name"].items(), key=lambda kv: -kv[1]["idle_s"])
    return {"window_s": ctx.trace.window_s, "idle_s": idle,
            "idle_s_by_card": c["idle_s"], "covered_by_card": c["covered"],
            "layers": c["layers"],
            "spans": [{"name": n, **v, "idle_share": v["idle_s"] / idle if idle else 0.0}
                      for n, v in rows]}


def main(argv=None) -> int:
    import argparse
    import json
    import sys

    import torch

    from benchmark import run
    from benchmark.core import device as dev
    from benchmark.core import spec

    p = argparse.ArgumentParser(description="one traced run and its per-span table")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    cell = spec.resolve(args.workload)
    torch.set_num_threads(run.THREADS)
    try:
        dev.require_cuda(cell.chips)
    except dev.NoDevice as e:
        print(f"program_spans: {e}", file=sys.stderr)
        return 3
    seen = []

    class Context(run.Context):
        def __init__(self, *a) -> None:
            super().__init__(*a)
            seen.append(self)

    run.Context = Context
    result = run.execute(cell, args.seed, args.seconds, True)
    out = {"workload": cell.name, "seed": args.seed, "result": result,
           "spans": table(seen[-1]) if seen else None}
    print(json.dumps(result), flush=True)
    print(json.dumps(out["spans"]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
