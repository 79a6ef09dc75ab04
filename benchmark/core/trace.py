"""The traced run's window: harness spans and the device trace.

`Spans` records the harness's own spans around its calls into each layer
of the program. In a traced run each span is a ``torch.profiler``
``record_function`` range, so it shares the profiler's clock with the
device's operations; in an untraced run a span costs nothing.

`capture` turns the profiler's events into a `TraceTable`: the device
operations (kernels, copies and sets) and the harness spans, in seconds on
one clock, with the window's bounds. The readers of the per-layer metrics
take the table and nothing of the profiler, so a test can hand them a
synthetic one.
"""

from __future__ import annotations

import contextlib
import inspect
from dataclasses import dataclass, field

import numpy as np

SPAN_PREFIX = "bench/"
WINDOW = "window"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


class Spans:
    """Named harness spans; ``enabled`` only in a traced run."""

    def __init__(self, enabled: bool) -> None:
        self.enabled = enabled

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        import torch

        return torch.autograd.profiler.record_function(SPAN_PREFIX + name)

    @contextlib.contextmanager
    def around(self, targets):
        """While open, and only in a traced run, each ``(owner, attribute,
        name)`` of ``targets`` (a function of the program, called on the
        main thread) runs inside a span ``name``; the originals come back
        on exit."""
        saved = []
        try:
            if self.enabled:
                for owner, attr, name in targets:
                    saved.append((owner, attr, inspect.getattr_static(owner, attr)))
                    setattr(owner, attr, self._wrapped(getattr(owner, attr), name))
            yield
        finally:
            for owner, attr, orig in reversed(saved):
                setattr(owner, attr, orig)

    def _wrapped(self, fn, name):
        def call(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return call


@dataclass
class TraceTable:
    """Device operations and harness spans of one window, in seconds."""

    op_name: list[str]
    op_device: np.ndarray  # (O,) device index
    op_start: np.ndarray   # (O,)
    op_end: np.ndarray     # (O,)
    span_name: list[str]
    span_start: np.ndarray
    span_end: np.ndarray
    window: tuple[float, float]
    devices: list[int] = field(default_factory=lambda: [0])

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def clipped(self, device: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        """Operation intervals clipped to the window (one device or all)."""
        keep = np.ones(len(self.op_start), bool) if device is None else (
            self.op_device == device)
        lo = np.clip(self.op_start[keep], *self.window)
        hi = np.clip(self.op_end[keep], *self.window)
        return lo, hi

    def kernel_seconds(self, match: str, exclude: bool = False) -> float:
        """Summed duration (inside the window) of operations whose name
        holds ``match`` (or, with ``exclude``, does not)."""
        lo, hi = self.clipped()
        sel = np.array([(match in n) != exclude for n in self.op_name], bool)
        return float((hi - lo)[sel].sum()) if len(sel) else 0.0


def union_intervals(lo: np.ndarray, hi: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The union of intervals as sorted disjoint (start, end) arrays."""
    if len(lo) == 0:
        return lo, hi
    order = np.argsort(lo, kind="stable")
    lo, hi = lo[order], hi[order]
    reach = np.maximum.accumulate(hi)
    new = np.ones(len(lo), bool)
    new[1:] = lo[1:] > reach[:-1]
    starts = lo[new]
    ends = reach[np.r_[np.flatnonzero(new)[1:] - 1, len(lo) - 1]]
    return starts, ends


def busy_seconds(table: TraceTable, device: int | None = None) -> float:
    s, e = union_intervals(*table.clipped(device))
    return float((e - s).sum())


def mean_busy_seconds(table: TraceTable) -> float:
    return float(np.mean([busy_seconds(table, d) for d in table.devices]))


def idle_gaps(table: TraceTable, device: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Stretches of the window with no operation on ``device``."""
    s, e = union_intervals(*table.clipped(device))
    starts = np.r_[table.window[0], e]
    ends = np.r_[s, table.window[1]]
    keep = ends > starts
    return starts[keep], ends[keep]


def _span_at(table: TraceTable, t: float) -> str:
    """The innermost harness span holding time ``t`` (or "no span")."""
    inside = (table.span_start <= t) & (table.span_end >= t)
    if not inside.any():
        return "no span"
    i = np.flatnonzero(inside)[np.argmax(table.span_start[inside])]
    return table.span_name[i]


def _short(name: str) -> str:
    """A kernel's name without its return type, namespace and arguments."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0][:120] or name[:120]


def breakdown(table: TraceTable) -> dict:
    """The device operations that took most time (by name), and the idle
    time of device 0 by the innermost harness span it fell in."""
    lo, hi = table.clipped()
    per_op: dict[str, float] = {}
    for name, d in zip(table.op_name, hi - lo):
        key = _short(name)
        per_op[key] = per_op.get(key, 0.0) + float(d)
    per_gap: dict[str, float] = {}
    for s, e in zip(*idle_gaps(table)):
        key = _span_at(table, 0.5 * (s + e))
        per_gap[key] = per_gap.get(key, 0.0) + float(e - s)
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]  # noqa: E731
    return {"device_ops": top(per_op), "idle_gaps": top(per_gap)}


def _attr(event, name: str):
    value = getattr(event, name, None)
    return value() if callable(value) else value


def capture(prof) -> TraceTable:
    """A `TraceTable` of a stopped ``torch.profiler.profile``: its device
    operations and the ``bench/`` user annotations, the window being the
    ``bench/window`` span."""
    op_name, op_dev, op_s, op_e = [], [], [], []
    sp_name, sp_s, sp_e = [], [], []
    for ev in prof.profiler.kineto_results.events():
        kind = str(_attr(ev, "activity_type") or "")
        name = _attr(ev, "name")
        start = _attr(ev, "start_ns") * 1e-9
        end = start + _attr(ev, "duration_ns") * 1e-9
        on_device = "CUDA" in str(_attr(ev, "device_type"))
        if name.startswith(SPAN_PREFIX):
            if not on_device:
                sp_name.append(name.removeprefix(SPAN_PREFIX))
                sp_s.append(start)
                sp_e.append(end)
        elif on_device and (kind in DEVICE_ACTIVITIES or "annotation" not in kind):
            op_name.append(name)
            op_dev.append(int(_attr(ev, "device_index") or 0))
            op_s.append(start)
            op_e.append(end)
    windows = [(s, e) for n, s, e in zip(sp_name, sp_s, sp_e) if n == WINDOW]
    if not windows:
        raise RuntimeError("the trace holds no window span")
    devices = sorted(set(op_dev)) or [0]
    return TraceTable(op_name, np.asarray(op_dev, np.int64), np.asarray(op_s),
                      np.asarray(op_e), sp_name, np.asarray(sp_s), np.asarray(sp_e),
                      windows[0], devices)
