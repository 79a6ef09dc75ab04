"""The per-layer readers and the trace reductions on a synthetic table."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark.core import spec
from benchmark.core import trace as tr
from benchmark.roofline import counts
from benchmark.run import Context


def table(ops, spans=(), window=(0.0, 10.0), devices=(0,)):
    """ops: (name, device, start, end); spans: (name, start, end)."""
    return tr.TraceTable(
        [o[0] for o in ops], np.array([o[1] for o in ops], np.int64),
        np.array([o[2] for o in ops], float), np.array([o[3] for o in ops], float),
        [s[0] for s in spans], np.array([s[1] for s in spans], float),
        np.array([s[2] for s in spans], float), window, list(devices))


OPS = [
    ("void mc_counts_kernel<false, false>(float const*, int const*)", 0, 1.0, 3.0),
    ("void mc_counts_kernel<false, false>(float const*, int const*)", 0, 2.5, 4.0),
    ("void at::native::elementwise_kernel<128, 4>(int)", 0, 5.0, 5.5),
    ("Memcpy DtoH (Device -> Pinned)", 0, 9.5, 10.5),  # clipped at the window
]
SPANS = [("window", 0.0, 10.0), ("generate", 0.5, 9.9), ("load", 4.0, 5.0)]


def test_union_and_busy():
    t = table(OPS, SPANS)
    s, e = tr.union_intervals(*t.clipped())
    assert s.tolist() == [1.0, 5.0, 9.5] and e.tolist() == [4.0, 5.5, 10.0]
    assert tr.busy_seconds(t) == pytest.approx(4.0)
    assert t.kernel_seconds("mc_counts_kernel") == pytest.approx(3.5)
    assert t.kernel_seconds("mc_counts_kernel", exclude=True) == pytest.approx(1.0)


def test_breakdown_labels_gaps_by_innermost_span():
    b = tr.breakdown(table(OPS, SPANS))
    assert b["device_ops"][0] == ["mc_counts_kernel<false, false>", 3.5]
    gaps = dict(b["idle_gaps"])
    # gaps: [0, 1] (mid 0.5: generate starts at 0.5 -> generate), [4, 5]
    # (mid 4.5: load), [5.5, 9.5] (generate)
    assert gaps["load"] == pytest.approx(1.0)
    assert gaps["generate"] == pytest.approx(5.0)


def test_readers():
    cell = spec.resolve("rect_ref.generate")
    t = table(OPS, SPANS)
    counters = {"rows": 200_000, "samples_used": 4_000_000_000,
                "slots_dispatched": 5_000_000_000, "batch_rows": 100_000,
                "batch_gaps_s": np.array([0.4, 0.5, 0.6])}
    ctx = Context(cell, counters, t)
    read = lambda name: spec.reader(name)(ctx)  # noqa: E731
    assert read("device_idle_share") == pytest.approx(60.0)
    ops = 4e9 * counts.rect_ops_per_sample()
    assert read("mc_roofline.rect") == pytest.approx(100 * ops / 67e12 / 3.5)
    assert read("round_aux_ms_per_100k") == pytest.approx(1.0 * 1e3 / 2)
    assert read("samples_per_config") == pytest.approx(20_000)
    assert read("slot_efficiency") == pytest.approx(80.0)
    assert read("steady_configs_per_s") == pytest.approx(200_000)


def test_readers_return_nothing_without_their_input():
    cell = spec.resolve("kgon8.polylabel")
    ctx = Context(cell, {"rows": 10, "samples_used": 100}, table(OPS, SPANS))
    assert spec.reader("mc_roofline.kgon")(ctx) is None  # kernel 7 never ran
    assert spec.reader("slot_efficiency")(ctx) is None
    assert spec.reader("steady_configs_per_s")(ctx) is None
    assert spec.reader("device_idle_share")(Context(cell, {}, None)) is None


def test_idle_share_averages_cards():
    ops = [("k", 0, 0.0, 10.0), ("k", 1, 0.0, 5.0)]
    t = table(ops, SPANS, devices=(0, 1))
    assert spec.reader("device_idle_share")(Context(None, {}, t)) == pytest.approx(25.0)
