"""`core.program_spans` and its readers on a synthetic trace and a
synthetic span record."""

from __future__ import annotations

import threading

import numpy as np
import pytest

from benchmark.core import program_spans as ps
from benchmark.core import spec
from benchmark.core import trace as tr
from benchmark.run import Context
from collide2d_tpu_torch.utils.profiling import Span

MAIN = threading.main_thread().ident
OTHER = MAIN + 1
READERS = ("idle_ms_per_100k.driver", "idle_ms_per_100k.pipeline",
           "dispatch_us_per_round", "readbacks_per_100k")


def table(ops, window=(0.0, 10.0), devices=(0,)):
    """ops: (device, start, end) in seconds."""
    return tr.TraceTable(
        ["k"] * len(ops), np.array([o[0] for o in ops], np.int64),
        np.array([o[1] for o in ops], float), np.array([o[2] for o in ops], float),
        ["window"], np.array([window[0]]), np.array([window[1]]), window,
        list(devices))


def span(i, name, start, end, parent=None, thread=MAIN, count=None):
    return Span(i, name, thread, int(start * 1e9), int(end * 1e9), parent, count)


# Card 0 busy in [1, 3] and [5, 6]: idle [0, 1], [3, 5], [6, 10].
OPS = [(0, 1.0, 3.0), (0, 5.0, 6.0)]
SPANS = [
    span(1, "driver/readback", 2.0, 4.0, parent=0, count=1),
    span(0, "pipeline/finish", 0.5, 4.5),
    span(3, "round/dispatch", 6.0, 7.0, parent=2, count=4),
    span(2, "driver/step", 5.5, 9.0),
    span(4, "pipeline/make_batch", 0.0, 10.0, thread=OTHER),
    span(6, "driver/readback", 7.5, 8.0, parent=4, thread=OTHER, count=1),
    span(5, "round/dispatch", 11.0, 12.0, count=9),  # after the window
]


def test_idle_goes_to_the_innermost_main_thread_span():
    c = ps.charge(table(OPS), SPANS)
    idle = {n: v["idle_s"] for n, v in c["by_name"].items()}
    assert idle["pipeline/finish"] == pytest.approx(1.0)  # [0.5, 1] and [4, 4.5]
    assert idle["driver/readback"] == pytest.approx(1.0)  # [3, 4]
    assert idle["round/dispatch"] == pytest.approx(1.0)   # [6, 7]
    assert idle["driver/step"] == pytest.approx(2.0)      # [7, 9]
    assert c["idle_s"] == [pytest.approx(7.0)]
    assert c["covered"] == [pytest.approx(5.0 / 7.0)]
    # round/dispatch inside driver/step counts to the driver
    assert c["layers"] == {"driver": pytest.approx(4.0), "pipeline": pytest.approx(1.0)}


def test_spans_of_other_threads_take_no_idle_time():
    c = ps.charge(table(OPS), SPANS)
    assert c["by_name"]["pipeline/make_batch"]["idle_s"] == 0.0
    assert c["by_name"]["pipeline/make_batch"]["self_s"] == 0.0
    assert c["by_name"]["pipeline/make_batch"]["count"] == 1  # counted, on any thread
    assert c["by_name"]["driver/readback"]["count"] == 2
    assert c["by_name"]["round/dispatch"]["count"] == 1      # one starts after the window
    assert c["by_name"]["driver/step"]["self_s"] == pytest.approx(2.5)


def test_cards_are_averaged():
    ops = OPS + [(1, 0.0, 10.0)]  # card 1 never idles
    c = ps.charge(table(ops, devices=(0, 1)), SPANS)
    assert c["idle_s"] == [pytest.approx(7.0), 0.0]
    assert c["by_name"]["driver/step"]["idle_s"] == pytest.approx(1.0)
    assert c["by_name"]["driver/step"]["idle_s_by_card"] == [pytest.approx(2.0), 0.0]
    assert c["layers"]["driver"] == pytest.approx(2.0)
    assert c["covered"][1] == 1.0


def test_readers(monkeypatch):
    monkeypatch.setattr(ps, "record", lambda: list(SPANS))
    ctx = Context(spec.resolve("rect_ref.generate"), {"rows": 200_000}, table(OPS))
    read = lambda name: spec.reader(name)(ctx)  # noqa: E731
    assert read("idle_ms_per_100k.driver") == pytest.approx(4.0 * 1e3 / 2)
    assert read("idle_ms_per_100k.pipeline") == pytest.approx(1.0 * 1e3 / 2)
    assert read("dispatch_us_per_round") == pytest.approx(1e6 / 4)
    assert read("readbacks_per_100k") == pytest.approx(1.0)


@pytest.mark.parametrize("name", READERS)
def test_readers_return_nothing_without_their_input(monkeypatch, name):
    cell = spec.resolve("rect_ref.generate")
    monkeypatch.setattr(ps, "record", lambda: None)  # a program without spans
    assert spec.reader(name)(Context(cell, {"rows": 10}, table(OPS))) is None
    monkeypatch.setattr(ps, "record", lambda: list(SPANS))
    assert spec.reader(name)(Context(cell, {"rows": 10}, None)) is None


def test_an_empty_record_reads_as_none():
    from collide2d_tpu_torch.utils import profiling

    profiling.clear()
    assert ps.record() is None


def test_every_cell_lists_the_span_metrics():
    for w in spec.benchmark()["workloads"]:
        names = {m["name"] for m in spec.resolve(w["name"]).per_layer}
        assert set(READERS) <= names, w["name"]
