"""readbacks_per_100k (count): the program's blocking device-to-host
reads (``driver/readback`` spans, by their counts) that start in the
window, on any thread, per 100,000 configurations labeled."""

from benchmark.core import program_spans


def read(ctx):
    spans = program_spans.record() if ctx.trace is not None else None
    if spans is None or ctx.counters.get("rows", 0) <= 0:
        return None
    reads = sum(s.count or 0 for s in program_spans.in_window(spans, ctx.trace.window)
                if s.name == "driver/readback")
    return reads * 1e5 / ctx.counters["rows"]
