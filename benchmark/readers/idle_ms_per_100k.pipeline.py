"""idle_ms_per_100k.pipeline (ms): card-idle milliseconds charged to the
program's ``pipeline/`` spans on the main thread, averaged over the
cards, per 100,000 configurations labeled (`core.program_spans`)."""

from benchmark.core import program_spans


def read(ctx):
    c = program_spans.charged(ctx)
    if c is None or ctx.counters.get("rows", 0) <= 0:
        return None
    return c["layers"][program_spans.PIPELINE] * 1e3 * 1e5 / ctx.counters["rows"]
