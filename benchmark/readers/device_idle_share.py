"""device_idle_share (%): the share of the window in which no operation ran
on the card, from the profiler's trace, averaged over the cards used."""

from benchmark.core import trace


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.mean_busy_seconds(ctx.trace) / ctx.trace.window_s)
