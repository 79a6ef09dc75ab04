"""dispatch_us_per_round (us): host microseconds inside the program's
``round/dispatch`` spans that start in the window, over the rounds they
dispatched (the sum of their counts)."""

from benchmark.core import program_spans


def read(ctx):
    spans = program_spans.record() if ctx.trace is not None else None
    if spans is None:
        return None
    done = [s for s in program_spans.in_window(spans, ctx.trace.window)
            if s.name == "round/dispatch"]
    rounds = sum(s.count or 0 for s in done)
    if rounds <= 0:
        return None
    return sum(s.end_ns - s.start_ns for s in done) * 1e-3 / rounds
