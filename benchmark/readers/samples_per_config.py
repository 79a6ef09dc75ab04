"""samples_per_config (samples): the samples behind the window's labels
over the rows labeled (the program's counts)."""


def read(ctx):
    c = ctx.counters
    return c["samples_used"] / c["rows"] if c["rows"] > 0 else None
