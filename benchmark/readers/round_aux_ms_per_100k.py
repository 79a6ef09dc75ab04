"""round_aux_ms_per_100k (ms): device time of every operation other than
the fused Monte Carlo kernel (packing, the stopping rule, gathers, copies)
per 100,000 configurations labeled, from the profiler's trace."""


def read(ctx):
    if ctx.trace is None or ctx.counters["rows"] <= 0:
        return None
    aux = ctx.trace.kernel_seconds(ctx.cell.config["mc_kernel"], exclude=True)
    return aux * 1e3 * 1e5 / ctx.counters["rows"]
