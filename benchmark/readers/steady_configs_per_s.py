"""steady_configs_per_s (configs/s): a batch's rows over the median gap
between batch completions, the first gap (the pipeline's fill) left out;
by the host's clock at each batch's finish."""

import numpy as np


def read(ctx):
    gaps = np.asarray(ctx.counters.get("batch_gaps_s", []))
    if gaps.size == 0:
        return None
    return ctx.counters["batch_rows"] / float(np.median(gaps))
