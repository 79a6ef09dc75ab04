"""The trajectory traffic's files: the k-gon traffic's rows with a
straight-line motion each, in the ``.npz`` layout ``movelabel`` reads.

The obstacle part of file ``index`` is `rows.kgon_file`'s, bitwise. The
motion is the port's own trajectory bench rows
(``utils.benchmarks.bench_agreement_polygons(moving=True)``): a velocity
with each component uniform in the configuration's ``velocity_range``, in
the obstacle's frame, a horizon ``t_max`` uniform in its ``t_max_range``,
and the angular rate ``omega`` (0: translation only). It takes a generator
of its own, so it shifts no draw of the obstacle rows.
"""

from __future__ import annotations

import numpy as np

from benchmark.gen import rows


def trajectory_file(config: dict, seed: int, index: int, device) -> dict:
    """File ``index`` of the trajectory traffic: `rows.kgon_file`'s host
    float32 arrays plus velocity (C, 2), t_max (C,) and omega (C,)."""
    out = rows.kgon_file(config, seed, index, device)
    g = rows.generator(seed, f"motion/{index}", device)
    c = config["rows_per_file"]
    velocity = rows._uniform(g, (c, 2), *config["velocity_range"], device)
    t_max = rows._uniform(g, (c,), *config["t_max_range"], device)
    out.update(velocity=velocity.cpu().numpy().astype(np.float32),
               t_max=t_max.cpu().numpy().astype(np.float32),
               omega=np.full(c, config["omega"], np.float32))
    return out
