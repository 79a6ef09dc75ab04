"""Offline waste/throughput simulator for the adaptive driver.

Counterpart of ``collide2d_tpu/mc/schedule_sim.py`` (numpy only), over
the port's `AdaptiveScheduler` and round plan; ``impl='cuda'`` plans as
the fused kernel does (the JAX module's Pallas plan). `generate` and
`relabel` call `min_convergence_points` and `optimize_checkpoints` to
resolve ``--schedule opt``.

Drives the REAL :class:`~collide2d_tpu_torch.mc.driver.AdaptiveScheduler` with
a synthetic device whose convergence behavior comes from a per-row
freeze-point profile, so schedule/ladder/policy questions ("where do the
dispatched sample-slots go?", "would a sixteenth ladder pay?") can be
answered exactly — same planner, same pipelined-readback state machine,
same repack policy as production — without touching hardware.

Two ways to get a profile:

- :func:`simulate_convergence` draws binomial k-trajectories for given
  true collision probabilities and replays the reference CI criterion
  (generate_dataset.cu:243-252 semantics via a NumPy mirror of
  ``mc.stats``) at every round boundary of the configured schedule.
- Feed the ``n_used`` column of a REAL run (``AdaptiveRun.materialize``
  or a dataset artifact) straight in: the simulator then reproduces that
  run's dispatch sequence and slot totals exactly (the JAX package's
  tests/test_schedule_sim.py proves it against that package's driver;
  the scheduler is the same class here).

The report splits every dispatched slot into
``used`` (sample slots the frozen labels actually consumed),
``ride``  (slots spent on rows that had already frozen but had not been
          repacked out yet — bounded by the ladder's rung spacing), and
``padding`` (slots on pad rows that exist only to round the buffer up to
          a ladder bucket),
plus dispatch/repack counts and an optional wall-clock model
(per-dispatch overhead + a buffer-size-dependent streaming rate), which
is what makes tail effects visible: small buckets stream slower, so a
policy that minimizes slots can still lose wall-clock.
"""

from __future__ import annotations

import numpy as np

from collide2d_tpu_torch.mc import estimator as est
from collide2d_tpu_torch.mc.driver import AdaptiveScheduler
from collide2d_tpu_torch.mc.stats import _LOG_INV_ALPHA, Z_SCORE

__all__ = [
    "round_boundaries",
    "stopping_counts",
    "simulate_convergence",
    "ProfileOps",
    "simulate_schedule",
    "min_convergence_points",
    "optimize_checkpoints",
]


def round_boundaries(cfg, impl: str = "cuda"):
    """Cumulative sample counts at every convergence checkpoint of
    ``cfg``'s schedule (the round ends of ``estimator._plan_round``,
    replayed to the cap). Deterministic: the plan depends only on the
    cumulative position, never on convergence."""
    out = []
    n = 0
    while n < cfg.max_samples:
        nb, _ = est._plan_round(cfg, n, 1, impl)
        n += nb
        out.append(n)
    return np.asarray(out, np.int64)


def _is_converged_np(n, k, accuracy_bins, bin_accuracy):
    """NumPy float32 mirror of mc.stats.is_converged (same dtypes so bin
    boundaries and degenerate cases agree bit for bit)."""
    n = np.asarray(n, np.float32)
    k = np.asarray(k, np.float32)
    degenerate = (k == n) | (k == 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        rot = np.float32(_LOG_INV_ALPHA) / n
        wald = np.float32(Z_SCORE) / n * np.sqrt(
            np.maximum(k - k * k / n, np.float32(0.0))
        )
    slack = np.where(degenerate, rot, wald)
    p = k / n
    bins = np.asarray(accuracy_bins, np.float32)
    match = (p[..., None] >= bins[:-1]) & (p[..., None] <= bins[1:])
    n_bins = len(bins) - 1
    last = (n_bins - 1) - np.argmax(match[..., ::-1], axis=-1)
    bin_idx = np.where(match.any(axis=-1), last, 0)
    target = np.asarray(bin_accuracy, np.float32)[bin_idx]
    return slack <= target


def stopping_counts(cp, cfg, impl: str = "cuda"):
    """Per-row sample counts recovered from final labels alone (batch files
    and ``ztest --cps_only`` keep no counts): the first round boundary of
    ``cfg``'s schedule at which a count k with float32(k) / float32(n) ==
    cp meets the row's bin accuracy; the final boundary for rows that never
    do. A row whose running estimate met the criterion only late gets an
    earlier boundary than the driver's, so the counts are a lower bound."""
    cp = np.asarray(cp, np.float32)
    out = np.full(cp.shape, 0, np.int64)
    open_ = np.ones(cp.shape, bool)
    bounds = round_boundaries(cfg, impl=impl)
    for n in bounds:
        k = np.rint(cp.astype(np.float64) * n)
        same = k.astype(np.float32) / np.float32(n) == cp
        first = open_ & same & _is_converged_np(n, k, cfg.accuracy_bins, cfg.bin_accuracy)
        out[first] = n
        open_ &= ~first
        if not open_.any():
            break
    out[open_] = bounds[-1]
    return out


def simulate_convergence(cp, cfg, seed: int = 0, impl: str = "cuda"):
    """Per-config freeze points for true probabilities ``cp``.

    Draws one binomial k-trajectory per config and returns the first
    round boundary (cumulative samples) at which the CI criterion holds;
    rows that never converge get the final boundary (where the at-cap
    flush freezes them)."""
    rng = np.random.default_rng(seed)
    cp = np.asarray(cp, np.float64)
    bounds = round_boundaries(cfg, impl=impl)
    k = np.zeros(cp.shape, np.int64)
    n_frozen = np.full(cp.shape, bounds[-1], np.int64)
    open_ = np.ones(cp.shape, bool)
    n_prev = 0
    for n_now in bounds:
        idx = np.flatnonzero(open_)
        if idx.size == 0:
            break
        k[idx] += rng.binomial(int(n_now - n_prev), cp[idx])
        conv = _is_converged_np(
            n_now, k[idx], cfg.accuracy_bins, cfg.bin_accuracy
        )
        newly = idx[conv]
        n_frozen[newly] = n_now
        open_[newly] = False
        n_prev = n_now
    return n_frozen


def min_convergence_points(
    cp, cfg, *, granule: int = 64, grid_points: int = 192, seed: int = 0
):
    """Earliest POSSIBLE convergence sample count per config.

    Like `simulate_convergence`, but replayed on a dense geometric grid
    of candidate boundaries (multiples of ``granule``) instead of the
    configured schedule — the per-row lower envelope any checkpoint
    schedule is then fit against. Rows that never satisfy the CI
    criterion before the cap return ``cfg.max_samples``.
    """
    cap = int(cfg.max_samples)
    g = np.unique(
        np.clip(
            (np.geomspace(granule, cap, grid_points) / granule)
            .round()
            .astype(np.int64)
            * granule,
            granule,
            cap,
        )
    )
    if g[-1] != cap:
        g = np.append(g, cap)
    rng = np.random.default_rng(seed)
    cp = np.asarray(cp, np.float64)
    k = np.zeros(cp.shape, np.int64)
    n_min = np.full(cp.shape, cap, np.int64)
    open_ = np.ones(cp.shape, bool)
    n_prev = 0
    for n_now in g:
        idx = np.flatnonzero(open_)
        if idx.size == 0:
            break
        k[idx] += rng.binomial(int(n_now - n_prev), cp[idx])
        conv = _is_converged_np(
            n_now, k[idx], cfg.accuracy_bins, cfg.bin_accuracy
        )
        newly = idx[conv]
        n_min[newly] = n_now
        open_[newly] = False
        n_prev = n_now
    return n_min, g


def optimize_checkpoints(
    n_min,
    cfg,
    *,
    grid=None,
    overhead_samples: float = 256.0,
    max_checkpoints: int = 24,
    granule: int = 64,
):
    """Choose convergence checkpoints minimizing expected sample slots.

    A checkpoint schedule never changes WHAT a label must satisfy (the
    per-bin CI criterion is evaluated at every checkpoint, and a row is
    only emitted once it holds — generate_dataset.cu:243-252 semantics);
    it only decides WHERE convergence is tested, i.e. how many extra
    samples a row draws past its earliest possible convergence point.
    Given the workload's measured ``n_min`` distribution
    (`min_convergence_points` over estimated cps, or the n_used column
    of a real run), the expected slot cost of a schedule C is

        sum_rows  min{c in C : c >= n_min_row}        (samples paid)
      + overhead_samples * sum_{c in C} active(c-)    (sync/dispatch)

    with active(c-) = rows not yet frozen when the checkpoint's round
    dispatches. Both terms are exact under instant repack; the second
    prices each extra sync at ``overhead_samples`` per still-active row
    (the default of 256 is the JAX package's; its value on the card is
    not measured). This function minimizes that objective
    exactly by dynamic programming over a candidate grid (O(G^2)), with
    ``max_checkpoints`` bounding the compile-shape bill, and returns
    CUMULATIVE checkpoints (granule-rounded, cap excluded) ready for
    ``AdaptiveConfig(schedule=...)``.

    The 'tuned' schedule is the K=1 special case of this (one
    hand-placed rule-of-three checkpoint); the DP typically places 3-6
    more where the cp distribution's mass converges.
    """
    n_min = np.asarray(n_min, np.int64)
    cap = int(cfg.max_samples)
    if grid is None:
        base = np.geomspace(
            max(granule, float(np.percentile(n_min, 1))), cap, 160
        )
        grid = np.unique(
            np.clip(
                (base / granule).round().astype(np.int64) * granule,
                granule, cap,
            )
        )
    grid = np.asarray(sorted(set(int(x) for x in grid) | {cap}), np.int64)
    g_count = len(grid)
    order = np.sort(n_min)
    rows_leq = np.searchsorted(order, grid, side="right")
    n_rows = n_min.size
    # DP over "grid[j] is a chosen checkpoint": rows in (grid[i],
    # grid[j]] pay grid[j] samples; the sync at grid[j] prices
    # overhead_samples per row still active after the previous
    # checkpoint. The overhead term makes sparse schedules win
    # naturally, so no explicit K bound is needed in the recursion.
    cost = np.full(g_count, np.inf)
    prev = np.full(g_count, -1, np.int64)
    for j in range(g_count):
        # first checkpoint at grid[j]: everyone active at the sync
        cost[j] = rows_leq[j] * float(grid[j]) + overhead_samples * n_rows
        for i in range(j):
            c = (
                cost[i]
                + (rows_leq[j] - rows_leq[i]) * float(grid[j])
                + overhead_samples * (n_rows - rows_leq[i])
            )
            if c < cost[j]:
                cost[j], prev[j] = c, i
    # the cap is always the final (flush) boundary
    pts = []
    j = g_count - 1
    while j >= 0:
        pts.append(int(grid[j]))
        j = int(prev[j])
    pts = sorted(set(pts))
    interior = [p for p in pts if p < cap]
    if len(interior) > max_checkpoints:
        # thin to an EVENLY spaced index subset, not an early-biased one:
        # the zero-cp mass converges at one early (rule-of-three) point
        # that any thinning keeps, while the budget's tail lives in
        # late-converging rows whose overshoot is bounded by the LATE
        # checkpoint gaps, which an early-biased subset widens.
        keep = np.linspace(0, len(interior) - 1, max_checkpoints)
        interior = sorted({interior[int(round(x))] for x in keep})
    # cap excluded by contract: the driver always flushes at max_samples
    return tuple(interior)


class ProfileOps:
    """AdaptiveScheduler device ops driven by a freeze-point profile.

    ``rows`` holds the freeze point of every REAL row currently in the
    buffer (frozen rows ride until a pack removes them, exactly like the
    device buffer); padding is the buffer tail beyond ``len(rows)``.
    Slot accounting happens at dispatch time: a row's slots in a round
    count as ``used`` while the round's end is <= its freeze point and as
    ``ride`` after; pad-row slots count as ``padding``.
    """

    def __init__(
        self,
        n_frozen,
        *,
        t_dispatch: float = 0.0,
        rate=None,
        buffer_len: int | None = None,
    ) -> None:
        self.rows = np.asarray(n_frozen, np.int64).copy()
        self._len = int(buffer_len) if buffer_len else self.rows.size
        if self._len < self.rows.size:
            raise ValueError("buffer_len smaller than the profile")
        self.t_dispatch = float(t_dispatch)
        self.rate = rate  # callable buffer_len -> samples/s, or None
        self._n_device = 0  # samples covered by dispatched rounds
        self.used = 0
        self.ride = 0
        self.padding = 0
        self.dispatched_slots = 0
        self.slots_by_bucket: dict[int, int] = {}
        self.n_dispatches = 0
        self.n_repacks = 0
        self.time = 0.0

    def buffer_len(self) -> int:
        return self._len

    def run_rounds(self, nb, step, n_rounds, n_samples_first, chunk_offset):
        nb, n_rounds = int(nb), int(n_rounds)
        ends = int(n_samples_first) + nb * np.arange(n_rounds, dtype=np.int64)
        # used rounds per row: boundaries at or before its freeze point
        used_rounds = np.searchsorted(ends, self.rows, side="right")
        self.used += int(nb * used_rounds.sum())
        self.ride += int(nb * (n_rounds * self.rows.size - used_rounds.sum()))
        self.padding += nb * n_rounds * (self._len - self.rows.size)
        slots = nb * n_rounds * self._len
        self.dispatched_slots += slots
        self.slots_by_bucket[self._len] = (
            self.slots_by_bucket.get(self._len, 0) + slots
        )
        self.n_dispatches += 1
        self.time += self.t_dispatch + (
            slots / self.rate(self._len) if self.rate else 0.0
        )
        self._n_device = int(ends[-1])
        return ("count", self._n_device)

    def start_transfer(self, handle) -> None:
        pass

    def resolve(self, handle) -> int:
        # done among real rows at the handle's boundary (the device sums
        # done&real after the run's LAST round — estimator.py num_done)
        return int((self.rows <= handle[1]).sum())

    def resolve_active(self, handle) -> int:
        return int(handle[1])

    def emit(self) -> None:
        pass

    def flush(self, n_samples) -> None:
        pass

    def pack(self, bucket):
        # The device packs on its CURRENT done flags (all dispatched
        # rounds have executed), not on the possibly-stale resolved count.
        bucket = int(bucket)
        active = self.rows[self.rows > self._n_device]
        if active.size > bucket:
            raise AssertionError(
                f"pack bucket {bucket} < active {active.size}: the "
                "stale-safe overestimate should make this impossible"
            )
        self.rows = active
        self._len = bucket
        self.n_repacks += 1
        return ("active", active.size)

    def progress(self, num_left, n_samples, rnd) -> None:
        pass

    def bookkeeping(self, n_samples, chunk_offset, num_real, rnd) -> None:
        pass


def simulate_schedule(
    n_frozen,
    cfg,
    *,
    impl: str = "cuda",
    t_dispatch: float = 0.0,
    rate=None,
    sync_samples: int | None = None,
    pipeline_work: int | None = None,
    eager_resolve: bool = False,
) -> dict:
    """Replay the production scheduler over a freeze-point profile.

    Returns a report dict: total dispatched ``slots`` and their
    used/ride/padding split, ``efficiency`` (used/slots), dispatch and
    repack counts, per-bucket slot histogram, and the modeled ``time``
    (0.0 unless ``t_dispatch``/``rate`` are given)."""
    ops = ProfileOps(n_frozen, t_dispatch=t_dispatch, rate=rate)
    kw = {}
    if sync_samples is not None:
        kw["sync_samples"] = sync_samples
    if pipeline_work is not None:
        kw["pipeline_work"] = pipeline_work
    sched = AdaptiveScheduler(
        cfg, ops, num_real=ops.rows.size, impl=impl,
        eager_resolve=eager_resolve, **kw
    )
    sched.run()
    return {
        "slots": ops.dispatched_slots,
        "used": ops.used,
        "ride": ops.ride,
        "padding": ops.padding,
        "efficiency": ops.used / ops.dispatched_slots
        if ops.dispatched_slots
        else 0.0,
        "dispatches": ops.n_dispatches,
        "repacks": ops.n_repacks,
        "slots_by_bucket": dict(sorted(ops.slots_by_bucket.items())),
        "time": ops.time,
        "n_samples": sched.n_samples,
    }
