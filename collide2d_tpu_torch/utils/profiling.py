"""Structured per-round timing for the adaptive driver's progress lines.

`StepTimer` is a copy of the one in ``collide2d_tpu/utils/profiling.py``
(rounds, samples drawn, active-set size, throughput). The JAX package's
profiler-trace context has no counterpart yet (``--trace_dir`` is
rejected by the port's CLI).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class StepTimer:
    """Accumulates per-round stats; ask for a summary whenever."""

    t0: float = field(default_factory=time.monotonic)
    rounds: int = 0
    samples_drawn: int = 0  # sum over rounds of n_batch * active
    configs_done: int = 0
    _last: float = field(default_factory=time.monotonic)
    log_every: int = 0
    log_fn: object = print

    def round_done(self, *, n_batch: int, active: int, done_total: int) -> None:
        self.rounds += 1
        self.samples_drawn += n_batch * active
        self.configs_done = done_total
        now = time.monotonic()
        if self.log_every and self.rounds % self.log_every == 0:
            self.log_fn(
                f"[mc] round {self.rounds}: active={active} "
                f"done={done_total} "
                f"{self.samples_drawn / max(now - self.t0, 1e-9) / 1e9:.2f}e9 samples/s"
            )
        self._last = now

    def summary(self) -> dict:
        elapsed = time.monotonic() - self.t0
        return {
            "rounds": self.rounds,
            "elapsed_s": elapsed,
            "samples_drawn": self.samples_drawn,
            "samples_per_sec": self.samples_drawn / max(elapsed, 1e-9),
            "configs_done": self.configs_done,
        }
