"""Host-side adaptive-labeling driver: scheduler, device ops and loop.

Counterpart of ``collide2d_tpu/mc/driver.py`` (the reference's host
while-loop, generate_dataset.cu:425-468), in four pieces:

- `AdaptiveScheduler` — the pure host state machine, the JAX package's
  class with its logic unchanged (so scheduler trajectories stay
  comparable): plans sync groups, decides when to resolve the done-count
  readback, when to emit and repack, when to stop and how to drain. Every
  device effect goes through an injected ops object.
- `_TorchOps` — the device ops on torch tensors: `_fused_round` rounds
  (from the fused kernel's table, packed once a buffer), on-device
  emit/flush/pack, and scalar readbacks through pinned host memory and a
  CUDA event (`_CopyToHost`).
- `AdaptiveRun` / `adaptive_collision_probabilities` / `run_interleaved`
  — state set-up, one scheduler run, final materialize, and the
  cross-batch interleaving of several runs.
- `_save_checkpoint` / `_load_checkpoint` — the mid-run checkpoint file,
  in the JAX package's ``.npz`` format (either package resumes the
  other's file).

Scheduling invariants (see `AdaptiveScheduler.run`): a resolved done
count may be one sync group stale, and a stale count undercounts done
rows, so a repack bucket sized from it can only be too roomy; after a
repack, the count of the group dispatched just before it is discarded; a
group right before an expensive round resolves synchronously.
"""

from __future__ import annotations

import functools
import os
import threading
from typing import NamedTuple

import numpy as np
import torch

from collide2d_tpu_torch.mc import estimator as est
from collide2d_tpu_torch.mc.estimator import AdaptiveConfig, _LoopState, resolve_impl
from collide2d_tpu_torch.mc.moving import MovingConfigs, MovingPolygonConfigs
from collide2d_tpu_torch.ops.mc_polygon_cuda import dedup_robot_axes
from collide2d_tpu_torch.utils.profiling import span

# Dispatch enough rounds between host syncs to amortise the readback. The
# value is the JAX package's, kept so scheduler trajectories stay
# comparable; it was sized for a slow host round trip, and re-measuring it
# on a GPU is later work.
SYNC_SAMPLES = 3 * 10**8
TUNED_SYNC_SAMPLES = 6 * 10**8
# Only SMALL groups pipeline their done-count readback; big groups
# resolve synchronously so a repack lands before the next large round.
PIPELINE_WORK = 5 * SYNC_SAMPLES


def sync_samples_for(schedule) -> int:
    """Schedule-aware sync quantum (shared policy with the JAX driver)."""
    return TUNED_SYNC_SAMPLES if schedule == "tuned" else SYNC_SAMPLES


class _OutState(NamedTuple):
    """Device-resident emission buffers, one row per ORIGINAL config plus
    one trailing discard slot: rows that must not be written scatter to
    index C, which keeps every scatter free of host synchronisation.
    k/n are the frozen integer numerator/denominator."""

    k: torch.Tensor     # int32 (C+1,) frozen true-counts (or tail-flush counts)
    n: torch.Tensor     # int32 (C+1,) frozen denominators (0 = never written)
    flag: torch.Tensor  # bool  (C+1,) converged (tail-flushed rows stay False)


def _emit_to_out(state: _LoopState, outs: _OutState) -> _OutState:
    """Scatter frozen labels of done rows into the output buffers
    (idempotent: frozen values never change after freezing)."""
    c = outs.k.shape[0] - 1
    emit = state.done & (state.uids >= 0)
    tgt = torch.where(emit, state.uids, c).to(torch.int64)
    return _OutState(
        k=outs.k.index_copy(0, tgt, state.k_frozen),
        n=outs.n.index_copy(0, tgt, state.n_frozen),
        flag=outs.flag.index_copy(0, tgt, torch.ones_like(emit)),
    )


def _flush_to_out(state: _LoopState, outs: _OutState, n_samples: int) -> _OutState:
    """Tail flush (generate_dataset.cu:470-479): unconverged rows get their
    current estimate at the final sample count; flag stays False."""
    c = outs.k.shape[0] - 1
    fl = ~state.done & (state.uids >= 0)
    tgt = torch.where(fl, state.uids, c).to(torch.int64)
    return _OutState(
        k=outs.k.index_copy(0, tgt, state.n_true),
        n=outs.n.index_copy(0, tgt, torch.full_like(state.uids, int(n_samples))),
        flag=outs.flag,
    )


def _pack_active(state: _LoopState, *, bucket: int, table=None):
    """Repack still-active rows into a ``bucket``-sized buffer on device.

    A stable sort puts active rows first in original order. Pad slots
    carry uids=-1 and done=True. Also returns the exact active count
    (int32 scalar on device) and ``table`` (the fused kernel's table of
    ``state.active``, `estimator.pack_round_table`) gathered with the same
    order in a ``driver/table`` span, or None: the table of the new buffer,
    bitwise, as every row's table depends on that row alone."""
    active = ~state.done & (state.uids >= 0)
    order = torch.argsort((~active).to(torch.int32), stable=True)[:bucket]
    slot_valid = active[order]
    new_state = _LoopState(
        uids=torch.where(slot_valid, state.uids[order], -1),
        active=type(state.active)(*(a[order] for a in state.active)),
        n_true=state.n_true[order],
        done=~slot_valid,
        k_frozen=state.k_frozen[order],
        n_frozen=state.n_frozen[order],
    )
    if table is not None:
        with span("driver/table", count=1):
            table = table.index_select(0, order)
    return new_state, active.sum(dtype=torch.int32), table


@functools.lru_cache(maxsize=None)
def _ladder_buckets(c0: int, min_bucket: int, ladder: str = "half") -> tuple[int, ...]:
    """Every bucket size the repack ladder can visit from a ``c0``-row
    buffer: c0 plus `_round_up_bucket`'s image over smaller counts."""
    vals = {c0}
    n = 1
    while n < c0:
        b = _round_up_bucket(n, min_bucket, ladder)
        if b < c0:
            vals.add(b)
        n = b + 1
    return tuple(sorted(vals, reverse=True))


def _round_up_bucket(n: int, min_bucket: int, ladder: str = "half") -> int:
    """Smallest ladder size >= n.

    "half": {2^k, 3*2^(k-1)} (padding <= 33%); "quarter": {2^k, 1.25x,
    1.5x, 1.75x} (<= 25%); "eighth": all 2^k + i*2^(k-3) (<= 12.5%);
    "sixteenth": all 2^k + i*2^(k-4) (<= 6.25%). Because the scheduler
    repacks exactly when the ladder would shrink a rung, the spacing also
    bounds how long converged rows keep sampling."""
    b = max(min_bucket, 1)
    while b < n:
        if ladder == "sixteenth" and b >= 128:
            for i in range(1, 16):
                m = b + i * (b // 16)
                if m >= n:
                    return m
        elif ladder in ("eighth", "sixteenth") and b >= 64:
            for i in range(1, 8):
                m = b + i * (b // 8)
                if m >= n:
                    return m
        elif ladder in ("quarter", "eighth", "sixteenth") and b >= 32:
            for m in (b + b // 4, b + b // 2, b + 3 * (b // 4)):
                if m >= n:
                    return m
        elif b >= 16:
            b2 = b + b // 2
            if b2 >= n:
                return b2
        b *= 2
    return b


# ---------------------------------------------------------------------------
# The scheduler (pure host logic over injected device ops)
# ---------------------------------------------------------------------------

CONTINUE, REPACKED, STOP = 0, 1, 2


class AdaptiveScheduler:
    """Plans sync groups and repack/stop/drain decisions for one
    adaptive-labeling run.

    ``ops`` provides every device effect (the protocol `_TorchOps`
    implements; tests inject fakes):

    - ``buffer_len() -> int`` — rows in the current device buffer
    - ``run_rounds(nb, step, n_rounds, n_samples_first, chunk_offset)
      -> handle`` — dispatch ``n_rounds`` same-plan rounds; returns an
      opaque done-count handle (state after the last round)
    - ``start_transfer(handle)`` — begin the async device->host copy
    - ``resolve(handle) -> int`` — block on the done count
    - ``emit()`` — scatter frozen labels into the output buffers
    - ``flush(n_samples)`` — at-cap tail flush into the output buffers
    - ``pack(bucket) -> handle`` — repack active rows into ``bucket``
      slots; returns an async exact-active-count handle
    - ``resolve_active(handle) -> int`` — block on that count
    - ``bookkeeping(n_samples, chunk_offset, num_real, rnd)`` —
      checkpoint hook (called at most once per handled count)
    - ``progress(num_left, n_samples, rnd)`` — observability hook

    The scheduler can be resumed mid-run from its counters. `step()`
    processes ONE sync group (dispatch + count handling) so callers can
    interleave several runs; `run()` loops step() to completion and
    drains. Each step is a ``driver/step`` span, its plan a
    ``driver/plan`` span (`utils.profiling.span`).
    """

    def __init__(
        self,
        cfg: AdaptiveConfig,
        ops,
        *,
        num_real: int,
        impl: str,
        n_sample: int = 1,
        n_shards: int = 1,
        n_samples: int = 0,
        chunk_offset: int = 0,
        rnd: int = 0,
        checkpoint_every: int = 0,
        sync_samples: int | None = None,  # None -> sync_samples_for(cfg)
        pipeline_work: int = PIPELINE_WORK,
        eager_resolve: bool = False,
    ) -> None:
        self.cfg = cfg
        self.ops = ops
        self.impl = impl
        self.n_sample = n_sample
        self.n_shards = n_shards
        self.num_real = num_real
        self.n_samples = n_samples
        self.chunk_offset = chunk_offset
        self.rnd = rnd
        self.checkpoint_every = checkpoint_every
        self.sync_samples = (
            sync_samples if sync_samples is not None
            else sync_samples_for(cfg.schedule)
        )
        self.pipeline_work = pipeline_work
        # Eager mode: handle the in-flight count at the TOP of step(),
        # BEFORE planning the next group, so a repack always lands before
        # the group it could have shrunk and no resolved count is ever
        # discarded. The resolve may block; sibling interleaved runs keep
        # the device busy meanwhile, so `run_interleaved` turns this on
        # and the serial drivers leave it off. Deterministic by
        # construction (no readiness probing).
        self.eager_resolve = eager_resolve
        self._inflight = None   # pipelined done-count handle (one group stale)
        self._pending_active = None  # async exact-active-count from last pack
        self._stopped = False
        self._drained = False

    # -- state inspection (cross-batch pipelining + tests) ---------------
    @property
    def finished(self) -> bool:
        """The loop guard is exhausted (drain may still be pending)."""
        return (
            self._stopped
            or self.num_real <= 0
            or self.n_samples >= self.cfg.max_samples
        )

    def _bookkeeping(self) -> None:
        if self.checkpoint_every:
            self.ops.bookkeeping(
                self.n_samples, self.chunk_offset, self.num_real, self.rnd
            )

    def _bucket_for(self, est_active: int) -> int:
        """Shard-aligned ladder bucket for ``est_active`` rows, capped at
        the current buffer (a repack never grows the buffer)."""
        bucket = _round_up_bucket(
            est_active, self.cfg.min_active, self.cfg.ladder
        )
        return min(
            -(-bucket // self.n_shards) * self.n_shards, self.ops.buffer_len()
        )

    def _handle(self, num_done: int) -> int:
        """Bookkeeping for one resolved done count.

        ``num_done`` may be one sync group STALE: labels freeze on device
        at the exact round the criterion holds, so a stale count only
        delays repack/exit decisions, never changes a label, and it
        UNDERCOUNTS done rows, so the bucket it sizes can only be too
        roomy.

        Repack policy: emit + repack exactly when the ladder bucket for
        the remaining active rows is SMALLER than the current buffer (or
        the cap/empty-pool stop paths fire). A repack that cannot shrink
        the buffer saves no slots; waiting past the next rung boundary
        keeps converged rows sampling, a waste bounded by the rung
        spacing.
        """
        cfg = self.cfg
        if self._pending_active is not None:
            # Exact active count from the last repack replaces the
            # provisional stale-safe overestimate.
            self.num_real = self.ops.resolve_active(self._pending_active)
            self._pending_active = None
            if self.num_real == 0:
                return STOP  # buffer is pure padding; everything emitted
        self.ops.progress(
            max(self.num_real - num_done, 0), self.n_samples, self.rnd
        )
        at_cap = self.n_samples >= cfg.max_samples
        if num_done == 0 and not at_cap:
            self._bookkeeping()
            return CONTINUE
        est_active = max(self.num_real - num_done, 0)
        if (
            not at_cap
            and est_active > 0
            and self._bucket_for(est_active) >= self.ops.buffer_len()
        ):
            # Repacking cannot shrink the buffer yet: converged rows keep
            # sampling (their labels are frozen).
            self._bookkeeping()
            return CONTINUE

        # Emit + repack, all on device: the host reads ONE scalar (the
        # exact active count).
        self.ops.emit()
        if at_cap:
            self.ops.flush(self.n_samples)
            self.num_real = 0
            return STOP
        if est_active == 0:
            self.num_real = 0
            return STOP
        # Async: the exact count resolves at the NEXT sync; until then the
        # stale-safe overestimate stands in.
        self._pending_active = self.ops.pack(self._bucket_for(est_active))
        self.num_real = est_active
        self._bookkeeping()
        return REPACKED

    def plan_group(self) -> tuple[list[tuple[int, int]], int]:
        """The next sync group: [(n_batch, step), ...] and its work in
        sample-slots. Accumulates rounds until ~sync_samples of device
        work (or the checkpoint cadence)."""
        group: list[tuple[int, int]] = []
        work = 0
        sim_n = self.n_samples
        buf = self.ops.buffer_len()
        while sim_n < self.cfg.max_samples:
            nb, step = est._plan_round(self.cfg, sim_n, self.n_sample, self.impl)
            sim_n += nb
            group.append((nb, step))
            work += nb * buf
            if work >= self.sync_samples or (
                self.checkpoint_every and len(group) >= self.checkpoint_every
            ):
                break
        return group, work

    def step(self) -> bool:
        """Dispatch ONE sync group and handle the pipelined readback.

        Returns False when the loop guard is exhausted (caller should
        `drain()`); True to keep stepping.
        """
        if self.finished:
            return False
        with span("driver/step"):
            return self._step()

    def _step(self) -> bool:
        if self.eager_resolve and self._inflight is not None:
            # Eager path: consume the previous group's count before
            # planning, so any repack shrinks THIS group's buffer.
            action = self._handle(self.ops.resolve(self._inflight))
            self._inflight = None
            if action == STOP:
                self._stopped = True
                return False
            if self.finished:
                return False
        with span("driver/plan"):
            group, work = self.plan_group()
        handle = None
        # Coalesce maximal same-plan runs into ONE multi-round dispatch
        # each: round tags and convergence checkpoints advance exactly as
        # per-round dispatches would.
        idx = 0
        while idx < len(group):
            nb, step = group[idx]
            count = 1
            while idx + count < len(group) and group[idx + count] == (nb, step):
                count += 1
            handle = self.ops.run_rounds(
                nb, step, count, self.n_samples + nb, self.chunk_offset
            )
            self.n_samples += nb * count
            self.chunk_offset += (nb // step) * count
            self.rnd += count
            idx += count
        self.ops.start_transfer(handle)
        if self._inflight is not None:
            # Pipelined readback: group k's count resolves while group k+1
            # is already queued.
            action = self._handle(self.ops.resolve(self._inflight))
            self._inflight = None
            if action == STOP:
                self._stopped = True
                return False
            if action == REPACKED:
                # The just-dispatched group's count refers to the
                # pre-repack buffer — discard it.
                return not self.finished
        if self.eager_resolve:
            # The count is consumed at the next step's top, before any
            # further dispatch.
            self._inflight = handle
            return not self.finished
        resolve_now = work >= self.pipeline_work
        if not resolve_now and self.n_samples < self.cfg.max_samples:
            # Schedule cliff: if the NEXT round is expensive, resolve this
            # group's count NOW so a repack can land before it.
            nb_next, _ = est._plan_round(
                self.cfg, self.n_samples, self.n_sample, self.impl
            )
            resolve_now = nb_next * self.ops.buffer_len() >= self.pipeline_work
        if resolve_now:
            action = self._handle(self.ops.resolve(handle))
            if action == STOP:
                self._stopped = True
                return False
        else:
            self._inflight = handle
        return not self.finished

    def drain(self) -> None:
        """Resolve the final group's count (or run bookkeeping once more
        after a repack consumed it) so converged rows emit and the at-cap
        tail flush runs. Idempotent."""
        if self._drained:
            return
        self._drained = True
        if not self._stopped and self.num_real > 0:
            if self._inflight is not None:
                self._handle(self.ops.resolve(self._inflight))
                self._inflight = None
            else:
                # A repack consumed the last count; the state still holds
                # frozen-but-unemitted labels (and possibly an at-cap tail).
                self._handle(self.num_real)

    def run(self) -> None:
        while self.step():
            pass
        self.drain()


# ---------------------------------------------------------------------------
# Real device ops
# ---------------------------------------------------------------------------


class _CopyToHost:
    """An asynchronous device->host copy of one tensor (pinned + event on
    CUDA, a plain view on the CPU)."""

    def __init__(self, t: torch.Tensor) -> None:
        self.event = None
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class _TorchOps:
    """`AdaptiveScheduler` ops backed by torch tensors on one device. Each
    op is a span: ``round/dispatch`` (counting its
    rounds), ``driver/readback`` (counting 1), ``driver/repack`` and
    ``driver/checkpoint``. ``table``: the fused kernel's table of
    ``state.active`` (`estimator.pack_round_table`), gathered at each
    repack; None = each round packs its own."""

    def __init__(self, key, state: _LoopState, outs: _OutState,
                 robot_wh: torch.Tensor, cfg: AdaptiveConfig, *, impl: str,
                 acc_bins: tuple, bin_acc: tuple, shape_noise: bool = True,
                 poly_a_keep: tuple[int, ...] | None = None,
                 ca: tuple[int, float] = (48, 1e-4), progress=None,
                 checkpoint_write=None, mesh=None, table=None) -> None:
        self.key = key
        self.state = state
        self.table = table
        self.outs = outs
        self.robot_wh = robot_wh
        self.cfg = cfg
        self.impl = impl
        self.acc_bins = acc_bins
        self.bin_acc = bin_acc
        self.shape_noise = shape_noise
        self.poly_a_keep = poly_a_keep
        # trajectory batches: the effective advancement budget and tolerance
        self.ca_iters, self.ca_tol = ca
        self._progress = progress
        self._checkpoint_write = checkpoint_write
        # Rounds' counts run sharded over this mesh; the state stays here.
        self.mesh = mesh
        # Device sample-slots dispatched so far (n_batch x rounds x buffer
        # rows, padding and post-freeze rows included).
        self.dispatched_slots = 0

    def buffer_len(self) -> int:
        return int(self.state.uids.shape[0])

    def run_rounds(self, nb, step, n_rounds, n_samples_first, chunk_offset):
        self.dispatched_slots += int(nb) * int(n_rounds) * self.buffer_len()
        with span("round/dispatch", count=int(n_rounds)):
            self.state, num_done = est._fused_round(
                self.key, self.state, self.robot_wh, chunk_offset,
                n_samples_first, n_rounds, nb, nb // step,
                step_samples=step, impl=self.impl,
                accuracy_bins=self.acc_bins, bin_accuracy=self.bin_acc,
                use_vertices=self.cfg.use_vertices, shape_noise=self.shape_noise,
                poly_a_keep=self.poly_a_keep, ca_iters=self.ca_iters,
                ca_tol=self.ca_tol, screen_impl=self.cfg.screen_impl,
                mesh=self.mesh, table=self.table,
            )
            return _CopyToHost(num_done)

    def start_transfer(self, handle: _CopyToHost) -> None:
        """Nothing to do: the copy started when the handle was made."""

    def resolve(self, handle: _CopyToHost) -> int:
        with span("driver/readback", count=1):
            return int(handle.numpy())

    resolve_active = resolve

    def emit(self) -> None:
        with span("driver/repack"):
            self.outs = _emit_to_out(self.state, self.outs)

    def flush(self, n_samples) -> None:
        with span("driver/repack"):
            self.outs = _flush_to_out(self.state, self.outs, n_samples)

    def pack(self, bucket) -> _CopyToHost:
        with span("driver/repack"):
            self.state, num_active, self.table = _pack_active(
                self.state, bucket=bucket, table=self.table)
            return _CopyToHost(num_active)

    def progress(self, num_left, n_samples, rnd) -> None:
        if self._progress is not None:
            self._progress(num_left=num_left, n_samples=n_samples, round=rnd)

    def bookkeeping(self, n_samples, chunk_offset, num_real, rnd) -> None:
        """Checkpoint hook: read the loop state and the output buffers back
        (without the discard slot, so the file has JAX's C rows) and write
        them with the scheduler's counters. The scheduler calls this only
        when ``checkpoint_every`` is set."""
        if self._checkpoint_write is None:
            return
        c = self.outs.k.shape[0] - 1
        # a copy on every device: the rounds update the state in place
        host = lambda a: a.to("cpu", copy=True).numpy()  # noqa: E731
        with span("driver/checkpoint"):
            self._checkpoint_write(
                out_k=host(self.outs.k[:c]), out_nn=host(self.outs.n[:c]),
                out_flag=host(self.outs.flag[:c]), uids=host(self.state.uids),
                n_true=host(self.state.n_true), done=host(self.state.done),
                k_frozen=host(self.state.k_frozen),
                n_frozen=host(self.state.n_frozen),
                active=[host(a) for a in self.state.active],
                n_samples=n_samples, chunk_offset=chunk_offset,
                num_real=num_real, round=rnd,
            )


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def _resolve_trajectory(configs, cfg: AdaptiveConfig) -> tuple[str, tuple[int, float]]:
    """The run's impl and effective (ca_iters, ca_tol).

    Static batches: `resolve_impl` ('auto' = the fused kernel). Trajectory
    batches follow the JAX driver on a TPU (driver.py:956-1004, 'pallas'
    read as 'cuda', 'jnp' as 'threefry'), with one readback of
    ``any(omega != 0)``:

    - translation-only batches compile the advancement out (ca_iters = 0):
      rectangles run kernel 13 on its exact window, and k-gons run kernel
      14. JAX keeps k-gons on jnp for its uid-keyed, compaction-invariant
      streams; the port's Philox kernels have those too, and the window
      is the same exact predicate on both paths;
    - rotating rectangle batches under 'auto' run the threefry screened
      cascade (its stage A is kernel 15 on the card): kernel 13's pure
      advancement misses grazes the cascade's eroded certificates count,
      so 'auto' does not switch predicates. An explicit 'cuda' runs
      kernel 13 with its advancement loop;
    - rotating k-gon batches run the threefry cascade; an explicit 'cuda'
      raises (kernel 14 has no advancement loop)."""
    impl = resolve_impl(cfg.impl)
    ca = (int(cfg.ca_iters), float(cfg.ca_tol))
    if not isinstance(configs, (MovingConfigs, MovingPolygonConfigs)):
        return impl, ca
    if ca[0] > 0:
        with span("driver/readback", count=1):
            rotating = bool((configs.omega != 0.0).any())
        if not rotating:
            return impl, (0, ca[1])
    if ca[0] > 0 and isinstance(configs, MovingPolygonConfigs):
        if cfg.impl == "cuda":
            raise ValueError(
                "impl='cuda' supports only translation-only MovingPolygonConfigs "
                "batches (this batch has rotating rows; rotating trajectory "
                "k-gons run the threefry CA path — use 'threefry' or 'auto')")
        return "threefry", ca
    if isinstance(configs, MovingConfigs) and cfg.impl == "auto":
        return "threefry", ca
    return impl, ca


def adaptive_collision_probabilities(
    key, configs, robot_wh, cfg: AdaptiveConfig = AdaptiveConfig(), *,
    progress=None, checkpoint_path=None, checkpoint_every: int = 0, mesh=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Label every configuration to its bin's CI accuracy target.

    Returns (cp float32, n_samples_used int64, converged bool) as host
    numpy arrays in the ORIGINAL configuration order (uids play the role
    of the reference's index column, compute_collision_probability.cu:
    337-344).

    Checkpoint / resume: with ``checkpoint_path`` and ``checkpoint_every``
    > 0 the loop state is written every that many rounds, and a later
    call with the same key, row count and configuration type resumes from
    the file (any other file is ignored); a clean finish deletes it. Both
    estimator paths key their streams by (key, uid, sample index), so a
    resumed run's labels are bitwise an uninterrupted run's.

    Several devices: pass a `parallel.make_mesh` (or `global_mesh`) mesh.
    Each round's counts then run over its config blocks and sample shards
    (`estimator._cuda_sharded_counts` on the kernel path,
    `estimator._sample_sharded_counts` on the threefry path) and come back
    to ``configs``' device, where the state, the stopping rule, repacks and
    checkpoints stay. Both paths key their streams by uid and sample index
    or step tag, so BOTH mesh axes are value-level no-ops: the labels equal
    an unsharded run's bit for bit, and ``impl='auto'`` keeps the kernel
    (JAX's 'auto' falls back to jnp under a mesh, driver.py:901-909, only
    because its kernel streams are tied to block position). A checkpoint
    written under a mesh is the file an unsharded run writes."""
    run = AdaptiveRun(key, configs, robot_wh, cfg, progress=progress,
                      checkpoint_path=checkpoint_path,
                      checkpoint_every=checkpoint_every, mesh=mesh)
    run.scheduler.run()
    return run.materialize()


class AdaptiveRun:
    """One adaptive labeling run: device-state set-up (or its restore from
    a checkpoint), a scheduler over `_TorchOps`, and the final
    materialize. An object, so the dataset pipeline can interleave the
    sync groups of several runs. ``mesh``: as
    `adaptive_collision_probabilities`'s. Each blocking read of the
    device is a ``driver/readback`` span."""

    def __init__(self, key, configs, robot_wh,
                 cfg: AdaptiveConfig = AdaptiveConfig(), *,
                 progress=None, checkpoint_path=None,
                 checkpoint_every: int = 0, mesh=None) -> None:
        if checkpoint_every < 0:
            raise ValueError(f"checkpoint_every must be >= 0, got {checkpoint_every}")
        c = configs.num
        device = configs.position.device
        self.C = c
        self.configs = configs
        self.checkpoint_path = checkpoint_path
        acc_bins = tuple(float(b) for b in cfg.accuracy_bins)
        bin_acc = tuple(float(b) for b in cfg.bin_accuracy)
        impl, ca = _resolve_trajectory(configs, cfg)
        is_poly = isinstance(configs, (est.PolygonConfigs, MovingPolygonConfigs))
        shape_noise = True
        poly_a_keep = None
        if impl == "cuda" and is_poly:
            # The k-gon kernels' robot-axis subset, from the robot vertices
            # while they are still on the host (no readback).
            host = (robot_wh.detach().cpu().numpy()
                    if isinstance(robot_wh, torch.Tensor) else robot_wh)
            poly_a_keep = dedup_robot_axes(host)
        elif impl == "cuda":
            # With every w/h sigma zero (the reference default,
            # generate_dataset.cu:285-290), the rectangle kernels draw 3
            # normals per sample instead of 5. One scalar readback at run
            # start; k-gon batches have no shape sigmas.
            with span("driver/readback", count=1):
                shape_noise = bool((configs.std_dev[:, 3:] != 0.0).any())
        robot_wh = torch.as_tensor(robot_wh, dtype=torch.float32, device=device)
        n_sample = est._mesh_axis(mesh, "sample")
        self.n_shards = est._mesh_axis(mesh, "config")
        state, num_real = self._initial_state(configs, robot_wh, cfg)
        outs = _OutState(
            k=torch.zeros((c + 1,), dtype=torch.int32, device=device),
            n=torch.zeros((c + 1,), dtype=torch.int32, device=device),
            flag=torch.zeros((c + 1,), dtype=torch.bool, device=device),
        )
        counters = dict(n_samples=0, chunk_offset=0, rnd=0)
        key_data = np.asarray(key, np.uint32).ravel()
        cfg_type = type(configs).__name__
        if checkpoint_path is not None and state is not None:
            # An all-pruned run has no buffer and nothing to resume.
            ckpt = _load_checkpoint(checkpoint_path, key_data, c, cfg_type=cfg_type)
            if ckpt is not None:
                state, outs, num_real, counters = _restored(ckpt, configs)
        table = None if state is None else est.pack_round_table(
            state.active, robot_wh, impl=impl, mesh=mesh, poly_a_keep=poly_a_keep)
        checkpoint_write = None
        if checkpoint_path is not None and checkpoint_every:
            def checkpoint_write(**kw):
                _save_checkpoint(checkpoint_path, key_data, c, cfg_type=cfg_type, **kw)
        self.ops = _TorchOps(
            key, state, outs, robot_wh, cfg, impl=impl, acc_bins=acc_bins,
            bin_acc=bin_acc, shape_noise=shape_noise, poly_a_keep=poly_a_keep,
            ca=ca, progress=progress, checkpoint_write=checkpoint_write,
            mesh=mesh, table=table,
        )
        self.scheduler = AdaptiveScheduler(cfg, self.ops, num_real=num_real,
                                           impl=impl, n_sample=n_sample,
                                           n_shards=self.n_shards,
                                           checkpoint_every=checkpoint_every,
                                           **counters)
        self._host_outs = None

    def _initial_state(self, configs, robot_wh: torch.Tensor,
                       cfg: AdaptiveConfig) -> tuple[_LoopState | None, int]:
        """The loop's first buffer and its count of real rows.

        With ``cfg.prune_sigma > 0`` (one mask readback), rows that
        `possible_collision_mask` rules out are marked done with cp = 0
        and zero samples and never enter the loop; the kept rows start in
        a ladder bucket padded with uid -1, their uids the original row
        ids, so their labels equal an unpruned run's. When every row is
        pruned there is no buffer (None) and the scheduler stops at once.
        """
        c = configs.num
        device = configs.position.device
        self.pruned = None
        if cfg.prune_sigma > 0:
            from collide2d_tpu_torch.ops.broad_phase import possible_collision_mask

            keep = possible_collision_mask(configs, robot_wh, cfg.prune_sigma)
            with span("driver/readback", count=1):
                keep = keep.cpu().numpy()
            self.pruned = ~keep
            keep0 = np.flatnonzero(keep)
            if keep0.size == 0:
                return None, 0
            # Shard-aligned, as the scheduler's repack buckets.
            shards = self.n_shards
            bucket = min(
                -(-_round_up_bucket(keep0.size, cfg.min_active, cfg.ladder)
                  // shards) * shards,
                -(-c // shards) * shards,
            )
            pad0 = np.concatenate([keep0, np.full(bucket - keep0.size, keep0[0])])
            gather = torch.as_tensor(pad0, dtype=torch.int64, device=device)
            real = torch.arange(bucket, device=device) < keep0.size
            uids = torch.where(real, gather, -1).to(torch.int32)
            active = type(configs)(*(a.index_select(0, gather) for a in configs))
            done = ~real
            num_real = int(keep0.size)
        else:
            uids = torch.arange(c, dtype=torch.int32, device=device)
            active = configs
            done = torch.zeros((c,), dtype=torch.bool, device=device)
            num_real = c
        n = uids.shape[0]
        state = _LoopState(
            uids=uids,
            active=active,
            n_true=torch.zeros((n,), dtype=torch.int32, device=device),
            done=done,
            k_frozen=torch.zeros((n,), dtype=torch.int32, device=device),
            n_frozen=torch.ones((n,), dtype=torch.int32, device=device),
        )
        return state, num_real

    def pipeline_ready(self) -> bool:
        """True once this run's initial phase has been DISPATCHED — the
        earliest point a pipelined driver admits the next batch (a
        scheduling hint only: it never touches keys, buffers or plans)."""
        s = self.scheduler
        return s.finished or s.n_samples >= max(1, s.cfg.initial_phase_samples)

    def prefetch_outputs(self) -> None:
        """Drain, then start the device->host copy of the output buffers
        without blocking; `materialize` completes it."""
        self.scheduler.drain()
        if self._host_outs is None:
            self._host_outs = [_CopyToHost(a) for a in self.ops.outs]

    def materialize(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Read the output buffers once, delete the checkpoint of a clean
        finish and assemble the host arrays (k/n division in float32 on
        the host)."""
        self.prefetch_outputs()
        with span("driver/readback", count=1):
            k_np, n_np, f_np = (h.numpy()[: self.C] for h in self._host_outs)
        if self.checkpoint_path is not None:
            try:
                os.remove(self.checkpoint_path)
            except FileNotFoundError:
                pass
        out_cp = np.zeros((self.C,), np.float32)
        out_n = np.zeros((self.C,), np.int64)
        written = n_np > 0
        out_cp[written] = k_np[written].astype(np.float32) / n_np[
            written
        ].astype(np.float32)
        out_n[written] = n_np[written]
        done = f_np.copy()
        if self.pruned is not None:
            done[self.pruned] = True  # cp 0, no samples
        return out_cp, out_n, done


def run_interleaved(makers, overlap: int, on_done, *,
                    eager_resolve: bool = True) -> None:
    """Drive several `AdaptiveRun`s with their sync groups interleaved.

    ``makers``: ordered zero-arg callables, each creating a fresh
    ``(tag, run)`` pair when the pipeline admits it; ``overlap``: max runs
    in flight; ``on_done(tag, run)``: called as runs complete, in
    submission order. A new run is admitted once the NEWEST in-flight run
    has dispatched its initial phase (`AdaptiveRun.pipeline_ready`). The
    next maker runs on a prefetch thread as soon as the previous
    admission happens (a ``pipeline/make_batch`` span; the main thread's
    wait for it is ``pipeline/admit_wait``, each ``on_done`` a
    ``pipeline/finish`` span); a finished run's output copy starts
    asynchronously (`prefetch_outputs`) and its ``on_done`` is deferred
    by one iteration. Labels do not depend on the interleaving: both
    estimator paths key their streams by (batch key, uid, round or step
    tag, sample index).
    """
    pending = list(makers)
    runs: list[tuple] = []
    finished: list[tuple] = []
    prefetch: dict = {"thread": None, "box": None}

    def make(maker):
        with span("pipeline/make_batch"):
            return maker()

    def start_prefetch():
        if pending and prefetch["thread"] is None:
            maker, box = pending[0], {}

            def work():
                try:
                    box["made"] = make(maker)
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    box["error"] = e

            t = threading.Thread(target=work, daemon=True)
            t.start()
            prefetch.update(thread=t, box=box)

    while runs or pending or finished:
        if pending and (
            not runs
            or (len(runs) < max(1, overlap) and runs[-1][1].pipeline_ready())
        ):
            if prefetch["thread"] is None:
                runs.append(make(pending.pop(0)))
            else:
                pending.pop(0)
                with span("pipeline/admit_wait"):
                    prefetch["thread"].join()
                box = prefetch["box"]
                prefetch.update(thread=None, box=None)
                if "error" in box:  # maker failed on the prefetch thread:
                    raise box["error"]  # surface the REAL traceback here
                runs.append(box["made"])
            runs[-1][1].scheduler.eager_resolve = bool(eager_resolve)
            start_prefetch()
        # Step the OLDEST run first (runs complete in order), then give
        # every younger run one sync group so its rounds queue behind.
        alive = runs[0][1].scheduler.step() if runs else False
        for _, r in runs[1:]:
            r.scheduler.step()
        if finished:
            with span("pipeline/finish"):
                on_done(*finished.pop(0))
        if runs and not alive:
            tag, r = runs.pop(0)
            r.prefetch_outputs()
            finished.append((tag, r))


# ---------------------------------------------------------------------------
# Checkpoint files (the JAX package's format)
# ---------------------------------------------------------------------------


def _save_checkpoint(path, key_data, n_configs, *, active, cfg_type: str,
                     **state) -> None:
    """Write one checkpoint atomically: a temporary file named for this
    process (two processes checkpointing one path cannot replace each
    other's half-written file), then ``os.replace``. The fields and dtypes
    are the JAX package's: ``cfg_type`` is the configuration class's name
    and the configuration fields go by position (``active_len``,
    ``active_{i}``), so trajectory types keep all 7. A file that cannot be
    written raises."""
    tmp = f"{path}.tmp.{os.getpid()}.npz"  # ends in .npz: savez keeps the name
    np.savez(
        tmp,
        key_data=key_data,
        n_configs=n_configs,
        cfg_type=np.str_(cfg_type),
        active_len=np.int64(len(active)),
        **{f"active_{i}": a for i, a in enumerate(active)},
        **state,
    )
    os.replace(tmp, path)


def _load_checkpoint(path, key_data, n_configs, cfg_type: str = "Configs"):
    """The fields of the checkpoint at ``path``, or None when there is
    none or it belongs to another run: another key, row count or
    configuration type, an unreadable file, or an older format (missing
    fields, such as the 4 named configuration fields the JAX package wrote
    before trajectories)."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            if (
                z["n_configs"] != n_configs
                or z["key_data"].shape != key_data.shape
                or not (z["key_data"] == key_data).all()
                or str(z["cfg_type"]) != cfg_type
            ):
                return None
            return {
                "out_k": z["out_k"],
                "out_nn": z["out_nn"],
                "out_flag": z["out_flag"],
                "uids": z["uids"],
                "n_true": z["n_true"],
                "done": z["done"],
                "k_frozen": z["k_frozen"],
                "n_frozen": z["n_frozen"],
                "active": [z[f"active_{i}"] for i in range(int(z["active_len"]))],
                "n_samples": z["n_samples"],
                "chunk_offset": z["chunk_offset"],
                "num_real": z["num_real"],
                "round": z["round"],
            }
    except (OSError, KeyError, ValueError):
        return None


def _restored(ckpt: dict, configs) -> tuple[_LoopState, _OutState, int, dict]:
    """Device state, output buffers (with the discard slot appended), the
    count of real rows and the scheduler's counters of a loaded
    checkpoint, on ``configs``' device.

    The real-row count is recomputed from the uids: the stored one may be
    the provisional overestimate the asynchronous repack runs on, and it
    must count done-but-unemitted rows too (the scheduler subtracts the
    done count itself), or the next repack bucket is sized too small and
    active rows are dropped."""
    device = configs.position.device

    def dev(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def with_sink(a, dtype):
        return torch.cat([dev(a, dtype), torch.zeros((1,), dtype=dtype, device=device)])

    state = _LoopState(
        uids=dev(ckpt["uids"], torch.int32),
        active=type(configs)(*(dev(a, f.dtype) for a, f in zip(ckpt["active"], configs))),
        n_true=dev(ckpt["n_true"], torch.int32),
        done=dev(ckpt["done"], torch.bool),
        k_frozen=dev(ckpt["k_frozen"], torch.int32),
        n_frozen=dev(ckpt["n_frozen"], torch.int32),
    )
    outs = _OutState(k=with_sink(ckpt["out_k"], torch.int32),
                     n=with_sink(ckpt["out_nn"], torch.int32),
                     flag=with_sink(ckpt["out_flag"], torch.bool))
    num_real = int((np.asarray(ckpt["uids"]) >= 0).sum())
    counters = dict(n_samples=int(ckpt["n_samples"]),
                    chunk_offset=int(ckpt["chunk_offset"]), rnd=int(ckpt["round"]))
    return state, outs, num_real, counters
