"""The adaptive loop's round update: the round epilogue kernel and its plain
version.

After each round's counts, every row of the adaptive loop's buffer
(`mc.estimator._LoopState`) takes the round: its running collision count
grows by the round's counts, the stopping rule of `mc.stats` is tested at
the round's cumulative sample count, and a row whose rule holds for the
first time freezes its label (``k_frozen``, ``n_frozen``). On the last
round of a same-plan run the done real rows (``uids >= 0``) are counted
too: the count the driver reads back.

`round_update` routes on the state's device:

- a CUDA tensor launches ``csrc/round_epilogue.cu`` (built at first use by
  `utils.cuda_build`), which updates the state IN PLACE and returns the
  same tensors, and counts the launch in ``LAUNCHES``; a failed build or
  launch raises. A round is then this one launch (and, on a run's last
  round, one 4-byte memset of the done count);
- a CPU tensor runs `round_update_plain`, the same update in torch
  operations, in place too.

Both give the same bits: the kernel's per-row arithmetic is
``csrc/round_epilogue.cuh``, which tests/test_torch_round_epilogue.py
compiles with g++ and holds to `mc.stats` bit for bit. No TPU kernel
corresponds: the JAX package leaves this step to XLA's fusion.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from collide2d_tpu_torch.mc import stats
from collide2d_tpu_torch.utils import cuda_build

_KERNEL = "round_epilogue"
# Launches of the CUDA kernel in this process (never the plain version).
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def round_update_plain(n_true, done, k_frozen, n_frozen, counts, n_after: int,
                       accuracy_bins, bin_accuracy, uids=None):
    """The round's update in torch operations, on any device, in place as
    the kernel's: returns ``(n_true, done, k_frozen, n_frozen, num_done)``,
    the first four the tensors given. ``counts`` None: the round's counts
    are already in ``n_true``. ``num_done``: the done real rows (``uids >=
    0``), an int32 scalar tensor, when ``uids`` is given, else None."""
    if counts is not None:
        n_true.add_(counts)
    conv = stats.is_converged(n_after, n_true, accuracy_bins, bin_accuracy)
    newly = conv & ~done
    done.logical_or_(conv)
    k_frozen.copy_(torch.where(newly, n_true, k_frozen))
    n_frozen.masked_fill_(newly, n_after)
    num_done = None if uids is None else (done & (uids >= 0)).sum(dtype=torch.int32)
    return n_true, done, k_frozen, n_frozen, num_done


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    lib = cuda_build.load(_KERNEL)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.round_epilogue_launch.restype = i
    lib.round_epilogue_launch.argtypes = [p, p, p, p, p, p, p, i, ctypes.c_int32,
                                          f, f, f, i, p, p, p]
    lib.round_epilogue_max_bins.restype = i
    lib.round_epilogue_max_bins.argtypes = []
    return lib


def stop_rule(accuracy_bins, bin_accuracy) -> tuple[float, float, tuple, tuple]:
    """The stopping rule's kernel arguments, each the float32 rounding of
    `mc.stats`' Python value: (z, ln(1/alpha), bin edges, bin targets)."""
    if len(bin_accuracy) != len(accuracy_bins) - 1 or not bin_accuracy:
        raise ValueError(f"need one target per bin, got edges {accuracy_bins} "
                         f"and targets {bin_accuracy}")
    return (stats._f32(stats.Z_SCORE), stats._f32(stats._LOG_INV_ALPHA),
            tuple(stats._f32(b) for b in accuracy_bins),
            tuple(stats._f32(a) for a in bin_accuracy))


@functools.lru_cache(maxsize=64)
def _rule(accuracy_bins: tuple, bin_accuracy: tuple):
    """`stop_rule` as the launcher takes it: (z, ln(1/alpha), bin count,
    edges and targets as host float arrays)."""
    z, lia, edges, targets = stop_rule(accuracy_bins, bin_accuracy)
    limit = _kernel_lib().round_epilogue_max_bins()
    if len(targets) > limit:
        raise ValueError(f"the round epilogue takes at most {limit} accuracy "
                         f"bins, got {len(targets)}")
    return (z, lia, len(targets), (ctypes.c_float * len(edges))(*edges),
            (ctypes.c_float * len(targets))(*targets))


def _check_inputs(n_true, done, k_frozen, n_frozen, counts, uids, n_after) -> None:
    ints = [n_true, k_frozen, n_frozen] + [t for t in (counts, uids) if t is not None]
    rows = n_true.shape
    if (any(t.dtype != torch.int32 or t.shape != rows for t in ints)
            or done.dtype != torch.bool or done.shape != rows or n_true.dim() != 1):
        raise ValueError("the round epilogue takes int32 (C,) n_true, k_frozen, "
                         "n_frozen, counts and uids and a bool (C,) done")
    if any(t.device != n_true.device for t in ints + [done]):
        raise ValueError("the round epilogue's tensors must share one device")
    if not all(t.is_contiguous() for t in ints + [done]):
        raise ValueError("the round epilogue's tensors must be contiguous")
    if not 0 < int(n_after) < 2**31:
        raise ValueError(f"n_after must be in (0, 2^31), got {n_after}")


def round_update(n_true, done, k_frozen, n_frozen, counts, n_after: int,
                 accuracy_bins, bin_accuracy, *, uids=None):
    """One round's update of the loop state: ``(n_true, done, k_frozen,
    n_frozen, num_done)`` as `round_update_plain` returns them.

    ``counts``: the round's int32 (C,) counts, or None when the fused
    counting kernel added them into ``n_true`` already. ``n_after``: the
    round's cumulative sample count. ``uids`` (the run's last round): also
    the count of done real rows, an int32 scalar tensor. The four state
    tensors are updated in place and returned: CUDA tensors launch the
    round epilogue kernel, CPU tensors run the plain version."""
    global LAUNCHES
    if n_true.device.type == "cpu":
        return round_update_plain(n_true, done, k_frozen, n_frozen, counts, n_after,
                                  accuracy_bins, bin_accuracy, uids)
    if n_true.device.type != "cuda":
        raise ValueError(f"unsupported device {n_true.device}")
    _check_inputs(n_true, done, k_frozen, n_frozen, counts, uids, n_after)
    rule = _rule(tuple(accuracy_bins), tuple(bin_accuracy))
    dev = n_true.device
    num_done = None if uids is None else torch.empty((), dtype=torch.int32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = cuda_build.launch(
        dev, _kernel_lib().round_epilogue_launch, ptr(counts), ptr(uids),
        n_true.data_ptr(), done.data_ptr(), k_frozen.data_ptr(), n_frozen.data_ptr(),
        ptr(num_done), int(n_true.shape[0]), int(n_after), stats._f32(n_after), *rule)
    if err != 0:
        raise RuntimeError(f"round_epilogue_launch failed: CUDA error {err}")
    LAUNCHES += 1
    return n_true, done, k_frozen, n_frozen, num_done
