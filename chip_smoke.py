"""Quickest proof that the PyTorch/CUDA port runs its main path on one GPU.

Run with no arguments from the repository root on a machine with an
NVIDIA H100 (sm_90a) and nvcc:

    python3 chip_smoke.py

Phases (each prints its result and seconds on its own line; any failure
raises, and the script then exits non-zero without printing a result):

1. the card's name and power limit (nvidia-smi); build the fused Monte
   Carlo kernel (collide2d_tpu_torch/csrc/mc_kernel.cu) from this checkout;
2. the kernel against its plain PyTorch version on the card, same Philox
   stream, C = 100,000 annulus configurations x n = 4096 samples, shape
   noise off and on, and the adaptive tail's 256 rows x 100,000 samples:
   sum |dcount| <= 1e-5 * C * n; samples/s of both, timed with CUDA
   events after a warm-up;
3. the main path: ``collide2d-torch generate --device cuda -n 2
   -b 100000 --seed 7`` at the default 64^4-row tables, 4e6 cap and
   reference bins, in process; two (100000, 5) float32 files with finite
   cp in [0, 1], kernel launches > 0, zero-probability share in
   [0.5, 0.7]; configs/s and mean samples per configuration;
4. the acceptance bar: ``ztest --cps_only true`` with another seed on the
   first 16,384 rows of batch 0, then ``compare``: mean |d| <= 1e-3 and a
   share within +-0.005 of at least 0.93;
5. stream invariance: ``generate -n 2 -b 16384`` with
   ``--overlap_batches 1`` and ``3`` at one seed give bitwise-equal files.

The second-to-last lines are the card (name, power limit) and one JSON
object describing each kernel of the path; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
C_CHECK, N_CHECK = 100_000, 4096
TAIL_ROWS, TAIL_SAMPLES = 256, 100_000
MISMATCH_BOUND = 1e-5


def _line(phase: str, seconds: float, **fields) -> None:
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{phase}] {body} seconds={seconds:.3f}", flush=True)


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def _quiet(fn, *args):
    """Run ``fn(*args)`` with its progress lines captured (returned)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args)
    return result, buf.getvalue()


def _events_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build():
    from collide2d_tpu_torch.utils import cuda_build

    t = time.monotonic()
    lib = cuda_build.library_path("mc_kernel")
    cuda_build.load("mc_kernel")
    _line("1 build", time.monotonic() - t, kernel="mc_kernel.cu", library=lib.name)


def phase_kernel_vs_plain() -> dict:
    from collide2d_tpu_torch.data.pipeline import GenerateConfig, _sample_tables
    from collide2d_tpu_torch.mc import prng
    from collide2d_tpu_torch.mc.estimator import Configs
    from collide2d_tpu_torch.mc.noise import sample_configuration_batch
    from collide2d_tpu_torch.ops import mc_cuda

    dev = torch.device("cuda")
    result = {}
    # (name, rows, samples, shape noise): the reference default and shape
    # noise at full batch width, then the adaptive tail's shape (min_active
    # rows, later_batch samples a round).
    cases = (("default", C_CHECK, N_CHECK, False),
             ("shape_noise", C_CHECK, N_CHECK, True),
             ("tail", TAIL_ROWS, TAIL_SAMPLES, False))
    for key, c, n, shape_noise in cases:
        t = time.monotonic()
        poses, variances = _sample_tables(GenerateConfig(
            num_poses=65_536, num_variances=65_536, shape_variance=shape_noise))
        cfg = GenerateConfig()
        pos, _, _, pose, sd = sample_configuration_batch(
            prng.PRNGKey(11), torch.as_tensor(poses, device=dev),
            torch.as_tensor(np.sqrt(variances), device=dev),
            num_configs=c, r_offset=cfg.r_offset, spread=cfg.spread)
        configs = Configs(pos, pose[:, 2], pose[:, :2], sd)
        params = mc_cuda.pack_mc_params(configs, cfg.robot_wh)
        uids = torch.arange(c, dtype=torch.int32, device=dev)
        seed = mc_cuda.round_seed(prng.PRNGKey(12), 3)
        got = mc_cuda.mc_counts(params, uids, seed, n, shape_noise=shape_noise)
        want = mc_cuda.mc_counts_plain(params, uids, seed, n,
                                       shape_noise=shape_noise, max_elems=1 << 24)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        total = int(diff.sum())
        if total > MISMATCH_BOUND * c * n:
            raise RuntimeError(
                f"kernel disagrees with its plain version: sum|dcount|={total} "
                f"> {MISMATCH_BOUND} * C * n ({key})")
        if not (0 < int(got.sum()) < c * n):
            raise RuntimeError("degenerate counts: all hits or none")
        kernel_ms = _events_ms(lambda: mc_cuda.mc_counts(
            params, uids, seed, n, shape_noise=shape_noise), reps=20)
        plain_ms = _events_ms(lambda: mc_cuda.mc_counts_plain(
            params, uids, seed, n, shape_noise=shape_noise,
            max_elems=1 << 24), reps=1)
        result[key] = dict(sum_abs_diff=total, max_abs_err=int(diff.max()),
                           rows_differ=int((diff > 0).sum()),
                           kernel_ms=kernel_ms, plain_ms=plain_ms)
        _line("2 kernel-vs-plain", time.monotonic() - t, case=key,
              shape_noise=shape_noise, C=c, n=n, sum_abs_dcount=total,
              rows_differ=result[key]["rows_differ"],
              kernel_ms=f"{kernel_ms:.4f}", plain_ms=f"{plain_ms:.2f}",
              kernel_samples_per_s=f"{c * n / kernel_ms * 1e3:.4e}",
              plain_samples_per_s=f"{c * n / plain_ms * 1e3:.4e}")
    return result


def _generate(argv):
    from collide2d_tpu_torch import cli
    from collide2d_tpu_torch.data.pipeline import generate_dataset

    return generate_dataset(cli.generate_config(cli.parse_args(["generate", *argv])))


def phase_main_path(work: Path) -> int:
    from collide2d_tpu_torch.ops import mc_cuda

    t = time.monotonic()
    data = work / "main"
    mc_cuda.reset_launches()
    stats, _ = _quiet(_generate, ["--device", "cuda", "-n", "2", "-b", "100000",
                                  "--seed", "7", "--data_dir", str(data)])
    torch.cuda.synchronize()
    launches = mc_cuda.LAUNCHES
    if launches <= 0:
        raise RuntimeError("the main path never launched the kernel")
    zero = []
    for i in range(2):
        rows = np.load(data / f"{i}.npy")
        if rows.shape != (100_000, 5) or rows.dtype != np.float32:
            raise RuntimeError(f"batch {i}: shape {rows.shape} dtype {rows.dtype}")
        cp = rows[:, 2]
        if not (np.isfinite(rows).all() and (cp >= 0).all() and (cp <= 1).all()):
            raise RuntimeError(f"batch {i}: cp not finite in [0, 1]")
        zero.append(float((cp == 0).mean()))
    zero_share = float(np.mean(zero))
    if not 0.5 <= zero_share <= 0.7:
        raise RuntimeError(f"zero-probability share {zero_share:.4f} not in [0.5, 0.7]")
    _line("3 generate", time.monotonic() - t, batches=2, batch_size=100_000,
          tables="64^4", setup_s=f"{stats.setup_seconds:.2f}",
          label_s=f"{stats.label_seconds:.3f}",
          configs_per_s=f"{stats.rows / stats.label_seconds:.1f}",
          mean_samples_per_config=f"{stats.samples_used / stats.rows:.1f}",
          slot_efficiency=f"{stats.samples_used / stats.slots_dispatched:.4f}",
          zero_share=f"{zero_share:.4f}", kernel_launches=launches)
    return launches


def phase_acceptance(work: Path) -> None:
    from collide2d_tpu_torch import cli
    from collide2d_tpu_torch.data.validate import compare_labels

    t = time.monotonic()
    data = work / "main"
    rows = np.load(data / "0.npy")[:16_384]
    head, inp, out = (work / f"ztest_{x}.npy" for x in ("head", "in", "cps"))
    np.save(head, rows)
    np.save(inp, rows[:, [0, 1, 3, 4]].astype(np.float32))
    rc, _ = _quiet(cli.main, [
        "ztest", "--device", "cuda", "--data_dir", str(data),
        "--data_file_in", str(inp), "--data_file_out", str(out),
        "--cps_only", "true", "--seed", "8"])
    if rc != 0:
        raise RuntimeError(f"ztest exited {rc}")
    report = compare_labels(rows, np.load(out))
    if report.mean_abs_diff > 1e-3 or report.frac_within_tolerance < 0.93:
        raise RuntimeError(f"acceptance bar missed: {report}")
    rc, _ = _quiet(cli.main, ["compare", str(head), str(out)])
    _line("4 ztest+compare", time.monotonic() - t, rows=16_384,
          mean_abs_d=f"{report.mean_abs_diff:.3e}",
          share_within_tol=f"{report.frac_within_tolerance:.4f}",
          tol=report.tolerance, compare_exit=rc)


def phase_invariance(work: Path) -> None:
    t = time.monotonic()
    dirs = []
    for overlap in (1, 3):
        d = work / f"overlap{overlap}"
        _quiet(_generate, ["--device", "cuda", "-n", "2", "-b", "16384",
                           "--num_poses", "4096", "--num_variances", "4096",
                           "--seed", "3", "--overlap_batches", str(overlap),
                           "--data_dir", str(d)])
        dirs.append(d)
    for i in range(2):
        if (dirs[0] / f"{i}.npy").read_bytes() != (dirs[1] / f"{i}.npy").read_bytes():
            raise RuntimeError(f"batch {i} differs between --overlap_batches 1 and 3")
    _line("5 invariance", time.monotonic() - t, batches=2, batch_size=16_384,
          bitwise_equal=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    t0 = time.monotonic()
    card = _card()
    print(f"[1 card] {card}", flush=True)
    if not (HERE / "collide2d_tpu_torch" / "__init__.py").is_file():
        raise SystemExit("chip_smoke: run it from a checkout of the repository")
    sys.path.insert(0, str(HERE))
    import collide2d_tpu_torch

    if Path(collide2d_tpu_torch.__file__).resolve().parent != HERE / "collide2d_tpu_torch":
        raise SystemExit("chip_smoke: imported collide2d_tpu_torch from outside this checkout")

    phase_build()
    check = phase_kernel_vs_plain()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        work = Path(tmp)
        launches = phase_main_path(work)
        phase_acceptance(work)
        phase_invariance(work)
    default = check["default"]
    kernels = {"kernels": [{
        "name": "mc_counts",
        "route": "cuda",
        "source": "collide2d_tpu_torch/csrc/mc_kernel.cu",
        "replaces": "collide2d_tpu/ops/mc_pallas.py:207",
        "launches": launches,
        "max_abs_err": max(check[k]["max_abs_err"] for k in check),
        "ms": default["kernel_ms"],
        "plain_ms": default["plain_ms"],
    }]}
    print(f"[done] seconds={time.monotonic() - t0:.1f}", flush=True)
    print(card, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
