"""Learned collision-probability model: the counterpart of
``collide2d_tpu/models/learned.py``.

The dataset the generator writes is training data for a learned model of
robot-vs-obstacle collision probability (generate_dataset.cu:30-36). This
module closes that loop on the card:

- **features** (13 a row): robot position (x, y), obstacle (width,
  height), the robot angle as (cos θ, sin θ), the five noise std-devs, and
  two physics columns: the exact signed distance between robot and
  obstacle at the mean pose and its σ-scaled margin (`_physics_cols`).
  On a CUDA device the distance is one launch of kernel 8
  (``csrc/distance_kernel.cu::obb_distance_kernel`` through
  `ops.distance_cuda.obb_distance_cuda_t`); on the CPU its plain version.
  cos θ and sin θ are numpy's, as the JAX package's `featurize` takes
  them, so the table columns equal JAX's bit for bit.
- **model**: an MLP (`MLP`, an ``nn.Module`` whose parameters carry the
  JAX pytree's names ``w0, b0, ..., wout, bout``, all float32). Its
  products take ``compute_dtype`` inputs and give float32 outputs; the
  bias is added to the float32 product, then the tanh GELU, then the cast
  (`apply_model`). One logit out; sigmoid -> cp.
- **training**: soft-label binary cross-entropy, AdamW with optax's
  constants, epochs of shuffled minibatches drawn by JAX's own
  permutation (`permutation`), with one host sync an epoch. The split,
  standardization and validation run in numpy on the host, as in JAX.
  ``data_parallel`` splits each minibatch over several devices, each
  computing its slice's gradient on a replica (`run_epoch_data_parallel`).

`collide2d-torch train` fits a model from a generated dataset directory;
`collide2d-torch predict` writes a bare cps vector (the ztest
``--cps_only`` schema) for `collide2d-torch compare`. The ``.npz``
artifact is the JAX package's: either package loads the other's model.

Entry points run on the card unless the caller passes ``device="cpu"``.
The module imports torch and numpy, never jax or optax.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
from pathlib import Path
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from collide2d_tpu_torch.mc import prng
from collide2d_tpu_torch.ops import distance_cuda

NUM_FEATURES = 13
# The reference's default robot (generate_dataset.cu robot_width /
# robot_height defaults) — the physics features are computed against this
# unless the caller passes its own.
ROBOT_WH = (4.07, 1.74)
# Kernel 8 takes (6, 8, M) boxes with M a multiple of its lane block.
_PAIR_ALIGN = 8 * distance_cuda.LANE_BLOCK


# ---------------------------------------------------------------------------
# Features


def _physics_cols(x, y, cos_t, sin_t, obs_w, obs_h, sd, robot_wh) -> torch.Tensor:
    """The framework's own physics as features: (N, 2) float32 columns on
    the inputs' device.

    Column 0: the exact signed distance between the robot box at its mean
    pose (centre (x, y), angle θ) and the obstacle box at the origin,
    negative inside. Box 1 is the robot ``(x, y, cos θ, sin θ, rw, rh)``,
    box 2 the obstacle ``(0, 0, 1, 0, |w|/2, |h|/2)``, both in kernel 8's
    (6, 8, M) layout; the kernel forms ``dx = 0 - x``, which is JAX's
    ``-x`` to the bit.

    Column 1: the σ-scaled margin, distance over the combined noise scale
    (positional sigmas in quadrature + the obstacle circumradius times
    sigma_theta + half the shape sigmas in quadrature), clipped to ±40.
    Square roots are correctly rounded (`prng.sqrt_rn`), as XLA's.
    """
    n = x.shape[0]
    padded = max(1, -(-n // _PAIR_ALIGN)) * _PAIR_ALIGN
    rw = float(np.float32(abs(float(robot_wh[0])) * 0.5))
    rh = float(np.float32(abs(float(robot_wh[1])) * 0.5))
    zeros, ones = torch.zeros_like(x), torch.ones_like(x)
    robot = torch.stack([x, y, cos_t, sin_t, torch.full_like(x, rw),
                         torch.full_like(x, rh)])
    obstacle = torch.stack([zeros, zeros, ones, zeros, obs_w.abs() * 0.5,
                            obs_h.abs() * 0.5])
    robot, obstacle = (F.pad(b, (0, padded - n)).reshape(6, 8, padded // 8)
                       for b in (robot, obstacle))
    d = distance_cuda.obb_distance_cuda_t(robot, obstacle)[:n]
    r_obs = 0.5 * prng.sqrt_rn(obs_w * obs_w + obs_h * obs_h)
    s_eff = (prng.sqrt_rn(sd[:, 0] * sd[:, 0] + sd[:, 1] * sd[:, 1])
             + r_obs * sd[:, 2]
             + 0.5 * prng.sqrt_rn(sd[:, 3] * sd[:, 3] + sd[:, 4] * sd[:, 4]))
    margin = torch.clamp(d / torch.clamp(s_eff, min=1e-3), -40.0, 40.0)
    return torch.stack([d, margin], dim=1)


def featurize(positions, var_idx, pose_idx, poses, std_devs, robot_wh=ROBOT_WH, *,
              device="cuda") -> np.ndarray:
    """Dataset rows + tables -> (N, 13) float32 feature matrix.

    Columns: x, y, obstacle_w, obstacle_h, cos(theta), sin(theta),
    sigma_x, sigma_y, sigma_theta, sigma_w, sigma_h, signed distance at
    the mean pose, sigma-scaled margin (`_physics_cols`, against
    ``robot_wh``, default the reference robot). ``poses`` is the (P, 3)
    poses.npy table, ``std_devs`` the (V, 5) STD-DEV table (the on-disk
    variances.npy holds variances; take sqrt first, as the labeler does —
    generate_dataset.cu:310-317). The table columns are gathered on the
    host; the physics columns run on ``device``.
    """
    positions = np.asarray(positions, np.float32)
    poses = np.asarray(poses, np.float32)
    std_devs = np.asarray(std_devs, np.float32)
    vi = np.asarray(var_idx, np.int64)
    pi = np.asarray(pose_idx, np.int64)
    if vi.size and (vi.min() < 0 or vi.max() >= len(std_devs)):
        raise ValueError(
            f"var_idx out of range [0, {len(std_devs)}) — wrong tables?"
        )
    if pi.size and (pi.min() < 0 or pi.max() >= len(poses)):
        raise ValueError(
            f"pose_idx out of range [0, {len(poses)}) — wrong tables?"
        )
    # numpy's cos/sin of the gathered angles, as JAX's featurize takes them
    # (the reference tables hold 64^4 rows, far more than a batch)
    pose = poses[pi]
    host = np.concatenate(
        [positions[:, 0:2], pose[:, 0:2], np.cos(pose[:, 2:3]), np.sin(pose[:, 2:3]),
         std_devs[vi]], axis=1).astype(np.float32)
    t = torch.from_numpy(host).to(device)
    phys = _physics_cols(t[:, 0], t[:, 1], t[:, 4], t[:, 5], t[:, 2], t[:, 3],
                         t[:, 6:11], robot_wh)
    return np.concatenate([host, phys.cpu().numpy()], axis=1)


# ---------------------------------------------------------------------------
# Model


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training knobs (defaults sized for the 1e7-row reference dataset)."""

    hidden: Sequence[int] = (256, 256, 256)
    epochs: int = 10
    batch_size: int = 8192
    learning_rate: float = 3e-4
    weight_decay: float = 1e-4
    val_fraction: float = 0.05
    seed: int = 0
    compute_dtype: str = "bfloat16"  # product input dtype; f32 outputs
    data_parallel: bool = False  # split each minibatch over the devices
    verbose: bool = False


class MLP(nn.Module):
    """The model's parameters, float32, named as the JAX pytree: ``w{i}``
    (fan_in, fan_out) and ``b{i}`` for each hidden layer, then ``wout``
    (last, 1) and ``bout`` (1,). Zeros until `init_params` or
    `params_from_jax` fills them; `apply_model` is its forward pass."""

    def __init__(self, hidden: Sequence[int], device=None):
        super().__init__()
        sizes = [NUM_FEATURES, *(int(h) for h in hidden)]
        self.num_layers = len(sizes) - 1
        for i in range(self.num_layers):
            self.register_parameter(f"w{i}", nn.Parameter(
                torch.zeros(sizes[i], sizes[i + 1], device=device)))
            self.register_parameter(f"b{i}", nn.Parameter(
                torch.zeros(sizes[i + 1], device=device)))
        self.wout = nn.Parameter(torch.zeros(sizes[-1], 1, device=device))
        self.bout = nn.Parameter(torch.zeros(1, device=device))


def init_params(key, hidden: Sequence[int], device="cuda") -> MLP:
    """He-initialized MLP, JAX's `init_params` draw for draw: the same key
    gives JAX's initial weights to within 1 ulp (`prng.normal`)."""
    model = MLP(hidden, device)
    sizes = [NUM_FEATURES, *hidden]
    with torch.no_grad():
        for i in range(len(sizes) - 1):
            key, sub = prng.split(key)
            scale = float(np.float32(np.sqrt(2.0 / sizes[i])))
            getattr(model, f"w{i}").copy_(
                prng.normal(sub, (sizes[i], sizes[i + 1]), device) * scale)
        key, sub = prng.split(key)
        scale = float(np.float32(np.sqrt(1.0 / sizes[-1])))
        model.wout.copy_(prng.normal(sub, (sizes[-1], 1), device) * scale)
    return model


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def params_from_jax(params: dict, device="cuda") -> MLP:
    """The MLP holding a JAX-style parameter dict (``{'w0': (13, h0), 'b0':
    ..., 'wout', 'bout'}``, numpy arrays or tensors), copied as float32 to
    ``device``: the weights carried across packages, and what the ``.npz``
    loader uses."""
    layers = sum(1 for k in params if k.startswith("w") and k != "wout")
    hidden = [int(np.shape(params[f"w{i}"])[1]) for i in range(layers)]
    model = MLP(hidden, device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            value = _to_numpy(params[name]).astype(np.float32)
            if value.shape != tuple(p.shape):
                raise ValueError(f"parameter {name}: shape {value.shape}, "
                                 f"expected {tuple(p.shape)}")
            p.copy_(torch.from_numpy(value))
    return model


def params_to_jax(model: MLP) -> dict:
    """`params_from_jax`'s inverse: ``{name: float32 numpy array}`` in the
    JAX pytree's names and order."""
    return {name: p.detach().cpu().numpy().copy()
            for name, p in model.named_parameters()}


def _mm_exact_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A float32 product of the (low-precision) operands: each product of
    two bfloat16 values is exact in float32 and the sums are float32,
    which is JAX's ``preferred_element_type=float32`` contract. Autograd
    rounds the operands' gradients to their dtype, as JAX's transpose
    does."""
    return torch.mm(a.float(), b.float())


class _TensorCoreMM(torch.autograd.Function):
    """``a @ b`` on the card's tensor cores: low-precision inputs, float32
    output (``aten::mm.dtype``, which has no autograd formula of its own).
    The backward products take the output gradient rounded to the inputs'
    dtype, as a TPU's default-precision products do."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return (torch.mm(g, b.t(), out_dtype=torch.float32).to(a.dtype),
                torch.mm(a.t(), g, out_dtype=torch.float32).to(b.dtype))


def _mm_tensor_cores(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _TensorCoreMM.apply(a, b)


# The low-precision product each device runs: the tensor cores on the
# card, the exact float32 product on the CPU (aten::mm.dtype has no CPU
# kernel). PERF.md times both on the card.
_LOW_PRECISION_MM = {"cuda": _mm_tensor_cores, "cpu": _mm_exact_f32}


def _product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 ``a @ b`` of two ``compute_dtype`` operands."""
    if a.dtype == torch.float32:
        if a.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("float32 products need "
                               "torch.backends.cuda.matmul.allow_tf32 = False")
        return torch.mm(a, b)
    return _LOW_PRECISION_MM[a.device.type](a, b)


def _dtype(name) -> torch.dtype:
    """The torch dtype of a ``compute_dtype`` name ('bfloat16', 'float32')."""
    if isinstance(name, torch.dtype):
        return name
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"compute_dtype must name a float dtype, got {name!r}")
    return dtype


def apply_model(model: MLP, x: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Logits (N,) for standardized features (N, NUM_FEATURES).

    Products take ``compute_dtype`` inputs and give float32 outputs
    (`_product`); the bias is added to the float32 product, then the tanh
    GELU (``jax.nn.gelu``'s default), and only then the cast back to
    ``compute_dtype``. Parameters stay float32 (cast per use)."""
    cd = _dtype(compute_dtype)
    h = x.to(cd)
    for i in range(model.num_layers):
        h = _product(h, getattr(model, f"w{i}").to(cd)) + getattr(model, f"b{i}")
        h = F.gelu(h, approximate="tanh").to(cd)
    return (_product(h, model.wout.to(cd)) + model.bout)[:, 0]


def _bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid BCE with soft targets, numerically stable in f32."""
    # log(1 + e^-|z|) + max(z, 0) - z*y
    return torch.mean(
        torch.logaddexp(torch.zeros_like(logits), -logits.abs())
        + torch.clamp(logits, min=0.0)
        - logits * targets
    )


# ---------------------------------------------------------------------------
# Training


def permutation(key, n: int, device=None) -> torch.Tensor:
    """`jax.random.permutation(key, n)` bit for bit: ``ceil(3 ln n /
    ln(2^32 - 1))`` rounds, each splitting the key, drawing 32 random bits
    a position and applying their stable sort (JAX's ``_shuffle``)."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, device=device)
    for _ in range(rounds):
        key, sub = prng.split(key)
        bits = prng.random_bits(sub, (n,), device)
        x = x[torch.sort(bits, stable=True).indices]
    return x


def adamw(model: MLP, learning_rate: float, weight_decay: float) -> torch.optim.AdamW:
    """``optax.adamw(learning_rate, weight_decay=weight_decay)``: b1 0.9, b2
    0.999, eps 1e-8, decay on every parameter (torch's default decay is
    0.01, optax's 1e-4: pass it)."""
    fused = next(model.parameters()).device.type == "cuda"
    return torch.optim.AdamW(model.parameters(), lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay, fused=fused)


def run_epoch(model: MLP, opt, key, x: torch.Tensor, y: torch.Tensor, compute_dtype,
              batch_size: int, steps: int) -> torch.Tensor:
    """One epoch: ``steps`` AdamW steps on minibatches of the shuffled rows
    (`permutation`), gathered on the rows' device. Returns the mean loss
    as a tensor on that device: the caller syncs once an epoch."""
    perm = permutation(key, x.shape[0], x.device)[: steps * batch_size]
    total = torch.zeros((), device=x.device)
    for idx in perm.reshape(steps, batch_size):
        loss = _bce(apply_model(model, x.index_select(0, idx), compute_dtype),
                    y.index_select(0, idx))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        total += loss.detach()
    return total / steps


def run_epoch_data_parallel(model: MLP, opt, replicas: list, key,
                            xy: list, compute_dtype, batch_size: int,
                            steps: int) -> torch.Tensor:
    """`run_epoch` with each minibatch split over devices: replica r (an
    `MLP` on its own device, with its own copy of the rows in ``xy[r]``)
    takes the r-th contiguous slice of the minibatch's indices, its loss
    weighted by the slice's share so the replicas' gradients sum to the
    gradient of the whole minibatch's mean loss. The gradients are summed
    in replica order into ``model`` (the optimizer's parameters), one
    AdamW step runs there, and the new parameters are copied back out to
    every replica. Returns the mean loss on ``model``'s device."""
    lead = next(model.parameters()).device
    perm = permutation(key, xy[0][0].shape[0], lead)[: steps * batch_size]
    total = torch.zeros((), device=lead)
    params = list(model.parameters())
    for idx in perm.reshape(steps, batch_size):
        for p in params:
            p.grad = torch.zeros_like(p)
        # Every slice goes out before any replica computes: a copy between
        # cards runs on the source card's stream, behind its work.
        parts = [part.to(x.device) for (x, _), part in
                 zip(xy, idx.tensor_split(len(replicas)))]
        for rep, (x, y), part in zip(replicas, xy, parts):
            if part.numel() == 0:
                continue
            loss = _bce(apply_model(rep, x.index_select(0, part), compute_dtype),
                        y.index_select(0, part)) * (part.numel() / batch_size)
            rep.zero_grad(set_to_none=True)
            loss.backward()
            for p, q in zip(params, rep.parameters()):
                p.grad += q.grad.to(lead)
            total += loss.detach().to(lead)
        opt.step()
        with torch.no_grad():
            for rep in replicas:
                for p, q in zip(params, rep.parameters()):
                    q.copy_(p)
    return total / steps


@dataclasses.dataclass
class TrainResult:
    params: dict
    norm_mean: np.ndarray
    norm_std: np.ndarray
    history: list  # per-epoch mean train loss
    val_bce: float
    val_mae: float
    val_mae_per_bin: list  # aligned with accuracy_bins intervals
    # robot the physics feature columns were computed against (rides
    # into the saved artifact so predictions reuse the same geometry)
    robot_wh: tuple = ROBOT_WH


def train_model(
    features: np.ndarray,
    labels: np.ndarray,
    cfg: TrainConfig = TrainConfig(),
    *,
    accuracy_bins: Sequence[float] = (0.0, 0.01, 0.1, 1.0),
    devices=None,
    robot_wh=ROBOT_WH,
    device="cuda",
) -> TrainResult:
    """Fit the MLP on (N, NUM_FEATURES) features / (N,) cp labels.

    Standardizes features by train-split statistics, trains
    ``cfg.epochs`` epochs on ``device``, and reports validation BCE/MAE
    (overall and per reference accuracy bin, so model error reads in the
    same units as the labeler's CI targets). ``result.params`` is the
    JAX-style dict of float32 numpy arrays.

    ``cfg.data_parallel`` over more than one device (``devices``, default
    every card for a CUDA ``device``, as JAX's ``jax.local_devices()``;
    entries may repeat a device): the training rows are cut to a multiple
    of the device count before the steps are counted (JAX's rule), every
    device holds a replica of the parameters and of the rows, and each
    minibatch is split over them (`run_epoch_data_parallel`). Over one
    device it is a no-op, as in JAX.
    """
    features = np.asarray(features, np.float32)
    labels = np.asarray(labels, np.float32)
    if features.ndim != 2 or features.shape[1] != NUM_FEATURES:
        raise ValueError(f"features must be (N, {NUM_FEATURES})")
    if labels.shape != (features.shape[0],):
        raise ValueError("labels must be (N,) aligned with features")
    if devices is None:
        dev = torch.device(device)
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   if dev.type == "cuda" else [dev])
    devs = [torch.device(d) for d in devices]
    parallel = cfg.data_parallel and len(devs) > 1
    n = features.shape[0]
    rng = np.random.default_rng(cfg.seed)
    order = rng.permutation(n)
    n_val = int(n * cfg.val_fraction)
    val_idx, train_idx = order[:n_val], order[n_val:]
    if train_idx.size < cfg.batch_size:
        raise ValueError(
            f"need >= batch_size={cfg.batch_size} training rows, have "
            f"{train_idx.size}; shrink batch_size"
        )

    mean = features[train_idx].mean(axis=0)
    std = features[train_idx].std(axis=0)
    std = np.where(std < 1e-6, 1.0, std).astype(np.float32)
    xtr = (features[train_idx] - mean) / std
    ytr = labels[train_idx]

    compute_dtype = _dtype(cfg.compute_dtype)
    model = init_params(prng.PRNGKey(cfg.seed), tuple(cfg.hidden), device)
    opt = adamw(model, cfg.learning_rate, cfg.weight_decay)
    x_dev = torch.from_numpy(np.ascontiguousarray(xtr)).to(device)
    y_dev = torch.from_numpy(np.ascontiguousarray(ytr)).to(device)
    if parallel:
        # The rows tile the devices evenly (JAX's rule); the steps are
        # counted after the cut.
        usable = (x_dev.shape[0] // len(devs)) * len(devs)
        x_dev, y_dev = x_dev[:usable], y_dev[:usable]
        replicas = [copy.deepcopy(model).to(d) for d in devs]
        copies: dict = {}
        xy = [copies.setdefault(str(d), (x_dev.to(d), y_dev.to(d))) for d in devs]
    steps = x_dev.shape[0] // cfg.batch_size
    if steps == 0:
        raise ValueError(
            f"batch_size={cfg.batch_size} exceeds the {x_dev.shape[0]} "
            "training rows left after the data-parallel truncation")

    key = prng.PRNGKey(cfg.seed + 1)
    history = []
    for epoch in range(cfg.epochs):
        key, sub = prng.split(key)
        if parallel:
            loss = run_epoch_data_parallel(model, opt, replicas, sub, xy,
                                           compute_dtype, cfg.batch_size, steps)
        else:
            loss = run_epoch(model, opt, sub, x_dev, y_dev, compute_dtype,
                             cfg.batch_size, steps)
        history.append(float(loss))
        if cfg.verbose:
            print(f"[train] epoch {epoch + 1}/{cfg.epochs} "
                  f"bce {history[-1]:.5f}")

    # validation on the held-out split (f32 features already on host)
    if n_val:
        xv = (features[val_idx] - mean) / std
        yv = labels[val_idx]
        logits = _predict_logits(model, xv, compute_dtype)
        # numerically stable sigmoid (exp of the negative magnitude only)
        ex = np.exp(-np.abs(logits))
        p = np.where(logits >= 0, 1.0 / (1.0 + ex), ex / (1.0 + ex))
        val_bce = float(
            np.mean(
                np.logaddexp(0.0, -np.abs(logits))
                + np.maximum(logits, 0.0)
                - logits * yv
            )
        )
        val_mae = float(np.mean(np.abs(p - yv)))
        per_bin = []
        edges = list(accuracy_bins)
        for lo, hi in zip(edges[:-1], edges[1:]):
            m = (yv >= lo) & ((yv < hi) | (hi == edges[-1]))
            per_bin.append(float(np.mean(np.abs(p - yv)[m])) if m.any()
                           else float("nan"))
    else:
        val_bce = val_mae = float("nan")
        per_bin = []
    return TrainResult(
        params=params_to_jax(model),
        norm_mean=np.asarray(mean, np.float32),
        norm_std=np.asarray(std, np.float32),
        history=history,
        val_bce=val_bce,
        val_mae=val_mae,
        val_mae_per_bin=per_bin,
        robot_wh=tuple(float(v) for v in robot_wh),
    )


def _predict_logits(model: MLP, x_std: np.ndarray, compute_dtype,
                    chunk: int = 1 << 20) -> np.ndarray:
    """Chunked forward pass (keeps giant eval sets out of one buffer)."""
    dev = next(model.parameters()).device
    outs = []
    with torch.no_grad():
        for i in range(0, x_std.shape[0], chunk):
            x = torch.from_numpy(np.ascontiguousarray(x_std[i: i + chunk],
                                                      np.float32)).to(dev)
            outs.append(apply_model(model, x, compute_dtype).cpu().numpy())
    return np.concatenate(outs) if outs else np.zeros((0,), np.float32)


# ---------------------------------------------------------------------------
# Persistence + inference surface


def save_model(path, result: TrainResult, cfg: TrainConfig) -> None:
    """One .npz artifact: params + normalization + architecture metadata,
    the JAX package's keys (``param_*``, ``norm_mean``, ``norm_std``,
    ``meta_json`` as uint8 JSON).

    Atomic publish (write-temp + rename, PID-suffixed temp name) — the
    same pattern as `utils.io_npy.save_npy`."""
    path = Path(path)
    meta = {
        "hidden": list(cfg.hidden),
        "compute_dtype": cfg.compute_dtype,
        "features": NUM_FEATURES,
        "robot_wh": list(getattr(result, "robot_wh", ROBOT_WH)),
        "val_bce": result.val_bce,
        "val_mae": result.val_mae,
    }
    arrays = {f"param_{k}": _to_numpy(v) for k, v in result.params.items()}
    arrays["norm_mean"] = result.norm_mean
    arrays["norm_std"] = result.norm_std
    arrays["meta_json"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8
    )
    if path.parent and not path.parent.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.tmp.{os.getpid()}")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


class LearnedCollisionModel:
    """Inference wrapper: cp predictions from a saved model artifact, on
    ``device``."""

    def __init__(self, params: dict, norm_mean, norm_std,
                 compute_dtype="bfloat16", robot_wh=ROBOT_WH, *, device="cuda"):
        self.device = torch.device(device)
        self.model = params_from_jax(params, self.device)
        self.norm_mean = torch.as_tensor(np.asarray(norm_mean, np.float32),
                                         device=self.device)
        self.norm_std = torch.as_tensor(np.asarray(norm_std, np.float32),
                                        device=self.device)
        self.compute_dtype = _dtype(compute_dtype)
        self.robot_wh = tuple(float(v) for v in robot_wh)

    @classmethod
    def load(cls, path, device="cuda") -> "LearnedCollisionModel":
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta_json"]).decode())
            n_feat = int(meta.get("features", z["norm_mean"].shape[0]))
            if n_feat != NUM_FEATURES:
                raise ValueError(
                    f"model artifact {path} was trained on {n_feat} "
                    f"features but this build featurizes "
                    f"{NUM_FEATURES} (physics features added round 4); "
                    "retrain with `collide2d-torch train`"
                )
            params = {
                k[len("param_"):]: z[k]
                for k in z.files
                if k.startswith("param_")
            }
            return cls(
                params, z["norm_mean"], z["norm_std"],
                compute_dtype=meta.get("compute_dtype", "bfloat16"),
                robot_wh=meta.get("robot_wh", ROBOT_WH),
                device=device,
            )

    def cp_from_features(self, features) -> torch.Tensor:
        """(N, NUM_FEATURES) raw features -> (N,) predicted cp, a float32
        tensor on the model's device."""
        x = (torch.as_tensor(features, dtype=torch.float32, device=self.device)
             - self.norm_mean) / self.norm_std
        with torch.no_grad():
            return torch.sigmoid(apply_model(self.model, x, self.compute_dtype))

    def cp_from_configs(self, configs) -> torch.Tensor:
        """Predicted cp for an `mc.estimator.Configs` batch — the learned
        model as a drop-in SURROGATE for `CollisionProbabilityModel.
        forward` (same batch type in, (N,) cp out, no sampling).

        A Configs row carries exactly the 13 features the model trains
        on: position, obstacle w/h, cos/sin of the robot angle (torch's,
        on the model's device), the five noise std-devs, and the two
        physics columns (`_physics_cols` against the model's stored
        ``robot_wh``; kernel 8 on a card). The contract is the model's
        measured accuracy, not the MC estimator's CI guarantee — use it
        for cheap dense sweeps, keep the adaptive labeler for
        dataset-grade labels.
        """
        pos, theta, wh, sd = (torch.as_tensor(a, dtype=torch.float32, device=self.device)
                              for a in configs)
        cos_t, sin_t = torch.cos(theta), torch.sin(theta)
        phys = _physics_cols(pos[:, 0], pos[:, 1], cos_t, sin_t, wh[:, 0], wh[:, 1],
                             sd, self.robot_wh)
        feats = torch.cat([pos, wh, cos_t[:, None], sin_t[:, None], sd, phys], dim=1)
        return self.cp_from_features(feats)

    def cp(self, positions, var_idx, pose_idx, poses, std_devs) -> np.ndarray:
        """Dataset-row form: resolves tables then predicts. (N,) float32."""
        feats = featurize(positions, var_idx, pose_idx, poses, std_devs,
                          robot_wh=self.robot_wh, device=self.device)
        chunk = 1 << 20
        out = [
            self.cp_from_features(feats[i: i + chunk]).cpu().numpy()
            for i in range(0, feats.shape[0], chunk)
        ]
        return np.concatenate(out) if out else np.zeros((0,), np.float32)


# ---------------------------------------------------------------------------
# Dataset-directory plumbing (ties into the pipeline's artifacts)


def _load_tables(data_dir) -> tuple[np.ndarray, np.ndarray]:
    """poses.npy + variances.npy -> (poses, STD-DEV table)."""
    from collide2d_tpu_torch.data import schemas
    from collide2d_tpu_torch.utils.io_npy import load_npy

    data_dir = Path(data_dir)
    poses = schemas.validate_poses(load_npy(data_dir / "poses.npy"))
    variances = schemas.validate_variances(
        load_npy(data_dir / "variances.npy")
    )
    return poses, np.sqrt(variances).astype(np.float32)


def load_training_data(
    data_dir, balance_bins: Sequence[float] | None = None,
    robot_wh=ROBOT_WH, *, device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """All labeled batches in a dataset dir -> ((N, 13) features, (N,) cp).

    Reads the generator's artifacts exactly as `balance.load_data` does
    (numeric batch files, skipping poses*/variance*/checkpoint*) and
    resolves table indices through poses.npy / variances.npy.

    ``balance_bins``: optional cp bin edges — truncates every bin to the
    smallest bin's row count before featurizing (`data.balance`, the
    reference's balance_datasets.py step), the standard counter to the
    annulus sampler's ~61% zero-probability mass dominating training."""
    from collide2d_tpu_torch.data.balance import (
        balance_single,
        compute_bin_idx,
        load_data,
    )
    from collide2d_tpu_torch.data.schemas import unpack_dataset_rows

    rows = load_data(data_dir)
    # BEFORE balance filtering: a NaN cp falls outside every balance
    # bin mask, so checking afterwards would silently DROP the corrupt
    # rows instead of raising.
    if not np.isfinite(rows).all():
        bad = int((~np.isfinite(rows).all(axis=1)).sum())
        raise ValueError(
            f"{data_dir}: {bad} rows contain NaN/inf — corrupt batch "
            "file? (a non-finite feature would silently train the model "
            "to NaN)"
        )
    if balance_bins is not None:
        rows = balance_single(
            rows, compute_bin_idx(rows[:, 2], list(balance_bins))
        )
    positions, cp, var_idx, pose_idx = unpack_dataset_rows(rows)
    poses, std_devs = _load_tables(data_dir)
    return featurize(positions, var_idx, pose_idx, poses, std_devs,
                     robot_wh=robot_wh, device=device), cp


def predict_file(model_path, input_path, data_dir, *, device="cuda") -> np.ndarray:
    """Predict cps for one batch file; returns the bare (N,) cp vector.

    Accepts both the (N, 5) labeled-dataset schema and the (N, 4)
    relabel-input schema (data/schemas.py) — the same inputs the
    relabel/ztest drivers take, so a saved cps vector slots directly
    into `collide2d-torch compare` / `data.validate.compare_labels` for
    z-scored acceptance against MC labels."""
    from collide2d_tpu_torch.data.schemas import (
        unpack_dataset_rows,
        unpack_relabel_rows,
    )
    from collide2d_tpu_torch.utils.io_npy import load_npy

    rows = np.asarray(load_npy(input_path), np.float32)
    if rows.ndim != 2 or rows.shape[1] not in (4, 5):
        raise ValueError(
            f"{input_path}: expected (N, 5) dataset rows or (N, 4) relabel "
            f"rows, got {rows.shape}"
        )
    if rows.shape[1] == 5:
        positions, _, var_idx, pose_idx = unpack_dataset_rows(rows)
    else:
        positions, var_idx, pose_idx = unpack_relabel_rows(rows)
    poses, std_devs = _load_tables(data_dir)
    model = LearnedCollisionModel.load(model_path, device=device)
    return model.cp(positions, var_idx, pose_idx, poses, std_devs)
