"""Counter-based random numbers in torch integer ops.

Two generators:

- **threefry2x32**, exactly as `jax.random` uses it with
  ``jax_threefry_partitionable=True`` (the default of the JAX package's
  jax): `PRNGKey`, `fold_in`, `split`, `random_bits`, `uniform`,
  `randint` and `normal`. A seed therefore means the same thing in both
  packages, and the threefry estimator path reproduces the JAX ``jnp``
  path's draws.
- **Philox4x32-10** (Salmon et al., SC'11; Random123's constants), the
  generator of the fused Monte Carlo kernel (``csrc/mc_kernel.cu``). The
  torch version here is the kernel's plain counterpart, with its two ways
  to turn words into normals: erf_inv of 23-bit codes
  (`normal_from_codes`) and Box-Muller pairs of 24-bit codes
  (`box_muller_from_codes`).

Representation: a host key is a numpy ``uint32`` array of shape (2,) —
a JAX key's ``key_data`` taken as it is. Batched keys on a device are a
pair ``(k0, k1)`` of int64 tensors. Every 32-bit word lives in an int64
tensor holding a value in [0, 2^32), so additions and shifts never
overflow: products are split into 16-bit halves (`_mulhilo`), which keeps
every intermediate below 2^49.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_THREEFRY_PARITY = 0x1BD11BDA
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85

# XLA's float32 erf_inv (Giles, "Approximating the erfinv function"), the
# polynomial `jax.lax.erf_inv` lowers to; csrc/mc_kernel.cu uses the same
# constants.
_ERFINV_LT5 = np.asarray(
    ["2.81022636e-08", "3.43273939e-07", "-3.5233877e-06", "-4.39150654e-06",
     "0.00021858087", "-0.00125372503", "-0.00417768164", "0.246640727",
     "1.50140941"], np.float32)
_ERFINV_GE5 = np.asarray(
    ["-0.000200214257", "0.000100950558", "0.00134934322", "-0.00367342844",
     "0.00573950773", "-0.0076224613", "0.00943887047", "1.00167406",
     "2.83297682"], np.float32)
SQRT2_F32 = np.float32(np.sqrt(2.0))

# XLA's CPU log1p: a Cephes rational for |x| < sqrt(2) - 1, else log(1 + x)
# with the Cephes logf polynomial (coefficients highest degree first).
_LOG1P_SMALL = 0.41421356237309504880
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOGF_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
           -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
           2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOGF_Q1, _LOGF_Q2 = -2.12194440e-4, 0.693359375
_SQRTHF = 0.707106781186547524


# ---------------------------------------------------------------------------
# threefry2x32
# ---------------------------------------------------------------------------


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds, as `jax.random`'s ``threefry2x32_p``.

    Every argument is a Python int or an int64 tensor of uint32 values
    (mutually broadcastable). Returns the pair of output words."""
    ks = (k0, k1, k0 ^ k1 ^ _THREEFRY_PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _THREEFRY_ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def _host_key(key) -> tuple[int, int]:
    key = np.asarray(key, np.uint32).reshape(-1)
    if key.shape != (2,):
        raise ValueError(f"expected a (2,) uint32 key, got shape {key.shape}")
    return int(key[0]), int(key[1])


def PRNGKey(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey` for a 32-bit seed: key words (0, seed)."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"seed {seed} does not fit in int32")
    return np.asarray([0, seed & MASK32], np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """`jax.random.fold_in` on a host key and a Python int."""
    y0, y1 = threefry2x32(*_host_key(key), 0, int(data) & MASK32)
    return np.asarray([y0, y1], np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """`jax.random.split` (partitionable form): key i = threefry(key, i)."""
    k0, k1 = _host_key(key)
    return np.asarray(
        [threefry2x32(k0, k1, i >> 32, i & MASK32) for i in range(num)],
        np.uint32,
    )


def fold_in_many(key, data: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched `fold_in`: one host key, a tensor of int32 data (e.g. uids,
    where -1 folds in as 0xffffffff like JAX's uint32 conversion).
    Returns the keys as a pair of int64 tensors shaped like ``data``."""
    k0, k1 = _host_key(key)
    d = data.to(torch.int64) & MASK32
    return threefry2x32(k0, k1, torch.zeros_like(d), d)


def fold_in_pair(k0: torch.Tensor, k1: torch.Tensor, data: int):
    """`fold_in` of one Python int into a batch of keys ``(k0, k1)``."""
    d = int(data) & MASK32
    return threefry2x32(k0, k1, 0, d)


def _key_words(key):
    """Host key -> two Python ints; a batched pair passes through with a
    trailing axis added for the sample dimension."""
    if isinstance(key, tuple):
        return key[0][..., None], key[1][..., None]
    return _host_key(key)


def random_bits(key, shape, device=None) -> torch.Tensor:
    """`jax.random.bits` (32-bit, partitionable): word i of the flattened
    ``shape`` is ``y0 ^ y1`` of threefry(key, (i >> 32, i & mask)).

    ``key`` is a host key (result has ``shape``) or a batched pair
    ``(k0, k1)`` with batch shape B (result has B + ``shape``)."""
    shape = tuple(int(s) for s in shape)
    if isinstance(key, tuple):
        device = key[0].device
    k0, k1 = _key_words(key)
    n = math.prod(shape)
    counts = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(k0, k1, counts >> 32, counts & MASK32)
    bits = y0 ^ y1
    return bits.reshape(bits.shape[:-1] + shape)


def _bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """Uniform [0, 1) floats from the top 23 bits (jax.random.uniform)."""
    fb = (bits >> 9) | 0x3F800000
    return fb.to(torch.int32).view(torch.float32) - 1.0


def uniform(key, shape, minval=0.0, maxval=1.0, device=None) -> torch.Tensor:
    """`jax.random.uniform` in float32; ``minval`` and ``maxval`` are
    numbers or arrays that broadcast against ``shape``."""
    lo = np.float32(minval)
    span = np.float32(maxval) - lo
    floats = _bits_to_unit_float(random_bits(key, shape, device))
    if np.ndim(lo) or np.ndim(span):
        lo_t = torch.as_tensor(np.array(np.broadcast_to(lo, np.shape(span))),
                               device=floats.device)
        span_t = torch.as_tensor(span, device=floats.device)
        return torch.maximum(fma(floats, span_t, lo_t), lo_t)
    return torch.clamp(fma(floats, span, lo), min=float(lo))


def _mulhilo(a, m: int):
    """(hi, lo) 32-bit words of ``a * m`` for uint32 ``a`` (int or int64
    tensor) and a Python-int constant ``m``, without 64-bit overflow."""
    p_lo = a * (m & 0xFFFF)
    p_hi = a * (m >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & MASK32


def randint(key, shape, minval: int, maxval: int, device=None) -> torch.Tensor:
    """`jax.random.randint` (int32): two 32-bit draws folded modulo the
    span, with JAX's uint32 wraparound reproduced."""
    k_hi, k_lo = split(key, 2)
    higher = random_bits(k_hi, shape, device)
    lower = random_bits(k_lo, shape, device)
    span = int(maxval) - int(minval)
    if span <= 0:
        span = 1
    if span > MASK32:
        raise ValueError(f"span {span} exceeds 32 bits")
    mult = (2**16) % span
    mult = ((mult * mult) & MASK32) % span
    _, prod = _mulhilo(higher % span, mult)
    offset = ((prod + lower % span) & MASK32) % span
    return (offset + int(minval)).to(torch.int32)


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add. ``b``
    and ``c`` are float32 tensors or float32 values as Python numbers.

    The product of two float32 values is exact in float64, so this equals
    a hardware FMA except when the float64 sum lands on a float32 rounding
    tie (about one case in 2^29). XLA's CPU backend and nvcc both contract
    ``a * b + c`` into an FMA, so this is what the JAX package computes
    inside ``jit`` and what the CUDA kernel computes."""
    def f64(x):
        return x.double() if isinstance(x, torch.Tensor) else float(x)

    return (a.double() * f64(b) + f64(c)).float()


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (via float64, where the double
    rounding is harmless), as IEEE ``sqrtf`` on XLA and CUDA; torch's
    vectorised CPU ``sqrt`` misrounds a fraction of a percent of inputs."""
    return torch.sqrt(x.double()).float()


def _f32(v: float) -> float:
    """A Python float rounded to float32, as XLA's float32 constants."""
    return float(np.float32(v))


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    """float32 Horner evaluation, highest degree first, one fused
    multiply-add per step (see `fma`)."""
    xd = x.double()
    p = torch.full_like(x, _f32(coeffs[0]))
    for c in coeffs[1:]:
        p = (p.double() * xd + _f32(c)).float()
    return p


def _log_cephes(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``log`` for x >= 0: the Cephes logf polynomial on
    the mantissa, with the emitter's fused multiply-adds."""
    m, e = torch.frexp(x)
    e = e.to(torch.float32)
    small = m < _f32(_SQRTHF)
    e = torch.where(small, e - 1.0, e)
    xx = torch.where(small, (m - 1.0) + m, m - 1.0)
    x2 = xx * xx
    x3 = x2 * xx
    y = _horner(xx, _LOGF_P[0:3])
    y1 = _horner(xx, _LOGF_P[3:6])
    y2 = _horner(xx, _LOGF_P[6:9])
    y = fma(fma(y, x3, y1), x3, y2)
    y = fma(y, x3, e * _f32(_LOGF_Q1))
    xx = fma(torch.full_like(x2, -0.5), x2, xx) + y
    out = fma(torch.full_like(e, _f32(_LOGF_Q2)), e, xx)
    return torch.where(x == 0, float("-inf"), out)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``log1p`` for x >= -1, bit for bit where the
    fused multiply-adds do not tie (see `fma`); torch's own ``log1p``
    differs from it by an ulp on about one input in ten."""
    x2 = x * x
    small = (x * x2) * (_horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN))
    small = x + fma(torch.full_like(x2, -0.5), x2, small)
    return torch.where(x.abs() < _f32(_LOG1P_SMALL), small,
                       _log_cephes(x + 1.0))


def erf_inv(x: torch.Tensor, *, xla_log1p: bool = True) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` polynomial, in the same operation order,
    with each Horner step a fused multiply-add (see `fma`).

    ``xla_log1p``: take the logarithm as XLA's CPU backend does (`log1p`),
    so `normal` gives `jax.random.normal`'s bits; False takes torch's
    ``log1p``, which on a CUDA tensor is the ``log1pf`` of the fused
    kernel."""
    w = -(log1p if xla_log1p else torch.log1p)(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, sqrt_rn(w) - 3.0)
    lt5 = [float(c) for c in _ERFINV_LT5]
    ge5 = [float(c) for c in _ERFINV_GE5]
    p = torch.where(lt, lt5[0], ge5[0])
    for i in range(1, len(_ERFINV_LT5)):
        p = fma(p, w, torch.where(lt, lt5[i], ge5[i]))
    result = p * x
    return torch.where(x.abs() == 1.0, x * float("inf"), result)


def normal(key, shape, device=None) -> torch.Tensor:
    """`jax.random.normal` in float32: sqrt(2) * erf_inv(uniform(-1, 1))."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    u = uniform(key, shape, lo, np.float32(1.0), device)
    return erf_inv(u) * float(SQRT2_F32)


# ---------------------------------------------------------------------------
# Philox4x32-10 and the kernel's normals
# ---------------------------------------------------------------------------


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32 with 10 rounds (Random123 ``philox4x32_R(10, ...)``).

    Counter words ``c0..c3`` and key words ``k0, k1`` are Python ints or
    int64 tensors of uint32 values. Returns the four output words."""
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & MASK32
            k1 = (k1 + _PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, _PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def normal_from_codes(codes: torch.Tensor) -> torch.Tensor:
    """Standard normals from 23-bit codes b in [0, 2^23):
    z = sqrt(2) * erf_inv((b + 0.5) * 2^-22 - 1).

    23 bits, not 24: every ``b + 0.5`` and the argument's extremes
    ±(1 - 2^-23) are exact in float32, so the draw is always finite (a
    24-bit top code rounds to erf_inv(1) = +inf). The logarithm is the
    kernel's (see `erf_inv`)."""
    u = (codes.to(torch.float32) + 0.5) * (2.0**-22) - 1.0
    return erf_inv(u, xla_log1p=False) * float(SQRT2_F32)


TWO_PI_F32 = np.float32(2 * np.pi)


def box_muller_from_codes(b1: torch.Tensor, b2: torch.Tensor):
    """One Box-Muller pair of standard normals from 24-bit codes b1, b2 in
    [0, 2^24), the torch twin of ``csrc/mc_stream.cuh::box_muller_pair`` and
    the formula of the TPU kernels' ``_box_muller`` (mc_pallas.py:125-131):
    u = (b + 1) * 2^-24 in (0, 1], r = sqrt(-2 log u1), a = 2 pi u2, and
    ``(r cos a, r sin a)``. The square root is correctly rounded (IEEE
    ``sqrtf``); ``log``, ``cos`` and ``sin`` are torch's, which on a CUDA
    tensor are the kernel's ``logf`` and ``sincosf`` and on the CPU differ
    from them by an ulp or two."""
    u1 = (b1.to(torch.float32) + 1.0) * (2.0**-24)
    u2 = (b2.to(torch.float32) + 1.0) * (2.0**-24)
    r = sqrt_rn(-2.0 * torch.log(u1))
    a = float(TWO_PI_F32) * u2
    return r * torch.cos(a), r * torch.sin(a)

