"""Counter-based threefry2x32 draws, bit-exact to ``jax.random``'s.

The population engine (``sim/population.py``) draws every random number of
client ``cid`` as a pure function of ``(seed, stream, cid, k)``; this module
reproduces the JAX package's draws bit for bit, so the port and the JAX
package simulate the same population from one seed. It follows JAX 0.9 with
``jax_threefry_partitionable`` on (its default):

* ``prng_key(seed)`` is the pair ``(0, seed)`` (``threefry_seed``);
* ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``;
* ``split(key, n)`` is "foldlike": key ``i`` is ``threefry2x32(key, (0, i))``;
* ``random_bits32(key, shape)`` hashes the counters ``(0, j)``, ``j`` the
  flat index into ``shape``, and returns ``b1 ^ b2`` of the two words;
* ``uniform``, ``randint`` and ``normal`` apply ``jax.random``'s bit
  transforms to those words (``jax/_src/random.py``).

A key is a ``Key`` of two int64 tensors holding uint32 words; the two may
have any (matching) batch shape, so one call draws for every client at
once. A draw's shape is the key's batch shape followed by ``shape``. The
uint32 arithmetic runs in int64 tensors masked to 32 bits, with logical
shifts of non-negative values: torch's ``uint32`` dtype lacks ops on both
CPU and CUDA. Nothing here holds state, and a draw stays on its key's
device.

``normal`` needs ``log1p`` and the population engine's durations ``exp``.
``torch.log1p``/``torch.exp`` differ from XLA's by an ulp on a few percent
of inputs, and their last bit also differs between CPU and CUDA, so this
module carries XLA's own float32 formulations (``exp``, ``log``, ``log1p``,
``erf_inv``): IEEE multiplies, adds, divides and bit operations only, with
each of XLA's fused multiply-adds done as one float64 multiply-add rounded
once to float32, and ``erf_inv``'s square root taken in float64 (torch's
float32 ``sqrt`` on CUDA is off by an ulp on ~0.7% of inputs). Every
function here therefore gives the same bits on the CPU and on the card, and
JAX's bits on the CPU, but for ``erf_inv``: XLA's CPU square root is not
correctly rounded either, which moves it by 1 ulp on under 1e-4 of inputs.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple, Union

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

IntLike = Union[int, torch.Tensor]


class Key(NamedTuple):
    """A batch of threefry keys: two int64 tensors of uint32 words."""

    k0: torch.Tensor
    k1: torch.Tensor

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.k0.shape)

    @property
    def device(self) -> torch.device:
        return self.k0.device

    def __getitem__(self, index) -> "Key":  # noqa: D105 (batch indexing)
        return Key(self.k0[index], self.k1[index])


def _u32(x: IntLike, device: torch.device) -> torch.Tensor:
    """``x`` as int64 words of its uint32 image (int32 wraps like JAX's
    ``convert_element_type``)."""
    return torch.as_tensor(x, device=device).to(torch.int64) & MASK32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds on broadcastable int64 word tensors."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def prng_key(seed: int, device: Union[str, torch.device] = "cpu") -> Key:
    """``jax.random.PRNGKey(seed)`` for a 32-bit integer seed: ``(0, seed)``."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is outside the int32 range")
    dev = torch.device(device)
    return Key(torch.zeros((), dtype=torch.int64, device=dev),
               torch.tensor(seed & MASK32, dtype=torch.int64, device=dev))


def fold_in(key: Key, data: IntLike) -> Key:
    """``jax.random.fold_in``: ``threefry2x32(key, (0, data))``, broadcast
    over the key's batch shape and ``data``'s shape."""
    d = _u32(data, key.device)
    return Key(*threefry2x32(key.k0, key.k1, torch.zeros_like(d), d))


def split(key: Key, num: int = 2) -> Key:
    """``jax.random.split`` (foldlike): batch shape ``key.shape + (num,)``."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    return Key(*threefry2x32(key.k0[..., None], key.k1[..., None],
                             torch.zeros_like(i), i))


def _counters(key: Key, shape: Sequence[int]) -> torch.Tensor:
    count = math.prod(shape)
    if count >= 2 ** 32:
        raise ValueError(f"draw of {count} values needs 64-bit counters")
    return torch.arange(count, dtype=torch.int64,
                        device=key.device).reshape(tuple(shape))


def _expand(key: Key, shape: Sequence[int]) -> Key:
    tail = (1,) * len(shape)
    return Key(key.k0.reshape(key.shape + tail),
               key.k1.reshape(key.shape + tail))


def random_bits32(key: Key, shape: Sequence[int] = ()) -> torch.Tensor:
    """32 random bits per element as int64 in ``[0, 2**32)``: ``b1 ^ b2`` of
    ``threefry2x32(key, (0, j))``, shape ``key.shape + shape``."""
    j = _counters(key, shape)
    k = _expand(key, shape)
    b1, b2 = threefry2x32(k.k0, k.k1, torch.zeros_like(j), j)
    return b1 ^ b2


def f32(x: float) -> float:
    """The float32 nearest ``x``, as a Python float (exact in torch f32 ops)."""
    return float(np.float32(x))


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, as XLA's fused multiply-add.

    XLA's CPU backend contracts a multiply feeding an add into an FMA.
    The product of two float32 values is exact in float64, and so is the sum
    at the magnitudes these functions see, so the one rounding to float32 is
    the FMA's. Plain float64 operations give the same bits on every device.
    """
    return (a.double() * b + c).float()


def uniform(key: Key, shape: Sequence[int] = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits as a mantissa in
    [1, 2), minus 1, then ``* (max - min) + min`` as one fused multiply-add,
    then ``max(min, .)``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits32(key, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(fma(floats, float(hi - lo), float(lo)),
                           float(lo))


def randint(key: Key, shape: Sequence[int], minval: IntLike,
            maxval: IntLike) -> torch.Tensor:
    """``jax.random.randint`` for int32 bounds: int32 draws in ``[minval,
    maxval)`` (``minval`` where ``maxval <= minval``).

    Two 32-bit draws from ``split(key)`` make a 64-bit number reduced mod
    the span with ``(2**16 % span)**2 % span``; products and sums wrap in
    uint32 as in JAX. Tensor bounds broadcast over the key's batch shape.
    """
    dev = key.device
    for b in (minval, maxval):
        if isinstance(b, torch.Tensor):
            if b.dtype not in (torch.int32, torch.int16, torch.int8,
                               torch.uint8):
                raise TypeError(f"randint bound tensors must be int32 or "
                                f"narrower, got {b.dtype}")
        elif not -2 ** 31 <= int(b) < 2 ** 31:
            raise ValueError(f"randint bound {b} does not fit in int32")
    lo, hi = (torch.as_tensor(b, device=dev).to(torch.int64)
              for b in (minval, maxval))
    tail = (1,) * len(shape)
    lo = lo.reshape(lo.shape + tail) if lo.dim() else lo
    hi = hi.reshape(hi.shape + tail) if hi.dim() else hi
    k = split(key, 2)
    higher = random_bits32(k[..., 0], shape)
    lower = random_bits32(k[..., 1], shape)
    span = torch.where(hi <= lo, torch.ones_like(hi), (hi - lo) & MASK32)
    mult = (2 ** 16) % span
    mult = ((mult * mult) & MASK32) % span
    offset = (((higher % span) * mult) & MASK32)
    offset = ((offset + lower % span) & MASK32) % span
    out = (lo + offset) & MASK32
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(torch.int32)


# XLA's float32 exp, log and log1p (its CPU backend's Cephes polynomials)
_EXP_LO, _EXP_HI = f32(-88.3762626647949), f32(88.3762626647950)
_LOG2E = f32(1.44269504088896341)
_EXP_C1, _EXP_C2 = f32(0.693359375), f32(-2.12194440e-4)
_EXP_P = tuple(f32(c) for c in (
    1.9875691500E-4, 1.3981999507E-3, 8.3334519073E-3, 4.1665795894E-2,
    1.6666665459E-1, 5.0000001201E-1))
_LOG_P = tuple(f32(c) for c in (
    7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
    1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
    3.3333331174E-1))
_LOG_Q1, _LOG_Q2 = f32(-2.12194440e-4), f32(0.693359375)
_SQRT_HALF = f32(0.707106781186547524)
_MIN_NORMAL = float(np.finfo(np.float32).tiny)
_LOG1P_SMALL = 0.41421356237309504880
_LOG1P_NUM = tuple(f32(c) for c in (
    4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
    6.5787325942061044846969E0, 2.9911919328553073277375E1,
    6.0949667980987787057556E1, 5.7112963590585538103336E1,
    2.0039553499201281259648E1))
_LOG1P_DEN = tuple(f32(c) for c in (
    1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
    2.2176239823732856465394E2, 3.0909872225312059774938E2,
    2.1642788614495947685003E2, 6.0118660497603843919306E1))


def _pow2(n: torch.Tensor) -> torch.Tensor:
    """``2**n`` in float32 for integral float ``n`` in [-126, 127], built
    from its exponent bits (no ``pow``, whose last bit varies by device)."""
    return ((n.to(torch.int32) + 127) << 23).view(torch.float32)


def exp(x: torch.Tensor) -> torch.Tensor:
    """Float32 ``exp`` with the bits of XLA's CPU backend: ``n = floor(x *
    log2(e) + 1/2)``, ``r = x - n*ln 2`` in two parts, a degree-5
    polynomial (Cephes' ``expf``), times ``2**n``; the multiply-adds fused.
    ``torch.exp`` differs from it by 1 ulp on about 9% of inputs. Exact in
    the normal range; results below it flush to zero."""
    x = torch.clamp(x, _EXP_LO, _EXP_HI)
    n = torch.floor(fma(x, _LOG2E, 0.5))
    r = fma(n, -_EXP_C1, x)
    r = fma(n, -_EXP_C2, r)
    rd = r.double()
    y = fma(r, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        y = fma(y, rd, c)
    y = 1.0 + fma(y, (r * r).double(), rd)
    # 2**n as two factors: n reaches 128 at the top of the clamp
    half = torch.floor(n * 0.5)
    out = y * _pow2(half) * _pow2(n - half)
    return torch.where(n < -126, torch.zeros_like(out), out)


def log(x: torch.Tensor) -> torch.Tensor:
    """Float32 ``log`` with the bits of XLA's CPU backend (Cephes' ``logf``
    in Eigen's evaluation order): ``x = m * 2**e`` with ``m`` in
    [sqrt(1/2), sqrt(2)), a degree-8 polynomial in ``m - 1``; ``-inf`` at 0,
    NaN below it, ``inf`` at ``inf``."""
    m, e = torch.frexp(torch.clamp_min(x, _MIN_NORMAL))
    e = e.to(torch.float32)
    low = m < _SQRT_HALF
    e = torch.where(low, e - 1.0, e)
    m = torch.where(low, m + m, m) - 1.0
    md = m.double()
    m2 = m * m
    m3 = (m2 * m).double()
    y = fma(m, _LOG_P[0], _LOG_P[1])
    y1 = fma(m, _LOG_P[3], _LOG_P[4])
    y2 = fma(m, _LOG_P[6], _LOG_P[7])
    y = fma(y, md, _LOG_P[2])
    y1 = fma(y1, md, _LOG_P[5])
    y2 = fma(y2, md, _LOG_P[8])
    y = fma(y, m3, y1.double())
    y = fma(y, m3, y2.double())
    y = fma(y, m3, (_LOG_Q1 * e).double())
    out = ((m - 0.5 * m2) + y) + _LOG_Q2 * e
    out = torch.where(x == 0, -math.inf, out)
    out = torch.where(x < 0, math.nan, out)
    return torch.where(torch.isinf(x) & (x > 0), math.inf, out)


def _horner(coeffs, x: torch.Tensor) -> torch.Tensor:
    p = torch.full_like(x, coeffs[0])
    xd = x.double()
    for c in coeffs[1:]:
        p = fma(p, xd, c)
    return p


def log1p(x: torch.Tensor) -> torch.Tensor:
    """Float32 ``log1p`` with the bits of XLA's CPU backend: ``log(1 + x)``
    for ``|x| >= sqrt(2) - 1``, else ``x - x**2/2 + x**3 * P(x)/Q(x)``
    (Cephes' rational approximation, Horner steps fused)."""
    x2 = x * x
    small = _horner(_LOG1P_NUM, x) / _horner(_LOG1P_DEN, x)
    small = (x * x2) * small
    small = x + fma(x2, -0.5, small.double())
    return torch.where(torch.abs(x) < _LOG1P_SMALL, small, log(x + 1.0))


# Giles' single-precision erf_inv, as XLA's chlo.erf_inv lowers it for f32
_ERFINV_W_LT_5 = tuple(f32(c) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941))
_ERFINV_W_GE_5 = tuple(f32(c) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """Float32 inverse error function in JAX's formulation (``lax.erf_inv``):
    ``w = -log1p(-x*x)``; a degree-8 polynomial in ``w - 2.5`` (w < 5) or
    ``sqrt(w) - 3`` (Horner steps as fused multiply-adds), times ``x``;
    ``+-inf`` at ``|x| == 1``. ``torch.erfinv`` differs from JAX's by tens of
    ulp."""
    w = -log1p(x * -x)
    lt = w < 5.0
    # sqrt in float64, rounded once: correctly rounded on every device
    # (CUDA's float32 sqrt kernel is not)
    root = torch.sqrt(w.double()).float()
    w = torch.where(lt, w - 2.5, root - 3.0).double()
    p = torch.where(lt, _ERFINV_W_LT_5[0], _ERFINV_W_GE_5[0])
    for a, b in zip(_ERFINV_W_LT_5[1:], _ERFINV_W_GE_5[1:]):
        p = fma(p, w, torch.where(lt, a, b).double())
    return torch.where(torch.abs(x) == 1.0, x * math.inf, p * x)


def normal(key: Key, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erf_inv(u)`` with ``u``
    uniform on ``[nextafter(-1, 0), 1)``."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0)
    return f32(math.sqrt(2.0)) * erf_inv(u)
