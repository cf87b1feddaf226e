"""The JAX package's random stream, in numpy on the host.

The bandit's key is a (2,) uint32 array, as a raw ``jax.random.PRNGKey``
is.  These functions reproduce, bit for bit, the ``jax.random`` calls the
JAX package's policies make on it, in the partitionable Threefry form
(``jax_threefry_partitionable``, the default since jax 0.5):

  * ``split(key, n)``: Threefry-2x32 of the counters (0, i), i < n — the
    two output words are the new key;
  * ``uniform(key, shape, minval, maxval)``: float32 draws — the 32 bits
    of element i (row-major over ``shape``) are ``x0 ^ x1`` of the
    counter (i >> 32, i mod 2^32); the top 23 become the mantissa of a
    float f in [1, 2), and the draw is ``max(minval, (f - 1) * (maxval -
    minval) + minval)``, the product and the sum one fused multiply-add
    as XLA's CPU backend compiles them;
  * ``choice(key, n, p)``: ``jax.random.choice(key, n, p=p)`` with
    replacement — float32 cumulative sum, ``r = c[-1] * (1 - u)``, the
    first index whose sum reaches ``r`` (``searchsorted``, side left);
  * ``normal(key, shape)``: ``sqrt(2) · erf_inv(u)`` with u the uniform
    on [nextafter(-1, 0), 1), as ``jax.random.normal`` computes it.
    ``erf_inv`` is XLA's float32 form (Giles' two polynomials of degree
    8, split at w = 5, w = -log1p(-u²)), each Horner step one fused
    multiply-add, and ``log1p`` is XLA's CPU float32 form as it compiles
    on x86-64 (a rational Cephes form below |x| = √2 - 1, else a Cephes
    log of 1 + x, each multiply that feeds one add fused with it).  Both
    were read from the compiled code of ``jax.jit(jnp.log1p)`` and of
    ``jax.random.normal`` on jax 0.9.0, and the port's ``normal`` equals
    jax's bit for bit on every one of the 2^23 uniforms it can draw
    (``tests/test_torch_policies.py``).

Fused multiply-adds are computed exactly: the product of two float32s
is exact in float64, the sum is taken with its rounding error
(``two_sum``), rounded to odd, and then to float32 — one rounding, as
the hardware instruction does.

The stream costs a few microseconds a call, and a decision draws a few
times, so it stays on the host: the card never waits on it.
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray
                 ) -> tuple:
    """Threefry-2x32 with 20 rounds of the counters (x0, x1) under
    ``key``; uint32 in, uint32 out, elementwise over the counters.  A
    (..., 2) stack of keys broadcasts against counters of shape
    (..., n) (one row of counters a key)."""
    key = np.asarray(key, np.uint32)
    k0, k1 = key[..., 0], key[..., 1]
    if key.ndim > 1:
        k0, k1 = k0[..., None], k1[..., None]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def split(key: np.ndarray, n: int = 2) -> np.ndarray:
    """``jax.random.split(key, n)``: (n, 2) uint32 keys."""
    zeros = np.zeros(n, np.uint32)
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(key, zeros, np.arange(n, dtype=np.uint32))
    return np.stack([b0, b1], axis=1)


def random_bits(key: np.ndarray, shape=()) -> np.ndarray:
    """``jax.random.bits(key, shape)`` for 32-bit words: ``x0 ^ x1`` of
    Threefry over the counters (i >> 32, i mod 2^32), i row-major.  A
    (Q, 2) stack of keys gives (Q, *shape): each key's own draws."""
    key = np.asarray(key, np.uint32)
    shape = tuple(shape)
    n = int(np.prod(shape, dtype=np.int64))
    i = np.arange(n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(key, (i >> np.uint64(32)).astype(np.uint32),
                              i.astype(np.uint32))
    return (b0 ^ b1).reshape(key.shape[:-1] + shape)


def fma(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` with one rounding (a fused multiply-add)."""
    a, b, c = (np.asarray(v, np.float32).astype(np.float64)
               for v in (a, b, c))
    p = a * b                      # exact: 24 + 24 bits fit in 53
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    # round to odd, so the rounding to float32 below is the only one
    odd = (s.view(np.uint64) & np.uint64(1)).astype(bool)
    s = np.where((err != 0) & ~odd,
                 np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def uniform(key: np.ndarray, shape=(), minval=0.0, maxval=1.0):
    """``jax.random.uniform(key, shape, minval=, maxval=)`` in float32:
    an array of ``shape`` ((Q, *shape) for a (Q, 2) stack of keys), or
    one np.float32 for one key and ``shape=()``."""
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    out = np.maximum(lo, fma(floats, np.float32(hi - lo), lo))
    return out[()] if out.ndim == 0 else out


def choice(key: np.ndarray, n: int, p: np.ndarray) -> int:
    """``jax.random.choice(key, n, p=p)`` for a float32 ``p`` of length
    ``n``: one index, drawn with replacement."""
    p = np.asarray(p, np.float32)
    if p.shape != (n,):
        raise ValueError(f"p has shape {p.shape}, expected ({n},)")
    c = np.cumsum(p, dtype=np.float32)
    r = c[-1] * (np.float32(1.0) - uniform(key))
    return int(np.searchsorted(c, r, side="left"))


def _f32(hex64: str) -> np.float32:
    """A float32 constant written as the float64 hex of XLA's LLVM IR."""
    return np.float32(np.frombuffer(bytes.fromhex(hex64)[::-1],
                                    np.float64)[0])


# XLA CPU's float32 log of 1 + x (Cephes logf): the mantissa in
# [sqrt(1/2), sqrt(2)) less 1, a polynomial in it, plus the exponent
# times log(2) split in two parts
_LOG_P = [_f32(h) for h in (
    "3FB2043760000000", "BFBD7A3700000000", "BFBFCBA9E0000000",
    "3FC23D37E0000000", "3FC999D580000000", "BFCFFFFF80000000",
    "3FBDE4A340000000", "BFC555CA00000000", "3FD5555540000000")]
_LOG2_LO, _LOG2_HI = _f32("BF2BD01060000000"), _f32("3FE6300000000000")
_SQRT_HALF = _f32("3FE6A09E60000000")
_FLT_MIN = _f32("3810000000000000")
# its rational form for |x| < sqrt(2) - 1
_LOG1P_DEN = [_f32(h) for h in (
    "402E2035A0000000", "4054C30B60000000", "406BB865A0000000",
    "4073519460000000", "406B0DB140000000", "404E0F3040000000")]
_LOG1P_NUM = [_f32(h) for h in (
    "3F07BC0960000000", "3FDFE818A0000000", "401A509F40000000",
    "403DE97380000000", "404E798EC0000000", "404C8E75A0000000",
    "40340A2020000000")]
_LOG1P_SMALL = _f32("3FDA8279A0000000")
# XLA's ErfInv32: Giles' coefficients for w < 5 and w >= 5
_ERFINV_LT5 = np.float32([2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                          -4.39150654e-06, 0.00021858087, -0.00125372503,
                          -0.00417768164, 0.246640727, 1.50140941])
_ERFINV_GE5 = np.float32([-0.000200214257, 0.000100950558, 0.00134934322,
                          -0.00367342844, 0.00573950773, -0.0076224613,
                          0.00943887047, 1.00167406, 2.83297682])


def _log_f32(y: np.ndarray) -> np.ndarray:
    """XLA CPU's float32 ``log(y)`` for finite y > 0 (the values
    ``log1p`` takes it at here)."""
    f32 = np.float32
    y = np.where(y > _FLT_MIN, y, _FLT_MIN).astype(f32)
    bits = y.view(np.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(f32)          # [0.5, 1)
    e = ((bits >> 23) - 127).astype(f32) + f32(1.0)
    small = m < _SQRT_HALF
    x = (m + f32(-1.0)) + np.where(small, m, f32(0.0))
    e = e - np.where(small, f32(1.0), f32(0.0))
    z = x * x
    x3 = z * x
    p = _LOG_P
    a1, a2, a3 = fma(x, p[0], p[1]), fma(x, p[2], p[3]), fma(x, p[4], p[5])
    b1, b2, b3 = fma(a1, x, p[6]), fma(a2, x, p[7]), fma(a3, x, p[8])
    poly = fma(fma(b1, x3, b2), x3, b3)
    y2 = fma(poly, x3, e * _LOG2_LO)
    s = fma(-z, f32(0.5), x)
    return fma(e, _LOG2_HI, s + y2)


def log1p(x: np.ndarray) -> np.ndarray:
    """XLA CPU's float32 ``log1p`` for x in (-1, 0.5]: bit-equal to
    ``jax.jit(jnp.log1p)`` there (every x that ``normal`` passes it)."""
    f32 = np.float32
    x = np.asarray(x, f32)
    large = _log_f32(x + f32(1.0))
    x2 = x * x
    den = np.ones_like(x)
    for c in _LOG1P_DEN:
        den = fma(den, x, c)
    num = np.full_like(x, _LOG1P_NUM[0])
    for c in _LOG1P_NUM[1:]:
        num = fma(num, x, c)
    r = fma(x2, f32(-0.5), (x * x2) * (num / den))
    return np.where(np.abs(x) < _LOG1P_SMALL, x + r, large).astype(f32)


def erf_inv(u: np.ndarray) -> np.ndarray:
    """XLA's float32 ``erf_inv`` for u in (-1, 1)."""
    f32 = np.float32
    u = np.asarray(u, f32)
    w = -log1p(-u * u)
    lt = w < f32(5.0)
    w = np.where(lt, w - f32(2.5), np.sqrt(w) - f32(3.0)).astype(f32)
    p = np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).astype(f32)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = fma(p, w, np.where(lt, a, b))
    return np.where(np.abs(u) == f32(1.0), u * np.finfo(f32).max,
                    p * u).astype(f32)


def normal(key: np.ndarray, shape=()) -> np.ndarray:
    """``jax.random.normal(key, shape)`` in float32, bit for bit; a
    (Q, 2) stack of keys gives (Q, *shape), each key's own draws, in one
    pass."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.asarray(uniform(key, shape, lo, 1.0), np.float32)
    out = np.float32(np.sqrt(2)) * erf_inv(u)
    return out[()] if out.ndim == 0 else out
