"""``jax.random``'s threefry stream in torch: the keys, bits, uniforms and
standard normals that ``jax.random`` gives ``tpusplat/train/densify.py``
(the split noise) and ``apps/train.py`` (its key chain), bit for bit.

A key is a pair of 32-bit integers ``(k1, k2)``, held as Python ints; there
is no global state. The draws (``fold_in``, ``random_bits``, ``normal``)
also take the pair as a device tensor (:func:`key_tensor`: int64, shape
[2]), which a CUDA graph reads at each replay where it would bake Python
ints in as constants; the draws of a tensor key are those of the same key
held as ints, bit for bit. The chain of keys (``key``, ``split``) stays on
the host, as ``apps/train.py``'s does. The forms are those of jax 0.9's
defaults
(``jax_default_prng_impl=threefry2x32``, ``jax_threefry_partitionable=True``,
32-bit mode):

  * ``key(seed)`` is ``(0, seed mod 2**32)``;
  * ``split(k, num)`` hashes the (hi, lo) words of ``iota(num)``: key i is
    the pair of the two output words at counter i;
  * ``fold_in(k, d)`` hashes the counter pair ``(0, d)``;
  * 32 random bits at flat index i are ``bits1 ^ bits2`` of the hash of the
    (hi, lo) words of i.

The hash is ``_threefry2x32_lowering`` of ``jax/_src/prng.py``: rotations
[13, 15, 26, 6] and [17, 29, 16, 24], key schedule ``k1 ^ k2 ^ 0x1BD11BDA``
and five key injections. The bits are int64 tensors masked to 32 bits, so
the same integer ops run on the CPU and on the card.

The normal is ``jax.random.normal``'s recipe (``jax/_src/random.py``,
``_uniform`` and ``_normal_real``): ``u = max(lo, (bitcast((bits >> 9) |
0x3f800000) - 1) * 2 + lo)`` with ``lo = nextafter(-1, 0)``, then
``sqrt(2) * erf_inv(u)``. ``erf_inv`` is the f32 code that XLA:CPU compiles
for ``lax.erf_inv``: a polynomial in ``w - 2.5`` (``w < 5``) or in
``sqrt(w) - 3`` with ``w = -log1p(-u*u)``, where log1p is XLA's rational
approximation (``|x| < sqrt(2) - 1``) or its own f32 log. The constants and
the order of operations are read from the compiled kernel of
``jax.jit(lambda k: jax.random.normal(k, shape))`` on x86 (its HLO, LLVM IR
and machine code, dumped with ``XLA_FLAGS=--xla_dump_to``). The machine
code fuses most multiply-adds into FMA instructions; ``_fma`` marks each one
of them.

Every f32 operation is computed in float64 and rounded to float32: for +,
-, *, / and sqrt the result is the correctly rounded f32 one (53 >= 2 * 24
+ 2 bits), and ``_fma`` rounds the exact a * b + c once, through
round-to-odd. IEEE float64 arithmetic is the same on the CPU and on the
card, so both give the same draws, equal to ``jax.random.normal``'s on all
2**23 possible uniforms.
"""

from __future__ import annotations

import math
import struct

import torch

MASK = 0xFFFFFFFF
Key = tuple[int, int]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_CHUNK = 1 << 21  # elements per pass of the f64 emulation (bounds its memory)


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & MASK


def threefry2x32(k, x0, x1):
    """The threefry-2x32 hash of counter words ``(x0, x1)`` under key ``k``
    (a pair of ints or a key tensor): Python ints or int64 tensors holding
    values below 2**32."""
    ks = (k[0], k[1], k[0] ^ k[1] ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def key(seed: int) -> Key:
    """``jax.random.key(seed)`` (32-bit mode: the seed wraps modulo 2**32)."""
    return (0, int(seed) & MASK)


def split(k: Key, num: int = 2) -> list[Key]:
    """``jax.random.split(k, num)``."""
    return [threefry2x32(k, i >> 32, i & MASK) for i in range(num)]


def key_tensor(k: Key, device) -> torch.Tensor:
    """The host key ``k`` as a key tensor on ``device``: int64, shape [2]."""
    return torch.tensor(k, dtype=torch.int64, device=device)


def fold_in(k, data: int):
    """``jax.random.fold_in(k, data)``: a pair of ints for a pair of ints, a
    key tensor for a key tensor."""
    out = threefry2x32(k, 0, int(data) & MASK)
    return torch.stack(out) if isinstance(k, torch.Tensor) else out


def random_bits(k, shape, device) -> torch.Tensor:
    """32 random bits per element, ``jax.random.bits(k, shape, uint32)``, as
    an int64 tensor of ``shape`` on ``device`` (that of a key tensor)."""
    n = math.prod(shape)
    i = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k, i >> 32, i & MASK)
    return (b1 ^ b2).reshape(shape)


_LO = struct.unpack("<f", struct.pack("<I", 0xBF7FFFFF))[0]  # nextafter(-1, 0) in f32


def _f32(x: torch.Tensor) -> torch.Tensor:
    """Round float64 values to float32, held in float64."""
    return x.to(torch.float32).to(torch.float64)


def _uniform64(bits: torch.Tensor) -> torch.Tensor:
    fl = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32).to(torch.float64)
    # (fl - 1) * (1 - lo) + lo: 1 - lo rounds to 2 in f32, so the product is
    # exact and one rounding remains (the same whether XLA fuses it or not).
    return torch.clamp_min(_f32((fl - 1.0) * 2.0 + _LO), _LO)


def uniform_pm1(bits: torch.Tensor) -> torch.Tensor:
    """The f32 uniform in [nextafter(-1, 0), 1) that ``jax.random.normal``
    draws from 32 random bits."""
    return _uniform64(bits).to(torch.float32)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once (the FMA instruction), for f32 values
    held in float64: the product is exact in float64; the sum is rounded to
    odd in float64 (its exact error from TwoSum), then to float32."""
    p = a * b
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    to_odd = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    return _f32(torch.where(to_odd, torch.nextafter(s, s + err), s))


def _h(bits: int) -> float:
    """A float32 constant as LLVM IR prints it (the bits of its float64)."""
    return struct.unpack("<d", struct.pack("<Q", bits))[0]


# XLA:CPU's f32 log: frexp into [sqrt(1/2), sqrt(2)), a polynomial in x = m - 1
# evaluated in three interleaved parts, and the exponent times ln 2 in two words.
_LOG_SQRTHF = _h(0x3FE6A09E60000000)
_LOG_P = [_h(b) for b in (0x3FB2043760000000, 0xBFBD7A3700000000, 0x3FBDE4A340000000,
                          0xBFBFCBA9E0000000, 0x3FC23D37E0000000, 0xBFC555CA00000000,
                          0x3FC999D580000000, 0xBFCFFFFF80000000, 0x3FD5555540000000)]
_LN2_LO, _LN2_HI = _h(0xBF2BD01060000000), 0.693359375
# XLA's log1p for |x| < sqrt(2) - 1 (Cephes): x - x^2 / 2 + x^3 * P(x) / Q(x).
_LOG1P_SMALL = _h(0x3FDA8279A0000000)
_LOG1P_Q = [_h(b) for b in (0x402E2035A0000000, 0x4054C30B60000000, 0x406BB865A0000000,
                            0x4073519460000000, 0x406B0DB140000000, 0x404E0F3040000000)]
_LOG1P_P = [_h(b) for b in (0x3F07BC0960000000, 0x3FDFE818A0000000, 0x401A509F40000000,
                            0x403DE97380000000, 0x404E798EC0000000, 0x404C8E75A0000000,
                            0x40340A2020000000)]
# erf_inv: (w < 5, w >= 5) coefficients, highest power first, as the HLO prints them.
_ERFINV = [(2.81022636e-08, -0.000200214257), (3.43273939e-07, 0.000100950558),
           (-3.5233877e-06, 0.00134934322), (-4.39150654e-06, -0.00367342844),
           (0.00021858087, 0.00573950773), (-0.00125372503, -0.0076224613),
           (-0.00417768164, 0.00943887047), (0.246640727, 1.00167406),
           (1.50140941, 2.83297682)]
_ERFINV = [tuple(struct.unpack("<f", struct.pack("<f", c))[0] for c in pair) for pair in _ERFINV]
_SQRT2 = struct.unpack("<f", struct.pack("<f", math.sqrt(2)))[0]


def _log(t: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 log of positive finite t."""
    tb = torch.clamp_min(t.to(torch.float32).view(torch.int32).to(torch.int64), 0x00800000)
    e = _f32(((tb >> 23) - 127).to(torch.float64) + 1.0)
    m = ((tb & 0x7FFFFF) | 0x3F000000).to(torch.int32).view(torch.float32).to(torch.float64)
    below = m < _LOG_SQRTHF
    x = _f32(_f32(m - 1.0) + torch.where(below, m, 0.0))
    e = torch.where(below, _f32(e - 1.0), e)
    z = _f32(x * x)
    x3 = _f32(z * x)
    p = _LOG_P
    a = _fma(_fma(x, p[0], p[1]), x, p[2])
    b = _fma(_fma(x, p[3], p[4]), x, p[5])
    c = _fma(_fma(x, p[6], p[7]), x, p[8])
    q = _fma(_fma(_fma(a, x3, b), x3, c), x3, _f32(e * _LN2_LO))
    r = _f32(_fma(-z, 0.5, x) + q)
    return _fma(e, _LN2_HI, r)


def _log1p(a: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 log1p of a in (-1, 0]."""
    a2 = _f32(a * a)
    den = _f32(a + _LOG1P_Q[0])
    for c in _LOG1P_Q[1:]:
        den = _fma(den, a, c)
    num = torch.full_like(a, _LOG1P_P[0])
    for c in _LOG1P_P[1:]:
        num = _fma(num, a, c)
    small = _fma(-a2, 0.5, _f32(_f32(a * a2) * _f32(num / den)))
    small = _f32(a + small)
    return torch.where(a.abs() < _LOG1P_SMALL, small, _log(_f32(a + 1.0)))


def _normal64(u: torch.Tensor) -> torch.Tensor:
    """``sqrt(2) * erf_inv(u)`` as XLA:CPU computes it in f32, for f32 u in
    (-1, 1) held in float64 (the uniform never reaches -1 or 1, so erf_inv's
    ``|u| == 1`` branch to infinity is left out)."""
    w = -_log1p(_f32(u * -u))
    central = w < 5.0
    t = torch.where(central, _f32(w - 2.5), _f32(_f32(torch.sqrt(w)) - 3.0))
    coef = [torch.full_like(w, c_out).masked_fill_(central, c_in) for c_in, c_out in _ERFINV]
    p = coef[0]
    for c in coef[1:]:
        p = _fma(p, t, c)
    return _f32(_f32(p * u) * _SQRT2)


def normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """The f32 standard normals that ``jax.random.normal`` makes of 32
    random bits each (int64 ``bits`` below 2**32), on their device."""
    flat = bits.reshape(-1)
    out = torch.empty(flat.shape, dtype=torch.float32, device=bits.device)
    for s in range(0, flat.numel(), _CHUNK):
        out[s:s + _CHUNK] = _normal64(_uniform64(flat[s:s + _CHUNK])).to(torch.float32)
    return out.reshape(bits.shape)


def normal(k, shape, device) -> torch.Tensor:
    """``jax.random.normal(k, shape)`` in float32 on ``device``."""
    return normal_from_bits(random_bits(k, tuple(shape), device))
