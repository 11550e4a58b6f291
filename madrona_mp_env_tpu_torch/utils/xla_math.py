"""XLA's CPU float32 ``exp`` and ``log1p``, op for op.

XLA's CPU backend does not call libm for these: it emits Cephes
polynomials with fused multiply-adds (``exp``, and ``log1p`` as the log of
1 + x away from zero, a rational approximation near it). ATen's
vectorized CPU routines differ from them in the last bit on ~9% of float32 inputs, so a plain
version that must give the JAX package's bits (the DreamerV3 critic's
symlog / symexp) evaluates XLA's algorithm here. Every step runs in
float64 tensor ops and is rounded to float32 where XLA rounds; a fused
multiply-add is one float64 ``a * b + c`` (the product of two float32
values is exact in float64) rounded once. The results are the same on
every device.

Domain: finite float32 inputs (``exp`` saturates like XLA's: inputs are
clamped to [-87.8, 88.8] and subnormal results flushed to 0, as XLA
flushes them; ``log1p`` of x <= -1 is NaN or -inf as XLA's; subnormal
inputs are not reproduced).
"""

from __future__ import annotations

import torch

_F64 = torch.float64

# GenerateVF32Exp's Cephes constants
_LOG2EF = 1.44269504088896341
_EXP_C1 = 0.693359375
_EXP_C2 = -2.12194440e-4
_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
          4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)
# GenerateVF32Log's
_SQRTHF = 0.707106781186547524
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1 = -2.12194440e-4
_LOG_Q2 = 0.693359375
# EmitLog1p's rational approximation for |x| < sqrt(2) - 1
_LOG1P_SMALL = 0.41421356237309504880
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)


def _f32(c: float) -> float:
    """A constant rounded to float32 (XLA's APFloat constants)."""
    return float(torch.tensor(c, dtype=torch.float32))


def _r(x: torch.Tensor) -> torch.Tensor:
    """Round float64 to float32, kept as float64 for the next op."""
    return x.to(torch.float32).to(_F64)


def _fma(a, b, c) -> torch.Tensor:
    return _r(a * b + c)


def exp(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 exp of float32 ``x``."""
    x = x.to(torch.float32).to(_F64)
    x = torch.clamp(x, _f32(-87.8), _f32(88.8))
    n = torch.floor(_fma(x, _f32(_LOG2EF), 0.5))
    n = torch.clamp(n, -127.0, 127.0)
    r = _fma(n, -_f32(_EXP_C1), x)
    r = _fma(n, -_f32(_EXP_C2), r)
    z = _fma(r, _f32(_EXP_P[0]), _f32(_EXP_P[1]))
    for p in _EXP_P[2:]:
        z = _fma(z, r, _f32(p))
    z = _fma(z, _r(r * r), r)
    z = _r(1.0 + z)
    # z * 2^n, and 0 for n = -127; subnormal results flushed to 0
    out = z * torch.exp2(n)
    return torch.where(out < 2.0 ** -126, torch.zeros_like(out),
                       out).to(torch.float32)


def _log64(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 log of float32 values held in float64."""
    xf = x.to(torch.float32)
    min_norm = torch.tensor(2.0 ** -126, dtype=torch.float32,
                            device=x.device)
    bits = torch.maximum(xf, min_norm).view(torch.int32)
    emm0 = (bits >> 23) - 0x7F
    # the mantissa with the exponent of 0.5: [0.5, 1)
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32).to(_F64)
    e = _r(1.0 + emm0.to(torch.float32).to(_F64))
    small = m < _f32(_SQRTHF)
    t = _r(_r(m - 1.0) + torch.where(small, m, torch.zeros_like(m)))
    e = _r(e - small.to(_F64))
    x2 = _r(t * t)
    x3 = _r(x2 * t)
    p = [_f32(c) for c in _LOG_P]
    y = _fma(t, p[0], p[1])
    y1 = _fma(t, p[3], p[4])
    y2 = _fma(t, p[6], p[7])
    y = _fma(y, t, p[2])
    y1 = _fma(y1, t, p[5])
    y2 = _fma(y2, t, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, _r(_f32(_LOG_Q1) * e))
    t = _r(t - _r(0.5 * x2))
    t = _r(t + y)
    out = _r(t + _r(_f32(_LOG_Q2) * e))
    out = torch.where(x == 0.0, torch.full_like(out, float("-inf")), out)
    out = torch.where(torch.isinf(x) & (x > 0), x, out)
    return torch.where((x < 0.0) | torch.isnan(x),
                       torch.full_like(out, float("nan")), out)


def _horner(x, coeffs):
    p = torch.zeros_like(x)
    for c in coeffs:
        p = _fma(p, x, _f32(c))
    return p


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 log1p of float32 ``x``: log(1 + x), and near 0 a
    Cephes rational approximation."""
    x = x.to(torch.float32).to(_F64)
    large = _log64(_r(x + 1.0))
    x2 = _r(x * x)
    small = _r(_horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN))
    small = _r(_r(x * x2) * small)
    small = _r(_r(-0.5 * x2) + small)
    small = _r(x + small)
    return torch.where(x.abs() < _f32(_LOG1P_SMALL), small,
                       large).to(torch.float32)
