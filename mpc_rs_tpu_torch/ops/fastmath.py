"""Fast float32 transcendentals of the ``fast=True`` tier, in plain PyTorch.

Port of ``mpc_rs_tpu/ops/fastmath.py:44-158``: the same polynomials, the
same constants (each rounded to float32 as ``np.float32`` rounds it) and the
same operation order. The CUDA ``__device__`` versions are in
``ops/csrc/fastmath.cuh``; the fleet kernel inlines them when ``fast`` is
set, and ``mpc_fastmath_eval`` (``ops/mppi_cuda.py::fastmath_eval``) runs
them elementwise so they can be held against these functions on the card.

Outside a kernel ``fdiv`` and ``freciprocal`` are exact division, as in the
JAX package (``fastmath.py:134-158``): the plain fast tier divides exactly,
and only the kernel uses the hardware approximate reciprocal.

The constants are Python floats holding float32 values, so a float32 tensor
sees exactly the JAX package's constants and a float64 tensor runs the same
polynomial in double.
"""

from __future__ import annotations

import math
import struct

import torch


def _f32(x: float) -> float:
    """x rounded to float32 (round to nearest even), as a Python float."""
    return struct.unpack("f", struct.pack("f", x))[0]


_INV_TWO_PI = _f32(1.0 / (2.0 * math.pi))
_TWO_PI_HI = 6.28125  # 2π split: hi + lo
_TWO_PI_LO = _f32(2.0 * math.pi - 6.28125)
_PI = _f32(math.pi)
_HALF_PI = _f32(math.pi / 2.0)
# sin Taylor deg-9 on the folded range [−π/2, π/2]
_S3 = _f32(-1.0 / 6.0)
_S5 = _f32(1.0 / 120.0)
_S7 = _f32(-1.0 / 5040.0)
_S9 = _f32(1.0 / 362880.0)
_SQRT2 = _f32(math.sqrt(2.0))
_LOG2 = _f32(math.log(2.0))
# cephes logf minimax polynomial on [√½−1, √2−1]
_LOGP = tuple(_f32(c) for c in (
    3.3333331174e-1, -2.4999993993e-1, 2.0000714765e-1, -1.6668057665e-1,
    1.4249322787e-1, -1.2420140846e-1, 1.1676998740e-1, -1.1514610310e-1,
    7.0376836292e-2,
))
_TINY = _f32(1e-38)


def _reduce_pi(x: torch.Tensor) -> torch.Tensor:
    """x − 2π·round(x/2π) ∈ [−π, π]; ``torch.round`` rounds half to even,
    as ``jnp.round`` does."""
    k = torch.round(x * _INV_TWO_PI)
    r = (x - k * _TWO_PI_HI) - k * _TWO_PI_LO
    return torch.clamp(r, -_PI, _PI)  # keeps the polynomial finite for huge |x|


def _sin_folded(r: torch.Tensor) -> torch.Tensor:
    r = torch.where(r > _HALF_PI, _PI - r, torch.where(r < -_HALF_PI, -_PI - r, r))
    r2 = r * r
    return r + r * r2 * (_S3 + r2 * (_S5 + r2 * (_S7 + r2 * _S9)))


def fsin(x: torch.Tensor) -> torch.Tensor:
    return _sin_folded(_reduce_pi(x))


def fcos(x: torch.Tensor) -> torch.Tensor:
    # cos x = sin(x + π/2), reduced in its own pass
    return _sin_folded(_reduce_pi(x + _HALF_PI))


def fsincos(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return fsin(x), fcos(x)


def flog(x: torch.Tensor) -> torch.Tensor:
    """Natural log for x > 0 (normal floats), in float32: exponent split by
    bit-casting, the √2 mantissa adjustment, then the logf polynomial."""
    xi = x.to(torch.float32).view(torch.int32)
    e = ((xi >> 23) & 0xFF) - 127
    m = ((xi & 0x007FFFFF) | 0x3F800000).view(torch.float32)
    big = m > _SQRT2
    m = torch.where(big, m * 0.5, m)
    ef = (e + big.to(torch.int32)).to(torch.float32)
    t = m - 1.0
    z = t * t
    p = _LOGP[-1]
    for c in reversed(_LOGP[:-1]):
        p = c + t * p
    y = t - 0.5 * z + t * z * p
    return y + ef * _LOG2


def frsqrt(x: torch.Tensor) -> torch.Tensor:
    """rsqrt with one Newton refinement."""
    y = torch.rsqrt(x)
    return y * (1.5 - 0.5 * x * y * y)


def fsqrt(x: torch.Tensor) -> torch.Tensor:
    return x * frsqrt(torch.clamp(x, min=_TINY))


def freciprocal(x: torch.Tensor) -> torch.Tensor:
    """1/x. Exact outside a kernel; the kernel's version is the hardware
    approximate reciprocal (``rcp.approx.f32``)."""
    return 1.0 / x


def fdiv(num, den):
    """num/den. Exact single-rounding division outside a kernel; in the
    kernel, num · rcp.approx(den)."""
    return num / den
