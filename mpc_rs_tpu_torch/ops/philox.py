"""Philox4x32-10 and the Box-Muller sampler of the fused MPPI kernels, in
plain PyTorch.

This is the plain version of the in-kernel sampler of
``ops/csrc/mppi_kernels.cu`` (which replaces the TPU hardware PRNG and the
``box-muller`` branch of ``_fill_vbuf``, ``mpc_rs_tpu/ops/mppi_pallas.py:
67-70,194-207``). Kernel and this function produce the same bits, so a
sampled solve on the card can be checked exactly against the plain tier fed
this noise, not only by its moments.

Layout contract (replaces ``_rollout_index``, ``mppi_pallas.py:42-49``):

- noise is in natural (K, N) order: row k is rollout k, column t is step t;
- rollout k, steps 4c .. 4c+3 come from ONE Philox4x32-10 call with
  counter = (k, c, solve, 0) and key = (seed, 0), all as uint32;
- the four output words (w0, w1, w2, w3) make two Box-Muller pairs:
  (w0, w1) → steps 4c (cos) and 4c+1 (sin); (w2, w3) → steps 4c+2 (cos) and
  4c+3 (sin). Steps past N are dropped;
- a pair (a, b): u1 = 2 − bitcast_f32((a >> 9) | 0x3F800000) ∈ (0, 1],
  u2 = bitcast_f32((b >> 9) | 0x3F800000) − 1 ∈ [0, 1),
  r = σ·√(−2 ln u1), θ = f32(2π)·u2, and the pair is (r cos θ, r sin θ),
  all in float32.

``seed`` and ``solve`` are taken modulo 2³², so a negative int32 seed keys
the same stream as its uint32 bit pattern.

Integer arithmetic runs on int64 tensors holding uint32 values. The 32×32 →
64 bit multiply splits the counter word into 16-bit halves, so no partial
product exceeds 2⁴⁸ and nothing overflows int64.
"""

from __future__ import annotations

import math

import torch

_M0 = 0xD2511F53
_M1 = 0xCD9E8D57
_W0 = 0x9E3779B9
_W1 = 0xBB67AE85
_MASK32 = 0xFFFFFFFF
_ONE_BITS = 0x3F800000  # bit pattern of 1.0f
_TWO_PI_F32 = 2.0 * math.pi  # rounded to float32 where it meets a tensor


def _mulhilo(m: int, a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of the 64-bit product m·a, for a constant
    multiplier m < 2³² and int64 ``a`` holding uint32 values."""
    p_lo = m * (a & 0xFFFF)  # < 2**48
    p_hi = m * (a >> 16)  # < 2**48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)  # < 2**49
    return (p_hi >> 16) + (mid >> 32), mid & _MASK32


def philox4x32_10(counter: tuple, key: tuple) -> tuple[torch.Tensor, ...]:
    """Philox4x32-10 (Salmon et al., SC'11) on broadcastable int64 tensors
    or ints holding uint32 values. Returns the four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _bits_to_f32(w: torch.Tensor) -> torch.Tensor:
    """uint32 (in int64) → float32 in [1, 2): the top 23 bits as mantissa."""
    return ((w >> 9) | _ONE_BITS).to(torch.int32).view(torch.float32)


def philox_normal(
    seed: int,
    solve: int,
    k: int,
    n: int,
    std_dev: float,
    *,
    device: torch.device | str,
) -> torch.Tensor:
    """(K, N) float32 noise σ·N(0, 1) by the layout contract above."""
    rows = torch.arange(k, dtype=torch.int64, device=device).unsqueeze(1)
    cols = torch.arange(-(-n // 4), dtype=torch.int64, device=device).unsqueeze(0)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    w = philox4x32_10(
        (rows, cols, zero + (solve & _MASK32), zero),
        (seed & _MASK32, 0),
    )
    out = []
    for a, b in ((w[0], w[1]), (w[2], w[3])):
        u1 = 2.0 - _bits_to_f32(a)
        u2 = _bits_to_f32(b) - 1.0
        r = std_dev * torch.sqrt(-2.0 * torch.log(u1))
        ang = _TWO_PI_F32 * u2
        out += [r * torch.cos(ang), r * torch.sin(ang)]
    # (K, C, 4) → (K, 4C): step 4c + i is word-pair output i of call c
    return torch.stack(out, dim=-1).reshape(k, -1)[:, :n].contiguous()
