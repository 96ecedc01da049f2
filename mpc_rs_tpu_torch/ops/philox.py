"""Philox4x32-10 and the samplers of the fused MPPI kernels, in plain
PyTorch.

This is the plain version of the in-kernel samplers of ``ops/csrc/``, which
replace the TPU hardware PRNG and the six branches of ``_fill_vbuf``
(``mpc_rs_tpu/ops/mppi_pallas.py:98-122,140-282``): ``box-muller``,
``clt4``, ``clt2q``, ``clt4a``, ``box-muller-a`` and ``wallace``. Kernel and these functions produce the
same bits (the float transforms up to the last bit of the library
transcendentals), so a sampled solve on the card can be checked against the
plain tier fed this noise, not only by its moments.

Layout contract (replaces ``_rollout_index``, ``mppi_pallas.py:42-49``, and
``pltpu.prng_seed(seed_b, b·100003)``, ``mppi_pallas.py:588``):

- noise is in natural (K, N) order per solve: row k is rollout k, column t
  is step t; a scenario batch is (B, K, N);
- every Philox4x32-10 call has key = (seed, 0) and counter
  (i, c, stream, 0), all uint32. A single solve (K1/K2) uses stream = its
  ``solve`` word; scenario b of a batch uses key seeds[b] and stream = b;
- ``box-muller``: rollout k, steps 4c .. 4c+3 come from call (i=k, c). The
  words (w0, w1) make the pair for steps 4c (cos) and 4c+1 (sin), (w2, w3)
  steps 4c+2 and 4c+3. A pair (a, b): u1 = 2 − bitcast_f32((a >> 9) |
  0x3F800000) ∈ (0, 1], u2 = bitcast_f32((b >> 9) | 0x3F800000) − 1 ∈
  [0, 1), r = σ·√(−2 ln u1), θ = f32(2π)·u2, and the pair is (r cos θ,
  r sin θ);
- ``clt4``: one word per normal. Rollout k, step 4c+i is word i of call
  (k, c), through x2 = (w & 0x00FF00FF) + ((w >> 8) & 0x00FF00FF),
  s4 = (x2 & 0xFFFF) + (x2 >> 16), z = (s4 − 510)·_CLT_INV_SIG,
  ε = z·(f32(A·σ) + f32(B·σ)·z²);
- ``clt4a``: one clt4 normal per rollout PAIR. Pair j holds rollouts 2j and
  2j+1; its step 4c+i is word i of call (j, c); rollout 2j takes +ε and
  2j+1 takes −ε, so every full pair's noise sums to exactly 0. With an odd
  K the last pair has only rollout 2j = K−1 (+ε); its partner index K is
  past K and masked like every rollout past K. (In the kernel the two lanes
  of a pair each make the calls c of their own parity and swap the words'
  normals with ``__shfl_xor_sync``.)
- ``wallace``: windows of ``WALLACE_PERIOD`` = 8 steps. Window c of rollout
  k is call (k, c): (w0, w1) is an exact Box-Muller pair (a, b) of N(0, 1)
  (r = √(−2 ln u1), no σ), step 8c gives σ·a and step 8c+1 σ·b; step 8c+ph,
  ph = 2 .. 7, gives f32(σ/√2)·(±a + b'), where the sign is flipped when bit
  31 of (w2 << (ph − 2)) is set, and b' is the b of rollout
  (k & ~31) | ((k − s_ph) & 31), s_ph = (29·ph + 13) mod 32 (never 0): the
  rotation runs within the warp of 32 consecutive rollouts (L = 32,
  ``__shfl_sync``). Every marginal is exactly N(0, σ²); the steps of a
  window are pairwise uncorrelated. The pool of a partial last warp is
  drawn for all its 32 rollouts, so the rotation is defined for every k.

``fast=True`` computes the transcendentals of box-muller, box-muller-a and
wallace with ``ops/fastmath.py``, as ``_sampling_math(fast)`` does.

Seeds and streams are taken modulo 2³², so a negative int32 seed keys the
same stream as its uint32 bit pattern.

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


SAMPLERS = ("box-muller", "clt4", "clt2q", "clt4a", "box-muller-a", "wallace")  # mppi_pallas.py:116
WALLACE_PERIOD = 8  # mppi_pallas.py:122
WARP = 32  # the wallace rotation width L

# CLT4x8 constants (mppi_pallas.py:98-104)
_CLT_INV_SIG = 1.0 / math.sqrt(4 * (256**2 - 1) / 12.0)
_CLT_A = 0.949188
_CLT_B = 0.018629

# CLT2Q constants (mppi_pallas.py:106-114)
_TRI_INV_SIG = 1.0 / math.sqrt(2 * (256**2 - 1) / 12.0)
_TRI_A = 1.019453
_TRI_B = -0.103499
_TRI_C = 0.029151


def _words(keys: torch.Tensor, streams: torch.Tensor, rows: int, calls: int):
    """The four words of the Philox calls (i, c, stream, 0) keyed
    (key, 0), for i < rows and c < calls; keys and streams (B,) int64.
    Each word is (B, rows, calls)."""
    dev = keys.device
    i = torch.arange(rows, dtype=torch.int64, device=dev)[None, :, None]
    c = torch.arange(calls, dtype=torch.int64, device=dev)[None, None, :]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return philox4x32_10((i, c, (streams & _MASK32)[:, None, None], zero),
                         ((keys & _MASK32)[:, None, None], 0))


def _math(fast: bool):
    if fast:
        from mpc_rs_tpu_torch.ops import fastmath as fm

        return fm.flog, fm.fsqrt, fm.fsin, fm.fcos
    return torch.log, torch.sqrt, torch.sin, torch.cos


def _uniforms(a, b):
    return 2.0 - _bits_to_f32(a), _bits_to_f32(b) - 1.0  # (0, 1], [0, 1)


def _box_muller(w, k: int, n: int, std_dev: float, fast: bool) -> torch.Tensor:
    log, sqrt, sin, cos = _math(fast)
    out = []
    for a, b in ((w[0], w[1]), (w[2], w[3])):
        u1, u2 = _uniforms(a, b)
        r = std_dev * sqrt(-2.0 * log(u1))
        ang = _TWO_PI_F32 * u2
        out += [r * cos(ang), r * sin(ang)]
    # (B, K, C, 4) → (B, K, 4C): step 4c + i is output i of call c
    return torch.stack(out, dim=-1).flatten(2)[:, :k, :n]


def _clt4(w, k: int, n: int, std_dev: float) -> torch.Tensor:
    f32 = dict(dtype=torch.float32, device=w[0].device)
    inv_sig = torch.tensor(_CLT_INV_SIG, **f32)
    ca, cb = torch.tensor(_CLT_A * std_dev, **f32), torch.tensor(_CLT_B * std_dev, **f32)
    out = []
    for wi in w:
        x2 = (wi & 0x00FF00FF) + ((wi >> 8) & 0x00FF00FF)
        s4 = (x2 & 0xFFFF) + (x2 >> 16)
        z = (s4.to(torch.float32) - 510.0) * inv_sig
        out.append(z * (ca + cb * (z * z)))
    return torch.stack(out, dim=-1).flatten(2)[:, :k, :n]


def _clt2q(w, k: int, n: int, std_dev: float) -> torch.Tensor:
    f32 = dict(dtype=torch.float32, device=w[0].device)
    inv_t = torch.tensor(_TRI_INV_SIG, **f32)
    qa, qb, qc = (torch.tensor(c * std_dev, **f32) for c in (_TRI_A, _TRI_B, _TRI_C))
    out = []
    for wi in w:
        x2 = (wi & 0x00FF00FF) + ((wi >> 8) & 0x00FF00FF)
        for half in (x2 & 0xFFFF, x2 >> 16):
            z = (half.to(torch.float32) - 255.0) * inv_t
            s = z * z
            out.append(z * (qa + s * (qb + qc * s)))
    # (B, K, C, 8) → (B, K, 8C): step 8c + 2i + h is half h of word i of call c
    return torch.stack(out, dim=-1).flatten(2)[:, :k, :n]


def _antithetic(eps: torch.Tensor, k: int) -> torch.Tensor:
    """(B, ceil(K/2), N) pair noise → (B, K, N): rollout 2j +ε, 2j+1 −ε."""
    return torch.stack([eps, -eps], dim=2).flatten(1, 2)[:, :k]


def _wallace(w, n: int, std_dev: float, fast: bool) -> torch.Tensor:
    log, sqrt, sin, cos = _math(fast)
    f32 = dict(dtype=torch.float32, device=w[0].device)
    sd, mix = torch.tensor(std_dev, **f32), torch.tensor(std_dev / math.sqrt(2.0), **f32)
    steps = []
    for c in range(-(-n // WALLACE_PERIOD)):
        u1, u2 = _uniforms(w[0][..., c], w[1][..., c])
        r = sqrt(-2.0 * log(u1))
        ang = _TWO_PI_F32 * u2
        a, b = r * cos(ang), r * sin(ang)
        for ph in range(min(WALLACE_PERIOD, n - c * WALLACE_PERIOD)):
            if ph == 0:
                z = sd * a
            elif ph == 1:
                z = sd * b
            else:
                flip = ((w[2][..., c] << (ph - 2)) & 0x80000000) != 0
                shift = (29 * ph + 13) % WARP
                b_rot = b.unflatten(-1, (-1, WARP)).roll(shift, dims=-1).flatten(-2)
                z = mix * (torch.where(flip, -a, a) + b_rot)
            steps.append(z)
    return torch.stack(steps, dim=-1)


def sample_noise(sampler: str, seeds, streams, k: int, n: int, std_dev: float, *,
                 fast: bool = False, device=None) -> torch.Tensor:
    """(B, K, N) float32 noise by the layout contract above: problem b is
    keyed ``seeds[b]`` with ``streams[b]`` in the counter. ``seeds`` and
    ``streams`` are (B,) integer tensors (or ints, for B = 1)."""
    keys = torch.as_tensor(seeds, device=device).to(torch.int64).reshape(-1)
    streams = torch.as_tensor(streams, device=keys.device).to(torch.int64).reshape(-1)
    if sampler == "box-muller":
        return _box_muller(_words(keys, streams, k, -(-n // 4)), k, n, std_dev, fast)
    if sampler == "clt4":
        return _clt4(_words(keys, streams, k, -(-n // 4)), k, n, std_dev)
    if sampler == "clt2q":
        return _clt2q(_words(keys, streams, k, -(-n // 8)), k, n, std_dev)
    if sampler == "clt4a":
        pairs = -(-k // 2)
        return _antithetic(_clt4(_words(keys, streams, pairs, -(-n // 4)), pairs, n, std_dev), k)
    if sampler == "box-muller-a":
        pairs = -(-k // 2)
        return _antithetic(_box_muller(_words(keys, streams, pairs, -(-n // 4)), pairs, n, std_dev, fast), k)
    if sampler == "wallace":
        k_pad = -(-k // WARP) * WARP  # whole warps: the rotation stays inside one
        w = _words(keys, streams, k_pad, -(-n // WALLACE_PERIOD))
        return _wallace(w, n, std_dev, fast)[:, :k]
    raise ValueError(f"unknown sampler {sampler!r}; expected one of {SAMPLERS}")


def philox_normal(seed: int, solve: int, k: int, n: int, std_dev: float, *,
                  device: torch.device | str) -> torch.Tensor:
    """(K, N) float32 noise σ·N(0, 1) of one solve (K1/K2): box-muller, key
    ``seed``, stream ``solve``."""
    return sample_noise("box-muller", seed, solve, k, n, std_dev, device=device)[0].contiguous()
