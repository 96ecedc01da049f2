"""The two diagnostic probes as CUDA kernels, with their plain PyTorch
versions: the kernel op-mix chain (D1) and the mul-add chain (D2).

D1 replaces ``scripts/diag_kernel_mix.py:283`` (``make_chain`` :36): J
warm-started MPPI solves of the fast-tier cart-pole with ``shaped4``, the
state held, with parts of the partials kernel switched off or swapped, one
of ``MODES``:

- ``full``: box-muller sampling, rollout and log-sum-exp, what every solve
  of the fast tier does; ``noroll``: the same sampling, the rollout replaced
  by c += v·v; ``nosample``: the rollout on a ramp, no sampling;
- ``clt`` (clt4), ``cltone``, ``cltbig`` and ``cltreg``: the same values
  from the same words (the three differ only in how the TPU kernel asks
  for its bits and where it keeps the noise; the port keeps noise in
  registers, so they share ``clt``'s kernel); ``clt2q``: two normals a word;
- ``bitsonly``: (w >> 9)·1e-7, the cheapest use of a word; ``cltf``: four
  [1, 2) floats of one word by a mantissa bitcast, then clt4's cubic;
  ``cvtonly``: clt4 on one word a rollout, XORed with 0x9E3779B9·(t+1) per
  step.

Each solve is one launch of ``kernel_mix_partials_kernel``
(``ops/csrc/diag_kernels.cuh``): the main path's partials body
(``mppi_common.cuh``) at R rollouts a thread (``rollouts_per_thread`` of
``ops/mppi_cuda.py``), with the mode's controls and scoring, whose last
block merges the rows by the problem's ticket and sets u_n ← Σ uw · (1/s)
(s = 0 counts as 1) and u0s[j] = u_n[0]: D1's own finalize
(``diag_kernel_mix.py:255-260``), no status ladder and no shift.

Words (replaces ``pltpu.prng_seed(seed, j·100003 + i)`` and the TPU's
calls of each mode): Philox4x32-10 keyed (seed, 0) with counter
(rollout k, call c, solve j, 0), all uint32, as ``ops/philox.py``. Word w of
rollout k is word w mod 4 of call w div 4. Words a rollout: 8 (two calls)
for ``full``, ``noroll``, ``bitsonly``, ``clt``, ``cltone``, ``cltbig``,
``cltf`` and ``cltreg`` (word t is step t; box-muller pairs words t and t+1
for steps t and t+1, t even); 4 (one call) for ``clt2q`` (word i gives steps
2i and 2i+1); 1 for ``cvtonly``; none for ``nosample``. Rollouts are in
natural order; ``nosample``'s ramp is defined on the TPU's blocks of
``ramp_block`` rollouts (bs·128, 8192 at bs = 64): rollout k takes
(u_n[t] + f32(k mod 128)·f32(1e-3)) + f32(1e-4)·f32(k div ramp_block).

D2 replaces ``scripts/diag_bf16_vpu.py:38`` (``make_chain`` :25): on one
(rows, 128) tile, ``inner`` dependent updates x ← x·a + b, b = x₀/2, with
a = f32(1.000001) in float32 and 1.0078125 in bf16. The kernel repeats the
tile's chain in each of ``steps`` CTAs. The float32 update is one fused
rounding (what XLA computes on the CPU); the bf16 update rounds after the
product and after the sum.

The wrappers take CPU or CUDA tensors: on a CPU tensor they run the plain
version, on a CUDA tensor they launch the kernel or raise. ``launches``
counts the calls that launched a kernel, per wrapper, per D1 mode and per
D2 dtype.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from mpc_rs_tpu_torch.controllers.mppi import MppiConfig
from mpc_rs_tpu_torch.ops import philox
from mpc_rs_tpu_torch.ops.mppi_cuda import (
    BLOCK,
    FLEET_HORIZON,
    NEG_BIG,
    CartPoleShaped4,
    _check,
    _library,
    _ptr,
    _raise_on,
    _rpt,
    _sampler_consts,
)

MODES = ("full", "nosample", "noroll", "bitsonly", "cltone", "cltbig", "cltf", "cltreg", "cvtonly",
         "clt2q", "clt")  # diag_kernel_mix.py:57-219
# enum MixMode in diag_kernels.cuh
_MODE_IDS = {"full": 0, "nosample": 1, "noroll": 2, "bitsonly": 3, "clt": 4, "cltone": 4, "cltbig": 4,
             "cltreg": 4, "cltf": 5, "cvtonly": 6, "clt2q": 7}
WORDS = {**{m: 8 for m in MODES}, "clt2q": 4, "cvtonly": 1, "nosample": 0}
RAMP_BLOCK = 64 * 128  # diag_kernel_mix.py:322, bs = 64

_MASK32 = 0xFFFFFFFF
_CVT_XOR = 0x9E3779B9  # diag_kernel_mix.py:160
_CLTF_MU = 4.0 + 510.0 / 256.0  # the mean of four [1, 2) floats of 256 levels
_CLTF_INV_SIG = 256.0 / math.sqrt(4 * (256**2 - 1) / 12.0)
_MANT = 0x007F8000
_ONE_BITS = 0x3F800000

FMA_A = {torch.float32: 1.000001, torch.bfloat16: 1.0078125}  # diag_bf16_vpu.py:27
_FMA_DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}

launches = {"kernel_mix_chain_fused": 0, "fma_chain_fused": 0, **{f"mode:{m}": 0 for m in MODES},
            "fma:float32": 0, "fma:bfloat16": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# --------------------------------------------------------------------------
# D1: plain version


def solve_words(mode: str, seed: int, solve: int, k: int, *, device=None) -> torch.Tensor:
    """(K, W) int64 words (uint32 values) of one solve, by the contract of
    the module docstring; W = ``WORDS[mode]``."""
    w = WORDS[_mode(mode)]
    if w == 0:
        return torch.zeros((k, 0), dtype=torch.int64, device=device)
    keys = torch.tensor([seed], dtype=torch.int64, device=device)
    streams = torch.tensor([solve], dtype=torch.int64, device=device)
    out = philox._words(keys, streams, k, -(-w // 4))  # four (1, K, calls)
    return torch.stack(out, dim=-1).flatten(2)[0, :, :w]


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def _mix_noise(mode: str, w: torch.Tensor, n: int, std_dev: float) -> torch.Tensor:
    """(K, N) float32 noise of the mode from (K, W) words."""
    k, dev = w.shape[0], w.device
    calls = tuple(w[None, :, i::4] for i in range(4))  # word i of each call, (1, K, calls)
    if mode in ("full", "noroll"):
        return philox._box_muller(calls, k, n, std_dev, fast=True)[0]
    if mode in ("clt", "cltone", "cltbig", "cltreg"):
        return philox._clt4(calls, k, n, std_dev)[0]
    if mode == "clt2q":
        return philox._clt2q(calls, k, n, std_dev)[0]
    if mode == "cvtonly":
        steps = [w[None, :, :1] ^ ((_CVT_XOR * (t + 1)) & _MASK32) for t in range(n)]
        return philox._clt4(steps, k, n, std_dev)[0]
    if mode == "bitsonly":
        return (w[:, :n] >> 9).to(torch.float32) * _f32(1e-7, dev)
    if mode == "cltf":
        f = [(((w[:, :n] << s) if s > 0 else (w[:, :n] >> -s)) & _MANT | _ONE_BITS)
             .to(torch.int32).view(torch.float32) for s in (15, 7, -1, -9)]
        z = ((f[0] + f[1]) + (f[2] + f[3]) - _f32(_CLTF_MU, dev)) * _f32(_CLTF_INV_SIG, dev)
        ca, cb = _f32(philox._CLT_A * std_dev, dev), _f32(philox._CLT_B * std_dev, dev)
        return z * (ca + cb * (z * z))
    raise ValueError(f"mode {mode!r} samples no noise")


def _mix_controls(mode: str, cfg: MppiConfig, u_n: torch.Tensor, words: torch.Tensor,
                  ramp_block: int) -> torch.Tensor:
    """(K, N) controls v of one solve in the dtype of u_n."""
    lo, hi = cfg.limit
    if mode == "nosample":
        k = torch.arange(cfg.n_rollouts, dtype=torch.int64, device=u_n.device)
        ramp = (k & 127).to(torch.float32) * _f32(1e-3, u_n.device)
        off = _f32(1e-4, u_n.device) * (k // ramp_block).to(torch.float32)
        return torch.clamp((u_n[None, :] + ramp[:, None]) + off[:, None], lo, hi)
    eps = _mix_noise(mode, words, cfg.n_horizon, cfg.std_dev)
    return torch.clamp(u_n[None, :] + eps.to(u_n.dtype), lo, hi)


def _mix_solve(mode: str, cfg: MppiConfig, model: CartPoleShaped4, x: torch.Tensor,
               u_n: torch.Tensor, words: torch.Tensor, ramp_block: int) -> torch.Tensor:
    """One solve of the chain in the dtype of u_n: controls, rollout (or
    noroll's c += v·v), score, log-sum-exp; returns the new u_n."""
    v = _mix_controls(mode, cfg, u_n, words, ramp_block)
    k, n = v.shape
    inv = cfg.std_dev ** -2.0
    c = torch.zeros(k, dtype=v.dtype, device=v.device)
    ct = torch.zeros_like(c)
    xs = tuple(x[i].expand(k) for i in range(x.shape[0]))
    for t in range(n):
        if mode == "noroll":
            c = c + v[:, t] * v[:, t]
        else:
            xs = model.step(*xs, v[:, t])
            c = c + model.cost(*xs)
        ct = ct + u_n[t] * inv * v[:, t]
    score = -c - ct
    finite = torch.isfinite(score)
    m = torch.where(finite, score, NEG_BIG).amax()
    inv_lambda = torch.tensor(1.0 / cfg.lambda_, dtype=v.dtype, device=v.device)
    e = torch.where(finite, torch.exp((score - m) * inv_lambda), 0.0)
    s = e.sum()
    return (e[:, None] * v).sum(dim=0) * (1.0 / torch.where(s == 0.0, 1.0, s))


def kernel_mix_chain_plain(cfg: MppiConfig, model: CartPoleShaped4, x: torch.Tensor,
                           u_n: torch.Tensor, *, mode: str, n_solves: int, base_seed: int = 0,
                           ramp_block: int = RAMP_BLOCK, words: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``kernel_mix_chain_fused``, in the dtype of u_n
    (float32 or float64; the noise is float32, as the kernel's). ``words``
    (J, K, W) int64 replaces the Philox words (the matched-words seam, as
    ``noise=`` is for the solves)."""
    mode = _mode(mode)
    _check_mix_config(cfg, n_solves, ramp_block)
    if words is not None and tuple(words.shape) != (n_solves, cfg.n_rollouts, WORDS[mode]):
        raise ValueError(f"words has shape {tuple(words.shape)}, expected "
                         f"{(n_solves, cfg.n_rollouts, WORDS[mode])} for mode {mode}")
    u0s = []
    for j in range(n_solves):
        w = (words[j] if words is not None
             else solve_words(mode, base_seed, j, cfg.n_rollouts, device=u_n.device))
        u_n = _mix_solve(mode, cfg, model, x.to(u_n.dtype), u_n, w, ramp_block)
        u0s.append(u_n[0])
    return torch.stack(u0s), u_n


def _mode(mode: str) -> str:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    return mode


def _check_mix_config(cfg: MppiConfig, n_solves: int, ramp_block: int) -> None:
    if cfg.n_horizon != FLEET_HORIZON:
        raise ValueError(f"no kernel for horizon N={cfg.n_horizon}; D1 is built for N={FLEET_HORIZON}")
    if not 1 <= cfg.n_rollouts < 2**31 - 4 * BLOCK:
        raise ValueError(f"n_rollouts must be in [1, 2**31 - {4 * BLOCK}), got {cfg.n_rollouts}")
    if not cfg.lambda_ > 0.0:
        raise ValueError(f"D1 scales by 1/lambda; lambda must be > 0, got {cfg.lambda_}")
    if cfg.control_inv is not None:
        raise ValueError("D1's control term is sigma^-2; control_inv is not taken")
    if n_solves < 1 or ramp_block < 1:
        raise ValueError(f"n_solves and ramp_block must be >= 1, got {n_solves}, {ramp_block}")


# --------------------------------------------------------------------------
# D1: kernel wrapper


class _ChainGraph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    x: torch.Tensor  # (4,) the held state, copied in before a replay
    u_n: torch.Tensor  # (N,) the warm start, updated in place by the chain
    seed: torch.Tensor  # (1,) int32 Philox key
    u0s: torch.Tensor  # (J,)
    partials: torch.Tensor  # (ceil(K/(256 R)), N+2) scratch
    tickets: torch.Tensor  # (1,) int32, left at zero by every launch


# One captured chain per (device, stream, mode, config, model, J, ramp block,
# R), with its own buffers and ticket; replays on that stream only.
_GRAPHS: dict[tuple, _ChainGraph] = {}


def _chain_graph(cfg: MppiConfig, model: CartPoleShaped4, device: torch.device, mode: str, n_solves: int,
                 ramp_block: int, rpt: int) -> _ChainGraph:
    """The chain of ``n_solves`` D1 launches captured once into a CUDA graph
    (the C loop of ``mpc_kernel_mix_chain`` issues them during the capture)."""
    stream = torch.cuda.current_stream(device)
    key = (device.index, stream.cuda_stream, mode, cfg, model, n_solves, ramp_block, rpt)
    if key in _GRAPHS:
        return _GRAPHS[key]
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    g = _ChainGraph(torch.cuda.CUDAGraph(), torch.zeros(model.n_state, **f32), torch.zeros(cfg.n_horizon, **f32),
                    torch.zeros(1, **i32), torch.zeros(n_solves, **f32),
                    torch.empty((-(-cfg.n_rollouts // (BLOCK * rpt)), cfg.n_horizon + 2), **f32),
                    torch.zeros(1, **i32))
    lo, hi = cfg.limit
    args = (_MODE_IDS[mode], model.c_constants[0], _sampler_consts(cfg.std_dev), cfg.n_horizon, cfg.n_rollouts,
            1.0 / cfg.lambda_, cfg.std_dev ** -2.0, lo, hi, cfg.std_dev, _CLTF_MU, _CLTF_INV_SIG, ramp_block, rpt,
            _ptr(g.x), _ptr(g.u_n), _ptr(g.seed), n_solves, _ptr(g.partials), _ptr(g.tickets), _ptr(g.u0s))
    with torch.cuda.graph(g.graph):  # captured on a side stream, replayed on the caller's
        err = _library().mpc_kernel_mix_chain(*args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _raise_on(err, "kernel_mix_chain_fused (capture)")
    _GRAPHS[key] = g
    return g


def kernel_mix_chain_fused(cfg: MppiConfig, model: CartPoleShaped4, x: torch.Tensor,
                           u_n: torch.Tensor, *, mode: str, n_solves: int, base_seed: int = 0,
                           ramp_block: int = RAMP_BLOCK, rollouts_per_thread: int | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """J = ``n_solves`` warm-started D1 solves of ``mode`` from the held
    state x (4,), starting at u_n (N,): returns (u0s (J,), the last u_n).
    ``model`` is the fast-tier ``CartPoleShaped4``; words keyed by
    ``base_seed`` with the solve index in the counter. One launch a solve,
    at R rollouts a thread (``rollouts_per_thread`` forces R, default
    ``mppi_cuda.rollouts_per_thread(K)``). CUDA tensors must be float32.

    On the card the J launches are captured once per (stream, mode, config,
    J, R) into a CUDA graph and replayed: x, u_n and the key are copied
    into the graph's buffers, the outputs out of them. On an H100 the
    replay measured about 1 µs a solve faster than the C loop's launches on
    the host-clock marginal (``runtime/profile_d1.py``, PERF.md §6), and the
    TPU probe runs its J solves in one call."""
    mode = _mode(mode)
    rpt = _rpt(cfg.n_rollouts, 1, rollouts_per_thread)
    if x.device.type == "cpu":
        return kernel_mix_chain_plain(cfg, model, x, u_n, mode=mode, n_solves=n_solves,
                                      base_seed=base_seed, ramp_block=ramp_block)
    if x.device.type != "cuda":
        raise ValueError(f"the fused kernels take CPU or CUDA tensors, got {x.device}")
    if not (isinstance(model, CartPoleShaped4) and model.fast):
        raise ValueError("the D1 kernel is built for the fast-tier CartPoleShaped4 only")
    _check_mix_config(cfg, n_solves, ramp_block)
    _check("x", x, (model.n_state,), torch.float32, x.device)
    _check("u_n", u_n, (cfg.n_horizon,), torch.float32, x.device)
    with torch.cuda.device(x.device):
        g = _chain_graph(cfg, model, x.device, mode, n_solves, ramp_block, rpt)
        g.x.copy_(x)
        g.u_n.copy_(u_n)
        key = base_seed & 0xFFFFFFFF
        g.seed.copy_(torch.tensor([key - (1 << 32) if key >= 1 << 31 else key], dtype=torch.int32),
                     non_blocking=True)
        g.graph.replay()
        u0s, u_out = g.u0s.clone(), g.u_n.clone()
    launches["kernel_mix_chain_fused"] += 1
    launches[f"mode:{mode}"] += 1
    return u0s, u_out


# --------------------------------------------------------------------------
# D2: plain version and kernel wrapper


def fma_chain_plain(x: torch.Tensor, inner: int) -> torch.Tensor:
    """``inner`` updates x ← x·a + x₀/2 of the tile x, float32 or bf16. In
    float32 each update rounds once: the product of two float32 values is
    exact in float64, and so is its sum with b while the two lie within
    2⁵ of each other in magnitude (true along the probe's same-sign chains
    from |x₀| in [1, 2)), so rounding that sum to float32 is the fused
    rounding. In bf16 torch rounds after each op."""
    a = FMA_A[_fma_dtype(x)]
    if x.dtype == torch.bfloat16:
        b = x * 0.5
        for _ in range(inner):
            x = x * a + b
        return x
    a64 = float(torch.tensor(a, dtype=torch.float32))
    b = (x * 0.5).double()
    for _ in range(inner):
        x = (x.double() * a64 + b).to(torch.float32)
    return x


def _fma_dtype(x: torch.Tensor) -> torch.dtype:
    if x.dtype not in FMA_A:
        raise TypeError(f"the mul-add chain takes float32 or bfloat16 tiles, got {x.dtype}")
    return x.dtype


def fma_chain_fused(x: torch.Tensor, inner: int, steps: int) -> torch.Tensor:
    """The tile after ``inner`` updates, computed by each of ``steps`` CTAs
    (every CTA stores the same values). x is (rows, 128), float32 with rows
    32 or 64, or bf16 with rows 64 or 128 (16 or 32 values, or bf16 pairs, a
    thread). On a CPU tensor: ``fma_chain_plain`` (``steps`` is the kernel's
    repetition and changes nothing)."""
    dtype = _fma_dtype(x)
    if inner < 0 or steps < 1:
        raise ValueError(f"inner must be >= 0 and steps >= 1, got {inner}, {steps}")
    if x.device.type == "cpu":
        return fma_chain_plain(x, inner)
    if x.device.type != "cuda":
        raise ValueError(f"the fused kernels take CPU or CUDA tensors, got {x.device}")
    count = x.numel() // (2 if dtype == torch.bfloat16 else 1)  # values of the kernel's type
    if x.dim() != 2 or x.shape[1] != 128 or count not in (16 * BLOCK, 32 * BLOCK):
        raise ValueError(f"the kernel takes (rows, 128) tiles of 16 or 32 values (bf16: pairs) a thread, "
                         f"rows 32/64 (float32) or 64/128 (bfloat16); got {tuple(x.shape)} {dtype}")
    _check("x", x, tuple(x.shape), dtype, x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().mpc_fma_chain(_FMA_DTYPE_IDS[dtype], count, inner, steps, FMA_A[dtype],
                                       _ptr(x), _ptr(out), ctypes.c_void_p(stream))
    _raise_on(err, "fma_chain_fused")
    launches["fma_chain_fused"] += 1
    launches[f"fma:{str(dtype).removeprefix('torch.')}"] += 1
    return out
