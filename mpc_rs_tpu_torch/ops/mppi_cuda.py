"""Fused MPPI solve (K2) and receding-horizon chain (K1): CUDA kernels and
their plain PyTorch versions.

Replaces ``mpc_rs_tpu/ops/mppi_pallas.py``: ``mppi_solve_fused`` stands for
``mppi_solve_pallas`` (``mppi_pallas_partials`` + ``finalize_partials``) and
``mppi_chain_fused`` for ``mppi_pallas_chain``. The kernels are in
``ops/csrc/mppi_kernels.cu``; their design note says what bounds them.

Each wrapper takes tensors on one device. On CPU tensors it runs the plain
version beside it (the CPU tests use it); on CUDA tensors it launches the
kernel or raises — it never falls back. ``launches`` counts, per wrapper,
the calls that launched the kernels (a solve is two launches, a chain of J
solves 2J), so a run can show that it went through the kernels.

The kernels are specialised for one model, the exact-tier nonlinear
cart-pole with the ``shaped4`` cost (``CartPoleShaped4``); the Pallas
kernels traced arbitrary callables instead (``mppi_pallas.py:287-297``).
Sampling is Philox4x32-10 + Box-Muller by the contract of ``ops/philox.py``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

import torch

from mpc_rs_tpu_torch.controllers.mppi import MppiConfig, MppiStatus, rollout_scores
from mpc_rs_tpu_torch.models import costs, dynamics
from mpc_rs_tpu_torch.models.params import CartPoleParams
from mpc_rs_tpu_torch.ops.philox import philox_normal

BLOCK = 256  # rollouts per block: the kernel's threads per block
HORIZON = 8  # the one horizon N the kernels are built for (kN in the source)
NEG_BIG = -3.4e38  # score of a block with no finite rollout (mppi_pallas.py:302)
NO_FINITE_BELOW = -3.3e38  # mppi_pallas.py:898,1022

# Wrapper calls that launched their kernels since the last reset; CPU calls
# do not count.
launches = {"mppi_solve_fused": 0, "mppi_chain_fused": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@dataclasses.dataclass(frozen=True)
class CartPoleShaped4:
    """The model the kernels are built for: ``make_cartpole_nonlinear(params,
    dt)`` (exact tier) with ``costs.shaped4``."""

    params: CartPoleParams
    dt: float
    n_state = 4

    @functools.cached_property
    def step(self):
        return dynamics.make_cartpole_nonlinear(self.params, self.dt)

    cost = staticmethod(costs.shaped4)

    def constants(self) -> list[float]:
        """The functor's constants, each folded in double as the JAX trace
        folds the Python-float products of ``dynamics.py:74-99``; ctypes
        rounds each to float32 once."""
        p = self.params
        ml = p.m2 * p.l
        return [
            p.d0,
            ml * ml,
            ml,
            p.kt,
            p.r_w,
            p.mass_line * p.m2 * p.g * p.l,
            p.j2 + p.m2 * p.l * p.l,
            p.m2 * p.g * p.l * p.l,
            self.dt,
        ]


class ChainResult(NamedTuple):
    u0s: torch.Tensor  # (J,) first control of each solve (0 on failure)
    statuses: torch.Tensor  # (J,) int32 MppiStatus
    u_n: torch.Tensor  # (N,) warm start after the last solve
    x: torch.Tensor  # (S,) state after the last plant step (x0 without plant)


# --------------------------------------------------------------------------
# plain versions


def mppi_partials_plain(cfg: MppiConfig, model: CartPoleShaped4, x: torch.Tensor,
                        u_n: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Per-block log-sum-exp partials of one solve, what
    ``mppi_partials_kernel`` writes: rows (m_b, s_b, uw_b[0..N-1]) for blocks
    of ``BLOCK`` rollouts, in the dtype of ``u_n``. A block without a finite
    rollout has m_b = NEG_BIG and zeros."""
    k, n = noise.shape
    v = torch.clamp(u_n + noise, cfg.limit[0], cfg.limit[1])
    score = rollout_scores(model.step, model.cost, tuple(x.unbind()), v, u_n,
                           cfg.std_dev, cfg.control_inv)
    nb = -(-k // BLOCK)
    pad = nb * BLOCK - k  # rollouts past K count as non-finite
    score = torch.nn.functional.pad(score, (0, pad), value=torch.nan).reshape(nb, BLOCK)
    v = torch.nn.functional.pad(v, (0, 0, 0, pad)).reshape(nb, BLOCK, n)
    finite = torch.isfinite(score)
    m_b = torch.where(finite, score, NEG_BIG).amax(dim=1)
    e = torch.where(finite, torch.exp((score - m_b[:, None]) / cfg.lambda_), 0.0)
    s_b = e.sum(dim=1)
    uw_b = (e[:, :, None] * v).sum(dim=1)
    return torch.cat([m_b[:, None], s_b[:, None], uw_b], dim=1)


def finalize_partials_plain(cfg: MppiConfig, partials: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge partials rows by log-sum-exp and apply the status ladder and
    zero fallback of ``finalize_partials`` (mppi_pallas.py:1021-1036), what
    ``mppi_finalize_kernel`` does. Returns (u_n', status int32)."""
    m_b, s_b, uw_b = partials[:, 0], partials[:, 1], partials[:, 2:]
    m = m_b.max()
    scale = torch.where(m_b > NO_FINITE_BELOW, torch.exp((m_b - m) / cfg.lambda_), 0.0)
    s = (s_b * scale).sum()
    uw = (uw_b * scale[:, None]).sum(dim=0)
    no_finite = m <= NO_FINITE_BELOW
    sum_zero = s == 0.0
    u_new = uw / torch.where(sum_zero, 1.0, s)
    status = torch.where(
        no_finite,
        MppiStatus.NO_FINITE,
        torch.where(
            sum_zero,
            MppiStatus.SUM_ZERO,
            torch.where(torch.isfinite(u_new[0]), MppiStatus.OK, MppiStatus.INVALID_U),
        ),
    ).to(torch.int32)
    return torch.where(status == MppiStatus.OK, u_new, 0.0), status


def mppi_solve_plain(cfg: MppiConfig, model: CartPoleShaped4, x: torch.Tensor,
                     u_n: torch.Tensor, *, seed: int = 0, solve: int = 0,
                     noise: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``mppi_solve_fused``, in the dtype of ``u_n``."""
    if noise is None:
        noise = philox_normal(seed, solve, cfg.n_rollouts, cfg.n_horizon, cfg.std_dev,
                              device=u_n.device)
    eps = noise.to(u_n.dtype)
    return finalize_partials_plain(cfg, mppi_partials_plain(cfg, model, x, u_n, eps))


def mppi_chain_plain(cfg: MppiConfig, model: CartPoleShaped4, x: torch.Tensor,
                     u_n: torch.Tensor, *, seeds: torch.Tensor | None = None,
                     n_solves: int | None = None, base_seed: int = 0,
                     noise: torch.Tensor | None = None, plant: bool = False) -> ChainResult:
    """Plain version of ``mppi_chain_fused``: J sequential plain solves, the
    warm start carried verbatim, the plant stepped in the dtype of ``x``."""
    j_total = _chain_length(seeds, n_solves, noise)
    x = x.clone()
    u0s, statuses = [], []
    for j in range(j_total):
        seed, solve = (int(seeds[j]), 0) if seeds is not None else (base_seed, j)
        u_n, st = mppi_solve_plain(cfg, model, x, u_n, seed=seed, solve=solve,
                                   noise=None if noise is None else noise[j])
        u0s.append(u_n[0])
        statuses.append(st)
        if plant:
            x = torch.stack(model.step(*x.unbind(), u_n[0].to(x.dtype)))
    return ChainResult(torch.stack(u0s), torch.stack(statuses), u_n, x)


def _chain_length(seeds, n_solves, noise) -> int:
    if (seeds is None) == (n_solves is None):
        raise ValueError("pass exactly one of seeds (J,) or n_solves")
    j = int(seeds.shape[0]) if seeds is not None else int(n_solves)
    if j < 1:
        raise ValueError(f"a chain needs at least one solve, got {j}")
    if noise is not None and noise.shape[0] != j:
        raise ValueError(f"noise has {noise.shape[0]} solves, the chain {j}")
    return j


# --------------------------------------------------------------------------
# kernel wrappers


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _kernel_args(cfg: MppiConfig, model: CartPoleShaped4, x, u_n, noise, noise_shape):
    """Validate for the kernel; return (library, common leading C args)."""
    from mpc_rs_tpu_torch.ops import build

    device = x.device
    if device.type != "cuda":
        raise ValueError(f"the fused kernels take CPU or CUDA tensors, got {device}")
    n, k = cfg.n_horizon, cfg.n_rollouts
    if n != HORIZON:
        raise ValueError(f"no kernel for horizon N={n}; the kernels are built for N={HORIZON}")
    if not 1 <= k < 2**31 - BLOCK:
        raise ValueError(f"n_rollouts must be in [1, 2**31 - {BLOCK}), got {k}")
    _check("x", x, (model.n_state,), torch.float32, device)
    _check("u_n", u_n, (n,), torch.float32, device)
    if noise is not None:
        _check("noise", noise, noise_shape, torch.float32, device)
    lib = build.load_library()
    consts = (ctypes.c_float * 9)(*model.constants())
    lo, hi = cfg.limit
    inv = cfg.std_dev ** -2.0 if cfg.control_inv is None else cfg.control_inv
    head = (consts, n, k, cfg.lambda_, inv, lo, hi, cfg.std_dev)
    return lib, head


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaGetLastError() = {err}")


def mppi_solve_fused(cfg: MppiConfig, model: CartPoleShaped4, x: torch.Tensor,
                     u_n: torch.Tensor, *, seed: int = 0, solve: int = 0,
                     noise: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """One MPPI solve (K2): returns (u_n' (N,), status int32 0-d), with the
    semantics of ``controllers.mppi.mppi_solve`` (zero fallback on failure).

    ``noise``: optional (K, N) perturbations, already scaled by σ; without
    it the kernel samples Philox noise keyed by ``seed`` with ``solve`` in
    the counter (``ops/philox.py``). CUDA tensors must be float32.
    """
    if x.device.type == "cpu":
        return mppi_solve_plain(cfg, model, x, u_n, seed=seed, solve=solve, noise=noise)
    lib, head = _kernel_args(cfg, model, x, u_n, noise, (cfg.n_rollouts, cfg.n_horizon))
    nb = -(-cfg.n_rollouts // BLOCK)
    partials = torch.empty((nb, cfg.n_horizon + 2), dtype=torch.float32, device=x.device)
    u_out = torch.empty_like(u_n)
    status = torch.empty((), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mpc_mppi_solve(
            *head, _ptr(x), _ptr(u_n), _ptr(noise), _ptr(None), 0,
            seed & 0xFFFFFFFF, solve & 0xFFFFFFFF,
            _ptr(partials), _ptr(u_out), _ptr(status), ctypes.c_void_p(stream),
        )
    _raise_on(err, "mppi_solve_fused")
    launches["mppi_solve_fused"] += 1
    return u_out, status


def mppi_chain_fused(cfg: MppiConfig, model: CartPoleShaped4, x: torch.Tensor,
                     u_n: torch.Tensor, *, seeds: torch.Tensor | None = None,
                     n_solves: int | None = None, base_seed: int = 0,
                     noise: torch.Tensor | None = None, plant: bool = False) -> ChainResult:
    """J receding-horizon solves (K1), each warm-started verbatim from the
    last; with ``plant`` the state takes one model step with each solve's
    u0 (a device-resident closed loop), otherwise x is held.

    Seeding: ``seeds`` (J,) int32 — solve j keys Philox with seeds[j], and
    draws what ``mppi_solve_fused(seed=seeds[j])`` draws; or ``n_solves``
    with ``base_seed`` — key base_seed, solve index j in the counter.
    ``noise`` (J, K, N) replaces sampling. The kernel works in its own
    copies of ``x`` and ``u_n``, updated in place and returned.
    """
    j = _chain_length(seeds, n_solves, noise)
    if x.device.type == "cpu":
        return mppi_chain_plain(cfg, model, x, u_n, seeds=seeds, n_solves=n_solves,
                                base_seed=base_seed, noise=noise, plant=plant)
    lib, head = _kernel_args(cfg, model, x, u_n, noise, (j, cfg.n_rollouts, cfg.n_horizon))
    if seeds is not None:
        _check("seeds", seeds, (j,), torch.int32, x.device)
    nb = -(-cfg.n_rollouts // BLOCK)
    partials = torch.empty((nb, cfg.n_horizon + 2), dtype=torch.float32, device=x.device)
    x_buf, u_buf = x.clone(), u_n.clone()
    u0s = torch.empty(j, dtype=torch.float32, device=x.device)
    statuses = torch.empty(j, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mpc_mppi_chain(
            *head, _ptr(x_buf), _ptr(u_buf), _ptr(noise), _ptr(seeds),
            base_seed & 0xFFFFFFFF, j, int(plant),
            _ptr(partials), _ptr(u0s), _ptr(statuses), ctypes.c_void_p(stream),
        )
    _raise_on(err, "mppi_chain_fused")
    launches["mppi_chain_fused"] += 1
    return ChainResult(u0s, statuses, u_buf, x_buf)
