"""Fused MPPI kernels and their plain PyTorch versions: one solve (K2), the
receding-horizon chain (K1) and the scenario batch of the fleet (K5/K6).

Replaces ``mpc_rs_tpu/ops/mppi_pallas.py``: ``mppi_solve_fused`` stands for
``mppi_solve_pallas`` (``mppi_pallas_partials`` + ``finalize_partials``),
``mppi_chain_fused`` for ``mppi_pallas_chain``, and
``mppi_batch_partials_fused`` + ``finalize_batch_fused`` for
``mppi_pallas_batch_partials`` (both of its kernels) + the vmapped
``finalize_partials``, and ``mppi_solve_batch_fused`` for both with the
vmapped ``finalize_partials``. All of them run one kernel,
``mppi_partials_kernel`` (``ops/csrc/mppi_common.cuh``), at R rollouts a
thread (``rollouts_per_thread``): a solve is one launch, whose last block to
finish merges the partials rows and finishes the solve; a chain of J solves
is J launches, a fleet tick's B solves one. ``mppi_batch_partials_fused``
returns the rows instead, for ``finalize_batch_fused`` (one block a
scenario). ``mppi_partials_merged_fused`` (one solve) and
``mppi_batch_partials_merged_fused`` (B) return each problem's merged row
(m, s, uw), the merge done in the launch and no ladder applied: a rank's
share of a multi-GPU solve (``parallel/sharded_mppi.py``), which
``finalize_batch_fused`` finishes after the all-reduces. The launchers are
in ``ops/csrc/mppi_kernels.cu``, whose design notes say what bounds the
kernel. ``mppi_sweep_batch_fused`` is the batch of ``tune``'s sweep, each
problem at its own (λ, σ), returning the ESS, at any horizon N from 1 to
``SWEEP_MAX_HORIZON`` (the JAX ``tune`` runs a vmap of ``mppi_solve`` at
any N, no Pallas kernel): one launch of a kernel of its own,
``mppi_sweep_kernel`` (``ops/csrc/sweep.cuh``), that takes N at run time.
The cart-pole's solves past N = 8 run the same way: every wrapper above
launches ``mppi_horizons_kernel`` (``ops/csrc/horizons.cu``) for it, one
kernel for N = 9-40 in the sweep's tile layout (``tile_solve.cuh``), with
the partials kernel's grid, rows and Philox words; and
``finalize_batch_fused`` is one kernel for N = 8-40.

Each wrapper takes tensors on one device. On CPU tensors it runs the plain
version beside it (the CPU tests use it); on CUDA tensors it launches the
kernel or raises — it never falls back. ``launches`` counts, per wrapper,
the calls that launched their kernel (a K1 call launches J times, once a
solve), so a run can show that it went through the kernels; the batched
wrappers also count their launches per sampler and in the fast tier.

The kernels are specialised for the models of the apps instead of tracing
arbitrary callables (``mppi_pallas.py:287-297``), each at the horizon its
app runs (``BUILT``): the nonlinear cart-pole with ``shaped4``
(``CartPoleShaped4``: mppi4-non-liner(-s), cartpole4) and the flagship
controller model with ``diag4`` (``Flagship4Diag4``: mppi4-non-liner-ukf,
flagship6), both at N = 8 in the exact or the fast tier (``fast``); and, in
the exact tier, the MPPI application family's double integrator with
``quad2`` at N = 40 (``DoubleIntegratorQuad2``: mppi2), linear cart-pole
with ``shaped4`` at N = 8 (``CartPoleLinearShaped4``: mppi4) and the HW
flagship's ``make_commu4`` with ``costs.commu4`` at N = 20
(``Commu4Cost4``); and the cart-pole with ``shaped4`` in the exact tier at
every horizon of ``serve``'s plan streaming, N = 9-40 (``SERVE_HORIZONS``).
K1/K2 and the scenario batch take every one of them.
Sampling is Philox4x32-10 by the contract of ``ops/philox.py``,
with any of its ``SAMPLERS`` and external noise, at R = 1 and 4, but for
serve's cart-pole, which is built for box-muller alone, at R = 1 (and at
N = 40 R = 4) (``BUILT_FOR``). On a CUDA device a wrapper raises a
``ValueError`` before any launch for a (model, N, source, R) that is not
built (``check_built``); the plain versions take every source and R.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import NamedTuple

import torch

from mpc_rs_tpu_torch.controllers.mppi import MppiConfig, MppiStatus
from mpc_rs_tpu_torch.models import costs, dynamics
from mpc_rs_tpu_torch.models.params import CartPoleParams
from mpc_rs_tpu_torch.ops import fastmath, philox

BLOCK = 256  # threads per block: each group of 256 rollouts of a block
FLEET_HORIZON = 8  # kN in the source: the fleets' N (D1's too, and tune's default)
# serve's plan-streaming horizons: N = clip(round(0.8 / period), max(8, M), 40)
# with --ticks-per-dispatch M > 1 (apps/serve.py:plan_horizon), every N of 9-40
SERVE_HORIZONS = range(9, 41)
# (model_id, N) pairs mppi_partials_kernel is built for (launch_model in
# ops/csrc/mppi_kernels.cu): the cart-pole and the flagship at N = 8 in both
# tiers (FAST_BUILT), the family's models in the exact tier at their apps' N,
# and the cart-pole in the exact tier at serve's plan-streaming N = 9-40
BUILT = frozenset({(0, 8), (1, 8), (2, 40), (3, 8), (4, 20), *((0, n) for n in SERVE_HORIZONS)})
# the horizons fleet_finalize_kernel is built for: those of BUILT's pairs
FINALIZE_HORIZONS = frozenset(n for _, n in BUILT)
FAST_BUILT = frozenset({(0, 8), (1, 8)})
NEG_BIG = -3.4e38  # score of a block with no finite rollout (mppi_pallas.py:302)
NO_FINITE_BELOW = -3.3e38  # mppi_pallas.py:898,1022
ROLLOUTS_PER_THREAD = (1, 4)  # the R the kernel is built for
NOISE_SOURCES = ("external", *philox.SAMPLERS)  # external noise (B, K, N), or a sampler's draw
# The noise sources and R each pair of BUILT is built for: every source at
# R = 1 and 4 (mppi_kernels.cu, family_mppi2.cu, family_mppi4.cu,
# family_commu4.cu), but serve's cart-pole, which draws box-muller alone
# (apps/serve.py): at N = 40 at R = 1 and 4, at N = 9-39 at R = 1 (R = 4
# would need K >= 66 561 at 8 robots). One kernel runs them all
# (mppi_horizons_kernel, ops/csrc/horizons.cu: R tiles of 256 rollouts a
# block).
BUILT_FOR = {(0, n): (("box-muller",), (1, 4) if n == 40 else (1,)) for n in SERVE_HORIZONS}
MIN_BLOCKS = 4 * 132  # four blocks on each of an H100's 132 SMs

# tune's sweep (mppi_sweep_kernel, ops/csrc/sweep.cuh): one kernel for every
# horizon N, the exact cart-pole with shaped4 (``SweepModel``), box-muller or
# external noise. A thread runs R rollouts a tile of 256 R (R = 4 up to N =
# 10, 2 up to 20, else 1, where R divides the block's tiles of 256:
# sweep_rollouts_a_thread, decided here and passed to the launch). A block's
# shared memory holds the tile's controls (256 R N floats) and scores (256
# R), u_n and the running Σ w v (N each) and the reductions' scratch (26
# floats, kTileRed): 4 (256 R (N + 1) + 2 N + 26) bytes
# (sweep_shared_bytes; the C side sizes the launch by the same formula, and
# the card tests hold the two equal through sweep_occupancy), which one
# block of an H100 may take up to 232 448 (227 KB, SWEEP_SHARED_MAX). At R =
# 1 that is 4 (258 N + 282), so the largest horizon is SWEEP_MAX_HORIZON =
# (232 448 / 4 - 282) // 258 = 224; the JAX make_sweep takes any n_horizon,
# and past 224 only the CPU runs it.
SWEEP_SHARED_MAX = 232_448
SWEEP_SCRATCH = 26  # floats: the tile max's 8 partials, 8 (s, Σw²) pairs, the ticket and a pad


def sweep_rollouts_a_thread(n: int, tiles: int) -> int:
    """R, the rollouts a thread of the sweep kernel runs in a tile at horizon
    ``n`` with ``tiles`` tiles of 256 a block (R N ≤ 40, so that the tile's
    controls take at most 40 KB and shared memory keeps five blocks an SM,
    and R | tiles). The wrapper passes it to the kernel."""
    return 4 if n <= 10 and tiles % 4 == 0 else 2 if n <= 20 and tiles % 2 == 0 else 1


def sweep_shared_bytes(n: int, tiles: int = 1) -> int:
    """The sweep kernel's dynamic shared memory a block at horizon ``n``."""
    return 4 * (BLOCK * sweep_rollouts_a_thread(n, tiles) * (n + 1) + 2 * n + SWEEP_SCRATCH)


SWEEP_MAX_HORIZON = (SWEEP_SHARED_MAX // 4 - BLOCK - SWEEP_SCRATCH) // (BLOCK + 2)
# A sweep block runs tiles of 256 rollouts one after another and pays its
# row, its ticket and its share of the merge once (sweep_tiles): the most
# tiles a block, up to SWEEP_MAX_TILES, whose grid still holds
# SWEEP_MIN_BLOCKS_AN_SM blocks for each SM of the card, eight waves at the
# kernel's five blocks an SM. Timed on an H100 (runtime/profile_sweep.py
# --tiles, PERF.md §6): at tune's grid (B = 96, K = 800 000) 16 tiles were
# the fastest at N = 8, 20 and 40 (8: +0.1-0.3 %, 32: +0.7-0.9 %, 64: +1.6-
# 2.0 %, 1: +2.8-15 %); at K = 65 536 4 tiles, 9.3 waves (8 tiles, 4.7
# waves: +1.5-2.6 %; 1 tile: +1.1-12 %).
SWEEP_MIN_BLOCKS_AN_SM = 40
SWEEP_MAX_TILES = 16
H100_SMS = 132  # the SMs the rows of the plain version on the CPU are grouped for


def _sms(device) -> int:
    dev = None if device is None else torch.device(device)
    if dev is not None and dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).multi_processor_count
    return H100_SMS


def sweep_tiles(k: int, b: int, device=None) -> int:
    """Tiles of 256 rollouts a sweep block for B problems of K rollouts on
    ``device``'s card (an H100's 132 SMs for the CPU): the largest power of
    two up to ``SWEEP_MAX_TILES`` whose grid, ceil(ceil(K / 256) / tiles)
    blocks a problem, keeps at least ``SWEEP_MIN_BLOCKS_AN_SM`` blocks an
    SM; 1 when none does (on an H100, tune's grid, B = 96, at K = 800 000:
    16 tiles, 196 blocks a problem; at K = 65 536: 4 tiles)."""
    tiles, least = -(-k // BLOCK), SWEEP_MIN_BLOCKS_AN_SM * _sms(device)
    fits = [t for t in (2 ** i for i in range(SWEEP_MAX_TILES.bit_length())) if -(-tiles // t) * b >= least]
    return max(fits, default=1)


# Wrapper calls that launched their kernels since the last reset; CPU calls
# do not count. "model:<class>" counts the K1/K2/batch calls of each model.
launches = {"mppi_solve_fused": 0, "mppi_chain_fused": 0, "mppi_solve_batch_fused": 0,
            "mppi_batch_partials_fused": 0, "finalize_batch_fused": 0, "mppi_sweep_batch_fused": 0,
            "mppi_partials_merged_fused": 0, "mppi_batch_partials_merged_fused": 0,
            "fastmath_eval": 0,
            "fast_tier": 0, **{f"sampler:{name}": 0 for name in ("external", *philox.SAMPLERS)}}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def built_for(model, n: int) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """The noise sources and R the kernel of ``model`` at horizon ``n`` is
    built for (``BUILT_FOR``; every source at R = 1 and 4 elsewhere)."""
    return BUILT_FOR.get((getattr(model, "model_id", None), n), (NOISE_SOURCES, ROLLOUTS_PER_THREAD))


def rollouts_per_thread(k: int, b: int = 1, model=None, n: int = FLEET_HORIZON) -> int:
    """R for B problems of K rollouts: the largest of ``ROLLOUTS_PER_THREAD``
    whose grid, ceil(K/(256 R)) blocks a problem, keeps at least
    ``MIN_BLOCKS`` blocks (the reductions then run once per 256 R rollouts);
    1 when none does, where R = 4 would leave SMs idle (K1 at K = 10 240).
    The same threshold past N = 8, where the family's R = 4 holds fewer
    blocks an SM (2 at N = 20, 1 at N = 40): measured there, a grid of one
    short wave at R = 4 loses to R = 1 (PERF.md §6). With a ``model``, only
    the R its kernel at horizon ``n`` is built for (``built_for``): 1
    wherever R = 4 is not, as for serve's cart-pole at N = 9-39, at any K."""
    fits = [r for r in built_for(model, n)[1] if -(-k // (BLOCK * r)) * b >= MIN_BLOCKS]
    return max(fits, default=1)


def _rpt(k: int, b: int, forced: int | None, model=None, n: int = FLEET_HORIZON) -> int:
    if forced is None:
        return rollouts_per_thread(k, b, model, n)
    if forced not in ROLLOUTS_PER_THREAD:
        raise ValueError(f"rollouts_per_thread must be one of {ROLLOUTS_PER_THREAD}, got {forced}")
    return forced


def inv_lambda(lambda_: float) -> float:
    """1/λ in double, which ctypes rounds to float32 once (the Pallas kernel's
    f32(1/λ), mppi_pallas.py:348); +inf for λ = 0, whose best rollout then
    weighs 0·inf = NaN, so the solve's status is INVALID_U as with a
    division by 0."""
    return math.inf if lambda_ == 0.0 else 1.0 / lambda_


@dataclasses.dataclass(frozen=True)
class CartPoleShaped4:
    """``make_cartpole_nonlinear(params, dt, fast=fast)`` with
    ``costs.shaped4``: the mppi4-non-liner and cartpole4 controller."""

    params: CartPoleParams
    dt: float
    fast: bool = False
    n_state = 4
    model_id = 0  # kCartPoleShaped4 in mppi_kernels.cu

    @functools.cached_property
    def step(self):
        return dynamics.make_cartpole_nonlinear(self.params, self.dt, fast=self.fast)

    cost = staticmethod(costs.shaped4)

    @functools.cached_property
    def c_constants(self):
        """``constants()`` and ``cost_constants()`` as the C entries take
        them, built once per model."""
        return _c_floats(self.constants()), _c_floats(self.cost_constants() or [0.0] * 4)

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

    def cost_constants(self) -> list[float]:
        return []


@dataclasses.dataclass(frozen=True)
class Flagship4Diag4:
    """``make_flagship4(params, dt, fast=fast)`` with ``make_diag4(*c)``:
    the flagship6 fleet's controller (``apps/fleet.py:121-122``)."""

    params: CartPoleParams
    dt: float
    c: tuple[float, float, float, float] = (0.1, 0.1, 1.0, 0.5)
    fast: bool = False
    n_state = 4
    model_id = 1  # kFlagship4Diag4 in mppi_kernels.cu

    @functools.cached_property
    def step(self):
        return dynamics.make_flagship4(self.params, self.dt, fast=self.fast)

    @functools.cached_property
    def cost(self):
        return costs.make_diag4(*self.c)

    c_constants = CartPoleShaped4.c_constants

    def constants(self) -> list[float]:
        """``Flagship4Consts`` (``ops/csrc/mppi_common.cuh``), folded in
        double as ``dynamics.py:122-173`` folds them."""
        p = self.params
        ml = p.m2 * p.l
        mll_j2 = p.m2 * p.l * p.l + p.j2
        return [
            p.d1_two, ml, mll_j2 * ml, -(ml**2) * p.g, 2.0 * mll_j2, p.r_w, p.kt,
            -(ml**2), p.m2 * p.g, p.l, p.mass_line_two, -2.0 * ml, (ml**2) * p.g,
            (2.0 * mll_j2 / p.r_w) * p.kt, p.l * p.mass_line_two, (2.0 * ml / p.r_w) * p.kt,
            self.dt,
        ]

    def cost_constants(self) -> list[float]:
        return list(self.c)


@dataclasses.dataclass(frozen=True)
class DoubleIntegratorQuad2:
    """``make_double_integrator(dt)`` with ``costs.quad2``: mppi2's
    controller (examples/mppi2.rs), two states, N = 40, exact tier."""

    dt: float
    fast = False
    n_state = 2
    model_id = 2  # kDoubleIntegratorQuad2 in mppi_kernels.cu

    @functools.cached_property
    def step(self):
        return dynamics.make_double_integrator(self.dt)

    cost = staticmethod(costs.quad2)
    c_constants = CartPoleShaped4.c_constants

    def constants(self) -> list[float]:
        """``DoubleIntegrator``: dt."""
        return [self.dt]

    def cost_constants(self) -> list[float]:
        return []


@dataclasses.dataclass(frozen=True)
class CartPoleLinearShaped4:
    """``make_cartpole_linear(params, dt)`` with ``costs.shaped4``: mppi4's
    controller (examples/mppi4.rs), N = 8, exact tier."""

    params: CartPoleParams
    dt: float
    fast = False
    n_state = 4
    model_id = 3  # kCartPoleLinearShaped4 in mppi_kernels.cu

    @functools.cached_property
    def step(self):
        return dynamics.make_cartpole_linear(self.params, self.dt)

    cost = staticmethod(costs.shaped4)
    c_constants = CartPoleShaped4.c_constants

    def constants(self) -> list[float]:
        """``CartPoleLinear`` (a32, b3, a12, b1, dt), folded in double as
        ``dynamics.py:42-45`` folds them."""
        p = self.params
        d = p.d_lin
        return [p.mass_line / d * p.m2 * p.g * p.l, -p.m2 * p.l / d / p.r_w * p.kt,
                -p.m2 * p.m2 * p.g * p.l * p.l / d, (p.m2 * p.l * p.l + p.j2) / d / p.r_w * p.kt,
                self.dt]

    def cost_constants(self) -> list[float]:
        return []


@dataclasses.dataclass(frozen=True)
class Commu4Cost4:
    """``make_commu4(params, dt)`` with ``costs.commu4``: the HW flagship's
    controller (mppi4-ukf-commu.rs, bench.py:230-288), N = 20, exact tier."""

    params: CartPoleParams
    dt: float
    fast = False
    n_state = 4
    model_id = 4  # kCommu4Cost4 in mppi_kernels.cu

    @functools.cached_property
    def step(self):
        return dynamics.make_commu4(self.params, self.dt)

    cost = staticmethod(costs.commu4)
    c_constants = CartPoleShaped4.c_constants

    def constants(self) -> list[float]:
        """``Commu4`` (``ops/csrc/mppi_common.cuh``), folded in double as
        ``dynamics.py:276-292`` folds them."""
        p = self.params
        ml = p.m2 * p.l
        mll_j2 = p.m2 * p.l * p.l + p.j2
        return [p.d1_two, ml, mll_j2 * ml, -(ml**2) * p.g, 2.0 * mll_j2, p.r_w, p.kt, -(ml**2),
                p.m2 * p.g * p.l * p.mass_line_two, -2.0 * ml, self.dt]

    def cost_constants(self) -> list[float]:
        return []


MODELS = (CartPoleShaped4, Flagship4Diag4, DoubleIntegratorQuad2, CartPoleLinearShaped4, Commu4Cost4)
launches.update({f"model:{m.__name__}": 0 for m in MODELS})
launches.update({f"finalize:N={n}": 0 for n in sorted(FINALIZE_HORIZONS)})
launches.update({f"sweep:N={n}": 0 for n in range(1, SWEEP_MAX_HORIZON + 1)})


@dataclasses.dataclass(frozen=True)
class SweepModel:
    """tune's sweep kernel (``mppi_sweep_kernel``) on ``model``, for
    ``check_built``: built for the exact ``CartPoleShaped4`` at every N of
    1-``SWEEP_MAX_HORIZON``, box-muller and external noise."""

    model: object

    @property
    def fast(self) -> bool:
        return self.model.fast

    @property
    def n_state(self) -> int:
        return self.model.n_state


def check_built(model, n: int, source: str | None = None, rpt: int | None = None) -> None:
    """Raise unless K1/K2 and the batch have a kernel for ``model`` at
    horizon ``n`` (and in its tier), or tune's sweep for a ``SweepModel``,
    and, where given, for noise ``source`` (``NOISE_SOURCES``) at ``rpt``
    rollouts a thread (``built_for``; the sweep takes no R, its tiles a
    block are any count). The wrappers check all four on a CUDA device
    before any launch; the plain versions take every source and R."""
    if isinstance(model, SweepModel):
        if not isinstance(model.model, CartPoleShaped4) or model.fast:
            raise ValueError(f"the sweep's kernel is built for the exact CartPoleShaped4, got {model.model}")
        if not 1 <= n <= SWEEP_MAX_HORIZON:
            raise ValueError(f"no sweep kernel for horizon N={n}; it runs N=1-{SWEEP_MAX_HORIZON} (a block's "
                             f"shared memory, {sweep_shared_bytes(n)} bytes at N={n}, past {SWEEP_SHARED_MAX})")
        if source is not None and source not in ("external", "box-muller"):
            raise ValueError(f"no kernel for noise source {source!r} with SweepModel at N={n}; it is built for "
                             f"external, box-muller")
        return
    if not isinstance(model, MODELS):
        raise ValueError(f"no kernel for model {type(model).__name__}; K1/K2 are built for "
                         f"{', '.join(m.__name__ for m in MODELS)}")
    elif (model.model_id, n) not in BUILT:
        built = sorted(m for i, m in BUILT if i == model.model_id)
        raise ValueError(f"no kernel for horizon N={n} with {type(model).__name__}; it is built for N={built}")
    elif model.fast and (model.model_id, n) not in FAST_BUILT:
        raise ValueError(f"no fast-tier kernel for {type(model).__name__} at N={n}")
    sources, rpts = built_for(model, n)
    if source is not None and source not in sources:
        raise ValueError(f"no kernel for noise source {source!r} with {type(model).__name__} at N={n}; "
                         f"it is built for {', '.join(sources)}")
    if rpt is not None and rpt not in rpts:
        raise ValueError(f"no kernel at {rpt} rollouts a thread with {type(model).__name__} at N={n}; "
                         f"it is built for R={list(rpts)}")


class ChainResult(NamedTuple):
    u0s: torch.Tensor  # (J,) first control of each solve (0 on failure)
    statuses: torch.Tensor  # (J,) int32 MppiStatus
    u_n: torch.Tensor  # (N,) warm start after the last solve
    x: torch.Tensor  # (S,) state after the last plant step (x0 without plant)


# --------------------------------------------------------------------------
# plain versions


def _rows_plain(model, xs, u_ns, noise, limit, inv, inv_lam, rows: int, squares: bool = False) -> torch.Tensor:
    """The (B, nb, N+2) rows (m_b, s_b, uw_b) of blocks of ``rows``
    rollouts, with the control-term coefficient ``inv`` and f32(1/λ)
    ``inv_lam`` (numbers, or (B, 1, 1) tensors of one a problem); with
    ``squares`` a last column, the sum of squared weights: (B, nb, N+3)."""
    b, k, n = noise.shape
    v = torch.clamp(u_ns[:, None] + noise, limit[0], limit[1])
    xs_k = tuple(xs[:, i:i + 1].expand(b, k) for i in range(xs.shape[1]))
    c = torch.zeros((b, k), dtype=v.dtype, device=v.device)
    for t in range(n):
        xs_k = model.step(*xs_k, v[:, :, t])
        c = c + model.cost(*xs_k)
    score = -c - torch.sum(u_ns[:, None] * inv * v, dim=-1)
    nb = -(-k // rows)
    pad = nb * rows - k  # rollouts past K count as non-finite
    score = torch.nn.functional.pad(score, (0, pad), value=torch.nan).reshape(b, nb, rows)
    v = torch.nn.functional.pad(v, (0, 0, 0, pad)).reshape(b, nb, rows, n)
    finite = torch.isfinite(score)
    m_b = torch.where(finite, score, NEG_BIG).amax(dim=-1)
    e = torch.where(finite, torch.exp((score - m_b[..., None]) * inv_lam), 0.0)
    cols = [m_b[..., None], e.sum(dim=-1)[..., None], (e[..., None] * v).sum(dim=-2)]
    if squares:
        cols.append((e * e).sum(dim=-1)[..., None])
    return torch.cat(cols, dim=-1)


def mppi_batch_partials_plain(cfg: MppiConfig, model, xs: torch.Tensor, u_ns: torch.Tensor,
                              noise: torch.Tensor, *, rollouts_per_thread: int | None = None
                              ) -> torch.Tensor:
    """Per-block log-sum-exp partials of B solves, what
    ``mppi_partials_kernel`` writes: (B, nb, N+2) rows (m_b, s_b, uw_b) for
    blocks of ``BLOCK``·R rollouts (R from ``rollouts_per_thread(K, B)``
    unless given), in the dtype of ``u_ns``. xs (B, S), u_ns (B, N), noise
    (B, K, N) already scaled by σ. A block without a finite rollout has
    m_b = NEG_BIG and zeros."""
    b, k, n = noise.shape
    inv = cfg.std_dev ** -2.0 if cfg.control_inv is None else cfg.control_inv
    return _rows_plain(model, xs, u_ns, noise, cfg.limit, inv, inv_lambda(cfg.lambda_),
                       BLOCK * _rpt(k, b, rollouts_per_thread, model, n))


def mppi_partials_plain(cfg: MppiConfig, model, x: torch.Tensor, u_n: torch.Tensor,
                        noise: torch.Tensor, *, rollouts_per_thread: int | None = None) -> torch.Tensor:
    """``mppi_batch_partials_plain`` of one solve: (nb, N+2) rows, what
    ``mppi_partials_kernel`` writes on a grid of one problem."""
    return mppi_batch_partials_plain(cfg, model, x[None], u_n[None], noise[None],
                                     rollouts_per_thread=rollouts_per_thread)[0]


def _ladder_plain(m: torch.Tensor, s: torch.Tensor, uw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The status ladder and zero fallback of ``finalize_partials``
    (mppi_pallas.py:1021-1036) on merged totals: the largest score m (...),
    the weight sum s (...) and the weighted controls uw (..., N)."""
    no_finite = m <= NO_FINITE_BELOW
    sum_zero = s == 0.0
    u_new = uw / torch.where(sum_zero, 1.0, s)[..., None]
    status = torch.where(
        no_finite,
        MppiStatus.NO_FINITE,
        torch.where(
            sum_zero,
            MppiStatus.SUM_ZERO,
            torch.where(torch.isfinite(u_new[..., 0]), MppiStatus.OK, MppiStatus.INVALID_U),
        ),
    ).to(torch.int32)
    return torch.where((status == MppiStatus.OK)[..., None], u_new, 0.0), status


def merge_rows_plain(cfg: MppiConfig, partials: torch.Tensor) -> torch.Tensor:
    """Merge each problem's partials rows (..., nb, N+2) by log-sum-exp at
    f32(1/λ), each row scaled by exp((m_b − m) f32(1/λ)) (0 for a row with
    no finite rollout), then summed: the merged row (..., N+2) = (m, s, uw),
    with no ladder. A problem with no finite rollout gives m = NEG_BIG and
    zeros."""
    m_b, s_b, uw_b = partials[..., 0], partials[..., 1], partials[..., 2:]
    m = m_b.amax(dim=-1, keepdim=True)
    scale = torch.where(m_b > NO_FINITE_BELOW, torch.exp((m_b - m) * inv_lambda(cfg.lambda_)), 0.0)
    s = (s_b * scale).sum(dim=-1)
    uw = (uw_b * scale[..., None]).sum(dim=-2)
    return torch.cat([m, s[..., None], uw], dim=-1)


def finalize_batch_plain(cfg: MppiConfig, partials: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge each problem's partials rows (..., nb, N+2) by log-sum-exp
    (``merge_rows_plain``) and apply the status ladder and zero fallback of
    ``finalize_partials`` (mppi_pallas.py:1021-1036), what the merging block
    of ``mppi_partials_kernel`` and ``fleet_finalize_kernel`` do. Returns
    (u_n' (..., N), status (...,) int32)."""
    row = merge_rows_plain(cfg, partials)
    return _ladder_plain(row[..., 0], row[..., 1], row[..., 2:])


def mppi_batch_partials_merged_plain(cfg: MppiConfig, model, xs: torch.Tensor, u_ns: torch.Tensor,
                                     noise: torch.Tensor, *, rollouts_per_thread: int | None = None
                                     ) -> torch.Tensor:
    """Plain version of ``mppi_batch_partials_merged_fused``: each problem's
    ``mppi_batch_partials_plain`` rows merged by ``merge_rows_plain``, (B,
    N+2) in the dtype of ``u_ns``. It stands for the JAX package's
    ``_jnp_partials`` (``mpc_rs_tpu/parallel/sharded_mppi.py:32-46``, one
    pass over the device's rollouts) in the kernel's order of blocks."""
    return merge_rows_plain(cfg, mppi_batch_partials_plain(cfg, model, xs, u_ns, noise,
                                                           rollouts_per_thread=rollouts_per_thread))


def mppi_partials_merged_plain(cfg: MppiConfig, model, x: torch.Tensor, u_n: torch.Tensor,
                               noise: torch.Tensor, *, rollouts_per_thread: int | None = None) -> torch.Tensor:
    """``mppi_batch_partials_merged_plain`` of one solve: the (N+2,) row."""
    return mppi_batch_partials_merged_plain(cfg, model, x[None], u_n[None], noise[None],
                                            rollouts_per_thread=rollouts_per_thread)[0]


def solve_noise(cfg: MppiConfig, model, seed: int, solve: int,
                sampler: str = "box-muller", device=None) -> torch.Tensor:
    """(K, N) float32 noise that K1/K2 sample in-kernel for one solve: key
    ``seed``, stream ``solve`` (``ops/philox.py``), the transcendentals of
    the model's tier."""
    return philox.sample_noise(sampler, seed, solve, cfg.n_rollouts, cfg.n_horizon, cfg.std_dev,
                               fast=model.fast, device=device)[0]


def mppi_solve_plain(cfg: MppiConfig, model, x: torch.Tensor,
                     u_n: torch.Tensor, *, seed: int = 0, solve: int = 0,
                     noise: torch.Tensor | None = None, sampler: str = "box-muller",
                     rollouts_per_thread: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``mppi_solve_fused``, in the dtype of ``u_n``."""
    if noise is None:
        noise = solve_noise(cfg, model, seed, solve, sampler, device=u_n.device)
    eps = noise.to(u_n.dtype)
    return finalize_batch_plain(cfg, mppi_partials_plain(cfg, model, x, u_n, eps,
                                                         rollouts_per_thread=rollouts_per_thread))


def mppi_chain_plain(cfg: MppiConfig, model, x: torch.Tensor,
                     u_n: torch.Tensor, *, seeds: torch.Tensor | None = None,
                     n_solves: int | None = None, base_seed: int = 0,
                     noise: torch.Tensor | None = None, plant: bool = False,
                     sampler: str = "box-muller", rollouts_per_thread: int | None = None) -> ChainResult:
    """Plain version of ``mppi_chain_fused``: J sequential plain solves, the
    warm start carried verbatim, the plant stepped in the dtype of ``x``."""
    j_total = _chain_length(seeds, n_solves, noise)
    x = x.clone()
    u0s, statuses = [], []
    for j in range(j_total):
        seed, solve = (int(seeds[j]), 0) if seeds is not None else (base_seed, j)
        u_n, st = mppi_solve_plain(cfg, model, x, u_n, seed=seed, solve=solve,
                                   noise=None if noise is None else noise[j], sampler=sampler,
                                   rollouts_per_thread=rollouts_per_thread)
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


def _library() -> ctypes.CDLL:
    from mpc_rs_tpu_torch.ops import build

    return build.load_library()


def _c_floats(values) -> ctypes.Array:
    """A float32 array for the C entries: each value, folded in double,
    rounded once."""
    return (ctypes.c_float * len(values))(*values)


@functools.cache
def _sampler_consts(std_dev: float) -> ctypes.Array:
    """The samplers' σ-scaled constants (``sampler_consts`` of the C entries),
    each folded in double and rounded to float32 once, built once per σ."""
    sd = std_dev
    return _c_floats((philox._CLT_A * sd, philox._CLT_B * sd, sd / math.sqrt(2.0),
                      philox._TRI_A * sd, philox._TRI_B * sd, philox._TRI_C * sd))


_TICKETS: dict[tuple[int, int, int], torch.Tensor] = {}


def merge_tickets(device: torch.device, p: int) -> torch.Tensor:
    """The merge's int32 (P,) tickets for ``device``'s current stream: zeroed
    once and kept per (device, stream, P). Every launch leaves them at zero
    (the merging block resets its problem's), so the launches of one stream
    share them; two streams never do."""
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (torch.device(device).index, stream, p)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(p, dtype=torch.int32, device=device)
    return _TICKETS[key]


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaGetLastError() = {err}")


def _launch(fn, args, what: str, tickets: torch.Tensor | None = None) -> None:
    """Call C entry ``fn`` on the current stream; on an error, zero the
    tickets (a launch cut short can leave one set) and raise."""
    err = fn(*args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0 and tickets is not None:
        tickets.zero_()
    _raise_on(err, what)


def _kernel_args(cfg: MppiConfig, model, x, u_n, noise, noise_shape, sampler, rpt):
    """Validate for the kernel; return (library, common leading C args)."""
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"the fused kernels take CPU or CUDA tensors, got {device}")
    if sampler not in philox.SAMPLERS:
        raise ValueError(f"sampler must be one of {philox.SAMPLERS}, got {sampler!r}")
    n, k = cfg.n_horizon, cfg.n_rollouts
    check_built(model, n, "external" if noise is not None else sampler, rpt)
    if not 1 <= k < 2**31 - 4 * BLOCK:
        raise ValueError(f"n_rollouts must be in [1, 2**31 - {4 * BLOCK}), got {k}")
    _check("x", x, (model.n_state,), torch.float32, device)
    _check("u_n", u_n, (n,), torch.float32, device)
    if noise is not None:
        _check("noise", noise, noise_shape, torch.float32, device)
    lib = _library()
    lo, hi = cfg.limit
    inv = cfg.std_dev ** -2.0 if cfg.control_inv is None else cfg.control_inv
    head = (model.model_id, *model.c_constants, int(model.fast), _SAMPLER_IDS[sampler],
            _sampler_consts(cfg.std_dev), n, k, inv_lambda(cfg.lambda_), inv, lo, hi, cfg.std_dev, rpt)
    return lib, head


def mppi_solve_fused(cfg: MppiConfig, model, x: torch.Tensor,
                     u_n: torch.Tensor, *, seed: int = 0, solve: int = 0,
                     noise: torch.Tensor | None = None, sampler: str = "box-muller",
                     rollouts_per_thread: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """One MPPI solve (K2), one launch: returns (u_n' (N,), status int32
    0-d), with the semantics of ``controllers.mppi.mppi_solve`` (zero
    fallback on failure). ``model`` is one of ``MODELS`` at a horizon of
    ``BUILT``; x (S,) and u_n (N,).

    ``noise``: optional (K, N) perturbations, already scaled by σ; without
    it the kernel samples ``sampler``'s Philox noise keyed by ``seed`` with
    ``solve`` in the counter (``ops/philox.py``). The model's ``fast`` picks
    the tier of the rollout and the sampling. ``rollouts_per_thread`` forces
    R (default ``rollouts_per_thread(K)``). CUDA tensors must be float32.
    """
    k = cfg.n_rollouts
    rpt = _rpt(k, 1, rollouts_per_thread, model, cfg.n_horizon)
    if x.device.type == "cpu":
        return mppi_solve_plain(cfg, model, x, u_n, seed=seed, solve=solve, noise=noise,
                                sampler=sampler, rollouts_per_thread=rpt)
    lib, head = _kernel_args(cfg, model, x, u_n, noise, (k, cfg.n_horizon), sampler, rpt)
    partials = torch.empty((-(-k // (BLOCK * rpt)), cfg.n_horizon + 2), dtype=torch.float32,
                           device=x.device)
    u_out = torch.empty_like(u_n)
    status = torch.empty((), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        tickets = merge_tickets(x.device, 1)
        _launch(lib.mpc_mppi_solve, (*head, _ptr(x), _ptr(u_n), _ptr(noise), _ptr(None), 0,
                                     seed & 0xFFFFFFFF, solve & 0xFFFFFFFF, _ptr(partials),
                                     _ptr(tickets), _ptr(u_out), _ptr(status)),
                "mppi_solve_fused", tickets)
    launches["mppi_solve_fused"] += 1
    launches[f"model:{type(model).__name__}"] += 1
    return u_out, status


def mppi_chain_fused(cfg: MppiConfig, model, x: torch.Tensor,
                     u_n: torch.Tensor, *, seeds: torch.Tensor | None = None,
                     n_solves: int | None = None, base_seed: int = 0,
                     noise: torch.Tensor | None = None, plant: bool = False,
                     sampler: str = "box-muller", rollouts_per_thread: int | None = None
                     ) -> ChainResult:
    """J receding-horizon solves (K1), one launch each, each warm-started
    verbatim from the last; with ``plant`` the state takes one step of the
    solve's model (of its tier) with each solve's u0 (a device-resident
    closed loop, the plant of ``bench.py:255``), otherwise x is held. ``sampler``, the tier and
    ``rollouts_per_thread`` as for ``mppi_solve_fused``.

    Seeding: ``seeds`` (J,) int32 — solve j keys Philox with seeds[j], and
    draws what ``mppi_solve_fused(seed=seeds[j])`` draws; or ``n_solves``
    with ``base_seed`` — key base_seed, solve index j in the counter.
    ``noise`` (J, K, N) replaces sampling. The kernel works in its own
    copies of ``x`` and ``u_n``, updated in place and returned.
    """
    j = _chain_length(seeds, n_solves, noise)
    k = cfg.n_rollouts
    rpt = _rpt(k, 1, rollouts_per_thread, model, cfg.n_horizon)
    if x.device.type == "cpu":
        return mppi_chain_plain(cfg, model, x, u_n, seeds=seeds, n_solves=n_solves,
                                base_seed=base_seed, noise=noise, plant=plant, sampler=sampler,
                                rollouts_per_thread=rpt)
    lib, head = _kernel_args(cfg, model, x, u_n, noise, (j, k, cfg.n_horizon), sampler, rpt)
    if seeds is not None:
        _check("seeds", seeds, (j,), torch.int32, x.device)
    partials = torch.empty((-(-k // (BLOCK * rpt)), cfg.n_horizon + 2), dtype=torch.float32,
                           device=x.device)
    x_buf, u_buf = x.clone(), u_n.clone()
    u0s = torch.empty(j, dtype=torch.float32, device=x.device)
    statuses = torch.empty(j, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        tickets = merge_tickets(x.device, 1)
        _launch(lib.mpc_mppi_chain, (*head, _ptr(x_buf), _ptr(u_buf), _ptr(noise), _ptr(seeds),
                                     base_seed & 0xFFFFFFFF, j, int(plant), _ptr(partials),
                                     _ptr(tickets), _ptr(u0s), _ptr(statuses)),
                "mppi_chain_fused", tickets)
    launches["mppi_chain_fused"] += 1
    launches[f"model:{type(model).__name__}"] += 1
    return ChainResult(u0s, statuses, u_buf, x_buf)


# --------------------------------------------------------------------------
# scenario batch (K5/K6): plain versions and kernel wrappers

_SAMPLER_IDS = {"external": 0, "box-muller": 1, "clt4": 2, "clt4a": 3, "wallace": 4,
                "clt2q": 5, "box-muller-a": 6}  # enum Sampler in mppi_common.cuh
MAX_SCENARIOS = 65535  # the grid's y dimension


def batch_noise(cfg: MppiConfig, model, seeds: torch.Tensor, sampler: str, first: int = 0) -> torch.Tensor:
    """(B, K, N) float32 noise that the batched kernel samples in-kernel:
    scenario b keyed ``seeds[b]`` with stream ``first`` + b
    (``ops/philox.py``), the transcendentals of the model's tier."""
    b = seeds.shape[0]
    return philox.sample_noise(sampler, seeds, first + torch.arange(b, device=seeds.device),
                               cfg.n_rollouts, cfg.n_horizon, cfg.std_dev, fast=model.fast)


def _batch_kernel_args(cfg: MppiConfig, model, xs, u_ns, source: str, rpt: int):
    """Validate B problems for the kernel (``check_built`` on the model,
    horizon, noise ``source`` and ``rpt``); return (B, N, K)."""
    device = xs.device
    if device.type != "cuda":
        raise ValueError(f"the fused kernels take CPU or CUDA tensors, got {device}")
    n, k = cfg.n_horizon, cfg.n_rollouts
    check_built(model, n, source, rpt)
    if not 1 <= k < 2**31 - 4 * BLOCK:
        raise ValueError(f"n_rollouts must be in [1, 2**31 - {4 * BLOCK}), got {k}")
    b = xs.shape[0]
    if not 1 <= b <= MAX_SCENARIOS:
        raise ValueError(f"the batched kernel takes 1 to {MAX_SCENARIOS} scenarios, got {b}")
    _check("xs", xs, (b, model.n_state), torch.float32, device)
    _check("u_ns", u_ns, (b, n), torch.float32, device)
    return b, n, k


def _batch(cfg: MppiConfig, model, xs, u_ns, seeds, sampler, noise, noise_out, rollouts_per_thread,
           merge: bool, what: str):
    """The batched kernel: the (B, nb, N+2) rows, and with ``merge`` the
    solves (u_n' (B, N), status (B,)) from the same launch."""
    if (noise is None) == (sampler is None):
        raise ValueError("pass exactly one of noise (B, K, N) or seeds with a sampler")
    if sampler is not None and (sampler not in philox.SAMPLERS or seeds is None):
        raise ValueError(f"sampler must be one of {philox.SAMPLERS}, with seeds (B,) int32")
    rpt = _rpt(cfg.n_rollouts, xs.shape[0], rollouts_per_thread, model, cfg.n_horizon)
    if xs.device.type == "cpu":
        if noise is None:
            noise = batch_noise(cfg, model, seeds, sampler)
        if noise_out is not None:
            noise_out.copy_(noise)
        parts = mppi_batch_partials_plain(cfg, model, xs, u_ns, noise.to(u_ns.dtype),
                                          rollouts_per_thread=rpt)
        return (parts, *finalize_batch_plain(cfg, parts)) if merge else (parts,)
    b, n, k = _batch_kernel_args(cfg, model, xs, u_ns, "external" if noise is not None else sampler, rpt)
    if noise is not None:
        _check("noise", noise, (b, k, n), torch.float32, xs.device)
    else:
        _check("seeds", seeds, (b,), torch.int32, xs.device)
    if noise_out is not None:
        _check("noise_out", noise_out, (b, k, n), torch.float32, xs.device)
    lib = _library()
    name = "external" if noise is not None else sampler
    mc, cc = model.c_constants
    partials = torch.empty((b, -(-k // (BLOCK * rpt)), n + 2), dtype=torch.float32, device=xs.device)
    u_out = torch.empty((b, n), dtype=torch.float32, device=xs.device) if merge else None
    status = torch.empty(b, dtype=torch.int32, device=xs.device) if merge else None
    sd = cfg.std_dev
    with torch.cuda.device(xs.device):
        tickets = merge_tickets(xs.device, b)
        _launch(lib.mpc_fleet_partials,
                (model.model_id, int(model.fast), _SAMPLER_IDS[name], mc, cc, _sampler_consts(sd),
                 n, b, k, inv_lambda(cfg.lambda_), sd ** -2.0 if cfg.control_inv is None else cfg.control_inv,
                 cfg.limit[0], cfg.limit[1], sd, rpt,
                 _ptr(xs), _ptr(u_ns), _ptr(noise), _ptr(seeds), _ptr(partials), _ptr(noise_out),
                 _ptr(tickets), _ptr(u_out), _ptr(status)),
                what, tickets)
    launches[what] += 1
    launches[f"model:{type(model).__name__}"] += 1
    launches[f"sampler:{name}"] += 1
    launches["fast_tier"] += int(model.fast)
    return (partials, u_out, status) if merge else (partials,)


def mppi_batch_partials_fused(cfg: MppiConfig, model, xs: torch.Tensor, u_ns: torch.Tensor, *,
                              seeds: torch.Tensor | None = None, sampler: str | None = None,
                              noise: torch.Tensor | None = None,
                              noise_out: torch.Tensor | None = None,
                              rollouts_per_thread: int | None = None) -> torch.Tensor:
    """Partials of B MPPI solves, one per scenario (K5/K6): (B, nb, N+2)
    rows, nb = ceil(K/(256 R)), for ``finalize_batch_fused`` (the launch
    does not merge them).

    Scenario b solves from xs[b] (B, S) with nominal u_ns[b] (B, N). Pass
    ``noise`` (B, K, N) already scaled by σ, or ``seeds`` (B,) int32 with a
    ``sampler`` of ``ops/philox.py`` (the kernel samples in-kernel, scenario
    b keyed seeds[b], stream b). ``noise_out`` (B, K, N) float32, optional,
    receives the noise the kernel used (for the checks on the card). The
    model's ``fast`` selects the tier; ``rollouts_per_thread`` forces R
    (default ``rollouts_per_thread(K, B)``). CUDA tensors must be float32.
    """
    return _batch(cfg, model, xs, u_ns, seeds, sampler, noise, noise_out, rollouts_per_thread,
                  False, "mppi_batch_partials_fused")[0]


def finalize_batch_fused(cfg: MppiConfig, partials: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge each scenario's (nb, N+2) rows and apply the status ladder
    (``fleet_finalize_kernel``, one warp a scenario): returns
    (u_n' (B, N), status (B,) int32). For rows merged outside the partials
    launch; ``mppi_solve_batch_fused`` merges inside it. One kernel, which
    takes N at run time, for every horizon of ``BUILT``
    (``FINALIZE_HORIZONS``); ``launches`` also counts its calls a horizon
    (``finalize:N=<n>``)."""
    if partials.device.type == "cpu":
        return finalize_batch_plain(cfg, partials)
    b, nb, width = partials.shape
    n = cfg.n_horizon
    if n not in FINALIZE_HORIZONS:
        raise ValueError(f"no finalize kernel for horizon N={n}; it is built for N={sorted(FINALIZE_HORIZONS)}")
    if width != n + 2:
        raise ValueError(f"partials rows must be N+2 = {n + 2} wide, got {width}")
    _check("partials", partials, (b, nb, width), torch.float32, partials.device)
    u_out = torch.empty((b, n), dtype=torch.float32, device=partials.device)
    status = torch.empty(b, dtype=torch.int32, device=partials.device)
    with torch.cuda.device(partials.device):
        _launch(_library().mpc_fleet_finalize,
                (n, b, nb, inv_lambda(cfg.lambda_), _ptr(partials), _ptr(u_out), _ptr(status)),
                "finalize_batch_fused")
    launches["finalize_batch_fused"] += 1
    launches[f"finalize:N={n}"] += 1
    return u_out, status


def mppi_solve_batch_fused(cfg: MppiConfig, model, xs: torch.Tensor, u_ns: torch.Tensor, *,
                           seeds: torch.Tensor | None = None, sampler: str | None = None,
                           noise: torch.Tensor | None = None, noise_out: torch.Tensor | None = None,
                           rollouts_per_thread: int | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """B MPPI solves (``mppi_solve_pallas_batch``) in one launch, the
    arguments as for ``mppi_batch_partials_fused``: each scenario's last
    block merges its rows. Returns (u_n' (B, N), status (B,) int32)."""
    _, u_out, status = _batch(cfg, model, xs, u_ns, seeds, sampler, noise, noise_out,
                              rollouts_per_thread, True, "mppi_solve_batch_fused")
    return u_out, status


# --------------------------------------------------------------------------
# the rank's merged row of a multi-GPU solve (K2 at P = 1, K5/K6 at P = B)


def _merged(cfg: MppiConfig, model, xs, u_ns, *, seeds, base_seed, word0, sampler, noise, noise_out,
            rollouts_per_thread, what: str) -> torch.Tensor:
    """One partials launch of P problems whose merging blocks write the
    merged rows (P, N+2), with no ladder. Problem b samples with key
    seeds[b], or ``base_seed`` when ``seeds`` is None (P = 1), with counter
    word ``word0`` + b; or reads ``noise`` (P, K, N)."""
    if sampler is not None and sampler not in philox.SAMPLERS:
        raise ValueError(f"sampler must be one of {philox.SAMPLERS}, got {sampler!r}")
    rpt = _rpt(cfg.n_rollouts, xs.shape[0], rollouts_per_thread, model, cfg.n_horizon)
    if xs.device.type == "cpu":
        if noise is None:
            noise = (batch_noise(cfg, model, seeds, sampler, word0) if seeds is not None else
                     solve_noise(cfg, model, base_seed, word0, sampler, device=xs.device)[None])
        if noise_out is not None:
            noise_out.copy_(noise)
        return mppi_batch_partials_merged_plain(cfg, model, xs, u_ns, noise.to(u_ns.dtype),
                                                rollouts_per_thread=rpt)
    b, n, k = _batch_kernel_args(cfg, model, xs, u_ns, "external" if noise is not None else sampler, rpt)
    if noise is not None:
        _check("noise", noise, (b, k, n), torch.float32, xs.device)
    elif seeds is not None:
        _check("seeds", seeds, (b,), torch.int32, xs.device)
    if noise_out is not None:
        _check("noise_out", noise_out, (b, k, n), torch.float32, xs.device)
    name = "external" if noise is not None else sampler
    mc, cc = model.c_constants
    partials = torch.empty((b, -(-k // (BLOCK * rpt)), n + 2), dtype=torch.float32, device=xs.device)
    rows = torch.empty((b, n + 2), dtype=torch.float32, device=xs.device)
    sd = cfg.std_dev
    with torch.cuda.device(xs.device):
        tickets = merge_tickets(xs.device, b)
        _launch(_library().mpc_partials_merged,
                (model.model_id, int(model.fast), _SAMPLER_IDS[name], mc, cc, _sampler_consts(sd),
                 n, b, k, inv_lambda(cfg.lambda_), sd ** -2.0 if cfg.control_inv is None else cfg.control_inv,
                 cfg.limit[0], cfg.limit[1], sd, rpt, _ptr(xs), _ptr(u_ns), _ptr(noise), _ptr(seeds),
                 base_seed & 0xFFFFFFFF, word0 & 0xFFFFFFFF, _ptr(partials), _ptr(noise_out), _ptr(tickets),
                 _ptr(rows)),
                what, tickets)
    launches[what] += 1
    launches[f"model:{type(model).__name__}"] += 1
    launches[f"sampler:{name}"] += 1
    launches["fast_tier"] += int(model.fast)
    return rows


def mppi_batch_partials_merged_fused(cfg: MppiConfig, model, xs: torch.Tensor, u_ns: torch.Tensor, *,
                                     seeds: torch.Tensor | None = None, sampler: str | None = None,
                                     noise: torch.Tensor | None = None, noise_out: torch.Tensor | None = None,
                                     rollouts_per_thread: int | None = None, first_scenario: int = 0
                                     ) -> torch.Tensor:
    """Each of B problems' partials merged in the launch, with no ladder:
    (B, N+2) rows (m, s, uw), what a rank of a multi-GPU fleet tick
    contributes to the rollouts axis' collectives (the device's partials of
    ``mppi_pallas_batch_partials``). The arguments are those of
    ``mppi_batch_partials_fused``, and ``first_scenario``: scenario b draws
    stream ``first_scenario`` + b, the draw of scenario ``first_scenario`` + b
    of a whole batch (a rank's sub-batch of a fleet split over the scenario
    axis). One launch of ``mppi_partials_kernel``,
    whose last block of each problem merges its rows (the same merge as
    ``mppi_solve_batch_fused``). A problem with no finite rollout gives
    m = NEG_BIG and zeros. ``finalize_batch_fused`` on the rows (B, 1, N+2)
    finishes the solves."""
    if (noise is None) == (sampler is None):
        raise ValueError("pass exactly one of noise (B, K, N) or seeds with a sampler")
    if sampler is not None and seeds is None:
        raise ValueError(f"sampler must be one of {philox.SAMPLERS}, with seeds (B,) int32")
    return _merged(cfg, model, xs, u_ns, seeds=seeds, base_seed=0, word0=first_scenario, sampler=sampler, noise=noise,
                   noise_out=noise_out, rollouts_per_thread=rollouts_per_thread,
                   what="mppi_batch_partials_merged_fused")


def mppi_partials_merged_fused(cfg: MppiConfig, model, x: torch.Tensor, u_n: torch.Tensor, *, seed: int = 0,
                               solve: int = 0, noise: torch.Tensor | None = None, sampler: str = "box-muller",
                               noise_out: torch.Tensor | None = None,
                               rollouts_per_thread: int | None = None) -> torch.Tensor:
    """One solve's partials merged in the launch (K2 at P = 1), with no
    ladder: the (N+2,) row (m, s, uw), what a rank of the K-sharded solve
    contributes (``mppi_pallas_partials``, ``sharded_mppi.py:110-118``).
    The draw is ``mppi_solve_fused``'s (key ``seed``, stream ``solve``),
    or ``noise`` (K, N); ``noise_out`` (K, N) receives the noise used."""
    k, n = cfg.n_rollouts, cfg.n_horizon
    return _merged(cfg, model, x[None], u_n[None], seeds=None, base_seed=seed, word0=solve,
                   sampler=None if noise is not None else sampler,
                   noise=None if noise is None else noise.reshape(1, k, n),
                   noise_out=None if noise_out is None else noise_out.view(1, k, n),
                   rollouts_per_thread=rollouts_per_thread, what="mppi_partials_merged_fused")[0]


# --------------------------------------------------------------------------
# tune's sweep: B problems, each at its own (λ, σ), with the ESS


def sweep_coefficients(lambdas: torch.Tensor, sigmas: torch.Tensor, dtype=torch.float32
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(1/λ_b, σ_b, σ_b⁻²) (B,) in ``dtype``: 1/λ and σ⁻² folded in double
    and rounded once, as ``inv_lambda`` and the C entries' σ⁻² (+inf for
    λ = 0, whose best rollout then weighs 0·inf = NaN: INVALID_U)."""
    sig = sigmas.to(torch.float64)
    return _inv_lambdas(lambdas, dtype), sig.to(dtype), (sig ** -2.0).to(dtype)


def _inv_lambdas(lambdas: torch.Tensor, dtype) -> torch.Tensor:
    lam = lambdas.to(torch.float64)
    return torch.where(lam == 0.0, math.inf, 1.0 / lam).to(dtype)


def sweep_noise(cfg: MppiConfig, seeds: torch.Tensor, solve: int, sigmas: torch.Tensor) -> torch.Tensor:
    """(B, K, N) float32 noise that the sweep's kernel samples: box-muller,
    problem b keyed ``seeds[b]`` with counter word ``solve`` (the tick) for
    every problem, scaled by σ_b. Problems of one seed draw the same
    standard normals (``ops/philox.py``)."""
    sig = sigmas.to(device=seeds.device, dtype=torch.float32)[:, None, None]
    return philox.sample_noise("box-muller", seeds, solve, cfg.n_rollouts, cfg.n_horizon, sig)


def _tiles(k: int, b: int, forced: int | None, device) -> int:
    if forced is None:
        return sweep_tiles(k, b, device)
    if forced < 1:
        raise ValueError(f"tiles_per_block must be at least 1, got {forced}")
    return forced


def sweep_partials_plain(cfg: MppiConfig, model, xs: torch.Tensor, u_ns: torch.Tensor, noise: torch.Tensor,
                         lambdas: torch.Tensor, sigmas: torch.Tensor, *,
                         tiles_per_block: int | None = None) -> torch.Tensor:
    """The sweep's (B, nb, N+3) rows (m_b, s_b, uw_b, Σw²_b) in the dtype
    of ``u_ns``, each problem at its own 1/λ_b and σ_b⁻²
    (``sweep_coefficients`` in that dtype), a row for the 256 ``tiles``
    rollouts of a kernel's block (``sweep_tiles`` unless
    ``tiles_per_block``). noise (B, K, N) already scaled."""
    b, k, n = noise.shape
    inv_l, _, inv = sweep_coefficients(lambdas, sigmas, u_ns.dtype)
    rows = BLOCK * _tiles(k, b, tiles_per_block, noise.device)
    return _rows_plain(model, xs, u_ns, noise.to(u_ns.dtype), cfg.limit, inv.to(xs.device)[:, None, None],
                       inv_l.to(xs.device)[:, None, None], rows, squares=True)


def finalize_sweep_plain(partials: torch.Tensor, lambdas: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge each problem's (nb, N+3) rows by log-sum-exp at its own 1/λ,
    Σw² scaled by the square of each row's factor, then the status ladder
    and zero fallback; ESS = s² / max(Σw², 1e-30)
    (``mpc_rs_tpu/controllers/mppi.py:145``). Returns (u_n' (B, N),
    status (B,) int32, ess (B,))."""
    inv_l = _inv_lambdas(lambdas, partials.dtype).to(partials.device)
    m_b, s_b, uw_b, q_b = partials[..., 0], partials[..., 1], partials[..., 2:-1], partials[..., -1]
    m = m_b.amax(dim=-1, keepdim=True)
    scale = torch.where(m_b > NO_FINITE_BELOW, torch.exp((m_b - m) * inv_l[:, None]), 0.0)
    s = (s_b * scale).sum(dim=-1)
    uw = (uw_b * scale[..., None]).sum(dim=-2)
    q = (q_b * (scale * scale)).sum(dim=-1)
    u, status = _ladder_plain(m[..., 0], s, uw)
    return u, status, s * s / torch.clamp(q, min=1e-30)


def mppi_sweep_batch_plain(cfg: MppiConfig, model, xs: torch.Tensor, u_ns: torch.Tensor, lambdas: torch.Tensor,
                           sigmas: torch.Tensor, *, seeds: torch.Tensor | None = None, solve: int = 0,
                           noise: torch.Tensor | None = None, tiles_per_block: int | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``mppi_sweep_batch_fused``, in the dtype of ``u_ns``:
    the sweep's noise (``sweep_noise``) or ``noise``, then
    ``sweep_partials_plain`` and ``finalize_sweep_plain``."""
    if noise is None:
        noise = sweep_noise(cfg, seeds, solve, sigmas)
    rows = sweep_partials_plain(cfg, model, xs, u_ns, noise, lambdas, sigmas, tiles_per_block=tiles_per_block)
    return finalize_sweep_plain(rows, lambdas)


def mppi_sweep_batch_fused(cfg: MppiConfig, model, xs: torch.Tensor, u_ns: torch.Tensor, lambdas: torch.Tensor,
                           sigmas: torch.Tensor, *, seeds: torch.Tensor | None = None, solve: int = 0,
                           noise: torch.Tensor | None = None, tiles_per_block: int | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B MPPI solves of ``tune``'s sweep in one launch (``mppi_sweep_kernel``,
    ``ops/csrc/sweep.cuh``): problem b solves from xs[b] (B, 4) with nominal
    u_ns[b] (B, N) at its own λ = lambdas[b] and σ = sigmas[b] (B,), for the
    exact cart-pole with ``shaped4`` (``CartPoleShaped4``, exact tier) at
    any horizon N of 1-``SWEEP_MAX_HORIZON``; ``cfg`` gives N, K and the
    control box (its λ and σ are not read). Pass ``seeds`` (B,) int32 with
    the tick ``solve`` (box-muller, problem b keyed seeds[b] with counter
    word ``solve``: cells of one seed draw the same normals,
    ``sweep_noise``) or ``noise`` (B, K, N) already scaled. Returns (u_n'
    (B, N), status (B,) int32, ess (B,)) with the zero fallback on failure;
    ``tiles_per_block`` forces the tiles of 256 rollouts a block (default
    ``sweep_tiles(K, B, device)``). CUDA tensors must be float32; on a CUDA device
    another model or N raises before any launch (``check_built`` on
    ``SweepModel(model)``). ``launches`` counts each launch, and under
    ``sweep:N=<n>`` its horizon."""
    if (noise is None) == (seeds is None):
        raise ValueError("pass exactly one of noise (B, K, N) or seeds (B,) with the tick `solve`")
    tiles = _tiles(cfg.n_rollouts, xs.shape[0], tiles_per_block, xs.device)
    if xs.device.type == "cpu":
        return mppi_sweep_batch_plain(cfg, model, xs, u_ns, lambdas, sigmas, seeds=seeds, solve=solve,
                                      noise=noise, tiles_per_block=tiles)
    b, n, k = _batch_kernel_args(cfg, SweepModel(model), xs, u_ns,
                                 "external" if noise is not None else "box-muller", None)
    dev = xs.device
    _check("lambdas", lambdas, (b,), torch.float32, dev)
    _check("sigmas", sigmas, (b,), torch.float32, dev)
    if noise is not None:
        _check("noise", noise, (b, k, n), torch.float32, dev)
    else:
        _check("seeds", seeds, (b,), torch.int32, dev)
    inv_l, sig, inv = sweep_coefficients(lambdas, sigmas)
    partials = torch.empty((b, -(-k // (BLOCK * tiles)), n + 3), dtype=torch.float32, device=dev)
    u_out = torch.empty((b, n), dtype=torch.float32, device=dev)
    status = torch.empty(b, dtype=torch.int32, device=dev)
    ess = torch.empty(b, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        tickets = merge_tickets(dev, b)
        _launch(_library().mpc_mppi_sweep,
                (model.c_constants[0], n, b, k, tiles, sweep_rollouts_a_thread(n, tiles), cfg.limit[0], cfg.limit[1], _ptr(xs), _ptr(u_ns),
                 _ptr(noise), _ptr(seeds), solve & 0xFFFFFFFF, _ptr(inv_l), _ptr(sig), _ptr(inv), _ptr(partials),
                 _ptr(tickets), _ptr(u_out), _ptr(status), _ptr(ess)),
                "mppi_sweep_batch_fused", tickets)
    launches["mppi_sweep_batch_fused"] += 1
    launches[f"sweep:N={n}"] += 1
    return u_out, status, ess


def sweep_occupancy(n: int, tiles: int = 1, device=None) -> dict:
    """The sweep kernel on ``device``'s card at horizon ``n`` with ``tiles``
    tiles of 256 rollouts a block: the blocks an SM holds at its dynamic
    shared memory (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), its
    registers a thread and local bytes (``cudaFuncGetAttributes``), R, and
    the dynamic shared bytes a launch asks for as the C side computes them
    (``shared_bytes``; ``sweep_shared_bytes`` should give the same). Raises
    for a horizon past ``SWEEP_MAX_HORIZON``."""
    check_built(SweepModel(CartPoleShaped4(CartPoleParams.single_wheel(), 0.1)), n)
    r = sweep_rollouts_a_thread(n, tiles)
    blocks, regs, local, shared = (ctypes.c_int(0) for _ in range(4))
    with torch.cuda.device(device):
        _raise_on(_library().mpc_sweep_occupancy(n, r, ctypes.byref(blocks), ctypes.byref(regs), ctypes.byref(local),
                                                 ctypes.byref(shared)), "sweep occupancy")
    return {"n": n, "tiles": tiles, "rollouts_a_thread": r, "blocks_per_sm": blocks.value, "registers": regs.value,
            "local_bytes": local.value, "shared_bytes": shared.value}


def horizons_occupancy(n: int, device=None) -> dict:
    """``mppi_horizons_kernel`` (the cart-pole's solves at N = 9-40) on
    ``device``'s card at horizon ``n``: the blocks an SM holds at its dynamic
    shared memory (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), its
    registers a thread and local bytes (``cudaFuncGetAttributes``: one kernel,
    the same at every N) and the dynamic shared bytes a launch asks for."""
    if n not in SERVE_HORIZONS:
        raise ValueError(f"the horizons kernel runs N={SERVE_HORIZONS.start}-{SERVE_HORIZONS.stop - 1}, got {n}")
    blocks, regs, local, shared = (ctypes.c_int(0) for _ in range(4))
    with torch.cuda.device(device):
        _raise_on(_library().mpc_horizons_occupancy(n, ctypes.byref(blocks), ctypes.byref(regs), ctypes.byref(local),
                                                    ctypes.byref(shared)), "horizons occupancy")
    return {"n": n, "blocks_per_sm": blocks.value, "registers": regs.value, "local_bytes": local.value,
            "shared_bytes": shared.value}


# --------------------------------------------------------------------------
# the fast-math device functions, elementwise

FASTMATH_FNS = ("fsin", "fcos", "flog", "frsqrt", "fsqrt", "freciprocal", "fdiv")


def fastmath_eval(fn: str, a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """fn(a) (or fdiv(a, b)) by the ``fastmath.cuh`` device function on a
    CUDA tensor, by ``ops/fastmath.py`` on a CPU tensor (where
    ``freciprocal`` and ``fdiv`` divide exactly)."""
    if fn not in FASTMATH_FNS:
        raise ValueError(f"unknown fast-math function {fn!r}; expected one of {FASTMATH_FNS}")
    if (fn == "fdiv") != (b is not None):
        raise ValueError("fdiv takes a and b; the other functions take a only")
    if a.device.type == "cpu":
        f = getattr(fastmath, fn)
        return f(a) if b is None else f(a, b)
    _check("a", a, a.shape, torch.float32, a.device)
    if b is not None:
        _check("b", b, a.shape, torch.float32, a.device)
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        _launch(_library().mpc_fastmath_eval, (FASTMATH_FNS.index(fn), a.numel(), _ptr(a), _ptr(b), _ptr(out)),
                "fastmath_eval")
    launches["fastmath_eval"] += 1
    return out
