"""K-sharded MPPI: one solve's K rollouts split over the ranks of a mesh
axis, merged by one log-sum-exp round of collectives.

Port of ``mpc_rs_tpu/parallel/sharded_mppi.py``. Each rank computes the
softmax partials (m, s, uw) of its K/n rollouts in one launch of the
partials kernel (``ops/mppi_cuda.py::mppi_partials_merged_fused``: the
launch's merging block writes the rank's merged row, where the TPU kernel
returns the device's partials, ``mppi_pallas.py:438``); on CPU tensors its
plain version stands for ``_jnp_partials``. Then, as ``sharded_mppi.py:73-80``:

    m* = all_reduce_MAX(m);  scale = e^((m − m*) f32(1/λ))   (0 where m has no finite rollout)
    (s*, uw*) = all_reduce_SUM(s · scale, uw · scale)

and ``finalize_batch_fused`` (``fleet_finalize_kernel`` on the card) applies
the status ladder and zero fallback to the row (m*, s*, uw*). A solve on
CUDA tensors is two launches (the partials, the finalize) and the two
collectives; it never runs a plain version.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from mpc_rs_tpu_torch.controllers.mppi import MppiConfig
from mpc_rs_tpu_torch.ops.mppi_cuda import (NO_FINITE_BELOW, check_built, finalize_batch_fused, inv_lambda,
                                            mppi_partials_merged_fused)
from mpc_rs_tpu_torch.parallel.mesh import Mesh, all_reduce

SEED_STRIDE = 7919  # rank r of an axis samples with key seed + r·7919 (sharded_mppi.py:110-118)


def rank_seed(seed: int | torch.Tensor, r: int):
    """``seed + r·7919`` wrapped to int32, as the JAX package's int32 sum: an
    int, or an int32 tensor of seeds."""
    if isinstance(seed, torch.Tensor):
        return ((seed.to(torch.int64) + r * SEED_STRIDE + 2**31) % 2**32 - 2**31).to(torch.int32)
    return (int(seed) + r * SEED_STRIDE + 2**31) % 2**32 - 2**31


def merge_rows(cfg: MppiConfig, rows: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The log-sum-exp merge of each problem's rank rows (B, N+2) over
    ``axis``: ``all_reduce`` MAX on m, then ``all_reduce`` SUM on the
    rescaled (s, uw). Returns the merged rows (B, N+2) (m*, s*, uw*), the same
    bits on every rank of the axis. Without a group, the rows themselves.

    The scale is e^((m − m*) f32(1/λ)), zero where m ≤ ``NO_FINITE_BELOW``
    (a rank with no finite rollout), as ``finalize_batch_plain`` scales a
    row. At λ = 0, f32(1/λ) = +inf makes the best rank's scale 0·inf = NaN,
    so the solve ends INVALID_U, as the JAX package's division by λ does."""
    if mesh.group(axis) is None:
        return rows
    m = all_reduce(rows[:, 0].clone(), dist.ReduceOp.MAX, mesh, axis)
    scale = torch.where(rows[:, 0] > NO_FINITE_BELOW, torch.exp((rows[:, 0] - m) * inv_lambda(cfg.lambda_)), 0.0)
    su = all_reduce(rows[:, 1:] * scale[:, None], dist.ReduceOp.SUM, mesh, axis)
    return torch.cat([m[:, None], su], dim=1)


def check_sharded(cfg: MppiConfig, model, n_ranks: int) -> int:
    """K's share a rank, K/n; raises unless n divides K and the partials
    kernel is built for the model at its horizon (``check_built``: a pair of
    ``BUILT``, whose horizons the finalize kernel is built for)."""
    check_built(model, cfg.n_horizon)
    if cfg.n_rollouts % n_ranks:
        raise ValueError(f"K={cfg.n_rollouts} not divisible by {n_ranks} ranks")
    return cfg.n_rollouts // n_ranks


def make_sharded_mppi(cfg: MppiConfig, model, mesh: Mesh, *, axis: str = "rollouts",
                      external_noise: bool = False, sampler: str = "box-muller"):
    """Returns ``solve(seed_or_noise, x, u_n) -> (u_n' (N,), status int32 0-d)``.

    K = cfg.n_rollouts is split evenly over ``mesh``'s ``axis``; ``model`` is
    one of ``ops/mppi_cuda.py``'s at a horizon it is built for (``BUILT``:
    the cart-pole's ``shaped4`` at N = 8-40, the flagship's ``diag4`` and
    the linear cart-pole at 8, the HW flagship's ``commu4`` at 20, mppi2's
    double integrator at 40; on a card the cart-pole past N = 8 takes
    box-muller alone, ``BUILT_FOR``). Rank r samples ``sampler``'s noise with key
    seed + r·7919 (int32) and stream 0, an independent stream a rank; with
    ``external_noise`` the first argument is the global (K, N) noise, already
    scaled by σ, of which rank r takes rows [r·K/n, (r+1)·K/n). x, u_n and
    the noise lie on the rank's device."""
    n = mesh.size(axis)
    k_local = check_sharded(cfg, model, n)
    local = dataclasses.replace(cfg, n_rollouts=k_local)
    r = mesh.coord(axis)

    def solve(seed_or_noise, x: torch.Tensor, u_n: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        if external_noise:
            noise = seed_or_noise[r * k_local:(r + 1) * k_local]
            row = mppi_partials_merged_fused(local, model, x, u_n, noise=noise)
        else:
            row = mppi_partials_merged_fused(local, model, x, u_n, seed=rank_seed(seed_or_noise, r), sampler=sampler)
        u, status = finalize_batch_fused(cfg, merge_rows(cfg, row[None], mesh, axis)[:, None])
        return u[0], status[0]

    return solve

