"""Batched hyperparameter sweep: the whole (λ, σ) grid, one launch a tick.

Port of ``mpc_rs_tpu/apps/tune.py``. The reference tunes MPPI by editing
compile-time constants and re-running (examples/op-mpc-x.rs:16-61, the K/λ/σ
blocks of every mppi4* example); here the sweep is data. An L×S grid × R
seeds = B independent closed-loop episodes (plant = mppi4-non-liner's
nonlinear cart-pole, its x₀ = [0.5, 0, 0.1, 0] and |θ| > 60° tip-over
guard, examples/mppi4.rs:30,50-53) advance together: each tick is one
launch of the sweep's partials kernel over all B episodes, each at its own
(λ, σ) (``ops/mppi_cuda.py::mppi_sweep_batch_fused``, at ``make_sweep``'s
horizon N: 8 for the grid and the CLI, as in the JAX package, and any N of
1-224 on the card through ``make_sweep(n_horizon=N)``), then the plant step
and the accumulators on (B,) tensors on the device, with no host read-back
before the episodes end. The report per cell: survival, mean accumulated
cost and mean softmax effective sample size (ESS → K: λ too hot; ESS → 1:
winner-take-all).

Noise: episode b keys Philox with its seed and takes the tick as the
counter word, so every cell draws the same standard normals for a seed and
tick (scaled by its σ): the common random numbers of the JAX grid, whose
cells share ``seed0 + arange(seeds)``.

    python -m mpc_rs_tpu_torch.apps.run tune --lambdas 0.1,0.5,1.4,2.5 --sigmas 1,3,10 --tune-seeds 8 --k 1024
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from mpc_rs_tpu_torch.apps.common import DEG60, resolve_device
from mpc_rs_tpu_torch.controllers.mppi import MppiConfig
from mpc_rs_tpu_torch.models import costs
from mpc_rs_tpu_torch.models.params import CartPoleParams
from mpc_rs_tpu_torch.ops.mppi_cuda import CartPoleShaped4, SweepModel, check_built, mppi_sweep_batch_fused


def make_sweep(*, k: int, n_horizon: int = 8, dt: float = 0.1, n_ticks: int = 50, limit=(-20.0, 20.0),
               device="cuda", dtype=torch.float32):
    """Returns ``sweep(lambdas (B,), sigmas (B,), seeds (B,)) -> (survived
    (B,) bool, total_cost (B,), mean_ess (B,))`` on ``device``, in float32
    as the JAX sweep (``dtype=torch.float64`` runs the plain version on the
    CPU; the kernel is float32). Any ``n_horizon`` on the CPU, as the JAX
    sweep; on a card every N whose block fits the card's shared memory, N =
    1-224 (``mppi_cuda.SWEEP_MAX_HORIZON``): another raises here, before
    any launch.

    One episode per entry (``tune.py:40-80``): the closed loop on the
    nonlinear cart-pole (examples/mppi4-non-liner.rs:81-94 dynamics, shaped
    cost :20-27), controller model == plant, the warm start u_n carried
    across ticks (examples/mppi4.rs:42); the tip latch |θ| > 60°, the cost
    accumulated unmasked, and the ESS summed only over the ticks before the
    episode tipped."""
    device = resolve_device(device)
    model = CartPoleShaped4(CartPoleParams.single_wheel(), dt)
    if device.type == "cuda":
        check_built(SweepModel(model), n_horizon)
    step, cost = model.step, costs.shaped4
    # λ and σ are the episodes' own (B,) tensors; the config gives N, K and the box
    cfg = MppiConfig(n_horizon=n_horizon, n_rollouts=k, lambda_=1.0, std_dev=1.0, limit=limit)
    f32 = dict(dtype=torch.float32, device=device)
    fx = dict(dtype=dtype, device=device)

    def vec(v, **kw):  # a (B,) tensor of its own on the device
        return v.to(**kw) if isinstance(v, torch.Tensor) else torch.tensor(np.asarray(v), **kw)

    def sweep(lambdas, sigmas, seeds):
        lam, sig = vec(lambdas, **f32), vec(sigmas, **f32)
        seed = vec(seeds, dtype=torch.int32, device=device)
        b = lam.shape[0]
        x = torch.tensor([0.5, 0.0, 0.1, 0.0], **fx).repeat(b, 1)
        u_n = torch.zeros((b, n_horizon), **fx)
        tipped = torch.zeros(b, dtype=torch.bool, device=device)
        c_acc, ess_acc, alive = (torch.zeros(b, **fx) for _ in range(3))
        for tick in range(n_ticks):
            u_n, _, ess = mppi_sweep_batch_fused(cfg, model, x, u_n, lam, sig, seeds=seed, solve=tick)
            x = torch.stack(step(*x.unbind(1), u_n[:, 0]), dim=1)
            was_tipped = tipped
            tipped = tipped | (torch.abs(x[:, 2]) > DEG60)  # examples/mppi4.rs:50-53
            c_acc = c_acc + cost(*x.unbind(1))
            # ESS is a λ-health signal of the upright loop: a tipped episode stops adding to it
            ess_acc = ess_acc + torch.where(was_tipped, 0.0, ess)
            alive = alive + (~was_tipped).to(dtype)
        return ~tipped, c_acc, ess_acc / torch.clamp(alive, min=1.0)

    return sweep


def sweep_grid(lambdas, sigmas, *, seeds: int, k: int, n_ticks: int = 50, seed0: int = 0, device="cuda"):
    """Evaluate the L×S×R grid; returns a list of per-cell dicts
    (``tune.py:83-117``)."""
    lam_g, sig_g, seed_g = np.meshgrid(
        np.asarray(lambdas, np.float32), np.asarray(sigmas, np.float32),
        seed0 + np.arange(seeds, dtype=np.int32), indexing="ij",
    )
    run = make_sweep(k=k, n_ticks=n_ticks, device=device)
    survived, total_cost, mean_ess = run(lam_g.ravel(), sig_g.ravel(), seed_g.ravel())
    surv = survived.cpu().numpy().reshape(lam_g.shape)
    costt = total_cost.cpu().numpy().reshape(lam_g.shape)
    ess = mean_ess.cpu().numpy().reshape(lam_g.shape)
    cells = []
    for i, lam in enumerate(lambdas):
        for j, sig in enumerate(sigmas):
            s = surv[i, j]
            cells.append({
                "lambda": float(lam),
                "sigma": float(sig),
                "survival": float(s.mean()),
                # cost and ESS over the surviving episodes only; None (JSON
                # null) when every seed tipped
                "mean_cost": float(costt[i, j][s].mean()) if s.any() else None,
                "mean_ess": float(ess[i, j][s].mean()) if s.any() else None,
                "seeds": int(s.size),
            })
    return cells


def tune(args):
    """CLI: grid sweep, table to stdout, JSON to <log-dir>/tune/tune.json."""
    lambdas = [float(v) for v in args.lambdas.split(",") if v]
    sigmas = [float(v) for v in args.sigmas.split(",") if v]
    k = args.k or 1024
    n_ticks = max(1, round(args.t_end / 0.1))
    cells = sweep_grid(lambdas, sigmas, seeds=args.tune_seeds, k=k, n_ticks=n_ticks, seed0=args.seed,
                       device=args.device)

    print(f"[tune] {len(lambdas)}x{len(sigmas)} grid x {args.tune_seeds} seeds, "
          f"K={k}, {n_ticks} ticks ({n_ticks * 0.1:.1f} s) per episode "
          f"— {len(cells) * args.tune_seeds} episodes in one launch a tick")
    print(f"{'lambda':>8} {'sigma':>8} {'survival':>9} {'mean_cost':>12} {'mean_ESS':>9}")
    for c in cells:
        cost_s = f"{c['mean_cost']:12.2f}" if c["mean_cost"] is not None else f"{'—':>12}"
        ess_s = f"{c['mean_ess']:9.1f}" if c["mean_ess"] is not None else f"{'—':>9}"
        print(f"{c['lambda']:8.3g} {c['sigma']:8.3g} {c['survival']:9.2f} {cost_s} {ess_s}")
    inf = float("inf")
    best = min(cells, key=lambda c: (-c["survival"], inf if c["mean_cost"] is None else c["mean_cost"]))
    best_cost = "—" if best["mean_cost"] is None else f"{best['mean_cost']:.1f}"
    print(f"[tune] best cell: lambda={best['lambda']:g} sigma={best['sigma']:g} "
          f"(survival {best['survival']:.2f}, cost {best_cost})")

    out_dir = os.path.join(args.log_dir, "tune")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "tune.json")
    with open(path, "w") as f:
        json.dump({"k": k, "n_ticks": n_ticks, "seeds": args.tune_seeds, "cells": cells}, f, indent=1)
    print(f"[tune] wrote {path}")
    return cells
