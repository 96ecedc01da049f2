"""MPPI example runners — port of ``mpc_rs_tpu/apps/mppi_examples.py:47-87``.

Only ``mppi4-non-liner`` is ported so far: the receding-horizon MPPI solve
on the nonlinear cart-pole, one solve per 0.1 s control tick, with a float64
host plant step between solves.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from mpc_rs_tpu_torch.apps.common import DEG60, Elapsed, make_mppi_solver, np_step, resolve_device
from mpc_rs_tpu_torch.controllers.mppi import MppiConfig
from mpc_rs_tpu_torch.models import dynamics
from mpc_rs_tpu_torch.models.params import CartPoleParams
from mpc_rs_tpu_torch.ops.mppi_cuda import CartPoleShaped4
from mpc_rs_tpu_torch.runtime.logger import CsvLogger


class LoopResult(NamedTuple):
    x: np.ndarray  # final plant state (float64)
    statuses: list[int]  # MppiStatus of every solve
    tick_seconds: list[float]  # host wall time of each tick (solve + plant step)
    tipped: bool  # |theta| passed 60 degrees and the loop stopped


def closed_loop(solve: Callable, plant_step: Callable, x0, u_n, *, t_end: float, dt: float,
                seed: int, logger: CsvLogger) -> LoopResult:
    """The receding-horizon loop of examples/mppi4.rs:29-70: solve with seed
    ``seed + i`` at tick i, apply u_n[0] for one host plant step, log
    t, u, x, and stop at a 60° tip or at ``t_end``."""
    x = np.asarray(x0, np.float64)
    statuses, ticks = [], []
    tipped = False
    t, i = 0.0, 0
    while t < t_end:
        t0 = time.perf_counter()
        u_n, status = solve(seed + i, x, u_n)
        u0 = float(u_n[0])  # waits for the solve
        x = np_step(plant_step, x, u0)
        ticks.append(time.perf_counter() - t0)
        statuses.append(int(status))
        print(
            f"t: {t:.2f}, u: {u0:6.2f}, "
            f"x: [{x[0]:6.2f}, {x[1]:5.2f}, {x[2]:5.2f}, {x[3]:5.2f}]"
        )
        if abs(x[2]) > DEG60:
            print("x[2] is over 60 degrees")
            tipped = True
            break
        logger.write_row(t, u0, x)
        t += dt
        i += 1
    return LoopResult(x, statuses, ticks, tipped)


def mppi4_non_liner(args) -> LoopResult:
    """Nonlinear cart-pole (the primary single-card workload) —
    examples/mppi4-non-liner.rs: N=8, K=800 000 by default, λ=0.5, σ=3,
    limits ±20, cost shaped4, dt=0.1."""
    p = CartPoleParams.single_wheel()
    t_hor, n = 0.8, 8
    dt = t_hor / n
    k = args.k or 800_000
    cfg = MppiConfig(n_horizon=n, n_rollouts=k, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
    device = resolve_device(args.device)
    model = CartPoleShaped4(p, 0.1)
    solve = make_mppi_solver(cfg, model, device)
    plant = dynamics.make_cartpole_nonlinear(p, 0.1)
    u_n = torch.zeros(n, dtype=torch.float32, device=device)
    el = Elapsed()
    with CsvLogger(f"{args.log_dir}/mppi/mppi.csv") as logger:
        res = closed_loop(solve, plant, [0.5, 0.0, 0.1, 0.0], u_n,
                          t_end=args.t_end, dt=dt, seed=args.seed, logger=logger)
    el.print()
    return res
