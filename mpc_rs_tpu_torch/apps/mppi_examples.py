"""MPPI example runners — port of ``mpc_rs_tpu/apps/mppi_examples.py``.

The MPPI application family: ``mppi2`` (double integrator, N=40),
``mppi4`` and ``mppi4-non-liner`` (linear and nonlinear cart-pole, N=8),
``mppi4-non-liner-s`` (the multi-rate loop with UKF(4,3)) and
``mppi4-non-liner-ukf`` (the flagship: 6-state plant, UKF2(6,5), the 2 N
pulse). Every MPPI solve runs on the device the caller names: the fused
kernel on a CUDA device (raising when there is none), its plain version
with ``--device cpu``. The plants step in float64 on the host between
solves, as in the JAX package.

The two UKF apps run their small estimator on the host CPU in float32 on
purpose, as the JAX apps pin theirs to the host CPU device
(``mppi_examples.py:283-306``): a 4- or 6-state filter is a few hundred
scalar operations, which a card would spend in launches. It is a placement
of the estimator, not a fallback of the solve, which stays on the device.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from mpc_rs_tpu_torch.apps.common import DEG60, PI_2, Elapsed, make_mppi_solver, np_step, resolve_device
from mpc_rs_tpu_torch.controllers.mppi import MppiConfig
from mpc_rs_tpu_torch.estimators import ukf
from mpc_rs_tpu_torch.models import dynamics, noise, observation
from mpc_rs_tpu_torch.models.params import CartPoleParams
from mpc_rs_tpu_torch.ops.mppi_cuda import (
    CartPoleLinearShaped4,
    CartPoleShaped4,
    DoubleIntegratorQuad2,
    Flagship4Diag4,
)
from mpc_rs_tpu_torch.runtime.console import print_con, print_rcv
from mpc_rs_tpu_torch.runtime.logger import CsvLogger
from mpc_rs_tpu_torch.runtime.loop import MultiRateConfig, pulse_disturbance, run_multirate_loop


class LoopResult(NamedTuple):
    x: np.ndarray  # final plant state (float64)
    statuses: list[int]  # MppiStatus of every solve
    tick_seconds: list[float]  # host wall time of each tick (solve + plant step)
    tipped: bool  # |theta| passed 60 degrees and the loop stopped

    def __array__(self, dtype=None, copy=None):
        """The final state, which the JAX runner returns: the acceptance
        checks read the result as that array (``apps/acceptance.py``)."""
        return np.asarray(self.x, dtype=dtype)


def _tick(solve, seed, x, u_n, plant_step):
    t0 = time.perf_counter()
    u_n, status = solve(seed, x, u_n)
    u0 = float(u_n[0])  # waits for the solve
    x = np_step(plant_step, x, u0)
    return u_n, int(status), u0, x, time.perf_counter() - t0


def regulate_loop(solve: Callable, plant_step: Callable, x0, u_n, *, t_end: float, dt: float,
                  seed: int) -> LoopResult:
    """mppi2's loop (examples/mppi2.rs): solve with seed ``seed + i`` at
    tick i, apply u_n[0] for one host plant step, print, and stop at a
    non-finite control or at ``t_end``."""
    x = np.asarray(x0, np.float64)
    statuses, ticks = [], []
    t, i = 0.0, 0
    while t < t_end:
        u_n, status, u0, x, s = _tick(solve, seed + i, x, u_n, plant_step)
        ticks.append(s)
        statuses.append(status)
        print(f"t: {t:.2f}, u: {u0:5.2f}, x: [{x[0]:.2f}, {x[1]:.2f}]")
        if not np.isfinite(u0):
            break
        t += dt
        i += 1
    return LoopResult(x, statuses, ticks, False)


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
        u_n, status, u0, x, s = _tick(solve, seed + i, x, u_n, plant_step)
        ticks.append(s)
        statuses.append(status)
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


def mppi2(args) -> LoopResult:
    """Inline f32 MPPI on a 2-state double integrator — examples/mppi2.rs.

    T=2, N=40, K=8000, λ=2.5, R=1, limit ±3, cost x0²+x1², 5 s sim.
    mppi2's weighting does not divide the control term by λ
    (control_inv = λ/R reproduces it)."""
    t_hor, n, k = 2.0, 40, args.k or 8000
    dt = t_hor / n
    cfg = MppiConfig(n_horizon=n, n_rollouts=k, lambda_=2.5, std_dev=1.0, limit=(-3.0, 3.0),
                     control_inv=2.5 / 1.0)
    device = resolve_device(args.device)
    solve = make_mppi_solver(cfg, DoubleIntegratorQuad2(dt), device, args.sampler)
    u_n = torch.zeros(n, dtype=torch.float32, device=device)
    return regulate_loop(solve, dynamics.make_double_integrator(dt), [1.0, 0.0], u_n,
                         t_end=args.t_end, dt=dt, seed=args.seed)


def _mppi4_loop(args, model, plant_step) -> LoopResult:
    """Shared body of mppi4 / mppi4-non-liner (examples/mppi4.rs:29-70):
    N=8, K=800 000 by default, λ=0.5, σ=3, limits ±20, cost shaped4."""
    t_hor, n = 0.8, 8
    dt = t_hor / n
    k = args.k or 800_000
    cfg = MppiConfig(n_horizon=n, n_rollouts=k, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
    device = resolve_device(args.device)
    solve = make_mppi_solver(cfg, model, device, getattr(args, "sampler", None))
    u_n = torch.zeros(n, dtype=torch.float32, device=device)
    el = Elapsed()
    with CsvLogger(f"{args.log_dir}/mppi/mppi.csv") as logger:
        res = closed_loop(solve, plant_step, [0.5, 0.0, 0.1, 0.0], u_n,
                          t_end=args.t_end, dt=dt, seed=args.seed, logger=logger)
    el.print()
    return res


def mppi4(args) -> LoopResult:
    """Library MPPI, linear 4-state model — examples/mppi4.rs."""
    p = CartPoleParams.single_wheel()
    return _mppi4_loop(args, CartPoleLinearShaped4(p, 0.1), dynamics.make_cartpole_linear(p, 0.1))


def mppi4_non_liner(args) -> LoopResult:
    """Nonlinear cart-pole (the primary single-card workload) —
    examples/mppi4-non-liner.rs."""
    p = CartPoleParams.single_wheel()
    return _mppi4_loop(args, CartPoleShaped4(p, 0.1), dynamics.make_cartpole_nonlinear(p, 0.1))


def nonliner_s_estimator(p: CartPoleParams, *, ref_qr: bool = False, dtype=torch.float32):
    """(params, state0, est_step) of mppi4-non-liner-s's UKF(4,3)
    (``mppi_examples.py:100-138``): the rpm/gyro sensor, Merwe α=1e-3, the
    plant stepped with the estimator tick's dt. The default Q/R are the
    dt-scaled piecewise-white-noise Q and R = diag(σ²); ``ref_qr`` takes the
    reference's hand-tuned constants (mppi4-non-liner-s.rs:210-226), which
    tip the loop within 1-2 s at this loop's 333 Hz."""
    plant = dynamics.make_cartpole_nonlinear(p, None)  # dt at call time
    hx = observation.make_hx_rpm_gyro4(p)
    if ref_qr:
        q = torch.tensor([[0, 0, 0, 0], [0, 0, 0, 1.0], [0, 0, 1.0, 1e2], [0, 1.0, 1e2, 1e4]], dtype=dtype)
        r = torch.diag(torch.tensor([50.0, 50.0, 0.5], dtype=dtype))
        p0 = torch.eye(4, dtype=dtype)
    else:
        q = noise.gen_q4(3e-3, (25.0, 400.0)).to(dtype)
        r = torch.diag(torch.tensor([2500.0, 2500.0, 0.25], dtype=dtype))
        p0 = 0.1 * torch.eye(4, dtype=dtype)
    params, state0 = ukf.ukf_init(torch.zeros(4, dtype=dtype), p0, q, r)
    state0 = state0._replace(x=torch.tensor([0.0, 0.0, 0.01, 0.0], dtype=dtype))

    def est_step(state, u, z, dt_est):
        def fxd(xv, uu):
            out = plant(*(xv[..., i] for i in range(4)), uu, dt_est)
            return torch.stack(torch.broadcast_tensors(*out), dim=-1)

        state = ukf.ukf_predict(params, state, u, fxd)
        return ukf.ukf_update(params, state, z, hx)

    return params, state0, est_step


def mppi4_non_liner_s(args):
    """Threaded closed-loop sim → deterministic multi-rate loop —
    examples/mppi4-non-liner-s.rs (K=15e5, σ=10, UKF(4,3), 1 ms sensor
    latency, a 3 ms sensor period, a 0.1 s control period)."""
    p = CartPoleParams.single_wheel()
    t_hor, n = 0.8, 8
    dt = t_hor / n
    k = args.k or 1_500_000
    cfg = MppiConfig(n_horizon=n, n_rollouts=k, lambda_=0.5, std_dev=10.0, limit=(-10.0, 10.0))
    device = resolve_device(args.device)
    solve = make_mppi_solver(cfg, CartPoleShaped4(p, dt), device, args.sampler)
    plant = dynamics.make_cartpole_nonlinear(p, None)  # dt at call time
    hx = observation.make_hx_rpm_gyro4(p)
    _, ukf0, est_step = nonliner_s_estimator(p, ref_qr=args.ref_qr)

    def sensor(rng_, x):
        z = hx(torch.tensor(x, dtype=torch.float32)).numpy()
        return z + rng_.normal(size=3) * [50.0, 50.0, 0.5]

    def controller(seed, xh, u_n):
        u, status = solve(seed, xh, u_n)
        return u.cpu(), int(status)  # one read-back a solve; the loop reads u_n every tick

    mr = MultiRateConfig(
        dt_phys=1e-3,
        sensor_period=3e-3,  # 1 ms latency + 2 ms pacing in the reference
        sensor_latency=1e-3,
        control_period=dt,
        log_period=dt,
        t_end=args.t_end,
        tip_over=lambda xh: abs(float(xh[2])) > DEG60,
    )
    with CsvLogger(f"{args.log_dir}/mppi/mppi.csv") as logger:
        res = run_multirate_loop(
            mr,
            plant_step=lambda x, u, dtp, f: np_step(plant, x, u, dtp),
            sensor=sensor,
            est_predict_update=lambda est, u, z, dte: est_step(est, u, torch.tensor(z, dtype=torch.float32), dte),
            est_state=lambda est: est.x.double().numpy(),
            controller=controller,
            predictor=None,
            x0=np.array([0.0, 0.0, 0.01, 0.0]),
            u0=torch.zeros(n, dtype=torch.float32),
            est0=ukf0,
            seeds=np.random.default_rng([args.seed, 1]),
            rng=np.random.default_rng(args.seed),
            logger=logger,
        )
    print(f"survived to t={res.t:.2f}s, tipped={res.tipped}, solves={res.n_solves}")
    return res


R_DIAG_IMU6 = (200.0, 200.0, 10.0, 0.05, 0.05)  # mppi4-non-liner-ukf's sensor σ


def nonliner_ukf_estimator(p: CartPoleParams, dt: float, *, est_in_loop: bool, alpha: float | None = None,
                           dtype=torch.float32):
    """(params, state0, est_step) of mppi4-non-liner-ukf's UKF2(6,5)
    (``mppi_examples.py:194-226``): the IMU sensor, Q = gen_q6 of the tick's
    dt rebuilt every step. With the estimate in the loop, the fleet-validated
    settings: P0 = 0.1·I, Q at 2.15·dt and Julier α=1 (f32-stable); in
    DEBUG_UKF mode (the reference default) its constants verbatim: P0 =
    10·I, Q at dt, Merwe α=1e-3. ``alpha`` overrides the spread."""
    plant6 = dynamics.make_flagship6(p)
    hx = observation.make_hx_imu6(p)
    q_scale = 2.15 if est_in_loop else 1.0
    if alpha is None:
        alpha = 1.0 if est_in_loop else 1e-3
    params, state0 = ukf.ukf_init(
        torch.zeros(6, dtype=dtype),
        (0.1 if est_in_loop else 10.0) * torch.eye(6, dtype=dtype),
        noise.gen_q6(torch.tensor(q_scale * dt, dtype=dtype)),
        torch.diag(torch.tensor(R_DIAG_IMU6, dtype=dtype)),
        alpha=alpha,
    )

    def est_step(state, u, z, dt_est):
        def fxd(xv, uu):
            out = plant6(*(xv[..., i] for i in range(6)), uu, dt_est, 0.0)
            return torch.stack(torch.broadcast_tensors(*out), dim=-1)

        state = state._replace(q=noise.gen_q6(q_scale * dt_est, dtype=state.q.dtype))
        state = ukf.ukf_predict(params, state, u, fxd)
        return ukf.ukf_update(params, state, z, hx)

    return params, state0, est_step


def mppi4_non_liner_ukf(args):
    """Flagship closed-loop sim — examples/mppi4-non-liner-ukf.rs.

    Two-wheel 6-state plant with a 2 N push for t∈(1,1.5) s, UKF2(6,5) with
    a per-tick gen_q, MPPI T=1.2 N=8 K=5e5 λ=1.4 σ=4 limit ±10, cost
    C=[0.1,0.1,1,0.5]; DEBUG_UKF (the controller sees the true state) is the
    reference default (:31), ``--use-ukf-estimate`` feeds it the estimate.
    ``--control-period`` sets the controller's period (default 3 ms; 0:
    free-running, a solve every physics tick). ``--console`` prints the
    reference's Con:/Rcv: streams (``runtime/console.py``) from the
    controller and the estimator."""
    p = CartPoleParams.two_wheel()
    t_hor, n = 1.2, 8
    dt = t_hor / n
    k = args.k or 500_000
    cfg = MppiConfig(n_horizon=n, n_rollouts=k, lambda_=1.4, std_dev=4.0, limit=(-10.0, 10.0))
    device = resolve_device(args.device)
    solve = make_mppi_solver(cfg, Flagship4Diag4(p, dt), device, args.sampler)
    plant6 = dynamics.make_flagship6(p)
    hx = observation.make_hx_imu6(p)
    _, ukf0, est_step = nonliner_ukf_estimator(p, dt, est_in_loop=args.use_ukf_estimate, alpha=args.ukf_alpha)
    r_diag = np.array(R_DIAG_IMU6)

    def sensor(rng_, x):
        z = hx(torch.tensor(x, dtype=torch.float32)).numpy()
        return z + rng_.normal(size=5) * r_diag

    t0_wall = []

    def _t():  # seconds since the first console line (mppi_examples.py:237-244)
        if not t0_wall:
            t0_wall.append(time.time())
        return time.time() - t0_wall[0]

    def controller(seed, xh, u_n):
        # 6-state estimate → 4-state controller input [x, dx, θ, θ̇] (:78)
        x4 = np.array([xh[0], xh[1], xh[3], xh[4]])
        if abs(x4[2]) > PI_2:
            return u_n, 0
        u, status = solve(seed, x4, u_n)
        u = u.cpu()  # one read-back a solve; the loop reads u_n every tick
        if args.console:
            print_con(_t(), float(u[0]), x4)
        return u, int(status)

    def est_update(est, u, z, dte):
        est = est_step(est, u, torch.tensor(z, dtype=torch.float32), dte)
        if args.console:
            print_rcv(_t(), u, est.x.numpy(), z, p_diag=torch.diagonal(est.p).numpy())
        return est

    def predictor(xh, u_n):
        xp = np.array(xh)
        for i in range(n):
            xp = np_step(plant6, xp, float(u_n[i]), dt, 0.0)
        return xp

    cp = args.control_period
    mr = MultiRateConfig(
        dt_phys=1e-3,
        sensor_period=9e-3,
        sensor_latency=0.0,
        control_period=(None if cp == 0 else cp) if cp is not None else 3e-3,
        log_period=30e-3,
        t_end=args.t_end,
        disturbance=pulse_disturbance(1.0, 1.5, 2.0),
        tip_over=lambda xh: abs(float(xh[3])) > PI_2,
    )
    el = Elapsed()
    with CsvLogger(f"{args.log_dir}/mppi/mppi.csv") as logger:
        res = run_multirate_loop(
            mr,
            plant_step=lambda x, u, dtp, f: np_step(plant6, x, u, dtp, f),
            sensor=sensor,
            est_predict_update=est_update,
            est_state=lambda est: est.x.double().numpy(),
            controller=controller,
            predictor=predictor,
            x0=np.zeros(6),
            u0=torch.zeros(n, dtype=torch.float32),
            est0=ukf0,
            seeds=np.random.default_rng([args.seed, 1]),
            rng=np.random.default_rng(args.seed),
            logger=logger,
            debug_ukf_bypass=not args.use_ukf_estimate,
        )
    if res.tipped:
        print("θ is over pi/2")
    el.print()
    print(f"survived to t={res.t:.2f}s, solves={res.n_solves}")
    return res
