"""Gradient-MPC (PANOC) example runners — port of
``mpc_rs_tpu/apps/mpc_examples.py``: ``op-en2``, ``op-mpc-x``,
``op-mpc-x-calc``, ``op-mpc-x-calc-nl``, ``mpc-ukf-x`` and ``mpc-ukf-s``
(examples/op-*.rs, mpc-ukf-x.rs, mpc-ukf-s.rs).

Every solve runs in float64 on the device the caller names (``--device``,
the card by default; ``cpu`` runs the same torch ops on the host), as the
JAX apps run with x64 on. The plants step in float64 on the host between
solves. The two UKF apps keep their small filters on the host, as the MPPI
apps do (``apps/mppi_examples.py``): ``mpc-ukf-x``'s UKF(4,2) in float64,
``mpc-ukf-s``'s UKF(6,5) in float32, each a few hundred scalar operations.

``op-en2`` returns its ``PanocResult``; the loops an ``MpcRun`` (its ``x``
is what the JAX runner returns) or, ``mpc-ukf-s``, a ``MultiRateRun`` (the
``LoopResult`` fields its check reads), each with a ``SolveLog`` of every
solve's host-clock seconds and PANOC iterations. The loops of ``op-mpc-x``
and ``mpc-ukf-x`` take a ``max_ticks`` prefix as library functions
(``run_op_mpc_x``, ``run_mpc_ukf_x``), which the CLI does not expose.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from mpc_rs_tpu_torch.apps.common import PI_2, Elapsed, np_step, resolve_device
from mpc_rs_tpu_torch.controllers.panoc import (
    PanocConfig,
    ball2_projection,
    box_projection,
    make_shifted_fd_value_and_grad,
    panoc_solve,
)
from mpc_rs_tpu_torch.controllers.qp import (
    build_condensed_qp,
    create_f_matrix,
    create_g_matrix,
    make_qp_value_and_grad,
)
from mpc_rs_tpu_torch.estimators.ukf import ukf_init, ukf_predict, ukf_update
from mpc_rs_tpu_torch.models import costs, dynamics, noise, observation, reference
from mpc_rs_tpu_torch.models.params import CartPoleParams
from mpc_rs_tpu_torch.runtime.logger import CsvLogger
from mpc_rs_tpu_torch.runtime.loop import MultiRateConfig, pulse_disturbance, run_multirate_loop

F64 = torch.float64


class SolveLog:
    """Host-clock seconds (the solve with its u read back) and PANOC
    iterations of every ``panoc_solve`` call of a run."""

    def __init__(self):
        self.seconds: list[float] = []
        self.iterations: list[int] = []

    def __call__(self, solve, *args):
        t0 = time.perf_counter()
        res = solve(*args)
        it, u = int(res.iterations), res.u.cpu()
        self.seconds.append(time.perf_counter() - t0)
        self.iterations.append(it)
        return res, u


class MpcRun(NamedTuple):
    x: np.ndarray  # final plant state, what the JAX runner returns
    ticks: int
    log: SolveLog

    def __array__(self, dtype=None, copy=None):
        """The final state, which the JAX runner returns: the acceptance
        checks read the result as that array (``apps/acceptance.py``)."""
        return np.asarray(self.x, dtype=dtype)


class MultiRateRun(NamedTuple):
    """mpc-ukf-s's result: the JAX runner's ``LoopResult`` fields that its
    acceptance check reads, and the solves' log."""

    t: float
    x: np.ndarray
    tipped: bool
    n_solves: int
    log: SolveLog


def linear_rollout(step, n: int, n_state: int = 4):
    """The states (..., n, n_state) of a linear vector-form ``step`` from x0
    (..., n_state) under u (..., n), all at once: X = F x0 + G u with F, G
    (``controllers/qp.py``) of the step's own (A, B), read off the step in
    float64. The values of n sequential steps, their sums in another order;
    an autodiff of it records four operations instead of n steps'."""
    eye = torch.eye(n_state, dtype=F64)
    a = step(eye, 0.0).T.numpy()  # row i of step(I) is A e_i
    b = step(torch.zeros(n_state, dtype=F64), 1.0).numpy()
    f, g = torch.tensor(create_f_matrix(a, n)), torch.tensor(create_g_matrix(a, b, n))
    cast = {}

    def rollout(x0, u_seq):
        key = (x0.dtype, x0.device)
        if key not in cast:
            cast[key] = (f.to(dtype=x0.dtype, device=x0.device).T, g.to(dtype=x0.dtype, device=x0.device).T)
        ft, gt = cast[key]
        return (x0 @ ft + u_seq @ gt).unflatten(-1, (n, n_state))

    return rollout


def _host_step(step, x, u: float) -> np.ndarray:
    """A vector-form step on a float64 host state."""
    return step(torch.tensor(x, dtype=F64), float(u)).numpy()


def op_en2(args):
    """PANOC smoke test: min u0²+u1² on a unit ball — examples/op-en2.rs."""
    dev = resolve_device(args.device)
    cfg = PanocConfig(tol=1e-6, max_iter=200, lbfgs_mem=10)
    res = panoc_solve(cfg, lambda u: u[..., 0] ** 2 + u[..., 1] ** 2, ball2_projection(1.0),
                      torch.zeros(2, dtype=F64, device=dev))
    u = res.u.cpu()
    print(f"parameters: (r={1.0:.4f}), iters = {int(res.iterations)}")
    print(f"u = [{float(u[0]):.6f}, {float(u[1]):.6f}]")
    return res


def _retry_solve(log: SolveLog, solve_fn, u_n, limit):
    """Zero-and-retry on failure or saturation — op-mpc-x.rs:199-218,
    bounded at 3 tries (``mpc_examples.py:38-48``)."""
    for _ in range(3):
        res, u = log(solve_fn, u_n)
        if int(res.iterations) == 0 or abs(float(u[0])) >= limit:
            print(f"\x1b[31mIncorrect States (iters={int(res.iterations)}, "
                  f"u0={float(u[0]):.2f}) -> retry\x1b[0m")
            u_n = torch.zeros_like(u_n)
            continue
        return res.u, u
    return torch.zeros_like(u_n), torch.zeros(u_n.shape, dtype=u_n.dtype)


def op_mpc_x_controller(device, *, max_iter: int | None = None, fd: bool = False):
    """(solve(x (4,) tensor, u (50,) tensor) -> PanocResult, step) of
    op-mpc-x (``mpc_examples.py:51-73``): T=0.5 N=50 on the light
    single-wheel linear model (``linear_rollout``), GAIN=[0,9.2,16,0.5,0], the cosh barrier,
    bounds ±30, memory 20, budget 60; autodiff gradients, or with ``fd``
    the reference's pre-stepped-state finite differences."""
    p = CartPoleParams.single_wheel_light()
    t_hor, n = 0.5, 50
    step = dynamics.as_vector_fn(dynamics.make_cartpole_linear(p, t_hor / n), 4)
    cost = costs.make_tracking_rollout_cost(step, reference.make_planning_err(p.l), [0.0, 9.2, 16.0, 0.5, 0.0],
                                            barrier=1.0, rollout=linear_rollout(step, n))
    cfg = PanocConfig(tol=1e-6, max_iter=max_iter or 60, lbfgs_mem=20)
    proj = box_projection(-30.0, 30.0)
    ref_fd = make_shifted_fd_value_and_grad(cost, step, eps=1e-3)

    def solve(x, u):
        vg = ref_fd(x) if fd else None
        return panoc_solve(cfg, lambda uu: cost(x, uu), proj, u, value_and_grad=vg)

    return solve, step


def run_op_mpc_x(args, max_ticks: int | None = None) -> MpcRun:
    """op-mpc-x's loop (``mpc_examples.py:75-94``), the first ``max_ticks``
    of its 1 001 ticks when given."""
    dev = resolve_device(args.device)
    solve, step = op_mpc_x_controller(dev, max_iter=args.max_iter, fd=args.fd)
    dt = 0.5 / 50
    x = np.array([3.0, 0.0, -0.7, 0.0])
    u = torch.zeros(50, dtype=F64, device=dev)
    log = SolveLog()
    max_iters = int(10.0 / dt)
    n_ticks = max_iters + 1 if max_ticks is None else min(max_ticks, max_iters + 1)
    ticks = 0
    with CsvLogger(f"{args.log_dir}/op-mpc-x/op-mpc-x.csv") as logger:
        for i in range(n_ticks):
            xt = torch.tensor(x, dtype=F64, device=dev)
            u, u_host = _retry_solve(log, lambda uu: solve(xt, uu), u, 30.0)
            x_est = np.array(x)
            for e in u_host.tolist():
                x_est = _host_step(step, x_est, e)
            x = _host_step(step, x, u_host[0])
            ticks += 1
            print(f"{i:4}/{max_iters}, {float(u_host[0]):7.2f}, "
                  f"act: ({x[0]:7.2f},{x[1]:7.2f},{x[2]:7.2f},{x[3]:7.2f}) "
                  f"est: ({x_est[0]:7.2f},{x_est[1]:7.2f},{x_est[2]:7.2f},{x_est[3]:7.2f})")
            logger.write_row(i * dt, float(u_host[0]), x, x_est)
            if abs(x[2]) > PI_2:
                print(f"Error: x[2] = {x[2]} > PI / 2")
                break
    return MpcRun(x, ticks, log)


def op_mpc_x(args) -> MpcRun:
    """Nonlinear-cost gradient MPC — examples/op-mpc-x.rs (autodiff
    gradients; ``--fd`` the reference's finite differences, quirk kept)."""
    return run_op_mpc_x(args)


def op_mpc_x_calc_controller(device, *, max_iter: int | None = None):
    """(solve(x, u) -> PanocResult, (A, B)) of the condensed-QP apps
    (``mpc_examples.py:97-117``): single-wheel T=0.8 N=8 C=diag(5,5,1,1),
    the raised-cosine reference, memory 20, budget 80, bounds ±30."""
    p = CartPoleParams.single_wheel()
    t_hor, n = 0.8, 8
    a, b = dynamics.linear_ab(p, t_hor / n)
    qp = build_condensed_qp(a, b, np.diag([5.0, 5.0, 1.0, 1.0]), n, device=device)
    vg_factory = make_qp_value_and_grad(qp, reference.make_gen_ref_raised_cosine(n))
    cfg = PanocConfig(tol=1e-6, max_iter=max_iter or 80, lbfgs_mem=20)
    proj = box_projection(-30.0, 30.0)

    def solve(x, u):
        return panoc_solve(cfg, None, proj, u, value_and_grad=vg_factory(x))

    return solve, (a, b)


def _op_mpc_x_calc(args, nonlinear_plant: bool) -> MpcRun:
    """Condensed-QP gradient MPC — examples/op-mpc-x-calc.rs (linear plant)
    and op-mpc-x-calc-nl.rs (nonlinear plant, the model-mismatch benchmark)."""
    dev = resolve_device(args.device)
    solve, (a, b) = op_mpc_x_calc_controller(dev, max_iter=args.max_iter)
    p = CartPoleParams.single_wheel()
    n, dt = 8, 0.8 / 8
    if nonlinear_plant:
        plant = dynamics.as_vector_fn(dynamics.make_cartpole_nonlinear(p, dt), 4)
        plant_step = lambda x, u0: _host_step(plant, x, u0)  # noqa: E731
    else:
        an, bn = np.array(a), np.array(b).reshape(-1)
        plant_step = lambda x, u0: an @ x + bn * u0  # noqa: E731

    x = np.array([0.5, 0.0, 0.1, 0.0])
    u = torch.zeros(n, dtype=F64, device=dev)
    log = SolveLog()
    el = Elapsed()
    max_iters = int(5.0 / dt)
    ticks = 0
    with CsvLogger(f"{args.log_dir}/op-mpc-x/op-mpc-x.csv") as logger:
        for i in range(max_iters + 1):
            res, u_host = log(solve, torch.tensor(x, dtype=F64, device=dev), u)
            u = res.u
            if int(res.iterations) == 0 or abs(float(u_host[0])) >= 30.0:
                print(f"status is invalid, u[0]: {float(u_host[0])}")
                break
            x = plant_step(x, float(u_host[0]))
            x_est = x.copy()
            for e in u_host.tolist():
                x_est = plant_step(x_est, e)
            ticks += 1
            t = i * dt
            print(f"{t:4.2f}, {float(u_host[0]):7.2f}, act: ({x[0]:7.2f},{x[1]:7.2f},{x[2]:7.2f},{x[3]:7.2f})")
            logger.write_row(t, float(u_host[0]), x, x_est)
            if abs(x[2]) > PI_2:
                print("x[2] is over pi/2")
                break
    el.print()
    return MpcRun(x, ticks, log)


def op_mpc_x_calc(args) -> MpcRun:
    return _op_mpc_x_calc(args, nonlinear_plant=False)


def op_mpc_x_calc_nl(args) -> MpcRun:
    return _op_mpc_x_calc(args, nonlinear_plant=True)


def mpc_ukf_x_parts(device, *, max_iter: int | None = None):
    """(solve(x, u) -> PanocResult, step, next_plan, hx, est0, est_step) of
    mpc-ukf-x (``mpc_examples.py:159-202``): T=0.5 N=10 on the
    heavy-J single-wheel linear model (``linear_rollout``), the
    rate-limited planner, GAIN=[0.5,0.5,16,3,0.1] with the 1e-6 cosh
    barrier, autodiff gradients,
    memory 20, budget 100, bounds ±30; the float64 UKF(4,2) on [dx, dθ] with
    Q, R of mpc-ukf-x.rs:46-53, on the host."""
    p = CartPoleParams.single_wheel_heavy_j()
    t_hor, n = 0.5, 10
    dt = t_hor / n
    step = dynamics.as_vector_fn(dynamics.make_cartpole_linear(p, dt), 4)
    next_plan = reference.make_next_plan(dt)
    plan_err = reference.make_plan_err(p.l)
    gain = [0.5, 0.5, 16.0, 3.0, 0.1]

    rollout = linear_rollout(step, n)

    def cost(x0, plans, u_seq):
        xs = rollout(x0, u_seq)
        return costs.tracking_stage_costs(plan_err(xs, plans), u_seq, xs[..., 2], gain, 1e-6).sum(dim=-1)

    cfg = PanocConfig(tol=1e-6, max_iter=max_iter or 100, lbfgs_mem=20)
    proj = box_projection(-30.0, 30.0)

    def solve(x, u):
        # the plan does not depend on u: rolled out once a solve
        plans = reference.rollout_plan(next_plan, next_plan(x), n)
        return panoc_solve(cfg, lambda uu: cost(x, plans, uu), proj, u)

    q = torch.tensor([[0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 1.0]], dtype=F64)
    r = torch.tensor([[0.75, 0.75], [0.75, 0.75]], dtype=F64)
    hx = observation.make_hx_vel2()
    params, est0 = ukf_init(torch.tensor([0.5, 0.0, -0.15, 0.0], dtype=F64), 10.0 * torch.eye(4, dtype=F64), q, r)

    def est_step(state, u, z):
        state = ukf_predict(params, state, u, step)
        return ukf_update(params, state, z, hx)

    return solve, step, next_plan, hx, est0, est_step


def run_mpc_ukf_x(args, max_ticks: int | None = None) -> MpcRun:
    """mpc-ukf-x's loop (``mpc_examples.py:204-232``): solve on the
    estimate, the control low-pass, the plant, the noisy [dx, dθ] (numpy
    noise in the JAX order), the filter; the first ``max_ticks`` when given."""
    dev = resolve_device(args.device)
    solve, step, next_plan, hx, est, est_step = mpc_ukf_x_parts(dev, max_iter=args.max_iter)
    n, dt = 10, 0.5 / 10
    rng = np.random.default_rng(args.seed)
    x_act = np.array([0.5, 0.0, -0.15, 0.0])
    u = torch.zeros(n, dtype=F64, device=dev)
    u_lpf = 0.0
    log = SolveLog()
    max_iters = int(min(args.t_end, 10.0) / dt)
    n_ticks = max_iters + 1 if max_ticks is None else min(max_ticks, max_iters + 1)
    ticks = 0
    with CsvLogger(f"{args.log_dir}/op-mpc-x/op-mpc-x.csv") as logger:
        for i in range(n_ticks):
            xt = est.x.to(dev)
            u, u_host = _retry_solve(log, lambda uu: solve(xt, uu), u, 30.0)
            x_pred = est.x.numpy()
            for e in u_host.tolist():
                x_pred = _host_step(step, x_pred, e)
            x_ref = est.x
            for _ in range(n):
                x_ref = next_plan(x_ref)
            u_lpf += (float(u_host[0]) - u_lpf) * 0.5  # control low-pass (:351-352)
            u = u.clone()
            u[0] = u_lpf
            x_act = _host_step(step, x_act, u_lpf)
            z = hx(torch.tensor(x_act, dtype=F64)).numpy() + rng.normal(size=2) * [0.75, 0.75]
            est = est_step(est, u_lpf, torch.tensor(z, dtype=F64))
            ticks += 1
            xe = est.x.tolist()
            print(f"{u_lpf:7.2f}, act: ({x_act[0]:7.2f},{x_act[1]:7.2f},{x_act[2]:7.2f},{x_act[3]:7.2f}) "
                  f"est: ({xe[0]:7.2f},{xe[1]:7.2f},{xe[2]:7.2f},{xe[3]:7.2f})")
            logger.write_row(i * dt, u_lpf, x_act, xe, x_pred, x_ref)
            if abs(x_act[2]) > PI_2:
                print(f"Error: x[2] = {x_act[2]} > PI / 2")
                break
    return MpcRun(x_act, ticks, log)


def mpc_ukf_x(args) -> MpcRun:
    """PANOC + inline UKF + rate-limited planner + control LPF —
    examples/mpc-ukf-x.rs (T=0.5 N=10, GAIN=[0.5,0.5,16,3,0.1])."""
    return run_mpc_ukf_x(args)


R_DIAG_IMU6 = (200.0, 200.0, 10.0, 0.05, 0.05)  # mpc-ukf-s's sensor σ, its R's diagonal


def mpc_ukf_s_parts(device, *, max_iter: int | None = None, est_dtype=torch.float32):
    """(solve(x4, u) -> PanocResult, plant6, hx, est0, est_step) of
    mpc-ukf-s (``mpc_examples.py:235-274``): the two-wheel condensed QP
    (T=1.2 N=8 C=diag(1,1,10,5), reference ≡ 0, bounds ±10, memory 20,
    budget 60) in float64 on ``device``; the UKF(6,5) on the IMU in
    ``est_dtype`` (the app's float32), its Q = gen_q6 of each step's dt
    (taken in float64, then cast), on the host."""
    p = CartPoleParams.two_wheel()
    t_hor, n = 1.2, 8
    dt = t_hor / n
    a, b = dynamics.linear_ab(p, dt, two_wheel=True)
    qp = build_condensed_qp(a, b, np.diag([1.0, 1.0, 10.0, 5.0]), n, device=device)
    vg_factory = make_qp_value_and_grad(qp, reference.make_gen_ref_zero(n))
    cfg = PanocConfig(tol=1e-6, max_iter=max_iter or 60, lbfgs_mem=20)
    proj = box_projection(-10.0, 10.0)

    def solve(x, u):
        return panoc_solve(cfg, None, proj, u, value_and_grad=vg_factory(x))

    plant6 = dynamics.make_accel6(p, with_force=True)
    hx = observation.make_hx_imu6(p)
    ed = est_dtype
    params, est0 = ukf_init(torch.zeros(6, dtype=ed), 10.0 * torch.eye(6, dtype=ed),
                            noise.gen_q6(torch.tensor(dt, dtype=ed)), torch.diag(torch.tensor(R_DIAG_IMU6, dtype=ed)))

    def est_step(state, u, z, dt_est):
        def fxd(xv, uu):
            out = plant6(*(xv[..., i] for i in range(6)), uu, dt_est, 0.0)
            return torch.stack(torch.broadcast_tensors(*out), dim=-1)

        state = state._replace(q=noise.gen_q6(dt_est).to(state.q.dtype))
        state = ukf_predict(params, state, u, fxd)
        return ukf_update(params, state, z, hx)

    return solve, plant6, hx, est0, est_step


def mpc_ukf_s(args) -> MultiRateRun:
    """Threaded sim with the library's QP macros and UKF2 → the
    deterministic multi-rate loop — examples/mpc-ukf-s.rs (two-wheel A/B,
    C=diag(1,1,10,5), gen_ref ≡ 0, the 2 N pulse; the controller sees the
    true state unless ``--use-ukf-estimate``)."""
    dev = resolve_device(args.device)
    solve, plant6, hx, ukf0, est_step = mpc_ukf_s_parts(dev, max_iter=args.max_iter)
    n, dt = 8, 1.2 / 8
    r_diag = np.array(R_DIAG_IMU6)
    log = SolveLog()

    def sensor(rng_, x):
        z = hx(torch.tensor(x, dtype=torch.float32)).numpy()
        return z + rng_.normal(size=5) * r_diag

    def controller(seed, xh, u_n):
        x4 = torch.tensor([xh[0], xh[1], xh[3], xh[4]], dtype=F64, device=dev)
        _, u = log(solve, x4, u_n.to(device=dev, dtype=F64))
        return u.to(torch.float32), 0

    def predictor(xh, u_n):
        xp = np.array(xh)
        for i in range(n):
            xp = np_step(plant6, xp, float(u_n[i]), dt, 0.0)
        return xp

    mr = MultiRateConfig(
        dt_phys=1e-3,
        sensor_period=9e-3,
        control_period=5e-3,
        log_period=30e-3,
        t_end=args.t_end,
        disturbance=pulse_disturbance(1.0, 1.5, 2.0),
        tip_over=lambda xh: abs(float(xh[3])) > PI_2,
    )
    el = Elapsed()
    with CsvLogger(f"{args.log_dir}/mpc-ukf/mpc-ukf.csv") as logger:
        res = run_multirate_loop(
            mr,
            plant_step=lambda x, u, dtp, f: np_step(plant6, x, u, dtp, f),
            sensor=sensor,
            est_predict_update=lambda est, u, z, dte: est_step(est, u, torch.tensor(z, dtype=torch.float32), dte),
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
    return MultiRateRun(res.t, res.x, res.tipped, res.n_solves, log)
