"""The estimator ladder and the PID baseline — the reference's pedagogical
examples (SURVEY §4.1): scalar KF → 2-state KF → scalar, 2-, 4- and 6-state
UKF → PID.

Port of ``mpc_rs_tpu/apps/estimator_examples.py``. Each app runs on
``--device`` (default cuda) in float64, the precision in which the JAX
package's acceptance runs them (``apps/acceptance.py:326-330``), and draws
its noise from ``np.random.default_rng(--seed)`` in the JAX app's order, so
the two packages see the same numbers. The UKF apps take the reference's
α=1e-3 and the ``eigh`` sigma root, as the JAX apps do.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from mpc_rs_tpu_torch.apps.common import DEG60, Elapsed, np_step, resolve_device
from mpc_rs_tpu_torch.controllers.pid import PidConfig, pid_init, pid_update
from mpc_rs_tpu_torch.estimators.gaussian import Gaussian, kf1d_predict
from mpc_rs_tpu_torch.estimators.kf import kf_predict, kf_update_joseph
from mpc_rs_tpu_torch.estimators.ukf import ukf_init, ukf_predict, ukf_update
from mpc_rs_tpu_torch.models import dynamics, observation
from mpc_rs_tpu_torch.models.params import CartPoleParams
from mpc_rs_tpu_torch.runtime.logger import CsvLogger


class EstRun(NamedTuple):
    """An estimator app's result (``estimator_examples.py:23-34``): the final
    filter state and the episode's history, on the host."""

    x: np.ndarray    # final estimate
    p: np.ndarray    # final covariance
    act: np.ndarray  # (T, n) truth trajectory
    est: np.ndarray  # (T, n) estimates (post-update)
    obs: np.ndarray  # (T, m) noisy observations


def _f64(args):
    """(factory kwargs, float64 tensor maker) on the app's device."""
    kw = dict(dtype=torch.float64, device=resolve_device(args.device))
    return kw, lambda v: torch.tensor(v, **kw)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _est_run(state, hist) -> EstRun:
    act, est, obs = (np.array([h[i] for h in hist]) for i in range(3))
    return EstRun(_host(state.x), _host(state.p), act, est, obs)


def one_liner_kf(args):
    """1-D KF with Gaussian algebra, wrong prior — examples/one-liner-kf.rs."""
    _, t = _f64(args)
    rng = np.random.default_rng(args.seed)
    x_act = 0.0
    x_est = Gaussian(t(10.0), t(10.0))
    for _ in range(100):
        u = 0.5
        x_act += u
        x_est = kf1d_predict(x_est, Gaussian(t(u), t(1.0)))
        x_obs = Gaussian(t(x_act + rng.normal() * 2.0), t(4.0))
        x_est = x_est * x_obs
        print(f"x_act: {x_act:6.2f}, x_obs: {float(x_obs.mean):6.2f}, "
              f"x_est.mean: {float(x_est.mean):6.2f}, x_est.var: {float(x_est.var):7.3f}")
    return x_est


def two_liner_kf(args):
    """2-state linear KF, Joseph form — examples/two-liner-kf.rs. Returns
    the final (x, P) on the host."""
    _, t = _f64(args)
    dt = 0.01
    f = t([[1.0, dt], [0.0, 1.0]])
    q = t([[0.25, 0.5], [0.5, 1.0]])
    h = t([[1.0, 0.0]])
    r = t([[4.0]])
    b = t([[0.0, 0.0], [1.0, -1.0]])
    rng = np.random.default_rng(args.seed)
    x_act = np.zeros(2)
    x_est = t([0.0, 0.0])
    p = 100.0 * torch.eye(2, dtype=torch.float64, device=f.device)
    fn, bn = _host(f), _host(b)
    for _ in range(100):
        u = np.array([0.5, -0.5])
        x_act = fn @ x_act + bn @ u
        x_est, p = kf_predict(x_est, p, f, q, t(u), b)
        z = t([x_act[0] + rng.normal() * 4.0])
        x_est, p = kf_update_joseph(x_est, p, z, h, r)
        print(f"x_act: ({x_act[0]:6.2f},{x_act[1]:6.2f}) x_obs: {float(z[0]):6.2f}, "
              f"x_est: ({float(x_est[0]):6.2f},{float(x_est[1]):6.2f})")
    return x_est.cpu(), p.cpu()


def ukf_one(args):
    """Scalar UKF — examples/ukf-one.rs (DT=1, Q=R=1, wrong prior 10/100)."""
    _, t = _f64(args)
    params, state = ukf_init(t([10.0]), t([[100.0]]), t([[1.0]]), t([[1.0]]))
    fx = lambda x, u: x + u * 1.0  # noqa: E731
    hx = lambda x: x  # noqa: E731
    rng = np.random.default_rng(args.seed)
    x_act = 0.0
    hist = []
    for _ in range(100):
        u = 0.5
        x_act += u
        state = ukf_predict(params, state, u, fx)
        z = t([x_act + rng.normal() * 1.0])
        state = ukf_update(params, state, z, hx)
        hist.append(([x_act], _host(state.x), _host(z)))
        print(f"x_act: {x_act:6.3f} x_obs: {float(z[0]):6.3f} "
              f"x_est: {float(state.x[0]):6.3f} p: {float(state.p[0, 0]):6.3f}")
    print("wm:", _host(params.wm[:3]))
    print("wc:", _host(params.wc[:3]))
    return _est_run(state, hist)


def ukf_two(args):
    """2-state UKF with the x1⁴ nonlinearity — examples/ukf-two.rs."""
    kw, t = _f64(args)
    dt = 0.1
    q = t([[0.25, 0.5], [0.5, 1.0]])
    r = t([[2.0]])
    params, state = ukf_init(torch.zeros(2, **kw), 10.0 * torch.eye(2, **kw), q, r)

    def fx(x, u):
        x0 = x[..., 0] + x[..., 1] ** 4 * dt
        x1 = x[..., 1] + (u[0] - u[1]) * dt
        return torch.stack(torch.broadcast_tensors(x0, x1), dim=-1)

    hx = lambda x: x[..., :1]  # noqa: E731
    rng = np.random.default_rng(args.seed)
    x_act = np.zeros(2)
    hist = []
    u = t([0.5, -0.5])
    for _ in range(100):
        x_act = np.array([x_act[0] + x_act[1] ** 4 * dt, x_act[1] + (0.5 - -0.5) * dt])
        state = ukf_predict(params, state, u, fx)
        z = t([x_act[0] + rng.normal() * 2.0])
        state = ukf_update(params, state, z, hx)
        hist.append((x_act.copy(), _host(state.x), _host(z)))
        print(f"x_act: ({x_act[0]:7.2f},{x_act[1]:7.2f}) x_obs: {float(z[0]):7.2f}, "
              f"x_est: ({float(state.x[0]):7.2f},{float(state.x[1]):7.2f})")
    return _est_run(state, hist)


def _vector(step):
    """Component step (x0, …, u) → vector form fx(x (..., n), u)."""

    def fx(x, u):
        out = step(*x.unbind(-1), u)
        return torch.stack(torch.broadcast_tensors(*out), dim=-1)

    return fx


def _run_ukf_pen(args, step, q, r_diag, hx, n_state):
    """The pendulum UKF examples' loop (``estimator_examples.py:128-156``):
    truth and filter on the same model at DT=0.01, u=0.1, 100 steps, the
    observation noise's σ equal to R's diagonal values, as the reference's."""
    kw, t = _f64(args)
    fx = _vector(step)
    params, state = ukf_init(torch.zeros(n_state, **kw), 10.0 * torch.eye(n_state, **kw), q,
                             torch.diag(t(r_diag)))
    rng = np.random.default_rng(args.seed)
    x_act = torch.zeros(n_state, **kw)
    hist = []
    dt = 0.01
    for i in range(100):
        u = 0.1
        x_act = fx(x_act, u)
        state = ukf_predict(params, state, u, fx)
        zv = _host(hx(x_act)) + rng.normal(size=len(r_diag)) * np.asarray(r_diag)
        state = ukf_update(params, state, t(zv), hx)
        hist.append((_host(x_act), _host(state.x), zv.copy()))
        print(f"t: {i * dt:4.2f} x_act: {np.round(_host(x_act)[:4], 2)} "
              f"x_est: {np.round(_host(state.x)[:4], 2)} "
              f"p: {np.round(np.diag(_host(state.p))[:4], 2)}")
    return _est_run(state, hist)


def ukf_pen(args):
    """4-state pendulum UKF, [dx, dθ] observed — examples/ukf-pen.rs."""
    p = CartPoleParams.single_wheel_j01()
    _, t = _f64(args)
    q = t([[0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 0.25, 0.5], [0, 0, 0.5, 1.0]])
    return _run_ukf_pen(args, dynamics.make_cartpole_nonlinear(p, 0.01), q, [0.5, 0.5],
                        observation.make_hx_vel2(), 4)


def ukf_pen2(args):
    """4-state pendulum UKF on rpm/gyro observations — examples/ukf-pen2.rs."""
    p = CartPoleParams.single_wheel()
    _, t = _f64(args)
    return _run_ukf_pen(args, dynamics.make_cartpole_nonlinear(p, 0.01), torch.diag(t([0.0, 0.0, 0.0, 0.25])),
                        [100.0, 100.0, 0.5], observation.make_hx_rpm_gyro4(p), 4)


def ukf_pen3(args):
    """6-state pendulum UKF on the force-IMU observation — examples/ukf-pen3.rs."""
    p = CartPoleParams.single_wheel()
    _, t = _f64(args)
    return _run_ukf_pen(args, dynamics.make_pen6(p, 0.01), torch.diag(t([0.0, 0.0, 0.0, 0.0, 0.0, 10.0])),
                        [100.0, 100.0, 0.5, 100.0, 100.0], observation.make_hx_force6(p), 6)


def pid(args):
    """PID baseline — examples/pid.rs (VelPid 0.6/0.4/5e-3, ±25). The
    controller runs on the device, the plant on the host in float64
    (``np_step``), as the JAX app's. The reference's PID is under-gained
    and tips ("over 60 degrees") by design. Returns the final state."""
    kw, t = _f64(args)
    p = CartPoleParams.single_wheel()
    dt = 1e-3
    step = dynamics.make_cartpole_linear_pid(p, dt)
    cfg = PidConfig(kp=0.6, ki=0.4, kd=5e-3, lo=-25.0, hi=25.0)
    s = pid_init(**kw)
    x = np.array([-0.5, 0.0, 0.2, 0.0])
    logger = CsvLogger(f"{args.log_dir}/pid/pid.csv")
    el = Elapsed()
    i = 0
    try:
        while i * dt < args.t_end:
            now = i * dt
            pp = 0.5
            phase = np.clip(x[0], -pp, pp) * math.pi / pp / 2.0
            theta_ref = -0.2 * math.sin(phase) ** 5
            u, s = pid_update(cfg, s, t(theta_ref), t(x[2]), dt)
            u = float(u)
            x = np_step(step, x, -u)
            if i % int(0.1 / dt) == 0:
                print(f"t: {now:.2f}, r: {theta_ref:8.5f}, u: {u:8.3f}, "
                      f"x: [{x[0]:10.4f}, {x[1]:6.2f}, {x[2]:5.2f}, {x[3]:5.2f}]")
                logger.write_row(now, u, theta_ref, x)
            if abs(x[2]) > DEG60:
                print("x[2] is over 60 degrees")
                break
            i += 1
    finally:
        logger.close()
    el.print()
    return x
