"""The port's runtime loops and the MPPI application family's apps on the
CPU: ``run_multirate_loop`` and ``run_simple_loop`` against the JAX loops
with a deterministic controller, the mppi2 and mppi4 loops against the same
loops written with the JAX package on the same noise a tick, one estimator
step of each UKF app against the JAX one, and each new CLI subcommand on
the plain path (and raising without a card by default)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_rs_tpu.apps.common import np_step as jax_np_step
from mpc_rs_tpu.controllers import mppi as jmppi
from mpc_rs_tpu.estimators import ukf as jukf
from mpc_rs_tpu.models import costs as jcosts
from mpc_rs_tpu.models import dynamics as jdyn
from mpc_rs_tpu.models import noise as jnoise
from mpc_rs_tpu.models import observation as jobs
from mpc_rs_tpu.models.params import CartPoleParams as JParams
from mpc_rs_tpu.runtime import logger as jlogger
from mpc_rs_tpu.runtime import loop as jloop
from mpc_rs_tpu_torch.apps import mppi_examples as apps
from mpc_rs_tpu_torch.apps import run as cli
from mpc_rs_tpu_torch.controllers import mppi as tmppi
from mpc_rs_tpu_torch.models import dynamics as tdyn
from mpc_rs_tpu_torch.models.params import CartPoleParams
from mpc_rs_tpu_torch.runtime import loop as tloop
from mpc_rs_tpu_torch.runtime.logger import CsvLogger

F64_BAND = dict(rtol=1e-9, atol=1e-12)


# --------------------------------------------------------------------------
# (iv) the loops against the JAX loops, with a deterministic controller


def _plant(x, u, dt, f):
    """A damped cart-pole-like linear plant in numpy: the same function in
    both loops."""
    a = np.array([[0, 1, 0, 0], [0, -0.1, -0.5, 0], [0, 0, 0, 1], [0, 0.2, 9.0, -0.05]])
    b = np.array([0.0, 1.0, 0.0, -1.5])
    return x + dt * (a @ x + b * u + np.array([0.0, f, 0.0, -f]))


def _controller():
    """Moves u_n[0] by 0.05 on every third call and by 0.004 (under the
    skip-publish ε) on the others, a function of the estimate too."""
    calls = {"n": 0}

    def controller(_seed_or_key, xh, u_n):
        calls["n"] += 1
        step = 0.05 if calls["n"] % 3 == 0 else 0.004
        return np.asarray(u_n, np.float64) + step - 0.01 * float(np.tanh(xh[2])), 0

    return controller


def _run(package, cfg, tmp_path, *, bypass, latency_est=True):
    mod = tloop if package == "port" else jloop
    est0 = np.zeros(4)
    path = str(tmp_path / f"{package}.csv")
    logger = (CsvLogger if package == "port" else jlogger.CsvLogger)(path)
    kw = dict(
        plant_step=_plant,
        sensor=lambda r, x: x[:3] + r.normal(size=3) * 0.01,
        est_predict_update=lambda est, u, z, dt: est + 0.5 * (np.array([*z, est[3] + dt * u]) - est),
        est_state=lambda est: np.asarray(est, np.float64),
        controller=_controller(),
        predictor=(lambda xh, u_n: xh + float(u_n[1])) if latency_est else None,
        x0=np.array([0.1, 0.0, 0.05, 0.0]),
        u0=np.zeros(6),
        est0=est0,
        rng=np.random.default_rng(0),
        logger=logger,
        debug_ukf_bypass=bypass,
    )
    if package == "port":
        res = mod.run_multirate_loop(mod.MultiRateConfig(**cfg), seeds=np.random.default_rng(1), **kw)
    else:
        res = mod.run_multirate_loop(mod.MultiRateConfig(**cfg), key=jax.random.key(1), **kw)
    logger.close()
    return res, open(path).read()


@pytest.mark.parametrize("case", ["latency", "free_running", "skip_publish_tip"])
def test_multirate_loop_matches_jax_loop(case, tmp_path):
    """The port's multi-rate loop against the JAX package's on the same
    closures: a 2 ms sensor latency with the estimate in the loop and a
    pulse; the free-running controller (a solve every physics tick); and
    skip-publish at a wide ε with the tip guard ending the episode. The
    histories, n_solves, t, x and the CSV rows are equal."""
    cfg = dict(dt_phys=1e-3, sensor_period=5e-3, t_end=0.4, log_period=1e-2)
    bypass = False
    if case == "latency":
        cfg.update(sensor_latency=2e-3, control_period=2e-2,
                   disturbance=jloop.pulse_disturbance(0.1, 0.2, 1.0))
    elif case == "free_running":
        cfg.update(control_period=None, t_end=0.1)
        bypass = True
    else:
        cfg.update(control_period=1e-2, skip_publish_eps=0.03, t_end=2.0,
                   tip_over=lambda xh: abs(float(xh[2])) > 0.3)
    if "disturbance" in cfg:
        port_cfg = {**cfg, "disturbance": tloop.pulse_disturbance(0.1, 0.2, 1.0)}
    else:
        port_cfg = cfg
    got, got_csv = _run("port", port_cfg, tmp_path, bypass=bypass)
    want, want_csv = _run("jax", cfg, tmp_path, bypass=bypass)
    assert got.n_solves == want.n_solves and got.tipped == want.tipped and got.t == want.t
    assert got.history == want.history
    np.testing.assert_array_equal(got.x, want.x)
    assert got_csv == want_csv and got_csv.count("\n") >= 10
    assert len(got.solve_seconds) == got.n_solves
    if case == "free_running":
        assert got.n_solves == len(got.history) == 100
    if case == "skip_publish_tip":
        assert got.tipped and got.t < 2.0
        published = {u for _, u in got.history}
        assert len(published) < got.n_solves  # some solves were not published


def test_simple_loop_matches_jax_loop(tmp_path):
    def solve(_seed_or_key, x, u_n):
        return np.asarray(u_n) * 0.5 - 0.8 * x[2] - 0.3 * x[3], 0

    def step(x, u):
        return _plant(x, u, 0.02, 0.0)

    paths = [str(tmp_path / "p.csv"), str(tmp_path / "j.csv")]
    with CsvLogger(paths[0]) as lg:
        got = tloop.run_simple_loop(solve=solve, plant_step=step, dt=0.02, t_end=1.0, x0=np.array([0.1, 0, 0.05, 0]),
                                    u0=np.zeros(3), seeds=np.random.default_rng(0),
                                    tip_over=lambda x: abs(x[2]) > 1.0, logger=lg)
    with jlogger.CsvLogger(paths[1]) as lg:
        want = jloop.run_simple_loop(solve=solve, plant_step=step, dt=0.02, t_end=1.0, x0=np.array([0.1, 0, 0.05, 0]),
                                     u0=np.zeros(3), key=jax.random.key(0),
                                     tip_over=lambda x: abs(x[2]) > 1.0, logger=lg)
    assert (got.t, got.tipped, got.n_solves) == (want.t, want.tipped, want.n_solves) and got.n_solves == 50
    for (ta, ua, xa), (tb, ub, xb) in zip(got.history, want.history):
        assert ta == tb and ua == ub and np.array_equal(xa, xb)
    assert open(paths[0]).read() == open(paths[1]).read()


def test_loop_seeds_come_from_the_generator():
    """Each solve gets the next integer of ``seeds`` in [0, 2³¹ − 1)."""
    got = []

    def controller(seed, xh, u_n):
        got.append(seed)
        return u_n, 0

    tloop.run_multirate_loop(
        tloop.MultiRateConfig(dt_phys=1e-2, sensor_period=5e-2, control_period=2e-2, t_end=0.2),
        plant_step=lambda x, u, dt, f: x, sensor=lambda r, x: x, est_predict_update=lambda e, u, z, dt: e,
        est_state=lambda e: np.zeros(4), controller=controller, predictor=None, x0=np.zeros(4),
        u0=np.zeros(2), est0=None, seeds=np.random.default_rng(5), rng=np.random.default_rng(0))
    want = np.random.default_rng(5).integers(0, 2**31 - 1, size=len(got)).tolist()
    assert got == want and len(got) == 10 and all(isinstance(s, int) for s in got)


# --------------------------------------------------------------------------
# (v) the mppi2 and mppi4 loops against the JAX package's, on the same noise


def _jax_loop(jcfg, jstep, jcost, x0, noise, n, dt, ticks, guard=None):
    jsolve = jax.jit(lambda x, u_n, eps: jmppi.mppi_solve(jcfg, jstep, jcost, None, x, u_n, noise=eps))
    x, u_n, rows = np.asarray(x0, np.float64), jnp.zeros(n, jnp.float64), []
    for i in range(ticks):
        r = jsolve(tuple(jnp.float64(c) for c in x), u_n, jnp.asarray(noise[i]))
        u_n = r.u_n
        x = jax_np_step(jstep, x, float(u_n[0]))
        rows.append([dt * i, float(u_n[0]), *x])
        if guard is not None and guard(x):
            break
    return np.asarray(rows), x


def _port_solve(cfg, model, noise):
    def solve(seed, x, u_n):
        r = tmppi.mppi_solve(cfg, model.step, model.cost, None, tuple(torch.tensor(c, dtype=torch.float64) for c in x),
                             u_n, noise=torch.tensor(noise[seed]))
        return r.u_n, r.status

    return solve


def test_mppi2_loop_matches_jax_loop(capsys):
    """mppi2's 5 s loop (100 ticks, N=40, control_inv = 2.5) in float64 on
    the same noise a tick: the trajectory equals the JAX one to 1e-9."""
    n, k, dt = 40, 256, 0.05
    kw = dict(n_horizon=n, n_rollouts=k, lambda_=2.5, std_dev=1.0, limit=(-3.0, 3.0), control_inv=2.5)
    noise = np.random.default_rng(2).standard_normal((101, k, n))
    model = apps.DoubleIntegratorQuad2(dt)
    res = apps.regulate_loop(_port_solve(tmppi.MppiConfig(**kw), model, noise), tdyn.make_double_integrator(dt),
                             [1.0, 0.0], torch.zeros(n, dtype=torch.float64), t_end=5.0, dt=dt, seed=0)
    want, x = _jax_loop(jmppi.MppiConfig(**kw), jdyn.make_double_integrator(dt), jcosts.quad2, [1.0, 0.0], noise, n,
                        dt, len(res.statuses))
    assert len(res.statuses) in (100, 101) and res.statuses == [0] * len(res.statuses)
    np.testing.assert_allclose(res.x, x, **F64_BAND)
    assert abs(res.x[0]) < 0.3 and abs(res.x[1]) < 0.3  # the acceptance rule (apps/acceptance.py:39-43)
    assert capsys.readouterr().out.count("t: ") == len(res.statuses)


# At mppi4's λ=0.5 the softmax weights one or two rollouts and the closed
# loop amplifies the packages' last-bit differences about tenfold a tick
# (tests/test_torch_apps.py). The linear cart-pole's loop does so at λ=5
# too (2e-15 at tick 1, 0.6 by tick 18) and at λ=20 (1e-6 by tick 20); at
# λ=50 it stays within 1e-10 over 20 ticks, so it is held there.
def test_mppi4_loop_matches_jax_loop(tmp_path, capsys):
    """20 ticks of mppi4's loop (the linear cart-pole) in float64 on the
    same noise a tick: the CSV rows and the final state equal the JAX
    loop's to 1e-9."""
    n, k, ticks = 8, 1024, 20
    kw = dict(n_horizon=n, n_rollouts=k, lambda_=50.0, std_dev=3.0, limit=(-20.0, 20.0))
    noise = 3.0 * np.random.default_rng(4).standard_normal((ticks, k, n))
    p = CartPoleParams.single_wheel()
    model = apps.CartPoleLinearShaped4(p, 0.1)
    with CsvLogger(str(tmp_path / "port.csv")) as log:
        res = apps.closed_loop(_port_solve(tmppi.MppiConfig(**kw), model, noise), model.step,
                               (0.5, 0.0, 0.1, 0.0), torch.zeros(n, dtype=torch.float64),
                               t_end=1.95, dt=0.1, seed=0, logger=log)
    got = np.loadtxt(tmp_path / "port.csv", delimiter=",")
    want, x = _jax_loop(jmppi.MppiConfig(**kw), jdyn.make_cartpole_linear(JParams.single_wheel(), 0.1),
                        jcosts.shaped4, (0.5, 0.0, 0.1, 0.0), noise, n, 0.1, ticks)
    assert got.shape == (ticks, 6) and res.statuses == [0] * ticks and not res.tipped
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], **F64_BAND)
    np.testing.assert_allclose(got[:, 0], want[:, 0], atol=1e-12)
    np.testing.assert_allclose(res.x, x, **F64_BAND)


# --------------------------------------------------------------------------
# (vi) one estimator step of each UKF app against the JAX one, in float64


def _jax_s_est(p, ref_qr):
    plant = jdyn.make_cartpole_nonlinear(p, None)
    hx = jobs.make_hx_rpm_gyro4(p)
    if ref_qr:
        q = jnp.asarray([[0, 0, 0, 0], [0, 0, 0, 1.0], [0, 0, 1.0, 1e2], [0, 1.0, 1e2, 1e4]], jnp.float64)
        r = jnp.diag(jnp.asarray([50.0, 50.0, 0.5], jnp.float64))
        p0 = jnp.eye(4, dtype=jnp.float64)
    else:
        q = jnoise.gen_q4(3e-3, (25.0, 400.0)).astype(jnp.float64)
        r = jnp.diag(jnp.asarray([2500.0, 2500.0, 0.25], jnp.float64))
        p0 = 0.1 * jnp.eye(4, dtype=jnp.float64)
    params, s0 = jukf.ukf_init(jnp.zeros(4, jnp.float64), p0, q, r)
    s0 = s0._replace(x=jnp.asarray([0.0, 0.0, 0.01, 0.0], jnp.float64))

    def est_step(state, u, z, dt_est):  # mppi_examples.py:127-135
        def fxd(xv, uu):
            out = plant(*(xv[..., i] for i in range(4)), uu, dt_est)
            return jnp.stack(jnp.broadcast_arrays(*out), axis=-1)

        state = jukf.ukf_predict(params, state, u, fxd)
        return jukf.ukf_update(params, state, z, hx)

    return s0, est_step


def _jax_ukf_est(p, dt, est_in_loop, alpha):
    plant6 = jdyn.make_flagship6(p)
    hx = jobs.make_hx_imu6(p)
    q_scale = 2.15 if est_in_loop else 1.0
    alpha = (1.0 if est_in_loop else 1e-3) if alpha is None else alpha
    params, s0 = jukf.ukf_init(
        jnp.zeros(6, jnp.float64), (0.1 if est_in_loop else 10.0) * jnp.eye(6, dtype=jnp.float64),
        jnoise.gen_q6(jnp.float64(q_scale * dt)),
        jnp.diag(jnp.asarray([200.0, 200.0, 10.0, 0.05, 0.05], jnp.float64)), alpha=alpha)

    def est_step(state, u, z, dt_est):  # mppi_examples.py:215-223
        def fxd(xv, uu):
            out = plant6(*(xv[..., i] for i in range(6)), uu, dt_est, 0.0)
            return jnp.stack(jnp.broadcast_arrays(*out), axis=-1)

        state = state._replace(q=jnoise.gen_q6(q_scale * dt_est).astype(state.q.dtype))
        state = jukf.ukf_predict(params, state, u, fxd)
        return jukf.ukf_update(params, state, z, hx)

    return s0, est_step


def _hold(got, jest, js0, steps):
    """The port's filter after ``steps`` against the JAX one run eagerly:
    x and P within 1e-8 of their largest entry, or within twice the JAX
    package's own distance between its filter run eagerly and under
    ``jax.jit`` where that is larger: with Merwe α=1e-3 at n=6 the center
    weight wc0 is about −2e6, which turns the last bits of two summation
    orders into 1e-6 of x and 1e-3 of a P of 1e3 in either package
    (DEBUG_UKF's filter, P0 = 10·I)."""
    want, want_jit = js0, js0
    for u, z, dt in steps:
        want = jest(want, u, jnp.asarray(z), dt)
        want_jit = jax.jit(jest)(want_jit, u, jnp.asarray(z), dt)
    for field in ("x", "p"):
        g, w, wj = getattr(got, field).numpy(), np.asarray(getattr(want, field)), np.asarray(getattr(want_jit, field))
        assert np.abs(g - w).max() <= 2.0 * np.abs(w - wj).max() + 1e-8 * np.abs(w).max() + 1e-10, field
    np.testing.assert_allclose(got.q.numpy(), np.asarray(want.q), rtol=1e-12, atol=1e-16)


@pytest.mark.parametrize("ref_qr", [False, True])
def test_nonliner_s_est_step_matches_jax(ref_qr):
    """mppi4-non-liner-s's UKF(4,3) step (Merwe α=1e-3, the plant at the
    tick's dt), twice, in float64."""
    _, s0, est = apps.nonliner_s_estimator(CartPoleParams.single_wheel(), ref_qr=ref_qr, dtype=torch.float64)
    js0, jest = _jax_s_est(JParams.single_wheel(), ref_qr)
    z = np.array([12.0, 11.0, 3.5])
    steps = [(1.3, z, 3e-3), (-0.7, z + 1.0, 2e-3)]
    got = s0
    for u, zz, dt in steps:
        got = est(got, u, torch.tensor(zz), dt)
    _hold(got, jest, js0, steps)


@pytest.mark.parametrize("est_in_loop, alpha", [(False, None), (True, None), (True, 0.5)])
def test_nonliner_ukf_est_step_matches_jax(est_in_loop, alpha):
    """mppi4-non-liner-ukf's UKF2(6,5) step (Q rebuilt from the tick's dt),
    twice, in float64, in DEBUG_UKF mode, with the estimate in the loop, and
    with another α."""
    p, jp = CartPoleParams.two_wheel(), JParams.two_wheel()
    _, s0, est = apps.nonliner_ukf_estimator(p, 0.15, est_in_loop=est_in_loop, alpha=alpha, dtype=torch.float64)
    js0, jest = _jax_ukf_est(jp, 0.15, est_in_loop, alpha)
    z = np.array([30.0, -30.0, 5.0, 1.0, 0.02])
    steps = [(2.0, z, 9e-3), (-1.0, z * 0.9, 1e-2)]
    got = s0
    for u, zz, dt in steps:
        got = est(got, u, torch.tensor(zz), dt)
    _hold(got, jest, js0, steps)


def test_ukf_estimators_default_to_float32_on_the_host():
    _, s0, _ = apps.nonliner_s_estimator(CartPoleParams.single_wheel())
    _, u0, _ = apps.nonliner_ukf_estimator(CartPoleParams.two_wheel(), 0.15, est_in_loop=True)
    for s in (s0, u0):
        assert s.x.dtype == s.p.dtype == torch.float32 and s.x.device.type == "cpu"


# --------------------------------------------------------------------------
# (vii) the new subcommands on the plain path, and without a card


APP_RUNS = {
    "mppi2": ["--k", "512"],
    "mppi4": ["--k", "1024", "--t-end", "1"],
    "mppi4-non-liner-s": ["--k", "1024", "--t-end", "0.5"],
    "mppi4-non-liner-ukf": ["--k", "1024", "--t-end", "0.3"],
    "mppi4-non-liner-ukf+est": ["--k", "1024", "--t-end", "0.3", "--use-ukf-estimate", "--control-period", "0.02",
                                "--ukf-alpha", "1.0"],
}


@pytest.mark.parametrize("case", APP_RUNS)
def test_family_cli_runs_on_cpu(case, tmp_path, capsys):
    name = case.split("+")[0]
    argv = [name, "--device", "cpu", "--sampler", "clt4a", *APP_RUNS[case]]
    if name != "mppi2":
        argv += ["--log-dir", str(tmp_path)]
    res = cli.main(argv)
    out = capsys.readouterr().out
    if name in ("mppi2", "mppi4"):
        assert np.isfinite(res.x).all() and res.statuses == [0] * len(res.statuses) and not res.tipped
        assert len(res.statuses) >= (100 if name == "mppi2" else 10)
    else:
        assert not res.tipped and res.t >= float(APP_RUNS[case][3]) - 1e-9 and res.n_solves >= 5
        assert "survived to t=" in out
        csv = np.loadtxt(tmp_path / "mppi" / "mppi.csv", delimiter=",")
        # t, u, x, x̂, x_pred (mppi_examples.py:153,306)
        assert csv.shape[1] == 2 + 3 * (4 if name == "mppi4-non-liner-s" else 6) and np.isfinite(csv).all()


@pytest.mark.parametrize("name", ["mppi2", "mppi4", "mppi4-non-liner-s", "mppi4-non-liner-ukf"])
def test_family_cli_default_device_without_cuda_raises(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device runs")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main([name, "--t-end", "0.1", *([] if name == "mppi2" else ["--log-dir", str(tmp_path)])])


@pytest.mark.parametrize("argv", [["mppi2", "--log-dir", "x"], ["mppi4", "--ref-qr"],
                                  ["mppi4-non-liner-s", "--use-ukf-estimate"], ["mppi4-non-liner", "--sampler", "clt4"]])
def test_family_cli_rejects_options_of_another_example(argv):
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(argv)
