"""The port's estimator ladder and PID baseline against the JAX package.

The library pieces (``Gaussian``, ``kf``, ``pid``, ``make_hx_vel2``,
``make_cartpole_linear_pid``, ``make_gaussian_sensor``) are fed the same
seeded numpy inputs in both packages. Each app runs at the same seed in
both packages (float64; the JAX package runs with x64, as its acceptance
does) and draws the same numpy noise: the truth and the observations are
equal bit for bit, and the app passes the JAX package's own acceptance
check (``mpc_rs_tpu/apps/acceptance.py:80-192``) and the port's copy of it
(``mpc_rs_tpu_torch/apps/acceptance.py``, which ``chip_smoke.py`` holds
its ladder apps to), with the same verdict.

Tolerances (measured over seeds 0-5 on the CPU):
- the KFs, ``ukf-one`` and ``pid``: F64_BAND (1e-9); the same operations.
- ``ukf-two`` and ``ukf-pen``: UKF_BAND (1e-6; measured at most 5.8e-7).
  The reference's α=1e-3 gives the non-center sigma points the weight
  1/(2α²(n+κ)) ≈ 1.7e5, which multiplies the last-bit differences of two
  builds' float64 sin, cos and sums.
- ``ukf-pen2`` and ``ukf-pen3``: the filters' trajectories part (the
  estimate by up to 3.6e-2 and 8.8e3 at seeds 0-5), so they are held step by
  step: one predict and update of each package from the JAX filter's state
  at every step, within 1e-8 (pen2; measured 1.0e-9) and 1e-4 (pen3;
  measured 3.8e-5) of |x|+1. pen3's covariance has near-equal eigenvalues
  (gaps near 1e-10 of C·P), where the two LAPACK builds' ``eigh`` bases
  differ by up to 3.8e-9; the JAX package's own jitted and eager filters
  part by 164 in the estimate at seed 2. At seeds 0-39 on the CPU the port
  passes pen3's check at 39 and the JAX app at 40 (the port misses seed 2,
  dx settled RMSE 1.18 against the band's 0.6); every other app passes at
  all 40 in both packages.
"""

import contextlib
import io
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mpc_rs_tpu.apps import acceptance as jacc
from mpc_rs_tpu.apps import estimator_examples as jest
from mpc_rs_tpu.controllers import pid as jpid
from mpc_rs_tpu.estimators import gaussian as jgauss
from mpc_rs_tpu.estimators import kf as jkf
from mpc_rs_tpu.models import dynamics as jdyn
from mpc_rs_tpu.models import observation as jobs
from mpc_rs_tpu.models.params import CartPoleParams as JParams
from mpc_rs_tpu_torch.apps import acceptance as tacc
from mpc_rs_tpu_torch.apps import estimator_examples as tladder
from mpc_rs_tpu_torch.apps import run as cli
from mpc_rs_tpu_torch.controllers import pid as tpid
from mpc_rs_tpu_torch.estimators import gaussian as tgauss
from mpc_rs_tpu_torch.estimators import kf as tkf
from mpc_rs_tpu_torch.models import dynamics as tdyn
from mpc_rs_tpu_torch.models import observation as tobs
from mpc_rs_tpu_torch.models.params import CartPoleParams

F64_BAND = dict(rtol=1e-9, atol=1e-9)
UKF_BAND = dict(rtol=1e-6, atol=1e-6)
STEP_BAND = {"ukf-pen2": 1e-8, "ukf-pen3": 1e-4}
T64 = dict(dtype=torch.float64)


# --------------------------------------------------------------------------
# library pieces


def test_gaussian_algebra_matches_jax():
    rng = np.random.default_rng(0)
    m = rng.normal(size=(2, 16))
    v = rng.uniform(0.1, 3.0, size=(2, 16))
    ja, jb = (jgauss.Gaussian(jnp.asarray(m[i]), jnp.asarray(v[i])) for i in range(2))
    ta, tb = (tgauss.Gaussian(torch.tensor(m[i]), torch.tensor(v[i])) for i in range(2))
    for jr, tr in ((ja + jb, ta + tb), (ja - jb, ta - tb), (ja * jb, ta * tb), (ja * 1.7, ta * 1.7),
                   (2.5 * ja, 2.5 * ta), (jgauss.kf1d_predict(ja, jb), tgauss.kf1d_predict(ta, tb))):
        np.testing.assert_allclose(tr.mean.numpy(), np.asarray(jr.mean), **F64_BAND)
        np.testing.assert_allclose(tr.var.numpy(), np.asarray(jr.var), **F64_BAND)


def test_kf_predict_and_joseph_update_match_jax():
    rng = np.random.default_rng(1)
    n, o = 4, 2
    x, u, z = rng.normal(size=n), rng.normal(size=2), rng.normal(size=o)
    f, b, h = rng.normal(size=(n, n)), rng.normal(size=(n, 2)), rng.normal(size=(o, n))
    a = rng.normal(size=(n, n))
    p, q, r = a @ a.T + np.eye(n), 0.1 * np.eye(n), np.diag([0.5, 2.0])
    j = jkf.kf_predict(*map(jnp.asarray, (x, p, f, q, u, b)))
    t = tkf.kf_predict(*map(torch.tensor, (x, p, f, q, u, b)))
    for tv, jv in zip(t, j):
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **F64_BAND)
    j0 = jkf.kf_predict(*map(jnp.asarray, (x, p, f, q)))
    t0 = tkf.kf_predict(*map(torch.tensor, (x, p, f, q)))
    np.testing.assert_allclose(t0[0].numpy(), np.asarray(j0[0]), **F64_BAND)
    j = jkf.kf_update_joseph(*map(jnp.asarray, (x, p, z, h, r)))
    t = tkf.kf_update_joseph(*map(torch.tensor, (x, p, z, h, r)))
    for tv, jv in zip(t, j):
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **F64_BAND)


def test_pid_update_matches_jax_over_a_sequence():
    rng = np.random.default_rng(2)
    cfg_kw = dict(kp=0.6, ki=0.4, kd=5e-3, lo=-25.0, hi=25.0)
    js, ts = jpid.pid_init(dtype=jnp.float64, shape=(8,)), tpid.pid_init(dtype=torch.float64, shape=(8,))
    for _ in range(50):
        ref, act = rng.normal(size=8), 3.0 * rng.normal(size=8)  # some steps hit the clamp
        ju, js = jpid.pid_update(jpid.PidConfig(**cfg_kw), js, jnp.asarray(ref), jnp.asarray(act), 1e-3)
        tu, ts = tpid.pid_update(tpid.PidConfig(**cfg_kw), ts, torch.tensor(ref), torch.tensor(act), 1e-3)
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **F64_BAND)
    for tv, jv in zip(ts, js):
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **F64_BAND)
    assert float(np.abs(np.asarray(ju)).max()) == 25.0


def test_make_hx_vel2_and_the_pid_cartpole_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 7, 4))
    np.testing.assert_array_equal(tobs.make_hx_vel2()(torch.tensor(x)).numpy(),
                                  np.asarray(jobs.make_hx_vel2()(jnp.asarray(x))))
    xs, u = rng.normal(size=(4, 32)), rng.normal(size=32)
    jstep = jdyn.make_cartpole_linear_pid(JParams.single_wheel(), 1e-3)
    tstep = tdyn.make_cartpole_linear_pid(CartPoleParams.single_wheel(), 1e-3)
    jx, tx = tuple(map(jnp.asarray, xs)), tuple(map(torch.tensor, xs))
    for _ in range(20):
        jx, tx = jstep(*jx, jnp.asarray(u)), tstep(*tx, torch.tensor(u))
    for tv, jv in zip(tx, jx):
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **F64_BAND)
    # the precedence quirk: D's mass line takes J1, not J1 / R_W²
    lin = tdyn.make_cartpole_linear(CartPoleParams.single_wheel(), 1e-3)
    assert not np.allclose(tstep(*map(torch.tensor, xs), torch.tensor(u))[3].numpy(),
                           lin(*map(torch.tensor, xs), torch.tensor(u))[3].numpy())


def test_make_gaussian_sensor_against_jax():
    """hx(x) plus σ times standard normals drawn from the caller's
    generator: the port's draw is the generator's randn (bit for bit), and
    the normalised noise of both packages' sensors has the moments of
    N(0, 1) over 2·10⁵ draws."""
    p = CartPoleParams.single_wheel()
    sig = [50.0, 50.0, 0.5]
    rng = np.random.default_rng(4)
    x = rng.normal(size=(20_000, 4)) * 0.1
    hx_t, hx_j = tobs.make_hx_rpm_gyro4(p), jobs.make_hx_rpm_gyro4(JParams.single_wheel())
    got = tobs.make_gaussian_sensor(hx_t, sig)(torch.Generator().manual_seed(9), torch.tensor(x))
    eps = torch.randn((20_000, 3), generator=torch.Generator().manual_seed(9), **T64)
    np.testing.assert_array_equal(got.numpy(), (hx_t(torch.tensor(x)) + torch.tensor(sig, **T64) * eps).numpy())
    zeros = tobs.make_gaussian_sensor(hx_t, [0.0, 0.0, 0.0])(torch.Generator().manual_seed(1), torch.tensor(x))
    np.testing.assert_allclose(zeros.numpy(), np.asarray(hx_j(jnp.asarray(x))), **F64_BAND)
    want = np.asarray(jobs.make_gaussian_sensor(hx_j, jnp.asarray(sig))(jax.random.key(9), jnp.asarray(x)))
    for z in (got.numpy(), want):
        e = (z - np.asarray(hx_j(jnp.asarray(x)))) / np.asarray(sig)
        assert abs(e.mean()) < 0.02 and abs(e.std() - 1.0) < 0.02


# --------------------------------------------------------------------------
# the apps


def _quiet(fn, args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = fn(args)
    return ret, buf.getvalue()


EST_APPS = ["ukf-one", "ukf-two", "ukf-pen", "ukf-pen2", "ukf-pen3"]
JAX_APPS = {"one-liner-kf": jest.one_liner_kf, "two-liner-kf": jest.two_liner_kf, "ukf-one": jest.ukf_one,
            "ukf-two": jest.ukf_two, "ukf-pen": jest.ukf_pen, "ukf-pen2": jest.ukf_pen2,
            "ukf-pen3": jest.ukf_pen3, "pid": jest.pid}
JAX_CHECKS = {"one-liner-kf": jacc.chk_kf1d, "two-liner-kf": jacc.chk_kf2d, "ukf-one": jacc.chk_ukf_one,
              "ukf-two": jacc.chk_ukf_two, "ukf-pen": jacc.chk_ukf_pen, "ukf-pen2": jacc.chk_ukf_pen2,
              "ukf-pen3": jacc.chk_ukf_pen3, "pid": jacc.chk_pid_tips}
# the port's checks of the apps chip_smoke.py runs on the card
TORCH_CHECKS = {app: tacc.SPECS[app][2] for app in chip_smoke.LADDER_APPS}


def _replay_steps(app, run):
    """Largest one-step distance, over |x|+1 and max|P|, of the port's
    predict and update from the JAX filter's state at every step of
    ``run`` (the JAX app's EstRun), fed that step's observation."""
    from mpc_rs_tpu.estimators import ukf as jukf
    from mpc_rs_tpu.utils import as_vector_fn
    from mpc_rs_tpu_torch.estimators import ukf as tukf

    jp, tp = JParams.single_wheel(), CartPoleParams.single_wheel()
    if app == "ukf-pen2":
        q, r, n = np.diag([0.0, 0.0, 0.0, 0.25]), [100.0, 100.0, 0.5], 4
        jfx, jhx = as_vector_fn(jdyn.make_cartpole_nonlinear(jp, 0.01), 4), jobs.make_hx_rpm_gyro4(jp)
        tfx, thx = tladder._vector(tdyn.make_cartpole_nonlinear(tp, 0.01)), tobs.make_hx_rpm_gyro4(tp)
    else:
        q, r, n = np.diag([0.0, 0.0, 0.0, 0.0, 0.0, 10.0]), [100.0, 100.0, 0.5, 100.0, 100.0], 6
        jfx, jhx = as_vector_fn(jdyn.make_pen6(jp, 0.01), 6), jobs.make_hx_force6(jp)
        tfx, thx = tladder._vector(tdyn.make_pen6(tp, 0.01)), tobs.make_hx_force6(tp)
    jpar, js = jukf.ukf_init(jnp.zeros(n), 10 * jnp.eye(n), jnp.asarray(q), jnp.diag(jnp.asarray(r)))
    tpar, ts = tukf.ukf_init(torch.zeros(n, **T64), 10 * torch.eye(n, **T64), torch.tensor(q),
                             torch.diag(torch.tensor(r)))
    dx = dp = 0.0
    for z in run.obs:
        got = tukf.ukf_update(tpar, tukf.ukf_predict(
            tpar, ts._replace(x=torch.tensor(np.asarray(js.x)), p=torch.tensor(np.asarray(js.p))), 0.1, tfx),
            torch.tensor(z), thx)
        js = jukf.ukf_update(jpar, jukf.ukf_predict(jpar, js, 0.1, jfx), jnp.asarray(z), jhx)
        jx, jpp = np.asarray(js.x), np.asarray(js.p)
        dx = max(dx, float((np.abs(got.x.numpy() - jx) / (np.abs(jx) + 1.0)).max()))
        dp = max(dp, float(np.abs(got.p.numpy() - jpp).max() / np.abs(jpp).max()))
    np.testing.assert_array_equal(np.asarray(js.x), run.est[-1])  # the replay is the JAX app's filter
    return dx, dp


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("app", list(JAX_APPS))
def test_ladder_app_matches_jax_and_passes_its_acceptance(app, seed, tmp_path):
    args = SimpleNamespace(seed=seed, device="cpu", log_dir=str(tmp_path), t_end=10.0)
    jret, jout = _quiet(JAX_APPS[app], args)
    tret, tout = _quiet(cli.main, [app, "--device", "cpu", "--seed", str(seed),
                                   *(["--log-dir", str(tmp_path)] if app == "pid" else [])])
    if app in STEP_BAND:
        np.testing.assert_array_equal(tret.act, jret.act)
        np.testing.assert_array_equal(tret.obs, jret.obs)
        assert max(_replay_steps(app, jret)) < STEP_BAND[app]
    elif app in EST_APPS:
        band = F64_BAND if app == "ukf-one" else UKF_BAND
        for field in tladder.EstRun._fields:
            np.testing.assert_allclose(getattr(tret, field), np.asarray(getattr(jret, field)), **band,
                                       err_msg=field)
    elif app == "one-liner-kf":
        np.testing.assert_allclose([float(tret.mean), float(tret.var)], [float(jret.mean), float(jret.var)],
                                   **F64_BAND)
    else:
        pairs = zip(tret, jret) if app == "two-liner-kf" else [(tret, jret)]
        for tv, jv in pairs:
            np.testing.assert_allclose(np.asarray(tv), np.asarray(jv), **F64_BAND)
    assert tout.count("\n") == jout.count("\n")
    want = JAX_CHECKS[app](jret, jout)
    assert want and JAX_CHECKS[app](tret, tout) == want
    assert TORCH_CHECKS[app](tret, tout) == want


def test_ladder_checks_reject_what_the_jax_checks_reject():
    """The copied criteria fail where the JAX package's do: a diverged
    estimate, and a PID that did not tip."""
    ret, _ = _quiet(tladder.ukf_pen2, SimpleNamespace(seed=0, device="cpu"))
    bad = ret._replace(est=ret.est + 1.0)
    for app in ("ukf-pen", "ukf-pen2"):
        assert not JAX_CHECKS[app](bad, "") and not TORCH_CHECKS[app](bad, "")
    assert not TORCH_CHECKS["pid"](np.zeros(4), "no tip")
    g = tgauss.Gaussian(torch.tensor(40.0, **T64), torch.tensor(1.0, **T64))
    assert not jacc.chk_kf1d(g, "") and not TORCH_CHECKS["one-liner-kf"](g, "")


def test_ladder_apps_take_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device runs")
    for app in ("ukf-pen", "pid"):
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main([app, *(["--log-dir", str(tmp_path)] if app == "pid" else [])])
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["ukf-pen", "--k", "8"])  # the ladder takes no MPPI option
