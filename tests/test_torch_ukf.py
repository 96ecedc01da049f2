"""The port's AoS unscented Kalman filter against the JAX package's.

``estimators/smallalg.py`` (the unrolled Cholesky, its solves and the
unrolled Jacobi eigendecomposition) and ``estimators/ukf.py``
(``sigma_points`` with the three roots, ``unscented_transform``,
``ukf_predict``, ``ukf_update``, ``ukf_step``) are held against
``mpc_rs_tpu/estimators/{smallalg,ukf}.py`` on the same numpy inputs at
(n, o) = (4, 3) and (6, 5). Then the AoS cases of ``tests/test_ukf.py`` run
on the port's filter, among them the 300-tick f32 closed-loop fidelity
replay that justifies the fleets' f32 α = 1 default.

Bands: float64 1e-10 (the same operations in another summation order);
float32 rtol 1e-4 / atol 1e-5. ``eigh`` sigma sets are compared up to the
sign of each ± column pair, which LAPACK builds may choose differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_rs_tpu.estimators import smallalg as jsmall
from mpc_rs_tpu.estimators import ukf as jukf
from mpc_rs_tpu.models import dynamics as jdyn
from mpc_rs_tpu.models import noise as jnoise
from mpc_rs_tpu.models import observation as jobs
from mpc_rs_tpu.models.params import CartPoleParams as JParams
from mpc_rs_tpu.utils import as_vector_fn
from mpc_rs_tpu_torch.estimators import smallalg as tsmall
from mpc_rs_tpu_torch.estimators import ukf as tukf
from mpc_rs_tpu_torch.models import dynamics as tdyn
from mpc_rs_tpu_torch.models import noise as tnoise
from mpc_rs_tpu_torch.models import observation as tobs
from mpc_rs_tpu_torch.models.params import CartPoleParams

BANDS = {np.float64: dict(rtol=1e-10, atol=1e-10), np.float32: dict(rtol=1e-4, atol=1e-5)}
TDTYPE = {np.float64: torch.float64, np.float32: torch.float32}
SIZES = [(4, 3), (6, 5)]
ROOTS = tukf.SQRT_METHODS


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _spd(rng, n, scale, batch=()):
    a = rng.normal(size=(*batch, n, n))
    return scale * (a @ np.swapaxes(a, -1, -2)) + 0.05 * np.eye(n)


def _t_vec(step, n):
    """The port's ``as_vector_fn``: a component step on (..., n)."""
    def f(x, u):
        return torch.stack(torch.broadcast_tensors(*step(*(x[..., i] for i in range(n)), u)), dim=-1)
    return f


def _models(n):
    """(JAX fx, JAX hx, port fx, port hx, x0, p0 scale) of the (n, o) model:
    the nonlinear cart-pole with the rpm/gyro sensor, or the flagship6 plant
    with the IMU."""
    if n == 4:
        jfx = as_vector_fn(jdyn.make_cartpole_nonlinear(JParams.single_wheel(), 0.01), 4)
        tfx = _t_vec(tdyn.make_cartpole_nonlinear(CartPoleParams.single_wheel(), 0.01), 4)
        return (jfx, jobs.make_hx_rpm_gyro4(JParams.single_wheel()), tfx,
                tobs.make_hx_rpm_gyro4(CartPoleParams.single_wheel()), np.array([0.1, -0.2, 0.15, 0.3]), 0.05)
    j6, t6 = jdyn.make_flagship6(JParams.two_wheel()), tdyn.make_flagship6(CartPoleParams.two_wheel())

    def jfx(x, u):
        return jnp.stack(jnp.broadcast_arrays(*j6(*(x[..., i] for i in range(6)), u, 0.01, 0.0)), axis=-1)

    def tfx(x, u):
        return torch.stack(torch.broadcast_tensors(*t6(*(x[..., i] for i in range(6)), u, 0.01, 0.0)), dim=-1)

    return (jfx, jobs.make_hx_imu6(JParams.two_wheel()), tfx, tobs.make_hx_imu6(CartPoleParams.two_wheel()),
            np.array([0.3, 0.5, 2.0, 0.08, 0.4, 1.0]), 1e-3)


def _both_init(x0, p0, q, r, dtype, **kw):
    jp, js = jukf.ukf_init(jnp.asarray(x0, dtype), jnp.asarray(p0, dtype), jnp.asarray(q, dtype),
                           jnp.asarray(r, dtype), **kw)
    tp, ts = tukf.ukf_init(torch.tensor(x0, dtype=TDTYPE[dtype]), p0, q, r, **kw)
    return (jp, js), (tp, ts)


def _assert_sigmas(got, want, n, root, band):
    """got against want (M, n); for 'eigh' with each ± pair of got in the
    order of want's (the pair's two rows swap when the column's sign does,
    before and after fx)."""
    if root == "eigh":
        got = got.copy()
        for i in range(1, n + 1):
            if np.abs(got[i] - want[i]).max() > np.abs(got[i] - want[i + n]).max():
                got[[i, i + n]] = got[[i + n, i]]
    np.testing.assert_allclose(got, want, **band)


# --------------------------------------------------------------------------
# smallalg


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n", [3, 4, 5, 6])
def test_smallalg_matches_jax(n, dtype):
    """chol_unrolled, chol_solve_unrolled, spd_solve_unrolled (with and
    without jitter) and eigh_jacobi_unrolled on a batch of SPD matrices,
    and a rank-deficient one whose zero pivot zeroes its column."""
    rng = np.random.default_rng(n)
    s = _spd(rng, n, 0.3, (8,)).astype(dtype)
    v = rng.normal(size=(n, n - 1))
    s[0] = (v @ v.T).astype(dtype)  # rank n - 1
    b = rng.normal(size=(8, n, 2)).astype(dtype)
    band = BANDS[dtype]
    ts, tb = torch.tensor(s), torch.tensor(b)
    jl, tl = jsmall.chol_unrolled(jnp.asarray(s)), tsmall.chol_unrolled(ts)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **band)
    np.testing.assert_allclose(_np(tsmall.chol_solve_unrolled(tl[1:], tb[1:])),
                               np.asarray(jsmall.chol_solve_unrolled(jl[1:], jnp.asarray(b[1:]))), **band)
    for jit in (0.0, 1e-3):
        np.testing.assert_allclose(_np(tsmall.spd_solve_unrolled(ts[1:], tb[1:], jit)),
                                   np.asarray(jsmall.spd_solve_unrolled(jnp.asarray(s[1:]), jnp.asarray(b[1:]), jit)),
                                   **band)
    jw, jv = jsmall.eigh_jacobi_unrolled(jnp.asarray(s))
    tw, tv = tsmall.eigh_jacobi_unrolled(ts)
    np.testing.assert_allclose(_np(tw), np.asarray(jw), **band)
    np.testing.assert_allclose(_np(tv), np.asarray(jv), **band)
    assert tw.shape == (8, n) and tv.shape == (8, n, n)


# --------------------------------------------------------------------------
# the AoS filter, function by function


def _case(n, o, dtype, root, alpha=1.0, seed=0):
    rng = np.random.default_rng(seed + 10 * n)
    jfx, jhx, tfx, thx, x0, scale = _models(n)
    x = x0 + 0.05 * rng.normal(size=n)
    p = _spd(rng, n, scale)
    q = _spd(rng, n, 1e-4)
    r = np.diag(rng.uniform(0.5, 2.0, size=o))
    jboth, tboth = _both_init(x, p, q, r, dtype, alpha=alpha, sqrt_method=root)
    return jboth, tboth, (jfx, jhx, tfx, thx), rng


@pytest.mark.parametrize("root", ROOTS)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n, o", SIZES)
def test_sigma_points_and_transform_match_jax(n, o, dtype, root):
    (jp, js), (tp, ts), _, rng = _case(n, o, dtype, root)
    band = BANDS[dtype]
    jsig = np.asarray(jukf.sigma_points(jp, js.x, js.p))
    tsig = _np(tukf.sigma_points(tp, ts.x, ts.p))
    assert tsig.shape == (2 * n + 1, n)
    _assert_sigmas(tsig, jsig, n, root, band)
    # the transform of a sigma set given to both (the JAX one's)
    sig = jsig + 0.01 * rng.normal(size=jsig.shape).astype(dtype)
    jm, jpp = jukf.unscented_transform(jp.wm, jp.wc, jnp.asarray(sig), js.q)
    tm, tpp = tukf.unscented_transform(tp.wm, tp.wc, torch.tensor(sig), ts.q)
    np.testing.assert_allclose(_np(tm), np.asarray(jm), **band)
    np.testing.assert_allclose(_np(tpp), np.asarray(jpp), **band)


def _assert_filter(got, j_out, j64_out, dtype):
    """The band; in float32 each entry may also be off by twice the JAX
    package's own float32 distance from its float64 filter: an update on
    the flagship's Pz (condition ~1e7) turns the last-bit differences of two
    float32 evaluations (LAPACK builds, summation orders) into ~1e-5 of x,
    in the JAX package as much as in the port."""
    got, want = _np(got).astype(np.float64), np.asarray(j_out, np.float64)
    band = BANDS[dtype]
    tol = band["atol"] + band["rtol"] * np.abs(want)
    if dtype == np.float32:
        tol = tol + 2.0 * np.abs(want - np.asarray(j64_out, np.float64))
    assert np.all(np.abs(got - want) <= tol), (np.abs(got - want) - tol).max()


@pytest.mark.parametrize("root", ROOTS)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n, o", SIZES)
def test_predict_update_step_match_jax(n, o, dtype, root):
    """One predict, one update and three steps, on the cart-pole (4, 3) or
    the flagship6 (6, 5) model, at the fleets' α = 1; the JAX package's
    float64 filter runs beside for the float32 band."""
    (jp, js), (tp, ts), (jfx, jhx, tfx, thx), rng = _case(n, o, dtype, root)
    (jp64, js64), _, _, _ = _case(n, o, np.float64, root)
    u = dtype(0.7)
    jpr, tpr = jukf.ukf_predict(jp, js, u, jfx), tukf.ukf_predict(tp, ts, float(u), tfx)
    jpr64 = jukf.ukf_predict(jp64, js64, float(u), jfx)
    _assert_filter(tpr.x, jpr.x, jpr64.x, dtype)
    _assert_filter(tpr.p, jpr.p, jpr64.p, dtype)
    _assert_sigmas(_np(tpr.sigma_f), np.asarray(jpr.sigma_f), n, root, BANDS[dtype])
    z = (np.asarray(jhx(jpr.x)) + rng.normal(size=o)).astype(dtype)
    jup, tup = jukf.ukf_update(jp, jpr, jnp.asarray(z), jhx), tukf.ukf_update(tp, tpr, torch.tensor(z), thx)
    jup64 = jukf.ukf_update(jp64, jpr64, jnp.asarray(z, jnp.float64), jhx)
    _assert_filter(tup.x, jup.x, jup64.x, dtype)
    _assert_filter(tup.p, jup.p, jup64.p, dtype)
    for _ in range(3):
        z = (np.asarray(jhx(js.x)) + 0.1 * rng.normal(size=o)).astype(dtype)
        js = jukf.ukf_step(jp, js, u, jnp.asarray(z), jfx, jhx)
        js64 = jukf.ukf_step(jp64, js64, float(u), jnp.asarray(z, jnp.float64), jfx, jhx)
        ts = tukf.ukf_step(tp, ts, float(u), torch.tensor(z), tfx, thx)
    _assert_filter(ts.x, js.x, js64.x, dtype)
    _assert_filter(ts.p, js.p, js64.p, dtype)
    np.testing.assert_allclose(_np(ts.p), _np(ts.p).T)


def test_params_take_the_root():
    jp, _ = jukf.ukf_init(jnp.zeros(4), jnp.eye(4), jnp.eye(4), jnp.eye(3), sqrt_method="cholesky")
    conv = tukf.UkfParams.from_arrays({k: np.asarray(v) for k, v in jp._asdict().items()})
    assert conv.sqrt_method == "cholesky"
    assert tukf.ukf_init(torch.zeros(4), torch.eye(4), torch.eye(4), torch.eye(3))[0].sqrt_method == "eigh"
    with pytest.raises(ValueError, match="sqrt_method"):
        tukf.ukf_init(torch.zeros(4), torch.eye(4), torch.eye(4), torch.eye(3), sqrt_method="svd")


def test_pen6_and_force6_match_jax():
    """The ukf-pen models the f32 cancellation case runs on."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(7, 6))
    jstep, tstep = jdyn.make_pen6(JParams.single_wheel(), 0.01), tdyn.make_pen6(CartPoleParams.single_wheel(), 0.01)
    want = np.asarray(as_vector_fn(jstep, 6)(jnp.asarray(x), 0.3))
    np.testing.assert_allclose(_np(_t_vec(tstep, 6)(torch.tensor(x), 0.3)), want, **BANDS[np.float64])
    want = np.asarray(jobs.make_hx_force6(JParams.single_wheel())(jnp.asarray(x)))
    got = tobs.make_hx_force6(CartPoleParams.single_wheel())(torch.tensor(x))
    np.testing.assert_allclose(_np(got), want, **BANDS[np.float64])


# --------------------------------------------------------------------------
# tests/test_ukf.py's AoS cases, on the port's filter


class NpUkf:
    """Oracle transcription of src/ukf.rs (SVD square root, f64), as
    tests/test_ukf.py:15-64 has it."""

    def __init__(self, x, p, q, r, alpha=1e-3, beta=2.0):
        self.n = len(x)
        self.x, self.p, self.q, self.r = map(np.array, (x, p, q, r))
        n = float(self.n)
        self.c = alpha**2 * (n + 3.0 - n)
        m = 2 * self.n + 1
        self.wm = np.full(m, 1.0 / (2 * self.c))
        self.wc = np.full(m, 1.0 / (2 * self.c))
        self.wm[0] = (self.c - n) / self.c
        self.wc[0] = (self.c - n) / self.c + 1 - alpha**2 + beta

    def _sigma_points(self):
        u, s, _ = np.linalg.svd(self.c * self.p)
        l = u @ np.diag(np.sqrt(s))
        return np.array([self.x] + [self.x + l[:, i] for i in range(self.n)]
                        + [self.x - l[:, i] for i in range(self.n)])

    def _ut(self, sigmas, cov):
        x = self.wm @ sigmas
        y = sigmas - x
        return x, (self.wc[:, None] * y).T @ y + cov

    def predict(self, u, fx):
        self.sigma_f = np.array([fx(s, u) for s in self._sigma_points()])
        self.x, self.p = self._ut(self.sigma_f, self.q)

    def update(self, z, hx):
        sigmas_h = np.array([hx(s) for s in self.sigma_f])
        zp, pz = self._ut(sigmas_h, self.r)
        pxz = (self.wc[:, None] * (self.sigma_f - self.x)).T @ (sigmas_h - zp)
        k = pxz @ np.linalg.inv(pz)
        self.x = self.x + k @ (z - zp)
        self.p = self.p - k @ pz @ k.T
        self.p = (self.p + self.p.T) / 2


def test_sigma_points_reconstruct_moments():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(4, 4))
    p = a @ a.T + 0.5 * np.eye(4)
    x = rng.normal(size=4)
    params, _ = tukf.ukf_init(torch.tensor(x), p, np.eye(4), np.eye(2))
    sig = _np(tukf.sigma_points(params, torch.tensor(x), torch.tensor(p)))
    assert sig.shape == (9, 4)
    wm, wc = _np(params.wm), _np(params.wc)
    mean = wm @ sig
    np.testing.assert_allclose(mean, x, atol=1e-9)
    y = sig - mean
    np.testing.assert_allclose((wc[:, None] * y).T @ y, p, rtol=1e-6, atol=1e-9)


def test_ukf_matches_numpy_oracle_cartpole():
    p = CartPoleParams.single_wheel()
    fx = _t_vec(tdyn.make_cartpole_nonlinear(p, 0.01), 4)
    hx = tobs.make_hx_rpm_gyro4(p)
    q = np.diag([0.0, 0.0, 0.0, 0.25])
    r = np.diag([100.0, 100.0, 0.5])
    p0 = np.eye(4) * 10.0
    x0 = np.zeros(4)
    params, state = tukf.ukf_init(torch.tensor(x0), p0, q, r)
    oracle = NpUkf(x0, p0, q, r)

    def np_fx(x, u):
        return _np(fx(torch.tensor(x), u))

    def np_hx(x):
        return _np(hx(torch.tensor(x)))

    rng = np.random.default_rng(0)
    u = 0.1
    x_act = np.zeros(4)
    for i in range(15):
        x_act = np_fx(x_act, u)
        z = np_hx(x_act) + rng.normal(size=3) * [100, 100, 0.5]
        state = tukf.ukf_update(params, tukf.ukf_predict(params, state, u, fx), torch.tensor(z), hx)
        oracle.predict(u, np_fx)
        oracle.update(z, np_hx)
        # the bands of tests/test_ukf.py:127-134: eigh and SVD roots agree to
        # ~1e-6 once the α=1e-3 center weights amplify them, and the open-loop
        # pendulum compounds it
        tol = 1e-4 if i < 10 else 3e-3
        np.testing.assert_allclose(_np(state.x), oracle.x, rtol=tol, atol=max(tol * 0.01, 1e-4))
        np.testing.assert_allclose(_np(state.p), oracle.p, rtol=10 * tol, atol=max(tol * 0.01, 1e-4))
    pf = _np(state.p)
    np.testing.assert_allclose(pf, pf.T)
    assert np.linalg.eigvalsh(pf).min() > -1e-10


def _pen6_finite_steps(seed: int, jax_filter: bool) -> int:
    """Steps of tests/test_ukf.py:216-235's f32 α=1e-3 replay (ukf-pen3's
    model and force IMU, numpy seed ``seed``) before the filter's mean or
    covariance goes non-finite, of 100: the JAX package's filter (jitted) or
    the port's."""
    tp, jp_ = CartPoleParams.single_wheel(), JParams.single_wheel()
    tfx, thx = _t_vec(tdyn.make_pen6(tp, 0.01), 6), tobs.make_hx_force6(tp)
    q = np.diag([0, 0, 0, 0, 0, 10.0])
    r = np.diag([100.0, 100.0, 0.5, 100.0, 100.0])
    if jax_filter:
        jfx, jhx = as_vector_fn(jdyn.make_pen6(jp_, 0.01), 6), jobs.make_hx_force6(jp_)
        params, s = jukf.ukf_init(jnp.zeros(6, jnp.float32), 10.0 * jnp.eye(6, dtype=jnp.float32),
                                  jnp.asarray(q, jnp.float32), jnp.asarray(r, jnp.float32))
        step = jax.jit(lambda st, z: jukf.ukf_step(params, st, jnp.float32(0.1), z, jfx, jhx))
    else:
        params, s = tukf.ukf_init(torch.zeros(6), 10.0 * np.eye(6), q, r)
        u = torch.tensor(0.1, dtype=torch.float32)
        step = lambda st, z: tukf.ukf_step(params, st, u, torch.tensor(z), tfx, thx)  # noqa: E731
    rng = np.random.default_rng(seed)
    x_act = np.zeros(6)
    for i in range(100):
        x_act = _np(tfx(torch.tensor(x_act), 0.1))
        z = (_np(thx(torch.tensor(x_act))) + rng.normal(size=5) * [100, 100, 0.5, 100, 100]).astype(np.float32)
        try:
            s = step(s, z)
        except torch.linalg.LinAlgError:  # torch's eigh raises where LAPACK's returns NaN
            return i
        if not (np.isfinite(_np(s.x)).all() and np.isfinite(_np(s.p)).all()):
            return i
    return 100


def test_ukf_f32_no_catastrophic_cancellation():
    """tests/test_ukf.py::test_ukf_f32_no_catastrophic_cancellation on the
    port: the f32 filter with the reference's α=1e-3 center weights, whose
    cancellation-free mean keeps it finite far longer than the naive mean
    would. The JAX test holds its filter finite for 100 steps at numpy seed
    0; that outcome is a matter of its rounding, as the filter itself
    diverges: the JAX package's own filter goes non-finite within 4-98
    steps at most seeds 1-9, and two float32 evaluations of one filter part
    ways within tens of steps. So the port is held to the reference's
    robustness over seeds 0-9 on the same inputs: its median number of
    finite steps is at least the JAX package's."""
    ours = [_pen6_finite_steps(seed, False) for seed in range(10)]
    ref = [_pen6_finite_steps(seed, True) for seed in range(10)]
    assert np.median(ours) >= np.median(ref), (ours, ref)


def test_ukf_jacobi_sigma_root_moment_contract():
    """Identity-UT over the sigma set reconstructs (x, P) for the eigh and
    the Jacobi root in f32, to the bounds of tests/test_ukf.py:238-273."""
    rng = np.random.default_rng(7)
    for trial in range(20):
        x0 = torch.tensor(rng.normal(size=6) * [0.2, 0.3, 0.5, 0.15, 0.5, 1.0], dtype=torch.float32)
        a = rng.normal(size=(6, 6)) * rng.uniform(0.02, 0.3)
        p0 = torch.tensor(a @ a.T + 1e-3 * np.eye(6), dtype=torch.float32)
        for m in ("eigh", "jacobi"):
            pr, _ = tukf.ukf_init(x0, p0, np.zeros((6, 6)), np.eye(5), sqrt_method=m)
            mean, cov = tukf.unscented_transform(pr.wm, pr.wc, tukf.sigma_points(pr, x0, p0),
                                                 torch.zeros((6, 6)))
            np.testing.assert_allclose(_np(mean), _np(x0), atol=5e-4, err_msg=f"trial {trial} {m} mean")
            pscale = max(float(p0.abs().max()), 1e-3)
            np.testing.assert_allclose(_np(cov) / pscale, _np(p0) / pscale, atol=2e-3,
                                       err_msg=f"trial {trial} {m} cov")


def test_ukf_jacobi_matches_eigh_on_linear_model():
    """Under linear fx/hx the UT sees only the sigma set's first two
    moments, so eigh and Jacobi give the same posterior up to the
    decomposition residual (f64; tests/test_ukf.py:276-318)."""
    rng = np.random.default_rng(11)
    a_lin = torch.tensor(np.eye(6) + 0.05 * rng.normal(size=(6, 6)))
    h_lin = torch.tensor(rng.normal(size=(5, 6)))

    def fx(xv, u):
        return xv @ a_lin.T + 0.1 * u

    def hx(xv):
        return xv @ h_lin.T

    q = np.diag([0, 0, 0, 0, 0, 10.0])
    r = np.diag([4.0, 4.0, 0.5, 4.0, 4.0])
    for trial in range(20):
        x0 = torch.tensor(rng.normal(size=6) * [0.2, 0.3, 0.5, 0.15, 0.5, 1.0])
        a = rng.normal(size=(6, 6)) * rng.uniform(0.02, 0.3)
        p0 = a @ a.T + 1e-3 * np.eye(6)
        z = torch.tensor(_np(h_lin) @ _np(x0) + rng.normal(size=5))
        states = {}
        for m in ("eigh", "jacobi"):
            pr, s = tukf.ukf_init(x0, p0, q, r, sqrt_method=m)
            states[m] = tukf.ukf_update(pr, tukf.ukf_predict(pr, s, 0.1, fx), z, hx)
        xe, xj = _np(states["eigh"].x), _np(states["jacobi"].x)
        scale = np.maximum(np.abs(xe), 1.0)
        np.testing.assert_allclose(xj / scale, xe / scale, atol=1e-5, err_msg=f"trial {trial}")
        pe_, pj_ = _np(states["eigh"].p), _np(states["jacobi"].p)
        pscale = max(np.abs(pe_).max(), 1e-3)
        np.testing.assert_allclose(pj_ / pscale, pe_ / pscale, atol=1e-5, err_msg=f"trial {trial} P")


# --------------------------------------------------------------------------
# the f32 closed-loop fidelity replay (tests/test_ukf.py:443-536)

TICKS, DT = 300, 0.01
SENS = np.array([200.0, 200.0, 10.0, 0.05, 0.05])


@pytest.fixture(scope="module")
def flagship_trajectory():
    """The f64 truth of tests/test_ukf.py:466-483 on the port's plant and
    sensor: stabilising state feedback on (x, dx, θ, dθ), noisy IMU
    observations, numpy seed 42. Returns (us, zs, truth (300, 6))."""
    p = CartPoleParams.two_wheel()
    plant6, hx = tdyn.make_flagship6(p), tobs.make_hx_imu6(p)
    rng = np.random.default_rng(42)
    gains = np.array([2.0, 3.0, 30.0, 6.0])
    x = np.zeros(6)
    us, zs, truth = [], [], []
    for _ in range(TICKS):
        u = float(np.clip(-gains @ x[[0, 1, 3, 4]], -10.0, 10.0))
        x = np.array([float(v) for v in plant6(*(torch.tensor(c, dtype=torch.float64) for c in x),
                                               torch.tensor(u, dtype=torch.float64), DT, 0.0)])
        assert abs(x[3]) < np.pi / 2
        zs.append(_np(hx(torch.tensor(x))) + SENS * rng.standard_normal(5))
        us.append(u)
        truth.append(x.copy())
    return np.asarray(us), np.asarray(zs), np.asarray(truth)


def _replay(us, zs, dtype: torch.dtype, alpha: float) -> np.ndarray:
    """The port's filter (eigh root) over the matched (u, z) inputs: the
    (300, 6) estimate trajectory."""
    p = CartPoleParams.two_wheel()
    plant6, hx = tdyn.make_flagship6(p), tobs.make_hx_imu6(p)

    def fx(xv, uu):
        return torch.stack(torch.broadcast_tensors(*plant6(*(xv[..., i] for i in range(6)), uu, DT, 0.0)), dim=-1)

    params, est = tukf.ukf_init(torch.zeros(6, dtype=dtype), 0.1 * np.eye(6),
                                tnoise.gen_q6(2.15 * DT).to(dtype), np.diag(SENS), alpha=alpha)
    xs = []
    for u, z in zip(us, zs):
        est = tukf.ukf_step(params, est, torch.tensor(u, dtype=dtype), torch.tensor(z, dtype=dtype), fx, hx)
        xs.append(_np(est.x).astype(np.float64))
    return np.asarray(xs)


def test_flagship_truth_matches_jax(flagship_trajectory):
    """The truth the replay runs on is the JAX test's: the port's plant and
    sensor in f64 give the JAX package's trajectory for the same controls."""
    us, zs, truth = flagship_trajectory
    p = JParams.two_wheel()
    plant6, hx = jdyn.make_flagship6(p), jobs.make_hx_imu6(p)
    x = np.zeros(6)
    for i in range(TICKS):
        x = np.array([float(v) for v in plant6(*(jnp.float64(c) for c in x), jnp.float64(us[i]),
                                               jnp.float64(DT), jnp.float64(0.0))])
        np.testing.assert_allclose(x, truth[i], rtol=1e-12, atol=1e-12)
    rng = np.random.default_rng(42)
    want_z = np.stack([np.asarray(hx(jnp.asarray(truth[i]))) + SENS * rng.standard_normal(5) for i in range(TICKS)])
    np.testing.assert_allclose(zs, want_z, rtol=1e-12, atol=1e-9)


def test_f32_closed_loop_estimator_fidelity(flagship_trajectory):
    """tests/test_ukf.py::test_f32_closed_loop_estimator_fidelity on the
    port's filter, four replays on identical (u, z) sequences:

    (a) the fleets' f32 α=1 filter tracks the f64 filter's est-vs-truth
        accuracy on every controller channel (settled RMS < 1.3 × f64 +
        1e-4);
    (b) the f32 α=1e-3 filter's state walks away from its f64 twin more
        than 20× faster than the α=1 pair does."""
    us, zs, truth = flagship_trajectory
    t64_j = _replay(us, zs, torch.float64, 1.0)
    t32_j = _replay(us, zs, torch.float32, 1.0)
    t64_m = _replay(us, zs, torch.float64, 1e-3)
    t32_m = _replay(us, zs, torch.float32, 1e-3)
    sl = np.array([0, 1, 3, 4])

    def settled_rms(traj):
        e = traj[100:, sl] - truth[100:][:, sl]
        return np.sqrt(np.mean(e ** 2, axis=0))

    np.testing.assert_array_less(settled_rms(t32_j), 1.3 * settled_rms(t64_j) + 1e-4)
    dev_j = np.sqrt(np.mean((t32_j - t64_j)[100:] ** 2, axis=0)).max()
    dev_m = np.sqrt(np.mean((t32_m - t64_m)[100:] ** 2, axis=0)).max()
    assert dev_m > 20.0 * dev_j, (dev_m, dev_j)


def test_f64_replay_matches_jax(flagship_trajectory):
    """The port's f64 α=1 replay against the JAX package's f64 replay on the
    same (u, z): the estimate trajectories agree within rtol 1e-8 /
    atol 1e-10 over all 300 ticks."""
    us, zs, _ = flagship_trajectory
    p = JParams.two_wheel()
    plant6, hx = jdyn.make_flagship6(p), jobs.make_hx_imu6(p)

    def fxd(xv, uu):
        return jnp.stack(jnp.broadcast_arrays(*plant6(*(xv[..., i] for i in range(6)), uu, jnp.float64(DT),
                                                      jnp.float64(0.0))), axis=-1)

    params, est = jukf.ukf_init(jnp.zeros(6), jnp.asarray(0.1 * np.eye(6)), jnoise.gen_q6(jnp.float64(2.15 * DT)),
                                jnp.asarray(np.diag(SENS)), alpha=1.0)
    tick = jax.jit(lambda s, u, z: jukf.ukf_update(params, jukf.ukf_predict(params, s, u, fxd), z, hx))
    want = []
    for u, z in zip(us, zs):
        est = tick(est, jnp.float64(u), jnp.asarray(z))
        want.append(np.asarray(est.x))
    np.testing.assert_allclose(_replay(us, zs, torch.float64, 1.0), np.asarray(want), rtol=1e-8, atol=1e-10)
