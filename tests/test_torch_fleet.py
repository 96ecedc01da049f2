"""The port's fleet slice against the JAX package: the Jacobi root, the SoA
UKF (predict, update, guard, the equilibrated gain, the α=1 f32 spread),
one whole fleet tick of each model, and the fleet CLI on the plain path.

Inputs are made with numpy and handed to both packages; the MPPI noise and
the sensor noise of a tick are injected into both, so a tick is compared
number for number. Bands: float64 runs the same operations in another
summation order (1e-9); float32 uses the JAX package's kernel band
(rtol 1e-3 / atol 2e-4, tests/test_pallas.py:59).
"""

import dataclasses
import math
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_rs_tpu.apps.fleet import _componentize_hx
from mpc_rs_tpu.controllers import mppi as jmppi
from mpc_rs_tpu.estimators import smallalg as jsmall
from mpc_rs_tpu.estimators import ukf_soa as jsoa
from mpc_rs_tpu.estimators.ukf import UkfState as JUkfState
from mpc_rs_tpu.estimators.ukf import ukf_guard as jukf_guard
from mpc_rs_tpu.estimators.ukf import ukf_init as jukf_init
from mpc_rs_tpu.models import costs as jcosts
from mpc_rs_tpu.models import dynamics as jdyn
from mpc_rs_tpu.models import noise as jnoise
from mpc_rs_tpu.models import observation as jobs
from mpc_rs_tpu.models.params import CartPoleParams as JParams
from mpc_rs_tpu.parallel.scenario import init_scenario_carry as jinit_carry
from mpc_rs_tpu.utils import as_vector_fn
from mpc_rs_tpu_torch.apps import run as cli
from mpc_rs_tpu_torch.apps.fleet import Fleet, build_fleet, run_fleet, tipped
from mpc_rs_tpu_torch.estimators import smallalg as tsmall
from mpc_rs_tpu_torch.estimators import ukf_soa as tsoa
from mpc_rs_tpu_torch.estimators.ukf import UkfParams, UkfState, merwe_weights, ukf_guard, ukf_init
from mpc_rs_tpu_torch.models import dynamics as tdyn
from mpc_rs_tpu_torch.models import noise as tnoise
from mpc_rs_tpu_torch.models import observation as tobs
from mpc_rs_tpu_torch.models.params import CartPoleParams
from mpc_rs_tpu_torch.parallel.scenario import carry_from_numpy
from mpc_rs_tpu_torch.runtime.loop import pulse_disturbance

ROOT = Path(__file__).resolve().parents[1]
F64_BAND = dict(rtol=1e-9, atol=1e-9)
F32_BAND = dict(rtol=1e-3, atol=2e-4)
BANDS = {np.float64: F64_BAND, np.float32: F32_BAND}
TDTYPE = {np.float64: torch.float64, np.float32: torch.float32}


def _spd(rng, b, n, scale):
    a = rng.normal(size=(b, n, n))
    return scale * (a @ a.transpose(0, 2, 1)) + 0.05 * np.eye(n)


# --------------------------------------------------------------------------
# smallalg and the UKF pieces


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_jacobi_entries_matches_jax(dtype):
    """The same rotation sequence: eigenvalues and eigenvectors (signs and
    order included) agree with the JAX package's."""
    n, b = 6, 32
    s = _spd(np.random.default_rng(0), b, n, 0.3).astype(dtype)
    s_lead = s.transpose(1, 2, 0)  # (n, n, B): the batch minor
    jw, jv = jsmall.jacobi_entries([[jnp.asarray(s_lead[i, j]) for j in range(n)] for i in range(n)], n)
    tw, tv = tsmall.jacobi_entries(torch.tensor(s_lead))
    np.testing.assert_allclose(tw.numpy(), np.stack([np.asarray(w) for w in jw]), **BANDS[dtype])
    np.testing.assert_allclose(tv.numpy(), np.asarray([[np.asarray(v) for v in row] for row in jv]),
                               **BANDS[dtype])
    rec = np.einsum("ikb,kb,jkb->ijb", tv.double().numpy(), tw.double().numpy(), tv.double().numpy())
    # four sweeps leave off-diagonal residue of order 1e-4 on random 6×6
    # matrices, in both packages
    np.testing.assert_allclose(rec, s_lead, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("alpha, n", [(1.0, 4), (1.0, 6), (1e-3, 6)])
def test_merwe_weights_and_init_match_jax(alpha, n):
    jp, js = jukf_init(jnp.zeros(n, jnp.float32), 0.1 * jnp.eye(n, dtype=jnp.float32),
                       jnp.eye(n, dtype=jnp.float32), jnp.eye(3, dtype=jnp.float32), alpha=alpha)
    tp, ts = ukf_init(torch.zeros(n), 0.1 * torch.eye(n), torch.eye(n), torch.eye(3), alpha=alpha)
    assert tp.c == jp.c and tp.n == jp.n and tp.n_obs == jp.n_obs == 3
    np.testing.assert_array_equal(tp.wm.numpy(), np.asarray(jp.wm))
    np.testing.assert_array_equal(tp.wc.numpy(), np.asarray(jp.wc))
    assert torch.isnan(ts.sigma_f).all() and ts.sigma_f.shape == (2 * n + 1, n)
    conv = UkfParams.from_arrays({k: np.asarray(v) for k, v in jp._asdict().items()})
    assert torch.equal(conv.wm, tp.wm) and conv.c == tp.c
    wm, wc, c = merwe_weights(n, alpha, dtype=torch.float64)
    assert abs(float(wm.sum()) - 1.0) < 1e-9


def test_ukf_guard_matches_jax():
    x = np.array([[1.0, np.nan, 2.0], [1.0, 2.0, 3.0], [4.0, 5.0, 6.0]])
    p = np.stack([np.eye(3) * 5.0, np.full((3, 3), np.nan), np.eye(3) * 7.0])
    want = jukf_guard(JUkfState(jnp.asarray(x), jnp.asarray(p), None, None, None), np.eye(3))
    got = ukf_guard(UkfState(torch.tensor(x), torch.tensor(p), None, None, None), np.eye(3))
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
    np.testing.assert_array_equal(got.p.numpy(), np.asarray(want.p))


def _soa_case(which, dtype, b=16, seed=0):
    """UKF params, a random SoA state, u, z and the fx/hx of a fleet model,
    for both packages."""
    rng = np.random.default_rng(seed)
    if which == "cartpole4":
        n, o, dt = 4, 3, 0.01
        jstep, tstep = jdyn.make_cartpole_nonlinear(JParams.single_wheel(), dt), \
            tdyn.make_cartpole_nonlinear(CartPoleParams.single_wheel(), dt)
        jfx_c = lambda xs, u: tuple(jnp.broadcast_arrays(*jstep(*xs, u)))  # noqa: E731
        tfx = lambda x, u: torch.stack(torch.broadcast_tensors(*tstep(*(x[..., i] for i in range(n)), u)), -1)  # noqa: E731,E501
        jhx, thx = jobs.make_hx_rpm_gyro4(JParams.single_wheel()), tobs.make_hx_rpm_gyro4(CartPoleParams.single_wheel())
        q = np.asarray(jnoise.gen_q4(dt))
        r = np.diag([50.0, 50.0, 0.5]) ** 2
        zs = np.array([[100.0], [100.0], [5.0]])
    else:
        n, o, dt = 6, 5, 0.01
        j6, t6 = jdyn.make_flagship6(JParams.two_wheel()), tdyn.make_flagship6(CartPoleParams.two_wheel())
        jfx_c = lambda xs, u: tuple(jnp.broadcast_arrays(*j6(*xs, u, dt, 0.0)))  # noqa: E731
        tfx = lambda x, u: torch.stack(torch.broadcast_tensors(*t6(*(x[..., i] for i in range(n)), u, dt, 0.0)), -1)  # noqa: E731,E501
        jhx, thx = jobs.make_hx_imu6(JParams.two_wheel()), tobs.make_hx_imu6(CartPoleParams.two_wheel())
        q = np.asarray(jnoise.gen_q6(2.15 * dt))
        r = np.diag([200.0, 200.0, 10.0, 0.05, 0.05])
        zs = np.array([[300.0], [300.0], [10.0], [0.1], [0.1]])
    q, r = q.astype(dtype), r.astype(dtype)
    jp, _ = jukf_init(jnp.zeros(n, dtype), jnp.eye(n, dtype=dtype), q, r, alpha=1.0)
    tp, _ = ukf_init(torch.zeros(n, dtype=TDTYPE[dtype]), torch.eye(n), torch.tensor(q), torch.tensor(r), alpha=1.0)
    x = (0.1 * rng.normal(size=(n, b))).astype(dtype)
    p = _spd(rng, b, n, 1e-3).transpose(1, 2, 0).astype(dtype)
    u = rng.normal(size=b).astype(dtype)
    z = (zs * rng.normal(size=(o, b))).astype(dtype)
    return dict(n=n, o=o, jp=jp, tp=tp, jfx_c=jfx_c, tfx=tfx, jhx_c=_componentize_hx(jhx, o), thx=thx,
                q=q, r=r, x=x, p=p, u=u, z=z)


def _jsoa(x, p):
    n = x.shape[0]
    return jsoa.SoaUkfState(x=tuple(jnp.asarray(x[i]) for i in range(n)),
                            p=tuple(tuple(jnp.asarray(p[i, j]) for j in range(n)) for i in range(n)),
                            sigma_f=None)


def _np_soa(s):
    return (np.stack([np.asarray(v) for v in s.x]),
            np.asarray([[np.asarray(v) for v in row] for row in s.p]))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("which", ["cartpole4", "flagship6"])
def test_soa_predict_update_guard_match_jax(which, dtype):
    c = _soa_case(which, dtype)
    js = jsoa.soa_predict(c["jp"], _jsoa(c["x"], c["p"]), jnp.asarray(c["u"]), c["jfx_c"], c["q"])
    ts = tsoa.soa_predict(c["tp"], tsoa.SoaUkfState(torch.tensor(c["x"]), torch.tensor(c["p"]), None),
                          torch.tensor(c["u"]), c["tfx"], torch.tensor(c["q"]))
    for got, want in zip((ts.x.numpy(), ts.p.numpy()), _np_soa(js)):
        np.testing.assert_allclose(got, want, **BANDS[dtype])
    np.testing.assert_allclose(ts.sigma_f.numpy(), np.stack([np.asarray(s) for s in js.sigma_f]),
                               **BANDS[dtype])
    js = jsoa.soa_update(c["jp"], js, tuple(jnp.asarray(zz) for zz in c["z"]), c["jhx_c"], c["r"])
    ts = tsoa.soa_update(c["tp"], ts, torch.tensor(c["z"]), c["thx"], torch.tensor(c["r"]))
    for got, want in zip((ts.x.numpy(), ts.p.numpy()), _np_soa(js)):
        np.testing.assert_allclose(got, want, **BANDS[dtype])
    np.testing.assert_array_equal(ts.p.numpy(), ts.p.transpose(0, 1).numpy())  # symmetrized
    # the guard: poison two scenarios
    x, p = ts.x.clone(), ts.p.clone()
    x[1, 3] = float("nan")
    p[0, 2, 5] = float("inf")
    p_reset = 0.1 * np.eye(c["n"], dtype=dtype)
    jg = jsoa.soa_guard(_jsoa(x.numpy(), p.numpy()), p_reset)
    tg = tsoa.soa_guard(tsoa.SoaUkfState(x, p, None), torch.tensor(p_reset))
    for got, want in zip((tg.x.numpy(), tg.p.numpy()), _np_soa(jg)):
        np.testing.assert_array_equal(got, want)
    assert torch.equal(tg.p[:, :, 3], torch.tensor(p_reset)) and torch.equal(tg.p[:, :, 5], torch.tensor(p_reset))


def test_equilibrated_solve_matches_f64_pivoted():
    """Port of tests/test_ukf_soa.py's check: on the flagship's scale-
    ill-conditioned Pz (4e4 … 2.5e-3) the f32 equilibrated, refined solve
    matches a pivoted float64 solve to 2e-3 relative."""
    rng = np.random.default_rng(3)
    b, o = 64, 5
    scales = np.array([4e4, 4e4, 1e2, 2.5e-3, 2.5e-3])
    c = rng.normal(size=(b, o, o))
    corr = np.eye(o) + 0.3 * (c + c.transpose(0, 2, 1)) / np.sqrt(o)
    corr = corr @ corr.transpose(0, 2, 1)
    d = np.sqrt(np.einsum("bii->bi", corr))
    corr /= d[:, :, None] * d[:, None, :]
    pz64 = corr * np.sqrt(scales)[None, :, None] * np.sqrt(scales)[None, None, :]
    rhs64 = rng.normal(size=(b, o)) * np.sqrt(scales)
    want = np.linalg.solve(pz64, rhs64[..., None])[..., 0]
    got = tsoa._chol_solve_equilibrated(torch.tensor(pz64.transpose(1, 2, 0), dtype=torch.float32),
                                        torch.tensor(rhs64.T[:, None, :], dtype=torch.float32))
    got = got[:, 0].T.double().numpy()
    assert (np.abs(got - want) / (np.abs(want) + 1e-12)).max() < 2e-3


def test_f32_predict_alpha_conditioning():
    """Port of tests/test_ukf.py::test_f32_predict_alpha_conditioning on the
    SoA predict: (a) at α=1 one f32 predict matches the f64 predict; (b) at
    α=1e-3 the f32 deviation is ≥1e3× larger — why the f32 fleet uses α=1."""
    p = CartPoleParams.two_wheel()
    dt = 0.01
    fx6 = tdyn.make_flagship6(p)

    def fx(x, u):
        return torch.stack(torch.broadcast_tensors(*fx6(*(x[..., i] for i in range(6)), u, dt, 0.0)), -1)

    q = tnoise.gen_q6(2.15 * dt)
    rng = np.random.default_rng(3)
    x0 = np.array([0.3, 0.5, 2.0, 0.08, 0.4, 1.0])
    a = rng.normal(size=(6, 6))
    p0 = 1e-4 * (a @ a.T) + np.diag([1e-4, 1e-3, 1e-2, 1e-5, 1e-4, 1e-3])
    err = {}
    for alpha in (1e-3, 1.0):
        out = {}
        for dt_ in (torch.float64, torch.float32):
            params, _ = ukf_init(torch.zeros(6, dtype=dt_), torch.eye(6), torch.eye(6), torch.eye(5), alpha=alpha)
            st = tsoa.SoaUkfState(torch.tensor(x0, dtype=dt_)[:, None], torch.tensor(p0, dtype=dt_)[:, :, None], None)
            out[dt_] = tsoa.soa_predict(params, st, torch.tensor([1.7], dtype=dt_), fx, q.to(dt_)).x
        err[alpha] = float((out[torch.float64] - out[torch.float32].double()).abs().max())
    assert err[1.0] < 1e-4, err
    assert err[1e-3] > 1e3 * err[1.0], err


# --------------------------------------------------------------------------
# one fleet tick against the JAX package's functions


def _jax_fleet_pieces(model):
    """The JAX package's fleet pieces, as apps/fleet.py:100-242 wires them."""
    if model == "flagship6":
        dt, n_sub = 0.01, 1
        p = JParams.two_wheel()
        plant6 = jdyn.make_flagship6(p)
        plant_fx = lambda xv, u, f: jnp.stack(jnp.broadcast_arrays(  # noqa: E731
            *plant6(*(xv[..., i] for i in range(6)), u, dt, f)), axis=-1)
        fx_c = lambda xs, u: tuple(jnp.broadcast_arrays(*plant6(*xs, u, dt, 0.0)))  # noqa: E731
        ctrl = jdyn.make_flagship4(p, 1.2 / 8, fast=True)
        cost = jcosts.make_diag4(0.1, 0.1, 1.0, 0.5)
        hx = jobs.make_hx_imu6(p)
        sens = jnp.asarray([200.0, 200.0, 10.0, 0.05, 0.05], jnp.float32)
        q, r = jnoise.gen_q6(jnp.float32(2.15 * dt)).astype(jnp.float32), jnp.diag(sens)
        x0 = jnp.zeros(6, jnp.float32)
        cfg = jmppi.MppiConfig(n_horizon=8, n_rollouts=0, lambda_=1.4, std_dev=4.0, limit=(-10.0, 10.0))
        sl, disturbance = (0, 1, 3, 4), lambda t: jnp.where((t > 1.0) & (t < 1.5), 2.0, 0.0)
    else:
        dt, n_sub = 0.05, 5
        p = JParams.single_wheel()
        step = jdyn.make_cartpole_nonlinear(p, dt / n_sub)
        plant_fx = as_vector_fn(step, 4)
        fx_c = lambda xs, u: step(*xs, u)  # noqa: E731
        ctrl = jdyn.make_cartpole_nonlinear(p, 0.1, fast=True)
        cost = jcosts.shaped4
        hx = jobs.make_hx_rpm_gyro4(p)
        sens = jnp.asarray([50.0, 50.0, 0.5], jnp.float32)
        x0 = jnp.asarray([0.5, 0.0, 0.1, 0.0], jnp.float32)
        q, r = jnoise.gen_q4(dt / n_sub).astype(jnp.float32), jnp.diag(sens * sens)
        cfg = jmppi.MppiConfig(n_horizon=8, n_rollouts=0, lambda_=0.5, std_dev=10.0, limit=(-10.0, 10.0))
        sl, disturbance = None, None
    n = x0.shape[0]
    p0 = 0.1 * jnp.eye(n, dtype=jnp.float32)
    params, ukf0 = jukf_init(x0, p0, q, r, alpha=1.0)
    return dict(dt=dt, n_sub=n_sub, plant_fx=plant_fx, fx_c=fx_c, ctrl=ctrl, cost=cost, hx=hx, sens=sens,
                cfg=cfg, sl=sl, disturbance=disturbance, p0=p0, params=params, ukf0=ukf0, x0=x0)


def _jax_tick(j, carry, mppi_noise, sensor_noise, k, unroll_sum=False):
    """One tick composed from the JAX package's public functions, with
    injected noise: the vmap MPPI solver (the fast tier outside a kernel),
    the plant, the sensor and the SoA UKF (``unroll_sum=True``: the mean's
    pair sums in sequence, as the fused estimator chain traces them)."""
    cfg = dataclasses.replace(j["cfg"], n_rollouts=k)
    x_hats = carry["ukf"]["x"] if j["sl"] is None else carry["ukf"]["x"][:, list(j["sl"])]
    res = jax.vmap(lambda xh, u, e: jmppi.mppi_solve(cfg, j["ctrl"], j["cost"], None, tuple(xh), u, noise=e))(
        jnp.asarray(x_hats), jnp.asarray(carry["u_n"]), jnp.asarray(mppi_noise))
    u0 = res.u_n[:, 0]
    n = carry["ukf"]["x"].shape[-1]
    b = carry["x"].shape[0]
    pk = carry["ukf"]["p"]
    soa = jsoa.SoaUkfState(x=tuple(jnp.asarray(carry["ukf"]["x"][:, i]) for i in range(n)),
                           p=tuple(tuple(jnp.asarray(pk[i * n + jj]) for jj in range(n)) for i in range(n)),
                           sigma_f=None)
    q, r = jnp.asarray(carry["ukf"]["q"][0]), jnp.asarray(carry["ukf"]["r"][0])
    hx_c = _componentize_hx(j["hx"], r.shape[-1])
    x = jnp.asarray(carry["x"])
    t = jnp.asarray(carry["t"])
    for i in range(j["n_sub"]):
        x = j["plant_fx"](x, u0) if j["disturbance"] is None else j["plant_fx"](x, u0, j["disturbance"](t))
        z = j["hx"](x) + j["sens"] * jnp.asarray(sensor_noise[i])
        soa = jsoa.soa_predict(j["params"], soa, u0, j["fx_c"], q, unroll_sum=unroll_sum)
        soa = jsoa.soa_update(j["params"], soa, tuple(z[:, jj] for jj in range(r.shape[-1])), hx_c, r,
                              unroll_sum=unroll_sum)
        soa = jsoa.soa_guard(soa, j["p0"])
    p_packed = np.stack([np.asarray(soa.p[i][jj]).reshape(b) for i in range(n) for jj in range(n)])
    return dict(x=np.asarray(x), u_n=np.asarray(res.u_n), status=np.asarray(res.status),
                ukf_x=np.stack([np.asarray(v) for v in soa.x], -1), ukf_p=p_packed)


def _tick_case(model, dtype, b=8, k=256):
    """The JAX pieces of a fleet model, a perturbed B-scenario carry (numpy,
    from the JAX package's init_scenario_carry; the flagship's clock inside
    the 2 N pulse) and the MPPI and sensor noise of one tick, in ``dtype``."""
    j = _jax_fleet_pieces(model)
    jc = jinit_carry(b, j["x0"], jnp.zeros(8, jnp.float32), j["ukf0"], jax.random.key(0), ukf_layout="soa")
    rng = np.random.default_rng(11)
    n, s = jc.ukf.x.shape[-1], jc.x.shape[-1]
    arrays = dict(
        x=np.asarray(jc.x) + 0.05 * rng.normal(size=(b, s)),
        u_n=0.5 * rng.normal(size=(b, 8)),
        ukf=dict(x=np.asarray(jc.ukf.x) + 0.05 * rng.normal(size=(b, n)),
                 p=_spd(rng, b, n, 1e-3).transpose(1, 2, 0).reshape(n * n, b),
                 q=np.asarray(jc.ukf.q), r=np.asarray(jc.ukf.r)),
        status=np.asarray(jc.status), t=np.full(b, 1.2 if model == "flagship6" else 0.0), key=jc.key,
    )
    cast = lambda a: a.astype(dtype) if isinstance(a, np.ndarray) and a.dtype.kind == "f" else a  # noqa: E731
    arrays = {kk: ({k2: cast(v2) for k2, v2 in v.items()} if isinstance(v, dict) else cast(v))
              for kk, v in arrays.items()}
    sigma = float(j["cfg"].std_dev)
    mppi_noise = (sigma * rng.standard_normal((b, k, 8))).astype(dtype)
    sensor_noise = rng.standard_normal((j["n_sub"], b, len(j["sens"]))).astype(dtype)
    return j, arrays, mppi_noise, sensor_noise


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("model", ["cartpole4", "flagship6"])
def test_fleet_tick_matches_jax(model, dtype):
    """One tick of build_fleet's step on a perturbed B=8 carry taken from
    the JAX package's init_scenario_carry, against the same tick composed
    from the JAX package's functions, both fed the same MPPI and sensor
    noise; the flagship's clock sits inside the 2 N pulse."""
    b, k = 8, 256
    j, arrays, mppi_noise, sensor_noise = _tick_case(model, dtype, b, k)
    want = _jax_tick(j, arrays, mppi_noise, sensor_noise, k)
    fl = build_fleet(model, k, "cpu", scenarios=b)
    got = fl.tick(carry_from_numpy(arrays), fl.generator, mppi_noise=torch.tensor(mppi_noise),
                  sensor_noise=torch.tensor(sensor_noise))
    assert got.status.tolist() == want["status"].tolist() == [0] * b
    band = BANDS[dtype]
    np.testing.assert_allclose(got.u_n.numpy(), want["u_n"], **band)
    np.testing.assert_allclose(got.x.numpy(), want["x"], **band)
    np.testing.assert_allclose(got.ukf.x.numpy(), want["ukf_x"], **band)
    np.testing.assert_allclose(got.ukf.p.numpy(), want["ukf_p"], **band)
    np.testing.assert_allclose(got.t.numpy(), arrays["t"] + np.asarray(fl.dt, dtype), rtol=1e-7)


def test_carry_from_numpy_rejects_unknown_fields():
    with pytest.raises(ValueError, match="unknown"):
        carry_from_numpy(dict(x=np.zeros((1, 4)), u_n=np.zeros((1, 8)), ukf={}, status=0, t=0, sigma=1))


def test_pulse_disturbance():
    f = pulse_disturbance()
    assert [f(t) for t in (0.5, 1.0, 1.2, 1.5, 2.0)] == [0.0, 0.0, 2.0, 0.0, 0.0]
    t = torch.tensor([0.5, 1.0, 1.2, 1.5], dtype=torch.float32)
    got = f(t)
    assert got.dtype == torch.float32 and got.tolist() == [0.0, 0.0, 2.0, 0.0]


# --------------------------------------------------------------------------
# the fleet on the plain path


def test_fleet_cli_runs_on_cpu():
    """The entry point on the plain path: 1 s of cartpole4 at B=16, K=512,
    every scenario survives."""
    out = subprocess.run(
        [sys.executable, "-m", "mpc_rs_tpu_torch.apps.run", "fleet", "--model", "cartpole4", "--device", "cpu",
         "--scenarios", "16", "--k", "512", "--t-end", "1"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    assert "survival= 1.000" in out.stdout and "survived 16/16" in out.stdout
    assert "sampler=clt4 " in out.stdout and "all statuses 0: True" in out.stdout


@pytest.mark.parametrize("sampler", ["clt2q", "box-muller-a"])
def test_fleet_cli_takes_every_sampler(sampler):
    """``fleet --sampler`` takes the JAX CLI's six samplers; the last two on
    the plain path, 1 s of cartpole4 at B=16, K=512."""
    res = cli.main(["fleet", "--model", "cartpole4", "--device", "cpu", "--scenarios", "16", "--k", "512",
                    "--t-end", "1", "--sampler", sampler])
    assert res.survival == 1.0 and res.statuses_ok and res.ticks == 20


def test_flagship_fleet_runs_on_cpu_through_the_pulse():
    """1.6 s of flagship6 at B=8, K=2048 (the exact tier with wallace):
    through the 2 N pulse, finite, every status 0, every scenario upright.
    (At K=256 the flagship loses scenarios to the pulse with every sampler;
    the fleet's operating point is K=8192.)"""
    fl = build_fleet("flagship6", 2048, "cpu", scenarios=8, fast_math=False, seed=2)
    assert fl.sampler == "wallace" and fl.cfg.n_rollouts == 2048
    res = run_fleet(fl, t_end=1.6, report_every=0.8)
    assert res.ticks == 160 and res.survival == 1.0 and res.statuses_ok
    assert torch.isfinite(res.carry.x).all() and torch.isfinite(res.carry.ukf.p).all()
    assert abs(float(res.carry.t[0]) - 1.6) < 1e-4


@pytest.mark.parametrize("th_max, guard", [
    ([0.1, np.nan, 2.0], 1.0),
    ([np.nan, np.nan], math.pi / 2),
    ([math.radians(60.0), 1.2, np.inf], math.radians(60.0)),
    ([0.0, 1.5707964, np.nan, 3.0], math.pi / 2),
])
def test_tipped_is_the_reference_rule(th_max, guard):
    """A scenario is tipped when its max |θ| passes the guard, evaluated as
    the JAX fleet evaluates it (``th_max > guard`` on the numpy readback,
    mpc_rs_tpu/apps/fleet.py:412): a NaN θ counts as survived, θ at the
    guard survives, +inf is tipped."""
    th = np.asarray(th_max, dtype=np.float32)
    got = tipped(th, guard)
    np.testing.assert_array_equal(got, th > guard)
    assert not got[np.isnan(th)].any()


def test_run_fleet_counts_a_nan_theta_as_survived():
    """A tick that leaves scenario 1's θ NaN and scenario 2's past the guard:
    run_fleet counts one tipped scenario, as the JAX fleet's count does."""
    carry0 = SimpleNamespace(x=torch.zeros(4, 4), status=torch.zeros(4, dtype=torch.int32))

    def tick(carry, generator):
        x = carry.x.clone()
        x[1, 2], x[2, 2], x[3, 2] = float("nan"), 1.2, -0.3
        return SimpleNamespace(x=x, status=carry.status)

    fl = Fleet(tick, carry0, None, 0.05, 2, math.radians(60.0), None, "clt4")
    res = run_fleet(fl, t_end=0.2, report_every=0.1)
    assert res.ticks == 4 and res.tipped == 1 and res.survival == 0.75 and res.statuses_ok
    assert math.isnan(float(res.carry.x[1, 2]))


def test_fleet_defaults_follow_the_jax_package():
    assert build_fleet("cartpole4", None, "cpu", scenarios=2).sampler == "clt4"
    fl = build_fleet("flagship6", None, "cpu", scenarios=2)
    assert fl.sampler == "clt4a" and fl.cfg.n_rollouts == 8192 and fl.guard == math.pi / 2
    assert build_fleet("cartpole4", 4096, "cpu", scenarios=2).sampler == "clt4a"
    with pytest.raises(ValueError, match="unknown fleet model"):
        build_fleet("cartpole6", None, "cpu")


def test_fleet_cli_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device runs")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["fleet", "--scenarios", "8", "--t-end", "0.05"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["fleet", "--resume", "x.npz"])  # the flag exists; the card is still the default


@pytest.mark.parametrize("argv", [
    ["mppi4-non-liner", "--scenarios", "8"],
    ["mppi4-non-liner", "--sampler", "clt4"],
    ["mppi4-non-liner", "--no-fast-math"],
    ["fleet", "--console"],
])
def test_cli_rejects_options_of_another_example(argv):
    """Each example parses only its own options; another's is an error, not
    silently ignored."""
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(argv)


def test_cli_has_one_subcommand_per_registered_example():
    from mpc_rs_tpu_torch.apps.registry import EXAMPLES

    for name in EXAMPLES:
        assert cli.build_parser().parse_args([name, "--device", "cpu"]).example == name
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["mppi4-linear"])
