"""The fused estimator chain (K7) of the port on the CPU, where
``estimator_chain_fused`` runs its plain version, against the JAX package.

- The plain version against the JAX kernel itself,
  ``make_estimator_chain(..., interpret=True)``, set up as
  ``tests/test_estimator_pallas.py:20-59`` sets it up (n=2, o=1, B=8,
  2 substeps), at that file's band (rtol 2e-5 / atol 2e-6, float32).
- At both fleets' dims, against the JAX package's ``soa_predict`` /
  ``soa_update(unroll_sum=True)`` / ``soa_guard`` composed as the kernel
  traces them (interpret mode at fleet dims costs minutes of XLA compile).
- One fleet tick with ``estimator_chain=True`` against the JAX tick with
  ``unroll_sum=True``, and in float64 against the port's torch-op tick.
- ``build_fleet(..., estimator_chain=True)`` running both fleets.

Bands: float64 1e-9 (the same operations in another summation order);
float32 the JAX package's kernel band, rtol 1e-3 / atol 2e-4. The kernel
itself is held against this plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_rs_tpu.apps.fleet import _componentize_hx
from mpc_rs_tpu.estimators import ukf_soa as jsoa
from mpc_rs_tpu.estimators.ukf import ukf_init as jukf_init
from mpc_rs_tpu.ops.estimator_pallas import make_estimator_chain
from mpc_rs_tpu_torch.apps.fleet import build_fleet, run_fleet
from mpc_rs_tpu_torch.estimators.ukf import ukf_init
from mpc_rs_tpu_torch.models.params import CartPoleParams
from mpc_rs_tpu_torch.ops import estimator_cuda
from mpc_rs_tpu_torch.ops.estimator_cuda import (
    CartPole4Rpm,
    EstimatorChain,
    Flagship6Imu,
    estimator_chain_fused,
    estimator_chain_plain,
)
from mpc_rs_tpu_torch.parallel.scenario import carry_from_numpy, make_scenario_step
from mpc_rs_tpu_torch.runtime.loop import Pulse, pulse_disturbance
from tests.test_torch_fleet import BANDS, TDTYPE, _jax_fleet_pieces, _jax_tick, _spd, _tick_case

KERNEL_BAND = dict(rtol=2e-5, atol=2e-6)  # tests/test_estimator_pallas.py:88


# --------------------------------------------------------------------------
# the plain version against the JAX kernel in interpret mode (toy dims)

DT = 0.05


class _Toy:
    """tests/test_estimator_pallas.py:24-35 in the port's vector form."""

    def plant_fx(self, x, u, f):
        x0, x1 = x[..., 0], x[..., 1]
        return torch.stack([x0 + x1 * DT, x1 + (u - 0.5 * x0 + f) * DT], -1)

    def fx(self, x, u):
        x0, x1 = x[..., 0], x[..., 1]
        return torch.stack(torch.broadcast_tensors(x0 + x1 * DT, x1 + (u - 0.5 * x0) * DT), -1)

    def hx(self, x):
        return (x[..., 1] * 2.0)[..., None]


def _jax_toy_chain(disturbed, substep_loop):
    def plant_c(xs, u, f):
        x0, x1 = xs
        return (x0 + x1 * DT, x1 + (u - 0.5 * x0 + f) * DT)

    def fx_c(xs, u):
        x0, x1 = xs
        return (x0 + x1 * DT, x1 + (u - 0.5 * x0) * DT)

    q, r, sig, p0 = 0.01 * np.eye(2), np.array([[0.25]]), np.array([0.5]), 0.1 * np.eye(2)
    params, _ = jukf_init(jnp.zeros(2), jnp.asarray(p0), jnp.asarray(q), jnp.asarray(r), alpha=1.0)
    return make_estimator_chain(
        params, plant_c, fx_c, lambda xs: (xs[1] * 2.0,), q, r, sig, p0, 2, DT,
        disturbance=(lambda tt: jnp.where(tt > 0.5, 2.0, 0.0)) if disturbed else None,
        control_start=0.4 if disturbed else 0.0, interpret=True, substep_loop=substep_loop,
    )


@pytest.mark.parametrize("disturbed", [False, True])
@pytest.mark.parametrize("substep_loop", [False, True])
def test_chain_plain_matches_pallas_interpret(substep_loop, disturbed):
    """Both substep forms of the JAX kernel, with and without the
    disturbance and control_start=0.4; scenario 3 starts with a NaN
    estimate, which the guard must recover in both."""
    b = 8
    rng = np.random.default_rng(0)
    x = (0.3 * rng.normal(size=(b, 2))).astype(np.float32)
    ex = (0.2 * rng.normal(size=(b, 2))).astype(np.float32)
    ex[3, 0] = np.nan
    pp = np.broadcast_to((0.1 * np.eye(2)).reshape(4, 1), (4, b)).astype(np.float32).copy()
    u0 = rng.normal(size=b).astype(np.float32)
    t = np.linspace(0.0, 1.0, b).astype(np.float32)
    nz = rng.normal(size=(2, b)).astype(np.float32)
    want = _jax_toy_chain(disturbed, substep_loop)(*(jnp.asarray(a) for a in (x, ex, pp, u0, t, nz)))

    params, _ = ukf_init(torch.zeros(2), 0.1 * torch.eye(2), 0.01 * torch.eye(2), torch.tensor([[0.25]]),
                         alpha=1.0)
    chain = EstimatorChain(_Toy(), params, 0.01 * torch.eye(2), torch.tensor([[0.25]]), torch.tensor([0.5]),
                           0.1 * torch.eye(2), 2, DT, Pulse(0.5, math.inf, 2.0) if disturbed else None,
                           0.4 if disturbed else 0.0)
    got = estimator_chain_fused(chain, *(torch.tensor(a) for a in (x, ex, pp, u0, t, nz)))
    for g, w, name in zip(got, want, ("x", "ukf_x", "p")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **KERNEL_BAND)
    assert torch.isfinite(got[1]).all() and torch.isfinite(got[2]).all()
    assert estimator_cuda.launches["estimator_chain_fused"] == 0  # the CPU path launches nothing


# --------------------------------------------------------------------------
# at the fleets' dims, against the JAX SoA functions composed as the kernel


def _port_chain(model):
    """The chain build_fleet makes for ``model``, and its JAX pieces."""
    j = _jax_fleet_pieces(model)
    if model == "flagship6":
        est, n_sub, dt_sub, dist = Flagship6Imu(CartPoleParams.two_wheel(), 0.01), 1, 0.01, pulse_disturbance()
    else:
        est, n_sub, dt_sub, dist = CartPole4Rpm(CartPoleParams.single_wheel(), 0.01), 5, 0.05 / 5, None
    t32 = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    params, _ = ukf_init(t32(j["x0"]), t32(j["p0"]), t32(j["ukf0"].q), t32(j["ukf0"].r), alpha=1.0)
    return j, EstimatorChain(est, params, t32(j["ukf0"].q), t32(j["ukf0"].r), t32(j["sens"]), t32(j["p0"]),
                             n_sub, dt_sub, dist)


def _jax_chain_ref(j, x, ex, pp, u0, t, noise):
    """The kernel's trace (estimator_pallas.py:129-152) from the JAX package's
    functions: plant, sensor, soa_predict/soa_update(unroll_sum=True), guard."""
    b, n = ex.shape
    o = len(j["sens"])
    q, r = np.asarray(j["ukf0"].q), np.asarray(j["ukf0"].r)
    hx_c = _componentize_hx(j["hx"], o)
    soa = jsoa.SoaUkfState(x=tuple(jnp.asarray(ex[:, i]) for i in range(n)),
                           p=tuple(tuple(jnp.asarray(pp[i * n + k]) for k in range(n)) for i in range(n)),
                           sigma_f=None)
    x = jnp.asarray(x)
    for i in range(j["n_sub"]):
        if j["disturbance"] is None:
            x = j["plant_fx"](x, jnp.asarray(u0))
        else:
            x = j["plant_fx"](x, jnp.asarray(u0), j["disturbance"](jnp.asarray(t) + i * 0.01))
        z = j["hx"](x) + jnp.asarray(j["sens"], x.dtype) * jnp.asarray(noise[i * o:(i + 1) * o].T)
        soa = jsoa.soa_predict(j["params"], soa, jnp.asarray(u0), j["fx_c"], q, unroll_sum=True)
        soa = jsoa.soa_update(j["params"], soa, tuple(z[:, k] for k in range(o)), hx_c, r, unroll_sum=True)
        soa = jsoa.soa_guard(soa, np.asarray(j["p0"]), mode="entry")
    return (np.asarray(x), np.stack([np.asarray(v) for v in soa.x], -1),
            np.stack([np.asarray(soa.p[i][k]) for i in range(n) for k in range(n)]))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("model", ["cartpole4", "flagship6"])
def test_chain_plain_matches_jax_soa_at_fleet_dims(model, dtype):
    """B=8 perturbed scenarios, the flagship's clock inside the pulse."""
    b = 8
    j, chain = _port_chain(model)
    rng = np.random.default_rng(5)
    s, n, o = len(j["x0"]), len(j["x0"]), len(j["sens"])
    x = (np.asarray(j["x0"]) + 0.05 * rng.normal(size=(b, s))).astype(dtype)
    ex = (np.asarray(j["x0"]) + 0.05 * rng.normal(size=(b, n))).astype(dtype)
    pp = _spd(rng, b, n, 1e-3).transpose(1, 2, 0).reshape(n * n, b).astype(dtype)
    u0 = rng.normal(size=b).astype(dtype)
    t = np.full(b, 1.2 if model == "flagship6" else 0.0, dtype)
    noise = rng.standard_normal((j["n_sub"] * o, b)).astype(dtype)
    want = _jax_chain_ref(j, x, ex, pp, u0, t, noise)
    got = estimator_chain_plain(chain, *(torch.tensor(a) for a in (x, ex, pp, u0, t, noise)))
    for g, w, name in zip(got, want, ("x", "ukf_x", "p")):
        assert g.dtype == TDTYPE[dtype]
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **BANDS[dtype])


@pytest.mark.parametrize("model", ["cartpole4", "flagship6"])
def test_chain_plain_f32_against_jax_on_the_card_inputs(model):
    """On the inputs the card's checks of the kernel use (``chain_inputs``
    at B = 1 024), the JAX package's float32 chain and the plain float32
    version, one order of operations on one CPU, agree within the band in
    every entry for cartpole4. For flagship6 they do not in a few: its
    float32 filter is ill-conditioned there, so two float32 evaluations of
    the reference itself differ past the band, as the kernel and the plain
    version do in up to ``K7_ILL_MAX`` (4) entries on the card
    (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""
    b = 1024
    fl = build_fleet(model, None, "cpu", scenarios=b, estimator_chain=True)
    chain = fl.tick.chain
    args = estimator_cuda.chain_inputs(chain, fl.carry.x, fl.carry.ukf.x)
    want = _jax_chain_ref(_port_chain(model)[0], *(a.numpy() for a in args))
    got = estimator_chain_plain(chain, *args)
    band = BANDS[np.float32]
    outside = sum(int((np.abs(g.double().numpy() - w) > band["atol"] + band["rtol"] * np.abs(w)).sum())
                  for g, w in zip(got, want))
    assert outside == 0 if model == "cartpole4" else 1 <= outside <= 4


# --------------------------------------------------------------------------
# one fleet tick, and the fleets on the chain


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("model", ["cartpole4", "flagship6"])
def test_chain_fleet_tick_matches_jax(model, dtype):
    """build_fleet(estimator_chain=True)'s tick against the JAX tick with
    unroll_sum=True, both fed the same MPPI and sensor noise; in float64 it
    also equals the torch-op tick of the default path."""
    b, k = 8, 256
    j, arrays, mppi_noise, sensor_noise = _tick_case(model, dtype, b, k)
    want = _jax_tick(j, arrays, mppi_noise, sensor_noise, k, unroll_sum=True)
    noise = dict(mppi_noise=torch.tensor(mppi_noise), sensor_noise=torch.tensor(sensor_noise))
    fl = build_fleet(model, k, "cpu", scenarios=b, estimator_chain=True)
    got = fl.tick(carry_from_numpy(arrays), fl.generator, **noise)
    assert got.status.tolist() == want["status"].tolist() == [0] * b
    band = BANDS[dtype]
    for g, w in ((got.u_n, want["u_n"]), (got.x, want["x"]), (got.ukf.x, want["ukf_x"]),
                 (got.ukf.p, want["ukf_p"])):
        np.testing.assert_allclose(g.numpy(), w, **band)
    if dtype == np.float64:
        plain = build_fleet(model, k, "cpu", scenarios=b)
        ref = plain.tick(carry_from_numpy(arrays), plain.generator, **noise)
        for g, w in ((got.x, ref.x), (got.ukf.x, ref.ukf.x), (got.ukf.p, ref.ukf.p)):
            np.testing.assert_allclose(g.numpy(), w.numpy(), **band)


@pytest.mark.parametrize("model, k, b, t0, t_end", [("cartpole4", 512, 16, 0.0, 1.0),
                                                    ("flagship6", 2048, 8, 0.9, 0.7)])
def test_chain_fleet_runs_on_cpu(model, k, b, t0, t_end):
    """cartpole4 over 1 s, and flagship6 from rest at t = 0.9 s through the
    2 N pulse of (1, 1.5) s, on the chain: every scenario upright, every
    status 0, the estimate finite."""
    fl = build_fleet(model, k, "cpu", scenarios=b, seed=2, estimator_chain=True)
    fl = fl._replace(carry=fl.carry._replace(t=torch.full_like(fl.carry.t, t0)))
    res = run_fleet(fl, t_end=t_end, report_every=t_end)
    assert res.survival == 1.0 and res.statuses_ok
    assert torch.isfinite(res.carry.ukf.x).all() and torch.isfinite(res.carry.ukf.p).all()
    assert float(res.carry.t[0]) == pytest.approx(t0 + t_end, abs=1e-4)


def test_chain_constants_fold_on_the_host():
    """The C entry's constant arrays: the functors' constants, then 0.5·c,
    the weights, Σwc, the substep, the pulse and the matrices."""
    _, chain = _port_chain("flagship6")
    plant, obs, head = (list(a) for a in chain.kernel_constants)
    p = CartPoleParams.two_wheel()
    assert len(plant) == 18 and plant[-1] == np.float32(p.m2 * p.l * p.l + p.j2)
    assert obs[1] == -obs[0] and obs[3] == np.float32(p.g)
    assert head[:4] == [np.float32(0.5 * 3.0), np.float32(1.0 / 6.0), np.float32(1.0 / 6.0), 3.0]
    assert head[6:11] == [1.0, 1.5, 2.0, 1.0, 1.0]  # the pulse, on; the guard, on
    assert len(head) == 11 + 36 + 25 + 5 + 36 and head[-1] == np.float32(0.1)


def test_chain_rejects_bad_arguments():
    _, chain = _port_chain("cartpole4")
    meta = torch.zeros(2, 4, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        estimator_chain_fused(chain, meta, meta, torch.zeros(16, 2, device="meta"),
                              torch.zeros(2, device="meta"), torch.zeros(2, device="meta"),
                              torch.zeros(15, 2, device="meta"))
    fl = build_fleet("cartpole4", 256, "cpu", scenarios=2)
    with pytest.raises(ValueError, match="chain_model"):
        make_scenario_step(fl.cfg, None, None, chain.params, None, None, chain.sig, estimator_chain=True)
