"""The port's plain MPPI tier against ``mpc_rs_tpu.controllers.mppi`` on the
same noise (made with numpy), in float64 and float32, with the failure
probes of the status ladder."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_rs_tpu.controllers import mppi as jmppi
from mpc_rs_tpu.models import costs as jcosts
from mpc_rs_tpu.models import dynamics as jdyn
from mpc_rs_tpu.models.params import CartPoleParams as JParams
from mpc_rs_tpu_torch.controllers import mppi as tmppi
from mpc_rs_tpu_torch.models import costs as tcosts
from mpc_rs_tpu_torch.models import dynamics as tdyn
from mpc_rs_tpu_torch.models.params import CartPoleParams as TParams

N = 8
X0 = (0.5, 0.0, 0.1, 0.0)
JSTEP = jdyn.make_cartpole_nonlinear(JParams.single_wheel(), 0.1)
TSTEP = tdyn.make_cartpole_nonlinear(TParams.single_wheel(), 0.1)
TDTYPE = {np.float64: torch.float64, np.float32: torch.float32}
# f64: same math, summed in another order — rtol 1e-9. f32: the band the
# JAX package holds its own kernel to (tests/test_pallas.py:59).
BANDS = {np.float64: dict(rtol=1e-9, atol=1e-12), np.float32: dict(rtol=1e-3, atol=2e-4)}


def _cfgs(k, lam=0.5, control_inv=None):
    kw = dict(n_horizon=N, n_rollouts=k, lambda_=lam, std_dev=3.0, limit=(-20.0, 20.0),
              control_inv=control_inv)
    return jmppi.MppiConfig(**kw), tmppi.MppiConfig(**kw)


def _both(k, dtype, *, seed=0, lam=0.5, control_inv=None, x=X0, u_scale=1.0,
          jcost=jcosts.shaped4, tcost=tcosts.shaped4):
    rng = np.random.default_rng(seed)
    eps = 3.0 * rng.standard_normal((k, N))
    u_n = u_scale * rng.standard_normal(N)
    jcfg, tcfg = _cfgs(k, lam, control_inv)
    want = jmppi.mppi_solve(
        jcfg, JSTEP, jcost, None, tuple(jnp.asarray(c, dtype) for c in x),
        jnp.asarray(u_n, dtype), noise=jnp.asarray(eps, dtype),
    )
    got = tmppi.mppi_solve(
        tcfg, TSTEP, tcost, None, tuple(torch.tensor(c, dtype=TDTYPE[dtype]) for c in x),
        torch.tensor(u_n.astype(dtype)), noise=torch.tensor(eps.astype(dtype)),
    )
    return want, got


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("control_inv", [None, 0.25])
@pytest.mark.parametrize("k", [1000, 4096])
def test_mppi_solve_matches_jax(dtype, control_inv, k):
    want, got = _both(k, dtype, seed=k, control_inv=control_inv)
    assert got.u_n.dtype == TDTYPE[dtype] and got.status.dtype == torch.int32
    assert int(got.status) == int(want.status) == 0
    band = BANDS[dtype]
    np.testing.assert_allclose(got.u_n.numpy(), np.asarray(want.u_n), **band)
    np.testing.assert_allclose(float(got.min_cost), float(want.min_cost), rtol=band["rtol"])
    np.testing.assert_allclose(float(got.ess), float(want.ess), rtol=band["rtol"])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_failure_probe_no_finite(dtype):
    """All scores non-finite (infinite cost) → NO_FINITE and zeros."""
    jinf = lambda *xs: jnp.full_like(xs[0], jnp.inf)
    tinf = lambda *xs: torch.full_like(xs[0], torch.inf)
    want, got = _both(512, dtype, jcost=jinf, tcost=tinf)
    assert int(got.status) == int(want.status) == tmppi.MppiStatus.NO_FINITE
    np.testing.assert_array_equal(got.u_n.numpy(), 0.0)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_failure_probe_nan_state(dtype):
    """A NaN in x0 makes every cost NaN → NO_FINITE and zeros."""
    want, got = _both(512, dtype, x=(float("nan"), 0.0, 0.1, 0.0))
    assert int(got.status) == int(want.status) == tmppi.MppiStatus.NO_FINITE
    np.testing.assert_array_equal(got.u_n.numpy(), 0.0)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_failure_probe_lambda_zero(dtype):
    """λ = 0 → 0/0 in the weight of the best rollout → INVALID_U and zeros."""
    want, got = _both(512, dtype, lam=0.0)
    assert int(got.status) == int(want.status) == tmppi.MppiStatus.INVALID_U
    np.testing.assert_array_equal(got.u_n.numpy(), 0.0)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_failure_probe_single_rollout(dtype):
    """K = 1 → OK, and u' is that rollout's clamped sequence."""
    want, got = _both(1, dtype, u_scale=30.0)
    assert int(got.status) == int(want.status) == tmppi.MppiStatus.OK
    np.testing.assert_allclose(got.u_n.numpy(), np.asarray(want.u_n), **BANDS[dtype])
    assert np.abs(got.u_n.numpy()).max() <= 20.0


def test_generator_sampling_is_seeded():
    _, cfg = _cfgs(2048)
    x = tuple(torch.tensor(c) for c in X0)
    u_n = torch.zeros(N, dtype=torch.float32)
    a = tmppi.mppi_solve(cfg, TSTEP, tcosts.shaped4, torch.Generator().manual_seed(3), x, u_n)
    b = tmppi.mppi_solve(cfg, TSTEP, tcosts.shaped4, torch.Generator().manual_seed(3), x, u_n)
    c = tmppi.mppi_solve(cfg, TSTEP, tcosts.shaped4, torch.Generator().manual_seed(4), x, u_n)
    assert int(a.status) == 0 and a.u_n.shape == (N,)
    assert torch.equal(a.u_n, b.u_n) and not torch.equal(a.u_n, c.u_n)
    with pytest.raises(ValueError, match="Generator"):
        tmppi.mppi_solve(cfg, TSTEP, tcosts.shaped4, None, x, u_n)


def test_noise_shape_is_checked():
    _, cfg = _cfgs(64)
    x = tuple(torch.tensor(c) for c in X0)
    with pytest.raises(ValueError, match="shape"):
        tmppi.mppi_solve(cfg, TSTEP, tcosts.shaped4, None, x, torch.zeros(N), noise=torch.zeros(N, 64))
