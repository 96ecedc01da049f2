"""The port's models against the JAX package: params, the nonlinear cart-pole
and the shaped4 cost, on the same random states made with numpy."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_rs_tpu.models import costs as jcosts
from mpc_rs_tpu.models import dynamics as jdyn
from mpc_rs_tpu.models.params import CartPoleParams as JParams
from mpc_rs_tpu_torch.models import costs as tcosts
from mpc_rs_tpu_torch.models import dynamics as tdyn
from mpc_rs_tpu_torch.models.params import CartPoleParams as TParams

NAMED = ["single_wheel", "single_wheel_light", "single_wheel_heavy_j", "single_wheel_j01", "two_wheel"]
PROPS = ["d_lin", "d0", "mass_line", "d1_two", "mass_line_two", "d_lin_two"]


def _pair(name):
    return getattr(JParams, name)(), getattr(TParams, name)()


@pytest.mark.parametrize("name", NAMED)
def test_params_equal_field_by_field(name):
    jp, tp = _pair(name)
    assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
    for prop in PROPS:
        assert getattr(jp, prop) == getattr(tp, prop), prop


@pytest.mark.parametrize("name", NAMED)
def test_params_from_mapping(name):
    jp, tp = _pair(name)
    assert TParams.from_mapping(dataclasses.asdict(jp)) == tp
    as_np = {k: np.float64(v) for k, v in dataclasses.asdict(jp).items()}
    back = TParams.from_mapping(as_np)
    assert back == tp and all(type(v) is float for v in dataclasses.asdict(back).values())


def test_params_from_mapping_rejects_unknown_field():
    with pytest.raises(ValueError, match="unknown"):
        TParams.from_mapping({**dataclasses.asdict(TParams.single_wheel()), "mass": 1.0})


def _states(seed, n=512):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(4, n)) * np.array([[1.0], [2.0], [0.8], [3.0]])
    u = rng.normal(size=n) * 10.0
    return x, u


# f64: the same operations in the same order — 1e-12. f32: the two
# libraries' sin/cos may differ by a few ulps — rtol 1e-5 / atol 1e-6.
BANDS = {np.float64: dict(rtol=1e-12, atol=1e-12), np.float32: dict(rtol=1e-5, atol=1e-6)}
TDTYPE = {np.float64: torch.float64, np.float32: torch.float32}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", ["single_wheel", "two_wheel"])
@pytest.mark.parametrize("trailing_dt", [False, True])
def test_cartpole_nonlinear_matches_jax(dtype, name, trailing_dt):
    jp, tp = _pair(name)
    x, u = _states(1)
    if trailing_dt:
        jstep, tstep, extra = jdyn.make_cartpole_nonlinear(jp), tdyn.make_cartpole_nonlinear(tp), (0.01,)
    else:
        jstep, tstep, extra = jdyn.make_cartpole_nonlinear(jp, 0.1), tdyn.make_cartpole_nonlinear(tp, 0.1), ()
    want = jstep(*(jnp.asarray(c, dtype) for c in x), jnp.asarray(u, dtype), *extra)
    got = tstep(*(torch.tensor(c.astype(dtype)) for c in x), torch.tensor(u.astype(dtype)), *extra)
    for w, g in zip(want, got):
        assert g.dtype == TDTYPE[dtype]
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BANDS[dtype])


def test_cartpole_nonlinear_is_explicit():
    """Every component reads the old state: n0 uses old x1, n2 old x3."""
    step = tdyn.make_cartpole_nonlinear(TParams.single_wheel(), 0.1)
    x = [torch.tensor(v, dtype=torch.float64) for v in (0.0, 1.0, 0.2, -2.0)]
    n0, _, n2, _ = step(*x, torch.tensor(5.0, dtype=torch.float64))
    assert float(n0) == pytest.approx(0.1) and float(n2) == pytest.approx(0.2 - 0.2)


def test_cartpole_nonlinear_fast_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdyn.make_cartpole_nonlinear(TParams.single_wheel(), 0.1, fast=True)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_shaped4_matches_jax(dtype):
    x, _ = _states(2, 2048)
    x *= 2.0  # reach every clamp
    want = jcosts.shaped4(*(jnp.asarray(c, dtype) for c in x))
    got = tcosts.shaped4(*(torch.tensor(c.astype(dtype)) for c in x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BANDS[dtype])


def test_shaped4_propagates_nan():
    nan = torch.tensor(float("nan"))
    z = torch.tensor(0.0)
    assert torch.isnan(tcosts.shaped4(nan, z, z, z))
