"""The port's models against the JAX package: params, the nonlinear cart-pole
(exact and fast tiers), the flagship models, the costs, the process noise
and the observation models, on the same random states made with numpy."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_rs_tpu.models import costs as jcosts
from mpc_rs_tpu.models import dynamics as jdyn
from mpc_rs_tpu.models import noise as jnoise
from mpc_rs_tpu.models import observation as jobs
from mpc_rs_tpu.models.params import CartPoleParams as JParams
from mpc_rs_tpu_torch.models import costs as tcosts
from mpc_rs_tpu_torch.models import dynamics as tdyn
from mpc_rs_tpu_torch.models import noise as tnoise
from mpc_rs_tpu_torch.models import observation as tobs
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


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_div_by_a_python_float_rounds_once(dtype):
    """``dynamics._div``, the thrust term's kt·u / r_w: a tensor (or a
    Python float) over a Python float is one IEEE division in the tensor's
    dtype, as numpy divides (on a CUDA tensor too, where PyTorch would
    multiply by the divisor's reciprocal: ``tests/test_torch_cuda.py`` holds
    it there)."""
    a = np.linspace(-40.0, 40.0, 100_003).astype(dtype)
    np.testing.assert_array_equal(tdyn._div(torch.tensor(a), 0.05).numpy(), a / np.asarray(0.05, dtype))
    assert tdyn._div(3.0, 0.05) == 3.0 / 0.05


def test_cartpole_nonlinear_fast_is_not_ported():
    """The fast tier was the part of the cart-pole left to port; it now
    exists and is not the exact tier (polynomial sin/cos): the two agree
    to the JAX package's fast-dynamics bound (tests/test_fastmath.py:62)
    but not bit for bit."""
    p = TParams.single_wheel()
    rng = np.random.default_rng(7)  # the points of tests/test_fastmath.py:57-59
    x = rng.uniform(-2.0, 2.0, (500, 4)).astype(np.float32)[:50]
    xs = [torch.tensor(c) for c in x.T]
    ut = torch.tensor(rng.uniform(-20.0, 20.0, 500).astype(np.float32)[:50])
    exact = tdyn.make_cartpole_nonlinear(p, 0.1)(*xs, ut)
    fast = tdyn.make_cartpole_nonlinear(p, 0.1, fast=True)(*xs, ut)
    assert any(not torch.equal(a, b) for a, b in zip(exact, fast))
    for a, b in zip(exact, fast):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=5e-5)


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


# The fast tiers outside a kernel: the same polynomials (bit-identical to
# the JAX package's on float32, see tests/test_torch_kernels.py) and exact
# division; the band is the exact tier's.
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("which", ["cartpole", "flagship4"])
def test_controller_models_match_jax(dtype, fast, which):
    x, u = _states(4)
    if which == "cartpole":
        jstep = jdyn.make_cartpole_nonlinear(JParams.single_wheel(), 0.1, fast=fast)
        tstep = tdyn.make_cartpole_nonlinear(TParams.single_wheel(), 0.1, fast=fast)
    else:
        jstep = jdyn.make_flagship4(JParams.two_wheel(), 0.15, fast=fast)
        tstep = tdyn.make_flagship4(TParams.two_wheel(), 0.15, fast=fast)
    want = jstep(*(jnp.asarray(c, dtype) for c in x), jnp.asarray(u, dtype))
    got = tstep(*(torch.tensor(c.astype(dtype)) for c in x), torch.tensor(u.astype(dtype)))
    for w, g in zip(want, got):
        assert g.dtype == TDTYPE[dtype]
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BANDS[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("force", ["zero", "tensor"])
def test_flagship6_matches_jax(dtype, force):
    """The 6-state plant with the f ≡ 0 specialisation (the UKF's model) and
    with a force tensor (the plant under the pulse)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(6, 256)) * np.array([[1.0], [2.0], [5.0], [0.8], [3.0], [10.0]])
    u = rng.normal(size=256) * 10.0
    f = rng.normal(size=256) * 2.0
    jf = 0.0 if force == "zero" else jnp.asarray(f, dtype)
    tf = 0.0 if force == "zero" else torch.tensor(f.astype(dtype))
    want = jdyn.make_flagship6(JParams.two_wheel())(
        *(jnp.asarray(c, dtype) for c in x), jnp.asarray(u, dtype), 0.01, jf)
    got = tdyn.make_flagship6(TParams.two_wheel())(
        *(torch.tensor(c.astype(dtype)) for c in x), torch.tensor(u.astype(dtype)), 0.01, tf)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BANDS[dtype])


@pytest.mark.parametrize("fast", [False, True])
def test_ddot_force_terms_match_jax(fast):
    """make_ddot with a nonzero force in both tiers (f64, the same order)."""
    rng = np.random.default_rng(6)
    dx, th, dth, u, f = (rng.normal(size=128) for _ in range(5))
    want = jdyn.make_ddot(JParams.two_wheel(), fast=fast)(*(jnp.asarray(a) for a in (dx, th, dth, u, f)))
    got = tdyn.make_ddot(TParams.two_wheel(), fast=fast)(*(torch.tensor(a) for a in (dx, th, dth, u, f)))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BANDS[np.float64])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_diag4_matches_jax(dtype):
    x, _ = _states(7)
    want = jcosts.make_diag4(0.1, 0.1, 1.0, 0.5)(*(jnp.asarray(c, dtype) for c in x))
    got = tcosts.make_diag4(0.1, 0.1, 1.0, 0.5)(*(torch.tensor(c.astype(dtype)) for c in x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BANDS[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("gen, dt", [("gen_q4", 0.01), ("gen_q6", 0.0215), ("gen_q6", 0.1)])
def test_process_noise_matches_jax(dtype, gen, dt):
    want = getattr(jnoise, gen)(jnp.asarray(dt, dtype))
    got = getattr(tnoise, gen)(torch.tensor(dt, dtype=TDTYPE[dtype]))
    assert got.dtype == TDTYPE[dtype] and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BANDS[dtype])
    np.testing.assert_array_equal(got.numpy(), got.numpy().T)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("which", ["rpm_gyro4", "imu6"])
def test_observation_models_match_jax(dtype, which):
    """Vector form on a (m, B, n) stack, as the UKF applies it."""
    n, jp, tp = (4, JParams.single_wheel(), TParams.single_wheel()) if which == "rpm_gyro4" else \
        (6, JParams.two_wheel(), TParams.two_wheel())
    x = np.random.default_rng(8).normal(size=(9, 16, n)).astype(dtype)
    want = getattr(jobs, f"make_hx_{which}")(jp)(jnp.asarray(x))
    got = getattr(tobs, f"make_hx_{which}")(tp)(torch.tensor(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BANDS[dtype])
