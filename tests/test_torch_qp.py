"""The port's condensed-QP layer (``mpc_rs_tpu_torch/controllers/qp.py``,
``models/dynamics.py::linear_ab``) against the JAX package and the C++
oracle, on the same numpy inputs.

- Builders: F, G, Q bit for bit (both are numpy float64); H = GᵀQG and GᵀQ
  within 1e-12 relative.
- QP algebra (float64): cost, gradient and linear term within 1e-12 of the
  JAX package and within the oracle band of ``tests/test_native_oracle.py:763-764``;
  the active-set inverse table within 1e-12.
- ``box_qp_newton`` in float64 over 64 states scaled as
  ``tests/test_native_oracle.py:780-790`` (every third ×8, so some bind the
  ±30 bounds), for iters 12 and 16, the safeguard on and off, with and
  without the table: within 1e-10 of the JAX package and at the oracle's
  enumerated optimum (rtol 1e-8, atol 1e-9).
- ``box_qp_newton`` in float32 (the fleet's): the KKT residual of
  ``tests/test_panoc.py:308-328`` (or 1.25x the JAX solve's own on the
  same states, where that is above the 2e-4) and, wherever both packages'
  active sets agree, the float32 band (rtol 1e-3, atol 2e-4) of the JAX
  package for 95 % of the entries, and over all within twice the JAX
  solve's own distance from the float64 solve.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_rs_tpu.controllers import qp as jqp
from mpc_rs_tpu.models import dynamics as jdyn
from mpc_rs_tpu.models import reference as jref
from mpc_rs_tpu.models.params import CartPoleParams as JParams
from mpc_rs_tpu_torch.controllers import qp as tqp
from mpc_rs_tpu_torch.models import dynamics as tdyn
from mpc_rs_tpu_torch.models import reference as tref
from mpc_rs_tpu_torch.models.params import CartPoleParams as TParams
from mpc_rs_tpu_torch.scripts import oracle as ora

C4 = np.diag([5.0, 5.0, 1.0, 1.0])
F64 = torch.float64


@pytest.fixture(scope="module")
def qps():
    a, b = jdyn.linear_ab(JParams.single_wheel(), 0.1)
    jq = jqp.build_condensed_qp(a, b, C4, 8)
    tq = tqp.build_condensed_qp(a, b, C4, 8)
    return jq, tq


@pytest.fixture(scope="module")
def lib():
    return ora.load_oracle()


@pytest.mark.parametrize("two_wheel,p_name,dt", [(False, "single_wheel", 0.1), (True, "two_wheel", 0.15),
                                                 (False, "single_wheel_light", 0.01)])
def test_linear_ab_and_builders_are_the_jax_arrays(two_wheel, p_name, dt):
    ja, jb = jdyn.linear_ab(getattr(JParams, p_name)(), dt, two_wheel=two_wheel)
    ta, tb = tdyn.linear_ab(getattr(TParams, p_name)(), dt, two_wheel=two_wheel)
    assert ta == ja and tb == jb  # the same nested floats
    for n in (8, 12):
        np.testing.assert_array_equal(tqp.create_f_matrix(ta, n), jqp.create_f_matrix(ja, n))
        np.testing.assert_array_equal(tqp.create_g_matrix(ta, tb, n), jqp.create_g_matrix(ja, jb, n))
        np.testing.assert_array_equal(tqp.create_q_matrix(C4, n), jqp.create_q_matrix(C4, n))
        jq, tq = jqp.build_condensed_qp(ja, jb, C4, n), tqp.build_condensed_qp(ta, tb, C4, n)
        for name in ("h", "gq"):
            want = np.asarray(getattr(jq, name))
            got = getattr(tq, name).numpy()
            assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max(), name
        assert tq.h.dtype == F64 and tqp.build_condensed_qp(ta, tb, C4, n, dtype=torch.float32).h.dtype == torch.float32


def test_condensed_qp_from_numpy_takes_the_jax_fields(qps):
    jq, tq = qps
    got = tqp.CondensedQp.from_numpy(*jq, dtype=F64)
    for name in tqp.CondensedQp._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(jq, name)))
    f32 = tqp.CondensedQp.from_numpy(*jq, dtype=torch.float32)
    assert all(v.dtype == torch.float32 for v in f32)


def test_reference_generators_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(7, 4)) * np.array([3.0, 1.0, 0.5, 1.0])
    xt, xj = torch.tensor(x), jnp.asarray(x)
    np.testing.assert_allclose(tref.make_gen_ref_raised_cosine(8)(xt).numpy(),
                               np.asarray(jref.make_gen_ref_raised_cosine(8)(xj)), rtol=1e-15, atol=1e-15)
    assert tref.make_gen_ref_zero(8)(xt).shape == (7, 8, 4)
    np.testing.assert_allclose(tref.make_planning_err(0.3)(xt).numpy(),
                               np.asarray(jref.make_planning_err(0.3)(xj)), rtol=1e-15, atol=1e-15)
    tp, jp = tref.make_next_plan(0.05), jref.make_next_plan(0.05)
    np.testing.assert_allclose(tp(xt).numpy(), np.asarray(jp(xj)), rtol=1e-15, atol=1e-15)
    np.testing.assert_allclose(tref.make_plan_err(0.3)(xt, tp(xt)).numpy(),
                               np.asarray(jref.make_plan_err(0.3)(xj, jp(xj))), rtol=1e-15, atol=1e-15)
    np.testing.assert_allclose(tref.rollout_plan(tp, xt[0], 10).numpy(),
                               np.asarray(jref.rollout_plan(jp, xj[0], 10)), rtol=1e-15, atol=1e-15)
    # gen_ref's phases are float64 and meet a float32 state in float32, as in the JAX package
    x32 = torch.tensor(x, dtype=torch.float32)
    got = tref.make_gen_ref_raised_cosine(8)(x32)
    want = np.asarray(jref.make_gen_ref_raised_cosine(8)(jnp.asarray(x, jnp.float32)))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_qp_algebra_matches_jax_and_the_oracle(qps, lib):
    jq, tq = qps
    gen_j, gen_t = jref.make_gen_ref_raised_cosine(8), tref.make_gen_ref_raised_cosine(8)
    r = np.random.default_rng(59)
    xs = r.uniform(-1.0, 1.0, (16, 4)) * np.array([2.0, 1.0, 0.3, 1.0])
    us = r.uniform(-20.0, 20.0, (16, 8))
    xr_t = gen_t(torch.tensor(xs)).flatten(-2)
    c_t = tqp.qp_cost(tq, torch.tensor(xs), torch.tensor(us), xr_t).numpy()
    g_t = tqp.qp_grad(tq, torch.tensor(xs), torch.tensor(us), xr_t).numpy()
    b_t = tqp.qp_linear_term(tq, torch.tensor(xs), xr_t).numpy()
    for i in range(16):
        x, u = jnp.asarray(xs[i]), jnp.asarray(us[i])
        xr = gen_j(x).reshape(-1)
        c_j, g_j = float(jqp.qp_cost(jq, x, u, xr)), np.asarray(jqp.qp_grad(jq, x, u, xr))
        assert abs(c_t[i] - c_j) <= 1e-12 * abs(c_j)
        assert np.abs(g_t[i] - g_j).max() <= 1e-12 * np.abs(g_j).max()
        np.testing.assert_allclose(b_t[i], np.asarray(jqp.qp_linear_term(jq, x, xr)), rtol=1e-12, atol=1e-12)
        # one problem without a batch axis gives the same numbers
        c1 = tqp.qp_cost(tq, torch.tensor(xs[i]), torch.tensor(us[i]), xr_t[i])
        assert abs(float(c1) - c_t[i]) <= 1e-13 * abs(c_t[i])
        c_o, g_o = ora.ora_qp_cost_grad(lib, xs[i], us[i])
        np.testing.assert_allclose(c_t[i], c_o, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(g_t[i], g_o, rtol=1e-10, atol=1e-12)
    # J(u) = uᵀHu + bᵀu + const: the linear term is the affine part of the cost
    c0 = tqp.qp_cost(tq, torch.tensor(xs), torch.zeros(16, 8, dtype=F64), xr_t).numpy()
    quad = np.einsum("bi,ij,bj->b", us, tq.h.numpy(), us)
    np.testing.assert_allclose(c_t - c0, quad + (b_t * us).sum(-1), rtol=1e-10)


def test_qp_value_and_grad_factory_matches_jax(qps):
    jq, tq = qps
    vj = jqp.make_qp_value_and_grad(jq, jref.make_gen_ref_raised_cosine(8))
    vt = tqp.make_qp_value_and_grad(tq, tref.make_gen_ref_raised_cosine(8))
    x, u = np.array([0.7, -0.2, 0.05, 0.3]), np.linspace(-3.0, 4.0, 8)
    cj, gj = vj(jnp.asarray(x))(jnp.asarray(u))
    ct, gt = vt(torch.tensor(x))(torch.tensor(u))
    assert abs(float(ct) - float(cj)) <= 1e-12 * abs(float(cj))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-12, atol=1e-12)


def test_active_set_inverse_table_matches_jax(qps):
    jq, tq = qps
    tt = tqp.active_set_inverse_table(tq.h)
    tj = np.asarray(jqp.active_set_inverse_table(jq.h))
    assert tt.shape == (256, 8, 8) and tt.dtype == F64
    assert np.abs(tt.numpy() - tj).max() <= 1e-12 * np.abs(tj).max()
    assert tqp.active_set_inverse_table(tq.h.float()).dtype == torch.float32


# --------------------------------------------------------------------------
# box_qp_newton


@pytest.fixture(scope="module")
def newton_case(qps, lib):
    """64 states, every third scaled ×8 (``test_native_oracle.py:780-790``),
    their linear terms, and the oracle's enumerated optima."""
    jq, tq = qps
    r = np.random.default_rng(61)
    scale = np.where(np.arange(64) % 3 == 0, 8.0, 1.0)[:, None]
    xs = scale * r.uniform(-1.0, 1.0, (64, 4)) * np.array([2.0, 1.0, 0.3, 1.0])
    b = tqp.qp_linear_term(tq, torch.tensor(xs), tref.make_gen_ref_raised_cosine(8)(torch.tensor(xs)).flatten(-2))
    u_o = np.stack([ora.ora_qp_solve_box(lib, x, -30.0, 30.0) for x in xs])
    return xs, b, u_o


@pytest.mark.parametrize("iters", [12, 16])
@pytest.mark.parametrize("safeguard", [True, False])
@pytest.mark.parametrize("table", [True, False])
def test_box_qp_newton_f64_matches_jax_and_the_oracle(qps, newton_case, iters, safeguard, table):
    jq, tq = qps
    xs, b, u_o = newton_case
    assert int((np.abs(u_o) >= 29.999).any(axis=1).sum()) >= 2  # some optima bind the bounds
    tbl_t = tqp.active_set_inverse_table(tq.h) if table else None
    tbl_j = jqp.active_set_inverse_table(jq.h) if table else None
    u0 = np.zeros((64, 8))
    got = tqp.box_qp_newton(tq.h, b, torch.tensor(u0), -30.0, 30.0, iters=iters, inv_table=tbl_t,
                            safeguard=safeguard).numpy()
    want = np.asarray(jqp.box_qp_newton(jq.h, jnp.asarray(b.numpy()), jnp.asarray(u0), -30.0, 30.0, iters=iters,
                                        inv_table=tbl_j, safeguard=safeguard))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got, u_o, rtol=1e-8, atol=1e-9)


def test_box_qp_newton_safeguard_escapes_an_active_set_cycle():
    """The random-QP class where the clipped Newton step cycles
    (``qp.py:164-170``): asymmetric bounds on an ill-conditioned Hessian.
    The port and the JAX package take the same projected-gradient arc."""
    rng = np.random.default_rng(11)
    q, _ = np.linalg.qr(rng.normal(size=(8, 8)))
    h = q @ np.diag(np.geomspace(1.0, 1.6e3, 8)) @ q.T
    b = rng.normal(size=(16, 8)) * 40.0
    u_sg = tqp.box_qp_newton(torch.tensor(h), torch.tensor(b), torch.zeros(16, 8, dtype=F64), -1.0, 3.0).numpy()
    want = np.asarray(jqp.box_qp_newton(jnp.asarray(h), jnp.asarray(b), jnp.zeros((16, 8)), -1.0, 3.0))
    np.testing.assert_allclose(u_sg, want, rtol=0, atol=1e-9)
    cost = lambda u: np.einsum("bi,ij,bj->b", u, h, u) + (b * u).sum(-1)  # noqa: E731
    u_ns = tqp.box_qp_newton(torch.tensor(h), torch.tensor(b), torch.zeros(16, 8, dtype=F64), -1.0, 3.0,
                             safeguard=False).numpy()
    assert (cost(u_sg) <= cost(u_ns) + 1e-9).all()


def _kkt_residual(u, h, b):
    """``tests/test_panoc.py:321-325``: the free coordinates' gradient over
    max(1, max|g|), in float32."""
    g = 2 * u @ h + b
    free = (u > -30.0 + 1e-4) & (u < 30.0 - 1e-4)
    return np.abs(g * free).max() / max(1.0, np.abs(g).max())


def test_box_qp_newton_f32_kkt_and_the_jax_band(qps):
    """The fleet's float32 solve. Its KKT residual is held at
    ``test_panoc.py``'s 2e-4, or at 1.25x the JAX package's own residual on
    the same states where that is larger: the float32 floor is about
    eps·‖H‖·‖u‖ ≈ 4e-4 absolute (``test_panoc.py:319-320``), and at numpy
    seed 9 the JAX solve's residual is 2.17e-4 (its own test passes by its
    PRNG key)."""
    jq, tq = qps
    jq32 = jqp.CondensedQp(*(jnp.asarray(v, jnp.float32) for v in jq))
    tq32 = tqp.CondensedQp(*(v.float() for v in tq))
    rng = np.random.default_rng(9)
    x0 = (np.array([0.5, 0.0, 0.1, 0.0]) + 0.5 * rng.normal(size=(128, 4))).astype(np.float32)
    xt = torch.tensor(x0)
    b = tqp.qp_linear_term(tq32, xt, tref.make_gen_ref_raised_cosine(8)(xt).flatten(-2))
    assert b.dtype == torch.float32
    u = tqp.box_qp_newton(tq32.h, b, torch.zeros(128, 8), -30.0, 30.0, iters=12).numpy()
    uj = np.asarray(jqp.box_qp_newton(jq32.h, jnp.asarray(b.numpy()), jnp.zeros((128, 8), jnp.float32), -30.0, 30.0,
                                      iters=12))
    h = tq32.h.numpy()
    assert _kkt_residual(u, h, b.numpy()) < max(2e-4, 1.25 * _kkt_residual(uj, h, b.numpy()))
    assert (np.abs(u) <= 30.0 + 1e-6).all()
    # the float32 band of the JAX solve where both active sets agree, but for
    # at most 5 % of the entries; over all, twice the JAX solve's own distance
    # from the float64 solve (cond(2H) ≈ 1.8e3 puts either float32 solve up to
    # ~1.7e-3 from it, and the two up to ~2.6e-3 apart)
    same_set = ((np.abs(u) >= 30.0 - 1e-4) == (np.abs(uj) >= 30.0 - 1e-4)).all(axis=1)
    assert same_set.mean() > 0.9
    in_band = np.abs(u - uj) <= 2e-4 + 1e-3 * np.abs(uj)
    assert in_band[same_set].mean() > 0.95
    u64 = tqp.box_qp_newton(tq.h, b.double(), torch.zeros(128, 8, dtype=F64), -30.0, 30.0, iters=12).numpy()
    assert np.abs(u - u64).max() <= 2.0 * np.abs(uj - u64).max()
