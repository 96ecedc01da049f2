"""The port's PANOC (``mpc_rs_tpu_torch/controllers/panoc.py``) against the
JAX package's (``mpc_rs_tpu/controllers/panoc.py``), float64, on the same
numpy inputs.

A solve is held to equal ``iterations`` and ``converged``, u within 1e-9,
the cost within 1e-10 relative and γ within 1e-12 relative, on the
``op-en2`` ball, the box quadratic of ``tests/test_panoc.py:48``, 16
condensed-QP states in the ``op-mpc-x-calc`` configuration and 16 in the QP
fleet's, a γ-recovery run and an autodiff run. One property of the
reference bounds this: a solve that runs past ~30 iterations on the
condensed QP spends its last ones where the FBE decrease is below the
rounding of f (|f| ~ 1e3), and amplifies last-bit differences to 1e-8-1e-5
in u; the JAX package's own jitted solve and its ``vmap``-ed solve of the
same problem part that far on such states. There both packages are held
within 2·√n·tol/λ_min(2H) of the exact optimum (the float64 Newton solve;
how far a solve stopped at tol can be on this strongly convex QP), and
still at the cost and γ bands.

A batch (``tests/test_panoc.py:220``'s five QPs, whose lanes converge at
different iterations) equals the port's loop over its lanes within 1e-12,
each lane the JAX solve within 1e-9, and the JAX ``vmap`` within 1e-9 or
twice the vmap's own distance from the JAX solve (1.2e-9 on one lane). Both finite-difference oracles are within
1e-10 of the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_rs_tpu.controllers import panoc as jpn
from mpc_rs_tpu.controllers import qp as jqp
from mpc_rs_tpu.models import costs as jcosts
from mpc_rs_tpu.models import dynamics as jdyn
from mpc_rs_tpu.models import reference as jref
from mpc_rs_tpu.models.params import CartPoleParams as JParams
from mpc_rs_tpu.utils import as_vector_fn
from mpc_rs_tpu_torch.controllers import panoc as tpn
from mpc_rs_tpu_torch.controllers import qp as tqp
from mpc_rs_tpu_torch.models import costs as tcosts
from mpc_rs_tpu_torch.models import dynamics as tdyn
from mpc_rs_tpu_torch.models import reference as tref
from mpc_rs_tpu_torch.models.params import CartPoleParams as TParams

F64 = torch.float64
NOISE_ITERS = 30  # past this many iterations a condensed-QP solve is noise-driven


def optimum_radius(h, tol):
    """How far from the optimum a solve that stopped at ‖R(u)‖∞ ≤ tol can
    be on the QP with Hessian 2H: 2·√n·tol / λ_min(2H) (strong convexity;
    4.5e-5 at tol 1e-6 on op-mpc-x-calc's QP, λ_min = 0.125)."""
    return 2.0 * np.sqrt(h.shape[-1]) * tol / float(torch.linalg.eigvalsh(2.0 * h.double()).min())


def assert_same_result(got, want, i=None, u_star=None, radius=None):
    """``got`` (a port PanocResult, lane ``i`` of a batch when given)
    against ``want`` (a JAX one). With ``u_star`` (the exact optimum) a
    solve that ran past NOISE_ITERS iterations is noise-driven, and both
    packages' u are held within ``radius`` of the optimum instead."""
    pick = (lambda v: v) if i is None else (lambda v: v[i])
    it_t, it_j = int(pick(got.iterations)), int(want.iterations)
    u_t, u_j = pick(got.u).numpy(), np.asarray(want.u)
    c_t, c_j = float(pick(got.cost)), float(want.cost)
    g_t, g_j = float(pick(got.gamma)), float(want.gamma)
    assert abs(c_t - c_j) <= 1e-10 * max(abs(c_j), 1e-300), (c_t, c_j)
    assert abs(g_t - g_j) <= 1e-12 * g_j, (g_t, g_j)
    if u_star is None or it_j <= NOISE_ITERS:
        assert it_t == it_j and bool(pick(got.converged)) == bool(want.converged), (it_t, it_j)
        np.testing.assert_allclose(u_t, u_j, rtol=0, atol=1e-9)
    else:
        assert np.abs(u_t - u_star).max() <= radius and np.abs(u_j - u_star).max() <= radius


def test_op_en2_ball():
    cfg = dict(tol=1e-6, max_iter=200, lbfgs_mem=10)
    want = jpn.panoc_solve(jpn.PanocConfig(**cfg), lambda u: u[0] ** 2 + u[1] ** 2, jpn.ball2_projection(1.0),
                           jnp.zeros(2))
    got = tpn.panoc_solve(tpn.PanocConfig(**cfg), lambda u: u[..., 0] ** 2 + u[..., 1] ** 2,
                          tpn.ball2_projection(1.0), torch.zeros(2, dtype=F64))
    assert_same_result(got, want)
    assert bool(got.converged) and got.iterations.dtype == torch.int32


def test_ball_with_the_minimum_outside():
    cfg = dict(tol=1e-8, max_iter=300, lbfgs_mem=10)
    want = jpn.panoc_solve(jpn.PanocConfig(**cfg), lambda u: jnp.sum((u - jnp.asarray([2.0, 2.0])) ** 2),
                           jpn.ball2_projection(1.0), jnp.zeros(2))
    target = torch.tensor([2.0, 2.0], dtype=F64)
    got = tpn.panoc_solve(tpn.PanocConfig(**cfg), lambda u: ((u - target) ** 2).sum(-1), tpn.ball2_projection(1.0),
                          torch.zeros(2, dtype=F64))
    assert_same_result(got, want)
    np.testing.assert_allclose(got.u.numpy(), [np.sqrt(0.5)] * 2, atol=1e-5)


def _box_quadratic(seed=0, n=6):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n))
    return a @ a.T + n * np.eye(n), rng.normal(size=n)


def test_box_quadratic():
    h, b = _box_quadratic()
    cfg = dict(tol=1e-9, max_iter=500, lbfgs_mem=10)
    hj, bj = jnp.asarray(h), jnp.asarray(b)
    want = jpn.panoc_solve(jpn.PanocConfig(**cfg), lambda u: 0.5 * u @ (hj @ u) + bj @ u,
                           jpn.box_projection(-0.2, 0.2), jnp.zeros(6))
    ht, bt = torch.tensor(h), torch.tensor(b)
    got = tpn.panoc_solve(tpn.PanocConfig(**cfg), lambda u: 0.5 * (u * (u @ ht.T)).sum(-1) + (u * bt).sum(-1),
                          tpn.box_projection(-0.2, 0.2), torch.zeros(6, dtype=F64))
    assert_same_result(got, want)
    assert bool(got.converged)


def test_max_iter_zero_returns_the_warm_start():
    u0 = torch.tensor([0.3, -0.1], dtype=F64)
    res = tpn.panoc_solve(tpn.PanocConfig(max_iter=0), lambda u: (u * u).sum(-1), tpn.box_projection(-1.0, 1.0), u0)
    assert int(res.iterations) == 0 and not bool(res.converged) and torch.equal(res.u, u0)
    assert float(res.fpr_norm) == float("inf")


QP_CONFIGS = {"op-mpc-x-calc": dict(tol=1e-6, max_iter=80, lbfgs_mem=20),
              "qp-fleet": dict(tol=1e-5, max_iter=60, lbfgs_mem=10)}


@pytest.fixture(scope="module")
def condensed():
    a, b = jdyn.linear_ab(JParams.single_wheel(), 0.1)
    jq = jqp.build_condensed_qp(a, b, np.diag([5.0, 5.0, 1.0, 1.0]), 8)
    tq = tqp.CondensedQp.from_numpy(*jq)
    return (jqp.make_qp_value_and_grad(jq, jref.make_gen_ref_raised_cosine(8)),
            tqp.make_qp_value_and_grad(tq, tref.make_gen_ref_raised_cosine(8)), tq)


@pytest.mark.parametrize("config", list(QP_CONFIGS))
def test_condensed_qp_states(condensed, config):
    """16 states around op-mpc-x-calc's start, all in one batched port
    solve, each against the JAX package's jitted solve; a solve past 30
    iterations against the exact optimum (the float64 Newton solve)."""
    vj, vt, tq = condensed
    cfg = QP_CONFIGS[config]
    r = np.random.default_rng(21)
    xs = np.array([0.5, 0.0, 0.1, 0.0]) + r.normal(size=(16, 4)) * np.array([1.0, 0.5, 0.1, 0.5])
    us = r.normal(size=(16, 8)) * np.where(np.arange(16) % 2 == 0, 0.0, 2.0)[:, None]  # half warm-started
    jcfg = jpn.PanocConfig(**cfg)
    one = jax.jit(lambda x, u: jpn.panoc_solve(jcfg, None, jpn.box_projection(-30.0, 30.0), u, value_and_grad=vj(x)))
    got = tpn.panoc_solve(tpn.PanocConfig(**cfg), None, tpn.box_projection(-30.0, 30.0), torch.tensor(us),
                          value_and_grad=vt(torch.tensor(xs)))
    xt = torch.tensor(xs)
    b = tqp.qp_linear_term(tq, xt, tref.make_gen_ref_raised_cosine(8)(xt).flatten(-2))
    u_star = tqp.box_qp_newton(tq.h, b, torch.zeros(16, 8, dtype=F64), -30.0, 30.0).numpy()
    n_clean = 0
    for i in range(16):
        want = one(jnp.asarray(xs[i]), jnp.asarray(us[i]))
        n_clean += int(want.iterations) <= NOISE_ITERS
        assert_same_result(got, want, i, u_star[i], optimum_radius(tq.h, cfg["tol"]))
    assert n_clean >= 10
    assert len(set(got.iterations.tolist())) > 1


def _stiff(u, xp):
    soft = 0.5 * (u * u).sum(-1)
    stiff = 50.0 * (xp.maximum(xp.abs(u) - 0.5, 0.0) ** 2).sum(-1)
    return soft + stiff + 0.3 * u[..., 0]


@pytest.mark.parametrize("period", [0, 7])
def test_gamma_backtracking_flush_and_recovery(period):
    """``tests/test_panoc.py:360-371``'s stiff cost from γ₀ = 0.5, far
    above 1/L: γ halves in the backtrack (the L-BFGS memory is flushed on
    each change), and with ``gamma_recovery_period`` it is doubled again
    every 7 iterations and backtracked anew."""
    cfg = dict(tol=1e-9, max_iter=400, lbfgs_mem=8, gamma_init=0.5, gamma_recovery_period=period)
    u0 = np.array([1.8, -1.7, 1.6, -1.5])
    want = jpn.panoc_solve(jpn.PanocConfig(**cfg), lambda u: _stiff(u, jnp), jpn.box_projection(-2.0, 2.0),
                           jnp.asarray(u0))
    zero = torch.zeros((), dtype=F64)

    class T:  # torch in the numpy spelling _stiff uses
        maximum = staticmethod(lambda a, b: torch.maximum(a, zero + b))
        abs = staticmethod(torch.abs)

    got = tpn.panoc_solve(tpn.PanocConfig(**cfg), lambda u: _stiff(u, T), tpn.box_projection(-2.0, 2.0),
                          torch.tensor(u0))
    assert_same_result(got, want)
    assert bool(got.converged) and float(got.gamma) <= 0.5 / 32  # γ was backtracked from γ₀


def _tracking(pkg):
    """The nonlinear cart-pole's tracking rollout cost (``tests/test_panoc.py:80-95``)."""
    if pkg == "jax":
        step = as_vector_fn(jdyn.make_cartpole_nonlinear(JParams.single_wheel(), 0.01), 4)
        return step, jcosts.make_tracking_rollout_cost(step, jref.make_planning_err(JParams.single_wheel().l),
                                                       [0.0, 9.2, 16.0, 0.5, 0.0])
    step = tdyn.as_vector_fn(tdyn.make_cartpole_nonlinear(TParams.single_wheel(), 0.01), 4)
    return step, tcosts.make_tracking_rollout_cost(step, tref.make_planning_err(TParams.single_wheel().l),
                                                   [0.0, 9.2, 16.0, 0.5, 0.0])


def test_autodiff_matches_jax_value_and_grad():
    _, cj = _tracking("jax")
    _, ct = _tracking("torch")
    x0 = np.array([0.5, 0.0, 0.1, 0.0])
    u = np.random.default_rng(1).normal(size=10) * 0.5
    fj, gj = jax.value_and_grad(lambda uu: cj(jnp.asarray(x0), uu))(jnp.asarray(u))
    xt = torch.tensor(x0)
    ft, gt = tpn.autograd_value_and_grad(lambda uu: ct(xt, uu))(torch.tensor(u))
    assert abs(float(ft) - float(fj)) <= 1e-12 * abs(float(fj))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-10, atol=1e-12)
    cfg = dict(tol=1e-6, max_iter=15, lbfgs_mem=10)
    want = jpn.panoc_solve(jpn.PanocConfig(**cfg), lambda uu: cj(jnp.asarray(x0), uu), jpn.box_projection(-5.0, 5.0),
                           jnp.asarray(u))
    got = tpn.panoc_solve(tpn.PanocConfig(**cfg), lambda uu: ct(xt, uu), tpn.box_projection(-5.0, 5.0),
                          torch.tensor(u))
    assert_same_result(got, want)


def test_fd_oracles_match_jax():
    sj, cj = _tracking("jax")
    st, ct = _tracking("torch")
    rng = np.random.default_rng(73)
    x = rng.uniform(-1.0, 1.0, 4) * np.array([3.0, 1.0, 0.5, 1.0])
    u = rng.uniform(-3.0, 3.0, 10)
    fj, gj = jpn.make_fd_value_and_grad(lambda uu: cj(jnp.asarray(x), uu), eps=1e-3)(jnp.asarray(u))
    ft, gt = tpn.make_fd_value_and_grad(lambda uu: ct(torch.tensor(x), uu), eps=1e-3)(torch.tensor(u))
    assert abs(float(ft) - float(fj)) <= 1e-12 * abs(float(fj))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0, atol=1e-10)
    fj, gj = jpn.make_shifted_fd_value_and_grad(cj, sj, eps=1e-3)(jnp.asarray(x))(jnp.asarray(u))
    ft, gt = tpn.make_shifted_fd_value_and_grad(ct, st, eps=1e-3)(torch.tensor(x))(torch.tensor(u))
    assert abs(float(ft) - float(fj)) <= 1e-12 * abs(float(fj))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0, atol=1e-10)
    # the quirk: the pre-stepped differences are not the cost's own gradient
    assert float((gt - tpn.make_fd_value_and_grad(lambda uu: ct(torch.tensor(x), uu))(torch.tensor(u))[1])
                 .abs().max()) > 1e-6


def _quadratic_batch():
    """``tests/test_panoc.py:220-231``: five box QPs."""
    rng = np.random.default_rng(7)
    hs, bs = [], []
    for _ in range(5):
        a = rng.normal(size=(6, 6))
        hs.append(a @ a.T + 4 * np.eye(6))
        bs.append(rng.normal(size=6))
    return np.array(hs), np.array(bs)


def test_batch_equals_its_lanes_and_the_jax_vmap():
    hs, bs = _quadratic_batch()
    cfg = dict(tol=1e-8, max_iter=300, lbfgs_mem=10)

    def t_cost(h, b):
        return lambda u: 0.5 * (u * (u[..., None, :] * h).sum(-1)).sum(-1) + (b * u).sum(-1)

    proj = tpn.box_projection(-0.5, 0.5)
    got = tpn.panoc_solve(tpn.PanocConfig(**cfg), t_cost(torch.tensor(hs), torch.tensor(bs)), proj,
                          torch.zeros(5, 6, dtype=F64))
    iters = got.iterations.tolist()
    assert len(set(iters)) > 1  # the lanes stop at different iterations
    for i in range(5):
        lane = tpn.panoc_solve(tpn.PanocConfig(**cfg), t_cost(torch.tensor(hs[i]), torch.tensor(bs[i])), proj,
                               torch.zeros(6, dtype=F64))
        assert int(lane.iterations) == iters[i] and bool(lane.converged) == bool(got.converged[i])
        np.testing.assert_allclose(got.u[i].numpy(), lane.u.numpy(), rtol=0, atol=1e-12)
        assert float(got.gamma[i]) == float(lane.gamma)

    def solve_one(h, b):
        return jpn.panoc_solve(jpn.PanocConfig(**cfg), lambda u: 0.5 * u @ (h @ u) + b @ u,
                               jpn.box_projection(-0.5, 0.5), jnp.zeros(6))

    want = jax.vmap(solve_one)(jnp.asarray(hs), jnp.asarray(bs))
    assert got.iterations.tolist() == np.asarray(want.iterations).tolist()
    for i in range(5):  # each lane within 1e-9 of the JAX solve, and of the JAX vmap but for its own spread
        one = jax.jit(solve_one)(jnp.asarray(hs[i]), jnp.asarray(bs[i]))
        np.testing.assert_allclose(got.u[i].numpy(), np.asarray(one.u), rtol=0, atol=1e-9)
        spread = float(np.abs(np.asarray(one.u) - np.asarray(want.u[i])).max())
        np.testing.assert_allclose(got.u[i].numpy(), np.asarray(want.u[i]), rtol=0, atol=max(1e-9, 2 * spread))


def test_lbfgs_two_loop_and_push_match_jax():
    """The ring memory read from slot idx − 1 backwards, with a wrapped idx,
    a partly empty memory, and the skip of slots a caller knows are empty."""
    rng = np.random.default_rng(5)
    m, n = 6, 5
    s, y = rng.normal(size=(m, n)), rng.normal(size=(m, n))
    y += 2.0 * s  # sᵀy > 0 mostly
    rho = 1.0 / (s * y).sum(-1)
    g = rng.normal(size=n)
    for idx, filled in ((9, m), (3, 3), (0, 0)):
        keep = np.zeros(m, bool)
        keep[[(idx - 1 - j) % m for j in range(filled)]] = True
        sk, yk, rk = s * keep[:, None], y * keep[:, None], rho * keep
        want = jpn._lbfgs_direction(jpn.LbfgsMem(jnp.asarray(sk), jnp.asarray(yk), jnp.asarray(rk), jnp.int32(idx)),
                                    jnp.asarray(g))
        mem = tpn.LbfgsMem(torch.tensor(sk), torch.tensor(yk), torch.tensor(rk), torch.tensor(idx))
        full = tpn._lbfgs_direction(mem, torch.tensor(g))
        np.testing.assert_allclose(full.numpy(), np.asarray(want), rtol=1e-13, atol=1e-13)
        np.testing.assert_allclose(tpn._lbfgs_direction(mem, torch.tensor(g), n_used=filled).numpy(), full.numpy(),
                                   rtol=1e-14, atol=1e-15)
        for sv, yv in ((s[0], y[0]), (s[1], -y[1])):  # accepted, rejected (sᵀy < 0)
            pj = jpn._lbfgs_push(jpn.LbfgsMem(jnp.asarray(sk), jnp.asarray(yk), jnp.asarray(rk), jnp.int32(idx)),
                                 jnp.asarray(sv), jnp.asarray(yv))
            pt = tpn._lbfgs_push(mem, torch.tensor(sv), torch.tensor(yv))
            for a, b in zip(pt, pj):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-15, atol=0)
