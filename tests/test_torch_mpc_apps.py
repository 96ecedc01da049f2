"""The port's gradient-MPC apps (``mpc_rs_tpu_torch/apps/mpc_examples.py``)
against the JAX package's (``mpc_rs_tpu/apps/mpc_examples.py``), float64 on
the CPU, on the same numpy inputs and noise.

- ``op-en2``: the JAX result and printout.
- ``op-mpc-x-calc``: the whole 51-tick CSV within 1e-8, the same verdict.
- ``op-mpc-x-calc-nl``: each of the 51 ticks from the JAX app's state: where
  the JAX solve is done within 30 iterations, the same iterations and u
  within 1e-9; past that a condensed-QP solve is noise-driven (the JAX
  package's own jitted and ``vmap``-ed solves part by up to 1e-6 there,
  ``tests/test_torch_panoc.py``), and both are held within 2·√n·tol/λ_min(2H)
  ≈ 4.5e-5 of the exact optimum. The two whole trajectories: within 1e-5,
  the same verdict.
- ``op-mpc-x`` (a solve takes seconds on the CPU): its loop for 3 ticks at
  a budget of 8 iterations against the JAX loop, CSV within 1e-9 (1e-8
  with ``--fd``, whose differences divide the cost's rounding by 2e-3); one full-budget tick (60 iterations) from the JAX state,
  where the 50-step quartic cost amplifies last-bit differences about
  1e7-fold from iteration ~15 on: the same iterations, the cost within 1e-8
  relative, u within 1e-5.
- ``mpc-ukf-x``: the app's first 11 ticks (``--t-end 0.5``) against the JAX
  app's CSV within 1e-8 (the same numpy noise), and each tick's solve and
  filter step from the JAX state within 1e-8 and 1e-10.
- ``mpc-ukf-s``: 0.3 s of the multi-rate loop (60 solves): the true state
  and control within 1e-8 of the JAX app's; each solve from the same
  inputs within 1e-5 (the QP's cost is ~2e5: noise-driven within ~10
  iterations) and each filter step in float64 within 1e-7; the app's
  float32 α = 1e-3 filter parts from the JAX one by O(1) in a step in both
  directions of rounding, so it is held to finite values.
"""

import contextlib
import io
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_rs_tpu.apps import mpc_examples as jme
from mpc_rs_tpu.apps.run import main as jax_main
from mpc_rs_tpu.controllers import panoc as jpn
from mpc_rs_tpu.controllers import qp as jqp
from mpc_rs_tpu.estimators import ukf as jukf
from mpc_rs_tpu.models import costs as jcosts
from mpc_rs_tpu.models import dynamics as jdyn
from mpc_rs_tpu.models import noise as jnoise
from mpc_rs_tpu.models import observation as jobs
from mpc_rs_tpu.models import reference as jref
from mpc_rs_tpu.models.params import CartPoleParams as JParams
from mpc_rs_tpu.utils import as_vector_fn
from mpc_rs_tpu_torch.apps import mpc_examples as tme
from mpc_rs_tpu_torch.apps import run as cli
from mpc_rs_tpu_torch.controllers import qp as tqp
from mpc_rs_tpu_torch.models import reference as tref

F64 = torch.float64
NOISE_ITERS = 30
RADIUS = 2.0 * np.sqrt(8) * 1e-6 / 0.1253964616268916  # 2·√n·tol/λ_min(2H) ≈ 4.5e-5: a tol-1e-6 stop's reach


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = main(argv)
    return ret, buf.getvalue()


def _csv(path):
    return np.loadtxt(path, delimiter=",", ndmin=2)


def chk_parks(x, out):  # mpc_rs_tpu/apps/acceptance.py:55-60
    return bool(np.isfinite(x).all() and "over pi/2" not in out and "Error:" not in out
                and abs(x[0]) < 0.3 and abs(x[2]) < 0.1)


def test_registry_has_the_gradient_mpc_apps_and_they_take_the_card_by_default(tmp_path):
    from mpc_rs_tpu_torch.apps import registry

    assert {"op-en2", "op-mpc-x", "op-mpc-x-calc", "op-mpc-x-calc-nl", "mpc-ukf-x", "mpc-ukf-s"} <= set(registry.EXAMPLES)
    assert cli.build_parser().parse_args(["op-mpc-x", "--fd", "--max-iter", "7"]).max_iter == 7
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["op-mpc-x-calc", "--fd"])  # op-mpc-x's option only
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device runs")
    for app in ("op-en2", "op-mpc-x-calc-nl", "mpc-ukf-s"):
        argv = [app] + ([] if app == "op-en2" else ["--log-dir", str(tmp_path)])
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main(argv)


def test_linear_rollout_is_the_stepped_rollout_and_the_jax_cost():
    """op-mpc-x's cost on ``linear_rollout`` (two matmuls) against the same
    cost stepped one state at a time and the JAX package's scan, with its
    gradient, on a batch and on one sequence."""
    from mpc_rs_tpu_torch.controllers.panoc import autograd_value_and_grad
    from mpc_rs_tpu_torch.models import costs as tcosts
    from mpc_rs_tpu_torch.models import dynamics as tdyn
    from mpc_rs_tpu_torch.models.params import CartPoleParams as TParams

    p = TParams.single_wheel_light()
    step = tdyn.as_vector_fn(tdyn.make_cartpole_linear(p, 0.01), 4)
    args = (step, tref.make_planning_err(p.l), [0.0, 9.2, 16.0, 0.5, 0.0])
    fast = tcosts.make_tracking_rollout_cost(*args, rollout=tme.linear_rollout(step, 50))
    stepped = tcosts.make_tracking_rollout_cost(*args)
    rng = np.random.default_rng(4)
    x0, u = rng.normal(size=(3, 4)) * np.array([3.0, 1.0, 0.5, 1.0]), rng.uniform(-10.0, 10.0, (3, 50))
    xt, ut = torch.tensor(x0), torch.tensor(u)
    np.testing.assert_allclose(tme.linear_rollout(step, 50)(xt, ut).numpy(),
                               tcosts.rollout_states(step, xt, ut).numpy(), rtol=1e-12, atol=1e-12)
    fv, fg = autograd_value_and_grad(lambda uu: fast(xt, uu))(ut)
    sv, sg = autograd_value_and_grad(lambda uu: stepped(xt, uu))(ut)
    np.testing.assert_allclose(fv.numpy(), sv.numpy(), rtol=1e-12)
    np.testing.assert_allclose(fg.numpy(), sg.numpy(), rtol=1e-10, atol=1e-10)
    jp = JParams.single_wheel_light()
    jstep = as_vector_fn(jdyn.make_cartpole_linear(jp, 0.01), 4)
    jcost = jcosts.make_tracking_rollout_cost(jstep, jref.make_planning_err(jp.l), [0.0, 9.2, 16.0, 0.5, 0.0])
    for i in range(3):
        jv, jg = jax.value_and_grad(lambda uu: jcost(jnp.asarray(x0[i]), uu))(jnp.asarray(u[i]))
        one_v, one_g = autograd_value_and_grad(lambda uu: fast(xt[i], uu))(ut[i])
        assert abs(float(one_v) - float(jv)) <= 1e-12 * abs(float(jv))
        np.testing.assert_allclose(one_g.numpy(), np.asarray(jg), rtol=1e-10, atol=1e-10)


def test_op_en2_matches_jax():
    want, jout = _run(jax_main, ["op-en2"])
    got, tout = _run(cli.main, ["op-en2", "--device", "cpu"])
    assert int(got.iterations) == int(want.iterations) and bool(got.converged) == bool(want.converged)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u), rtol=0, atol=1e-9)
    assert tout == jout


def test_op_mpc_x_calc_trajectory_matches_jax(tmp_path):
    jx, jout = _run(jax_main, ["op-mpc-x-calc", "--log-dir", str(tmp_path / "j")])
    got, tout = _run(cli.main, ["op-mpc-x-calc", "--device", "cpu", "--log-dir", str(tmp_path / "t")])
    a, b = _csv(tmp_path / "j/op-mpc-x/op-mpc-x.csv"), _csv(tmp_path / "t/op-mpc-x/op-mpc-x.csv")
    assert a.shape == b.shape == (51, 10) and got.ticks == 51
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-8)
    assert chk_parks(got.x, tout) and chk_parks(np.asarray(jx), jout)
    assert len(got.log.iterations) == 51 and max(got.log.iterations) <= 80


def _calc_nl_jax_states():
    """The JAX op-mpc-x-calc-nl loop's (x, u warm start, its solve) at each
    tick (``mpc_examples.py:97-152``), and its plant."""
    p = JParams.single_wheel()
    a, b = jdyn.linear_ab(p, 0.1)
    qp = jqp.build_condensed_qp(a, b, np.diag([5.0, 5.0, 1.0, 1.0]), 8)
    vgf = jqp.make_qp_value_and_grad(qp, jref.make_gen_ref_raised_cosine(8))
    cfg = jpn.PanocConfig(tol=1e-6, max_iter=80, lbfgs_mem=20)
    solve = jax.jit(lambda x, u: jpn.panoc_solve(cfg, None, jpn.box_projection(-30.0, 30.0), u, value_and_grad=vgf(x)))
    plant = as_vector_fn(jdyn.make_cartpole_nonlinear(p, 0.1), 4)
    x, u, out = np.array([0.5, 0.0, 0.1, 0.0]), jnp.zeros(8), []
    for _ in range(51):
        res = solve(jnp.asarray(x), u)
        out.append((x, np.asarray(u), res))
        u = res.u
        x = np.array(plant(jnp.asarray(x), float(u[0])))
    return out, plant


def test_op_mpc_x_calc_nl_ticks_and_trajectory_match_jax(tmp_path):
    solve, (a, b) = tme.op_mpc_x_calc_controller("cpu")
    qp = tqp.build_condensed_qp(a, b, np.diag([5.0, 5.0, 1.0, 1.0]), 8)
    gen_ref = tref.make_gen_ref_raised_cosine(8)
    n_clean = 0
    states, plant = _calc_nl_jax_states()
    for x, u, want in states:
        got = solve(torch.tensor(x), torch.tensor(u))
        if int(want.iterations) <= NOISE_ITERS:
            n_clean += 1
            assert int(got.iterations) == int(want.iterations)
            np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u), rtol=0, atol=1e-9)
        else:
            xt = torch.tensor(x)
            u_star = tqp.box_qp_newton(qp.h, tqp.qp_linear_term(qp, xt, gen_ref(xt).flatten(-2)),
                                       torch.zeros(8, dtype=F64), -30.0, 30.0).numpy()
            assert np.abs(got.u.numpy() - u_star).max() <= RADIUS and np.abs(np.asarray(want.u) - u_star).max() <= RADIUS
    assert n_clean >= 40
    # the whole trajectory against the JAX loop's (the app's, mpc_examples.py:127-152)
    got, tout = _run(cli.main, ["op-mpc-x-calc-nl", "--device", "cpu", "--log-dir", str(tmp_path)])
    b_ = _csv(tmp_path / "op-mpc-x/op-mpc-x.csv")
    assert b_.shape == (51, 10)
    u0s = [float(want.u[0]) for _, _, want in states]
    xs = [x for x, _, _ in states[1:]] + [np.array(plant(jnp.asarray(states[-1][0]), u0s[-1]))]
    np.testing.assert_allclose(b_[:, 1], u0s, rtol=0, atol=1e-5)
    np.testing.assert_allclose(b_[:, 2:6], np.array(xs), rtol=0, atol=1e-5)
    assert chk_parks(got.x, tout) and chk_parks(xs[-1], "")


def _op_mpc_x_jax_tick(max_iter, fd):
    """The JAX op-mpc-x tick (``mpc_examples.py:51-73``) at a budget."""
    p = JParams.single_wheel_light()
    step = as_vector_fn(jdyn.make_cartpole_linear(p, 0.01), 4)
    cost = jcosts.make_tracking_rollout_cost(step, jref.make_planning_err(p.l), [0.0, 9.2, 16.0, 0.5, 0.0],
                                             barrier=1.0)
    cfg = jpn.PanocConfig(tol=1e-6, max_iter=max_iter, lbfgs_mem=20)
    ref_fd = jpn.make_shifted_fd_value_and_grad(cost, step, eps=1e-3)

    @jax.jit
    def tick(x, u):
        return jpn.panoc_solve(cfg, lambda uu: cost(x, uu), jpn.box_projection(-30.0, 30.0), u,
                               value_and_grad=ref_fd(x) if fd else None)

    return tick, step


@pytest.mark.parametrize("fd", [False, True])
def test_op_mpc_x_loop_matches_the_jax_loop_at_a_short_budget(tmp_path, fd):
    tick, step = _op_mpc_x_jax_tick(8, fd)
    x, u, rows = np.array([3.0, 0.0, -0.7, 0.0]), jnp.zeros(50), []
    for i in range(3):  # mpc_examples.py:79-93, the JAX loop's body
        with contextlib.redirect_stdout(io.StringIO()):
            u = jme._retry_solve(lambda uu: tick(jnp.asarray(x), uu), u, 30.0)
        x_est = np.array(x)
        for e in np.array(u):
            x_est = np.array(step(jnp.asarray(x_est), float(e)))
        x = np.array(step(jnp.asarray(x), float(u[0])))
        rows.append(np.concatenate([[i * 0.01, float(u[0])], x, x_est]))
    args = types.SimpleNamespace(device="cpu", max_iter=8, fd=fd, log_dir=str(tmp_path))
    with contextlib.redirect_stdout(io.StringIO()):
        got = tme.run_op_mpc_x(args, max_ticks=3)
    assert got.ticks == 3 and got.log.iterations == [8, 8, 8]
    # the finite differences divide the cost's rounding (|f| ~ 3e3) by 2e-3
    np.testing.assert_allclose(_csv(tmp_path / "op-mpc-x/op-mpc-x.csv"), np.array(rows), rtol=0,
                               atol=1e-8 if fd else 1e-9)


def test_op_mpc_x_full_budget_tick_matches_jax():
    tick, _ = _op_mpc_x_jax_tick(60, False)
    x0 = np.array([3.0, 0.0, -0.7, 0.0])
    want = tick(jnp.asarray(x0), jnp.zeros(50))
    solve, _ = tme.op_mpc_x_controller("cpu")
    got = solve(torch.tensor(x0), torch.zeros(50, dtype=F64))
    assert int(got.iterations) == int(want.iterations) == 60
    assert abs(float(got.cost) - float(want.cost)) <= 1e-8 * abs(float(want.cost))
    assert np.abs(got.u.numpy() - np.asarray(want.u)).max() <= 1e-5


def test_mpc_ukf_x_matches_jax(tmp_path):
    jx, jout = _run(jax_main, ["mpc-ukf-x", "--t-end", "0.5", "--log-dir", str(tmp_path / "j")])
    got, tout = _run(cli.main, ["mpc-ukf-x", "--device", "cpu", "--t-end", "0.5", "--log-dir", str(tmp_path / "t")])
    a, b = _csv(tmp_path / "j/op-mpc-x/op-mpc-x.csv"), _csv(tmp_path / "t/op-mpc-x/op-mpc-x.csv")
    assert a.shape == b.shape == (11, 18) and got.ticks == 11
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.x, np.asarray(jx), rtol=0, atol=1e-8)
    # each tick's solve and filter step from the JAX state (the JAX app's
    # own closures, rebuilt as mpc_examples.py:164-202 builds them)
    solve, step, _, hx, est0, est_step = tme.mpc_ukf_x_parts("cpu")
    p = JParams.single_wheel_heavy_j()
    jstep = as_vector_fn(jdyn.make_cartpole_linear(p, 0.05), 4)
    q = jnp.asarray([[0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 1.0]])
    params, jest = jukf.ukf_init(jnp.asarray([0.5, 0.0, -0.15, 0.0]), 10.0 * jnp.eye(4), q,
                                 jnp.asarray([[0.75, 0.75], [0.75, 0.75]]))
    jhx = jobs.make_hx_vel2()
    rng = np.random.default_rng(0)
    for i in range(4):
        u = rng.normal(size=10)
        z = rng.normal(size=2)
        jnext = jukf.ukf_update(params, jukf.ukf_predict(params, jest, float(u[0]), jstep), jnp.asarray(z), jhx)
        test_state = est0._replace(x=torch.tensor(np.asarray(jest.x)), p=torch.tensor(np.asarray(jest.p)))
        tnext = est_step(test_state, float(u[0]), torch.tensor(z))
        np.testing.assert_allclose(tnext.x.numpy(), np.asarray(jnext.x), rtol=0, atol=1e-10)
        np.testing.assert_allclose(tnext.p.numpy(), np.asarray(jnext.p), rtol=1e-10, atol=1e-10)
        jest = jnext
    assert i == 3


def test_mpc_ukf_s_matches_jax(tmp_path):
    jres, _ = _run(jax_main, ["mpc-ukf-s", "--t-end", "0.3", "--log-dir", str(tmp_path / "j")])
    got, _ = _run(cli.main, ["mpc-ukf-s", "--device", "cpu", "--t-end", "0.3", "--log-dir", str(tmp_path / "t")])
    assert got.n_solves == jres.n_solves == 60 and not got.tipped
    a, b = _csv(tmp_path / "j/mpc-ukf/mpc-ukf.csv"), _csv(tmp_path / "t/mpc-ukf/mpc-ukf.csv")
    assert a.shape == b.shape and a.shape[1] == 20 and np.isfinite(b).all()
    # the controller sees the true state (DEBUG_UKF): t, u and the state agree
    np.testing.assert_allclose(b[:, :8], a[:, :8], rtol=0, atol=1e-8)


@pytest.mark.parametrize("est_dtype", ["float32", "float64"])
def test_mpc_ukf_s_solve_and_filter_steps_match_jax(est_dtype):
    """Each solve and filter step from the same inputs. The two-wheel QP's
    cost is ~2e5, so its FBE decreases fall below f's rounding within ~10
    iterations: u within 1e-5 (measured ≤ 4.8e-6), iterations not held.
    The filter: in float64 within 1e-7 (α = 1e-3 weights of ~1.7e5 amplify
    the last bits); the app's float32 one parts from the JAX package's by
    O(1) within one step, for the same reason (ROADMAP §3), so it is held
    to its dtype and finite values."""
    jdt, tdt = getattr(jnp, est_dtype), getattr(torch, est_dtype)
    solve, _, _, est0, est_step = tme.mpc_ukf_s_parts("cpu", est_dtype=tdt)
    p = JParams.two_wheel()
    a_, b_ = jdyn.linear_ab(p, 0.15, two_wheel=True)
    qp = jqp.build_condensed_qp(a_, b_, np.diag([1.0, 1.0, 10.0, 5.0]), 8)
    vgf = jqp.make_qp_value_and_grad(qp, jref.make_gen_ref_zero(8))
    cfg = jpn.PanocConfig(tol=1e-6, max_iter=60, lbfgs_mem=20)
    jsolve = jax.jit(lambda x, u: jpn.panoc_solve(cfg, None, jpn.box_projection(-10.0, 10.0), u, value_and_grad=vgf(x)))
    jplant6 = jdyn.make_accel6(p, with_force=True)
    jhx = jobs.make_hx_imu6(p)
    r_diag = np.array([200.0, 200.0, 10.0, 0.05, 0.05])
    params, jest = jukf.ukf_init(jnp.zeros(6, jdt), 10.0 * jnp.eye(6, dtype=jdt), jnoise.gen_q6(jdt(0.15)),
                                 jnp.diag(jnp.asarray(r_diag, jdt)))

    @jax.jit
    def jest_step(state, u, z, dt_est):
        def fxd(xv, uu):
            out = jplant6(*(xv[..., i] for i in range(6)), uu, dt_est, 0.0)
            return jnp.stack(jnp.broadcast_arrays(*out), axis=-1)

        state = state._replace(q=jnoise.gen_q6(dt_est).astype(state.q.dtype))
        return jukf.ukf_update(params, jukf.ukf_predict(params, state, u, fxd), z, jhx)

    rng = np.random.default_rng(2)
    for _ in range(3):
        x4, u0 = rng.normal(size=4) * np.array([0.3, 0.3, 0.1, 0.3]), rng.normal(size=8)
        if est_dtype == "float64":
            res = solve(torch.tensor(x4), torch.tensor(u0))
            want = jsolve(jnp.asarray(x4), jnp.asarray(u0))
            assert np.abs(res.u.numpy() - np.asarray(want.u)).max() <= 1e-5
        z = np.asarray(jhx(jnp.asarray(rng.normal(size=6) * 0.1, jdt))) + rng.normal(size=5) * r_diag
        jnext = jest_step(jest, float(u0[0]), jnp.asarray(z, jdt), 9e-3)
        state = est0._replace(x=torch.tensor(np.asarray(jest.x)), p=torch.tensor(np.asarray(jest.p)))
        tnext = est_step(state, float(u0[0]), torch.tensor(z, dtype=tdt), 9e-3)
        assert tnext.x.dtype == tdt and torch.isfinite(tnext.x).all()
        if est_dtype == "float64":
            want_x = np.asarray(jnext.x)
            assert np.abs(tnext.x.numpy() - want_x).max() <= 1e-7 * max(1.0, np.abs(want_x).max())
        jest = jnext
