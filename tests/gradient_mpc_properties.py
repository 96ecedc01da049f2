"""Measures the properties of the JAX package's gradient MPC that bound how
closely the port can follow it (ROADMAP.md §3), on the CPU, float64 unless
named, and prints one JSON line each:

    python tests/gradient_mpc_properties.py [--fleet]

- ``calc_nl_ticks``: op-mpc-x-calc-nl's 51 ticks from the JAX app's states:
  the JAX jitted solve against the same solve ``vmap``-ed over a batch of
  one (another compilation of the same function) and against the port's.
- ``qp_states``: the same spread on 16 condensed-QP states at the QP
  fleet's tol 1e-5.
- ``op_mpc_x_tick0``: op-mpc-x's first 60-iteration solve, JAX jit against
  its batch of one and against the port.
- ``newton_f32``: ``tests/test_panoc.py:308-328``'s KKT residual of the
  float32 Newton solve on numpy seed 9's 128 states, and two float32 solves'
  distances from each other and from the float64 solve.
- ``ukf_s_filter_step``: one step of mpc-ukf-s's UKF(6,5) from the same
  state in both packages, float32 and float64.
- ``iteration_ops``: torch calls of one op-mpc-x-calc PANOC iteration.
- with ``--fleet`` (about a minute): the QP fleet's scenarios upright after
  3 s at B=1024 (Newton, JAX seeds 0-3) and at B=512 (float32 PANOC, the
  JAX fleet from its own x0 and from the port's, and the port's).

A script of the tests' directory: it imports both packages, as the tests do.
"""

import json
import sys
from collections import Counter

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.overrides import TorchFunctionMode  # noqa: E402

from mpc_rs_tpu.apps import fleet as jfleet  # noqa: E402
from mpc_rs_tpu.controllers import panoc as jpn  # noqa: E402
from mpc_rs_tpu.controllers import qp as jqp  # noqa: E402
from mpc_rs_tpu.estimators import ukf as jukf  # noqa: E402
from mpc_rs_tpu.models import costs as jcosts  # noqa: E402
from mpc_rs_tpu.models import dynamics as jdyn  # noqa: E402
from mpc_rs_tpu.models import noise as jnoise  # noqa: E402
from mpc_rs_tpu.models import observation as jobs  # noqa: E402
from mpc_rs_tpu.models import reference as jref  # noqa: E402
from mpc_rs_tpu.models.params import CartPoleParams as JParams  # noqa: E402
from mpc_rs_tpu.utils import as_vector_fn  # noqa: E402
from mpc_rs_tpu_torch.apps import fleet as tfleet  # noqa: E402
from mpc_rs_tpu_torch.apps import mpc_examples as tme  # noqa: E402
from mpc_rs_tpu_torch.controllers import qp as tqp  # noqa: E402
from mpc_rs_tpu_torch.models import reference as tref  # noqa: E402


def emit(name, **row):
    print(json.dumps({"property": name, **row}), flush=True)


def _maxabs(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def condensed(tol, max_iter, mem, dtype=jnp.float64):
    a, b = jdyn.linear_ab(JParams.single_wheel(), 0.1)
    qp = jqp.build_condensed_qp(a, b, np.diag([5.0, 5.0, 1.0, 1.0]), 8, dtype=dtype)
    vgf = jqp.make_qp_value_and_grad(qp, jref.make_gen_ref_raised_cosine(8))
    cfg = jpn.PanocConfig(tol=tol, max_iter=max_iter, lbfgs_mem=mem)

    def one(x, u):
        return jpn.panoc_solve(cfg, None, jpn.box_projection(-30.0, 30.0), u, value_and_grad=vgf(x))

    return jax.jit(one), jax.jit(jax.vmap(one))


def calc_nl_ticks():
    one, many = condensed(1e-6, 80, 20)
    solve_t, _ = tme.op_mpc_x_calc_controller("cpu")
    plant = as_vector_fn(jdyn.make_cartpole_nonlinear(JParams.single_wheel(), 0.1), 4)
    x, u, rows = np.array([0.5, 0.0, 0.1, 0.0]), jnp.zeros(8), []
    for i in range(51):
        r1 = one(jnp.asarray(x), u)
        rb = many(jnp.asarray(x)[None], u[None])
        rt = solve_t(torch.tensor(x), torch.tensor(np.asarray(u)))
        rows.append((i, int(r1.iterations), int(rb.iterations[0]), int(rt.iterations),
                     _maxabs(r1.u, rb.u[0]), _maxabs(r1.u, rt.u.numpy())))
        u = r1.u
        x = np.array(plant(jnp.asarray(x), float(u[0])))
    worst = max(rows, key=lambda r: r[4])
    emit("calc_nl_ticks", jit_vs_vmap_max=worst[4], at_tick=worst[0], iterations_there=worst[1:3],
         ticks_with_unequal_jax_iterations=[r[:3] for r in rows if r[1] != r[2]],
         port_vs_jit_max=max(r[5] for r in rows),
         jit_vs_vmap_max_within_30_iterations=max(r[4] for r in rows if r[1] <= 30))


def qp_states():
    one, many = condensed(1e-5, 60, 10)
    r = np.random.default_rng(21)
    xs = np.array([0.5, 0.0, 0.1, 0.0]) + r.normal(size=(16, 4)) * np.array([1.0, 0.5, 0.1, 0.5])
    rb = many(jnp.asarray(xs), jnp.zeros((16, 8)))
    spreads = []
    for i in range(16):
        r1 = one(jnp.asarray(xs[i]), jnp.zeros(8))
        spreads.append((int(r1.iterations), _maxabs(r1.u, rb.u[i])))
    emit("qp_states", tol=1e-5, jit_vs_vmap_max=max(s for _, s in spreads),
         jit_vs_vmap_max_within_30_iterations=max((s for it, s in spreads if it <= 30), default=0.0))


def op_mpc_x_tick0():
    p = JParams.single_wheel_light()
    step = as_vector_fn(jdyn.make_cartpole_linear(p, 0.01), 4)
    cost = jcosts.make_tracking_rollout_cost(step, jref.make_planning_err(p.l), [0.0, 9.2, 16.0, 0.5, 0.0], barrier=1.0)
    cfg = jpn.PanocConfig(tol=1e-6, max_iter=60, lbfgs_mem=20)

    def one(x, u):
        return jpn.panoc_solve(cfg, lambda uu: cost(x, uu), jpn.box_projection(-30.0, 30.0), u)

    x, u = jnp.asarray([3.0, 0.0, -0.7, 0.0]), jnp.zeros(50)
    r1 = jax.jit(one)(x, u)
    rb = jax.jit(jax.vmap(one))(x[None], u[None])
    solve_t, _ = tme.op_mpc_x_controller("cpu")
    rt = solve_t(torch.tensor(np.asarray(x)), torch.zeros(50, dtype=torch.float64))
    emit("op_mpc_x_tick0", iterations=int(r1.iterations), jit_vs_vmap=_maxabs(r1.u, rb.u[0]),
         port_vs_jit=_maxabs(r1.u, rt.u.numpy()), cost_rel=abs(float(rt.cost) / float(r1.cost) - 1.0))


def newton_f32():
    a, b = jdyn.linear_ab(JParams.single_wheel(), 0.1)
    tq = tqp.build_condensed_qp(a, b, np.diag([5.0, 5.0, 1.0, 1.0]), 8)
    tq32 = tqp.CondensedQp(*(v.float() for v in tq))
    rng = np.random.default_rng(9)
    x0 = torch.tensor((np.array([0.5, 0.0, 0.1, 0.0]) + 0.5 * rng.normal(size=(128, 4))).astype(np.float32))
    bvec = tqp.qp_linear_term(tq32, x0, tref.make_gen_ref_raised_cosine(8)(x0).flatten(-2))
    u_t = tqp.box_qp_newton(tq32.h, bvec, torch.zeros(128, 8), -30.0, 30.0, iters=12).numpy()
    u_j = np.asarray(jqp.box_qp_newton(jnp.asarray(tq32.h.numpy()), jnp.asarray(bvec.numpy()),
                                       jnp.zeros((128, 8), jnp.float32), -30.0, 30.0, iters=12))
    u64 = tqp.box_qp_newton(tq.h, bvec.double(), torch.zeros(128, 8, dtype=torch.float64), -30.0, 30.0, iters=12)

    def kkt(u):
        g = 2 * u @ tq32.h.numpy() + bvec.numpy()
        free = (u > -30.0 + 1e-4) & (u < 30.0 - 1e-4)
        return float(np.abs(g * free).max() / max(1.0, np.abs(g).max()))

    emit("newton_f32", kkt_residual_jax=kkt(u_j), kkt_residual_port=kkt(u_t), port_vs_jax=_maxabs(u_t, u_j),
         jax_vs_f64=_maxabs(u_j, u64.numpy()), port_vs_f64=_maxabs(u_t, u64.numpy()))


def ukf_s_filter_step():
    out = {}
    r_diag = np.array([200.0, 200.0, 10.0, 0.05, 0.05])
    p = JParams.two_wheel()
    for name, jd, td in (("float32", jnp.float32, torch.float32), ("float64", jnp.float64, torch.float64)):
        plant6, hx = jdyn.make_accel6(p, with_force=True), jobs.make_hx_imu6(p)
        params, est = jukf.ukf_init(jnp.zeros(6, jd), 10.0 * jnp.eye(6, dtype=jd), jnoise.gen_q6(jd(0.15)),
                                    jnp.diag(jnp.asarray(r_diag, jd)))

        def fxd(xv, uu):
            out_ = plant6(*(xv[..., i] for i in range(6)), uu, 9e-3, 0.0)
            return jnp.stack(jnp.broadcast_arrays(*out_), axis=-1)

        rng = np.random.default_rng(0)
        z = np.asarray(hx(jnp.asarray(rng.normal(size=6) * 0.1, jd))) + rng.normal(size=5) * r_diag
        state = est._replace(q=jnoise.gen_q6(9e-3).astype(jd))
        want = jukf.ukf_update(params, jukf.ukf_predict(params, state, 0.3, fxd), jnp.asarray(z, jd), hx)
        _, _, _, est0, est_step = tme.mpc_ukf_s_parts("cpu", est_dtype=td)
        got = est_step(est0, 0.3, torch.tensor(z, dtype=td), 9e-3)
        out[name] = {"max_abs_diff": _maxabs(got.x.numpy(), want.x), "max_abs_x": float(np.abs(np.asarray(want.x)).max())}
    emit("ukf_s_filter_step", **out)


def iteration_ops():
    solve, _ = tme.op_mpc_x_calc_controller("cpu")

    class Count(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.calls = Counter()

        def __torch_function__(self, func, types, args=(), kwargs=None):
            self.calls[getattr(func, "__name__", str(func))] += 1
            return func(*args, **(kwargs or {}))

    views = {"__get__", "dim", "__getitem__", "reshape", "to", "expand_as", "transpose", "unflatten", "flatten"}
    with Count() as c:
        res = solve(torch.tensor([0.5, 0.0, 0.1, 0.0], dtype=torch.float64), torch.zeros(8, dtype=torch.float64))
    ops = sum(v for k, v in c.calls.items() if k not in views)
    emit("iteration_ops", iterations=int(res.iterations), torch_ops_per_iteration=ops / int(res.iterations))


def fleet_tips():
    rows = []
    for seed in range(4):
        tick, carry, _ = jfleet.build_qp_fleet(1024, seed=seed, solver="newton")
        for _ in range(30):
            carry = tick(carry)
        rows.append(float((np.abs(np.asarray(carry[0])[:, 2]) < np.pi / 2).mean()))
    emit("qp_fleet_newton_b1024_upright", jax_seeds_0_3=rows)
    fl = tfleet.build_qp_fleet(512, "cpu", seed=0, solver="panoc")
    tick, carry, _ = jfleet.build_qp_fleet(512, seed=0, solver="panoc")
    jc_port_x0, jc, tc = (jnp.asarray(fl.carry[0].numpy()), carry[1], carry[2]), carry, fl.carry
    for _ in range(30):
        jc_port_x0, jc, tc = tick(jc_port_x0), tick(jc), fl.tick(tc)
    up = lambda x: float((np.abs(np.asarray(x)[:, 2]) < np.pi / 2).mean())  # noqa: E731
    emit("qp_fleet_panoc_f32_b512_upright", jax_own_x0=up(jc[0]), jax_port_x0=up(jc_port_x0[0]), port=up(tc[0].numpy()))


if __name__ == "__main__":
    for fn in (calc_nl_ticks, qp_states, op_mpc_x_tick0, newton_f32, ukf_s_filter_step, iteration_ops):
        fn()
    if "--fleet" in sys.argv[1:]:
        fleet_tips()
