"""``mpc-ukf-commu`` (the HW gradient-MPC app) against the JAX package's
app, on the CPU, float64, one recorded Sensor3 packet stream step by step.

The estimator: each packet's filter step from the JAX trajectory's state,
the app's own UKF2(6,5) (``make_accel6`` with the cos θ denominator, gen_q6's
default PHY, α = 1e-3), within 1e-8.

The controls: the app's condensed QP at N = 40 (C = diag(0, 0, 10, 3)) has
cond(2H) ≈ 4.0e7 (λ_min 0.164, λ_max 6.6e6), and its PANOC solve does not
reach tol 1e-6 within the 60-iteration budget (43-60 iterations, the
residual up to 0.29). From the fourth iteration on, its γ backtrack and
line search take decisions on differences below the rounding of f
(|f| ≈ 2e6): the port and the JAX package agree to 1e-15 for three
iterations and part at the fourth or later (on this stream: two ticks
of 30 at the third), as the JAX package's own jitted and ``vmap``-ed solves
part (5e-5 at 20 iterations). So no solve ends within 30 iterations, and
none within 2·√n·tol/λ_min(2H) of the optimum, in either package. The
controls are held as far as that allows: every tick's first two
iterations within 1e-12 of the JAX solve's, and every tick's 60-iteration
solve as close to the exact optimum (bounded least squares, BVLS) as the
JAX package's own solves come, in objective (within twice the larger of the
JAX jitted and ``vmap``-ed solves' gaps, plus 1e-9 of |J*|).
"""

import contextlib
import io
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import lsq_linear

from mpc_rs_tpu.controllers.panoc import PanocConfig as JPanocConfig
from mpc_rs_tpu.controllers.panoc import box_projection as jbox
from mpc_rs_tpu.controllers.panoc import panoc_solve as jpanoc
from mpc_rs_tpu.controllers.qp import build_condensed_qp as jbuild_qp
from mpc_rs_tpu.controllers.qp import make_qp_value_and_grad as jmake_vg
from mpc_rs_tpu.estimators import ukf as jukf
from mpc_rs_tpu.models import dynamics as jdyn
from mpc_rs_tpu.models import noise as jnoise
from mpc_rs_tpu.models import observation as jobs
from mpc_rs_tpu.models.params import CartPoleParams as JParams
from mpc_rs_tpu_torch.apps import commu_examples
from mpc_rs_tpu_torch.apps import run as cli
from mpc_rs_tpu_torch.controllers.qp import build_condensed_qp, qp_linear_term
from mpc_rs_tpu_torch.estimators import ukf as tukf
from mpc_rs_tpu_torch.io import packets as pk
from mpc_rs_tpu_torch.models import dynamics as tdyn
from mpc_rs_tpu_torch.models import noise as tnoise
from mpc_rs_tpu_torch.models import reference
from mpc_rs_tpu_torch.models.params import CartPoleParams

JTW = JParams.two_wheel()
N = commu_examples.MPC_COMMU_N
DT = 1.2 / N
R_DIAG = np.array(commu_examples.R_DIAG_COMMU)


def _jax_app(dtype, max_iter=60):
    """(solve, est0, est_step) as ``mpc_rs_tpu/apps/commu_examples.py:312-377``
    builds them, the filter in ``dtype``."""
    a, b = jdyn.linear_ab(JTW, DT, two_wheel=True)
    qp = jbuild_qp(a, b, np.diag([0.0, 0.0, 10.0, 3.0]), N)

    def gen_ref(x):  # :327-334
        phases = jnp.arange(N) * (math.pi / N)
        r0 = x[0] * (1.0 + jnp.cos(phases)) / 2.0
        r1 = jnp.clip(-0.75 * x[0], -2.0, 2.0) * jnp.sin(phases)
        r2 = jnp.clip(-0.5 * x[0], -0.35, 0.35) * jnp.cos(phases) / 2.0
        r3 = jnp.clip(-0.5 * x[0], -1.5, 1.5) * jnp.sin(phases)
        return jnp.stack([r0, r1, r2, r3], axis=-1)

    vg_factory = jmake_vg(qp, gen_ref)
    pcfg = JPanocConfig(tol=1e-6, max_iter=max_iter, lbfgs_mem=20)

    def solve(x, u):
        return jpanoc(pcfg, None, jbox(-10.0, 10.0), u, value_and_grad=vg_factory(x))

    plant6 = jdyn.make_accel6(JTW, with_force=False)
    hx = jobs.make_hx_imu6(JTW)
    r_diag = jnp.asarray(R_DIAG, jnp.float32)
    params, est = jukf.ukf_init(jnp.zeros(6, dtype), 10.0 * jnp.eye(6, dtype=dtype),
                                jnoise.gen_q6(jnp.float32(DT)).astype(dtype), jnp.diag(r_diag).astype(dtype))

    def est_step(state, u, z, dt_est, enable_mask):
        def fxd(xv, uu):
            out = plant6(*(xv[..., i] for i in range(6)), uu, dt_est, 0.0)
            return jnp.stack(jnp.broadcast_arrays(*out), axis=-1)

        state = state._replace(q=jnoise.gen_q6(dt_est).astype(state.q.dtype),
                               r=jnoise.gen_r_mask(r_diag, enable_mask).astype(state.r.dtype))
        state = jukf.ukf_predict(params, state, u, fxd)
        return jukf.ukf_update(params, state, z, jobs.make_masked_hx(hx, enable_mask))

    return jax.jit(solve), jax.jit(jax.vmap(solve)), est, jax.jit(est_step)


def _stream(n_packets, seed=0):
    """(wire bytes, dt) of seeded Sensor3 packets: the fake MCU's truth plant
    (``make_accel6``, cos θ) under a slow control, its float32 IMU with the
    fake MCU's sensor noise, dt jittered around 10 ms, every third packet
    with a random enable mask."""
    rng = np.random.default_rng(seed)
    truth, hx = jdyn.make_accel6(JTW, with_force=False), jobs.make_hx_imu6(JTW)
    x, out = np.zeros(6), []
    for i in range(n_packets):
        u, dt = 0.5 * np.sin(0.3 * i), float(rng.uniform(0.008, 0.012))
        for _ in range(10):
            x = np.array([float(v) for v in truth(*x, u, dt / 10, 0.0)])
        z = np.array(hx(jnp.asarray(x, jnp.float32)))
        z += rng.normal(size=5) * list(commu_examples.SENSOR3_NOISE)
        enable = int(rng.integers(0, 32)) if i % 3 == 0 else 0b11111
        pkt = pk.Sensor3(enable, int(np.clip(z[0], -32768, 32767)), int(np.clip(z[1], -32768, 32767)),
                         float(z[2]), float(z[3]), float(z[4]))
        out.append((pkt.as_cobs(), dt))
    return out


def _port_state(jstate):
    return tukf.UkfState(x=torch.tensor(np.asarray(jstate.x)), p=torch.tensor(np.asarray(jstate.p)),
                         q=torch.tensor(np.asarray(jstate.q)), r=torch.tensor(np.asarray(jstate.r)), sigma_f=None)


def test_the_apps_estimator_matches_jax_step_by_step_in_float64():
    """30 packets, each step from the JAX trajectory's state (the control
    fed back as the app feeds pre_u): x within 1e-8, P within 1e-8 of its
    scale."""
    _, _, jstate, jstep = _jax_app(jnp.float64)
    _, est0, tstep = commu_examples.mpc_ukf_commu_parts("cpu", est_dtype=torch.float64)
    np.testing.assert_array_equal(est0.p.numpy(), np.asarray(jstate.p))
    np.testing.assert_array_equal(est0.q.numpy(), np.asarray(jstate.q))
    for i, (wire, dt) in enumerate(_stream(30)):
        enable, z = pk.Sensor3.from_cobs(wire).parse()
        u = 0.3 * math.sin(0.2 * i)
        want = jstep(jstate, u, jnp.asarray(z, jnp.float64), jnp.float64(dt),
                     jnp.asarray(np.asarray(jnoise.enable_bits_to_mask(enable))))
        got = tstep(_port_state(jstate), u, z, dt, tnoise.enable_bits_to_mask(enable))
        np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(got.p.numpy(), np.asarray(want.p), rtol=1e-8,
                                   atol=1e-8 * np.abs(np.asarray(want.p)).max())
        jstate = want


def test_the_apps_controls_against_jax_on_a_recorded_stream():
    """The filter and the solve along 12 packets of the stream, the JAX app
    driving (its estimate, its warm start): each tick's first two PANOC
    iterations within 1e-12 of the JAX solve's (equal iterations), and the
    60-iteration solve's objective gap within twice the JAX jitted and
    ``vmap``-ed solves' larger gap plus 1e-9·|J*| (module docstring)."""
    jsolve, jsolve_v, jstate, jstep = _jax_app(jnp.float64)
    jsolve2 = _jax_app(jnp.float64, max_iter=2)[0]
    tsolve, _, _ = commu_examples.mpc_ukf_commu_parts("cpu")
    tsolve2, _, _ = commu_examples.mpc_ukf_commu_parts("cpu", max_iter=2)
    a, b = tdyn.linear_ab(CartPoleParams.two_wheel(), DT, two_wheel=True)
    qp = build_condensed_qp(a, b, np.diag([0.0, 0.0, 10.0, 3.0]), N)
    gen_ref = reference.make_gen_ref_raised_cosine(N, velocity_gain=-0.75)
    chol = np.linalg.cholesky(qp.h.numpy())
    u_n, pre_u = np.zeros(N), 0.0
    for wire, dt in _stream(12, seed=1):
        enable, z = pk.Sensor3.from_cobs(wire).parse()
        jstate = jstep(jstate, pre_u, jnp.asarray(z, jnp.float64), jnp.float64(dt),
                       jnp.asarray(np.asarray(jnoise.enable_bits_to_mask(enable))))
        xh = np.asarray(jstate.x)
        x4 = np.array([xh[0], xh[1], xh[3], xh[4]])
        want2, got2 = jsolve2(jnp.asarray(x4), jnp.asarray(u_n)), tsolve2(torch.tensor(x4), torch.tensor(u_n))
        assert int(got2.iterations) == int(want2.iterations)
        np.testing.assert_allclose(got2.u.numpy(), np.asarray(want2.u), rtol=0, atol=1e-12)
        want = jsolve(jnp.asarray(x4), jnp.asarray(u_n))
        want_v = jsolve_v(jnp.asarray(x4)[None], jnp.asarray(u_n)[None])
        got = tsolve(torch.tensor(x4), torch.tensor(u_n))
        xt = torch.tensor(x4)
        lin = qp_linear_term(qp, xt, gen_ref(xt).flatten(-2))
        # the exact optimum: uᵀHu + bᵀu = |Lᵀu + L⁻¹b/2|² + const with H = LLᵀ,
        # a bounded least-squares problem solved exactly (BVLS, an active-set method)
        u_star = lsq_linear(chol.T, -np.linalg.solve(chol, lin.numpy()) / 2.0, bounds=(-10.0, 10.0), method="bvls",
                            tol=1e-14).x

        def objective(v):
            v = torch.tensor(np.array(v), dtype=torch.float64)
            return float(v @ qp.h @ v + lin @ v)

        j_star = objective(u_star)
        jax_gap = max(objective(want.u), objective(want_v.u[0])) - j_star
        assert objective(got.u) - j_star <= 2.0 * jax_gap + 1e-9 * abs(j_star), (objective(got.u), jax_gap, j_star)
        u_n = np.asarray(want.u)
        u0 = float(np.clip(u_n[0], -10.0, 10.0))
        if abs(u0 - pre_u) >= 1e-2:
            pre_u = u0


def test_mpc_ukf_commu_cli_on_the_cpu():
    """``--sim-mcu --t-end 1 --max-iter 8`` on the plain path: solves against
    a fake MCU (at its 60-iteration budget a CPU solve takes 0.1-0.3 s, more
    on a loaded host, so the budget is cut), an int of the solve count, the
    iterations within the budget, the float64 filter finite."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = cli.main(["mpc-ukf-commu", "--device", "cpu", "--sim-mcu", "--t-end", "1", "--ukf-dtype", "float64",
                        "--max-iter", "8"])
    assert res.solves >= 2 and int(res) == res.solves and f"{res.solves} solves" in buf.getvalue()
    assert len(res.iterations) == res.solves and all(1 <= i <= 8 for i in res.iterations)
    assert res.packets >= 1 and res.finite and res.plant_max_abs_theta is not None


def test_mpc_ukf_commu_cli_options_and_card_default():
    args = cli.build_parser().parse_args(["mpc-ukf-commu"])
    assert (args.serial, args.device, args.ukf_dtype, args.max_iter, args.console) == ("/dev/ttyUSB0", "cuda",
                                                                                      "float32", None, False)
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["mpc-ukf-commu", "--sampler", "clt4"])  # an MPPI app's option
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main(["mpc-ukf-commu", "--sim-mcu", "--t-end", "0.1"])
