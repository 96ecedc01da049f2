"""The port's QP fleet (``mpc_rs_tpu_torch/apps/fleet.py::build_qp_fleet``)
against the JAX package's (``mpc_rs_tpu/apps/fleet.py:251-369``).

The JAX fleet draws x0 from a JAX key, which torch cannot reproduce: both
fleets start from the JAX carry's x0 (``build_qp_fleet(..., x0=)``).

- Newton at B = 16 (no inverse table) and B = 8 (the table, B < 16): the
  float64 build's five closed-loop ticks within 1e-10 of the same JAX tick
  in float64; float32 ticks from the JAX state in the float32 band (rtol
  1e-3, atol 2e-4) but for 5 % of the entries, and within the float32
  conditioning floor of the exact optimum.
- PANOC at B = 16 and 64, five ticks from the JAX state: float64 lanes the
  JAX package solves within 30 iterations within 2e-9, the others within
  2·√n·tol/λ_min(2H) of the exact optimum (past ~30 iterations a condensed-QP solve is
  noise-driven, ``tests/test_torch_panoc.py``); float32 lanes, which are
  noise-driven from the start in both packages, are held to PANOC's
  descent.
- The CLI prints the JAX line's fields, and ``--device cuda`` raises
  without a card.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_rs_tpu.apps import fleet as jfleet
from mpc_rs_tpu.controllers import panoc as jpn
from mpc_rs_tpu.controllers import qp as jqp
from mpc_rs_tpu.models import dynamics as jdyn
from mpc_rs_tpu.models import reference as jref
from mpc_rs_tpu.models.params import CartPoleParams as JParams
from mpc_rs_tpu.utils import as_vector_fn
from mpc_rs_tpu_torch.apps import fleet as tfleet
from mpc_rs_tpu_torch.apps import run as cli

F32_BAND = dict(rtol=1e-3, atol=2e-4)


def jax_qp_tick(b, solver, dtype):
    """The JAX fleet's tick (``fleet.py:282-323``) built in ``dtype``; the
    float32 one is ``build_qp_fleet``'s own."""
    if dtype == jnp.float32:
        tick, carry, _ = jfleet.build_qp_fleet(b, seed=4, solver=solver)
        return tick, carry
    p = JParams.single_wheel()
    a, bm = jdyn.linear_ab(p, 0.1)
    qp = jqp.build_condensed_qp(a, bm, np.diag([5.0, 5.0, 1.0, 1.0]), 8, dtype=dtype)
    gen_ref = jref.make_gen_ref_raised_cosine(8)
    plant = as_vector_fn(jdyn.make_cartpole_nonlinear(p, 0.1), 4)
    tbl = jqp.active_set_inverse_table(qp.h) if b < 16 else None
    vgf = jqp.make_qp_value_and_grad(qp, gen_ref)
    cfg = jpn.PanocConfig(tol=1e-5, max_iter=60, lbfgs_mem=10)

    def solve(x, u_n):
        if solver == "newton":
            bvec = jqp.qp_linear_term(qp, x, jax.vmap(lambda xi: gen_ref(xi).reshape(-1))(x))
            return jqp.box_qp_newton(qp.h, bvec, u_n, -30.0, 30.0, iters=12, inv_table=tbl, safeguard=False)
        return jax.vmap(lambda xi, ui: jpn.panoc_solve(cfg, None, jpn.box_projection(-30.0, 30.0), ui,
                                                       value_and_grad=vgf(xi)).u)(x, u_n)

    @jax.jit
    def tick(carry):
        x, u_n, key = carry
        u = solve(x, u_n)
        return jax.vmap(plant)(x, u[:, 0]), u, key

    _, carry32, _ = jfleet.build_qp_fleet(b, seed=4, solver=solver)
    return tick, (jnp.asarray(carry32[0], dtype), jnp.asarray(carry32[1], dtype), carry32[2])


NOISE_ITERS = 30  # past this many iterations a condensed-QP PANOC solve is noise-driven (test_torch_panoc.py)
RADIUS = 2.0 * np.sqrt(8) * 1e-5 / 0.1253964616268916  # 2·√n·tol/λ_min(2H): a tol-1e-5 stop's distance to the optimum


@pytest.fixture(scope="module")
def exact():
    """u*(x): the float64 Newton solve with the safeguard, the oracle's
    enumerated optimum on this class (``tests/test_torch_qp.py``)."""
    from mpc_rs_tpu_torch.controllers import qp as tqp
    from mpc_rs_tpu_torch.models import dynamics as tdyn
    from mpc_rs_tpu_torch.models import reference as tref
    from mpc_rs_tpu_torch.models.params import CartPoleParams as TParams

    a, bm = tdyn.linear_ab(TParams.single_wheel(), 0.1)
    qp = tqp.build_condensed_qp(a, bm, np.diag([5.0, 5.0, 1.0, 1.0]), 8)
    gen_ref = tref.make_gen_ref_raised_cosine(8)

    def solve(x):
        x = torch.tensor(np.asarray(x, np.float64))
        b = tqp.qp_linear_term(qp, x, gen_ref(x).flatten(-2))
        return tqp.box_qp_newton(qp.h, b, torch.zeros(x.shape[0], 8, dtype=torch.float64), -30.0, 30.0).numpy()

    return solve


def _ticks_from_the_jax_state(b, solver, dtype, n=5):
    """(JAX carry before, JAX carry after, the port's carry after) of n
    ticks, the port's each from the JAX carry."""
    jtick, jcarry = jax_qp_tick(b, solver, getattr(jnp, dtype))
    fl = tfleet.build_qp_fleet(b, "cpu", solver=solver, x0=np.asarray(jcarry[0]), dtype=getattr(torch, dtype))
    assert fl.carry[0].dtype == getattr(torch, dtype) and fl.carry[1].shape == (b, 8)
    out = []
    for _ in range(n):
        jnext = jtick(jcarry)
        got = fl.tick(tuple(torch.tensor(np.asarray(v)) for v in jcarry[:2]))
        out.append((jcarry, jnext, got))
        jcarry = jnext
    return out


@pytest.mark.parametrize("b", [8, 16])
def test_newton_fleet_float64_closed_loop_matches_jax(b):
    jtick, jcarry = jax_qp_tick(b, "newton", jnp.float64)
    fl = tfleet.build_qp_fleet(b, "cpu", solver="newton", x0=np.asarray(jcarry[0]), dtype=torch.float64)
    carry = fl.carry
    for _ in range(5):
        jcarry, carry = jtick(jcarry), fl.tick(carry)
        for got, want in zip(carry, jcarry[:2]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-10)


@pytest.mark.parametrize("b", [8, 16])
def test_newton_fleet_float32_ticks_match_jax(b, exact):
    """Each tick from the JAX state: u in the float32 band of the JAX
    tick's but for at most 5 % of the entries, and within the float32
    floor cond(2H)·eps·max|u| ≈ 1.8e3 · 6e-8 · 30 ≈ 3.2e-3 of the exact
    optimum (the JAX tick is up to 3.7e-4 from it, the port's up to 1.3e-3);
    the next state in the band."""
    for jcarry, jnext, got in _ticks_from_the_jax_state(b, "newton", "float32"):
        u, uj = got[1].numpy(), np.asarray(jnext[1])
        in_band = np.abs(u - uj) <= F32_BAND["atol"] + F32_BAND["rtol"] * np.abs(uj)
        assert in_band.mean() >= 0.95
        u_star = exact(jcarry[0])
        assert np.abs(u - u_star).max() <= 5e-3 and np.abs(uj - u_star).max() <= 5e-3
        np.testing.assert_allclose(got[0].numpy(), np.asarray(jnext[0]), **F32_BAND)


@pytest.mark.parametrize("b", [16, 64])
def test_panoc_fleet_float64_ticks_match_jax(b, exact):
    """Each tick from the JAX state, lane by lane: where the JAX lane's
    solve is done within 30 iterations, u within 2e-9 of it; past that its
    last iterations are noise-driven (``tests/test_torch_panoc.py``), and
    both packages' lanes are held within 2·√8·tol/λ_min(2H) ≈ 4.5e-4 of
    the exact optimum (measured: the port's up to 2.6e-5, the JAX
    package's up to 7.7e-6)."""
    a, bm = jdyn.linear_ab(JParams.single_wheel(), 0.1)
    qp = jqp.build_condensed_qp(a, bm, np.diag([5.0, 5.0, 1.0, 1.0]), 8)
    vgf = jqp.make_qp_value_and_grad(qp, jref.make_gen_ref_raised_cosine(8))
    cfg = jpn.PanocConfig(tol=1e-5, max_iter=60, lbfgs_mem=10)
    iters = jax.jit(jax.vmap(lambda x, u: jpn.panoc_solve(cfg, None, jpn.box_projection(-30.0, 30.0), u,
                                                          value_and_grad=vgf(x)).iterations))
    n_clean = 0
    for jcarry, jnext, got in _ticks_from_the_jax_state(b, "panoc", "float64"):
        u, uj = got[1].numpy(), np.asarray(jnext[1])
        clean = np.asarray(iters(jcarry[0], jcarry[1])) <= NOISE_ITERS
        n_clean += int(clean.sum())
        np.testing.assert_allclose(u[clean], uj[clean], rtol=0, atol=2e-9)
        u_star = exact(jcarry[0])
        assert np.abs(u - u_star).max() <= RADIUS and np.abs(uj - u_star).max() <= RADIUS
    assert n_clean >= 0.7 * 5 * b


@pytest.mark.parametrize("b", [16, 64])
def test_panoc_fleet_float32_ticks_descend(b):
    """float32 PANOC at tol 1e-5 runs into float32's rounding: neither
    package's lanes converge within the 60 iterations, and their iterates
    are noise-driven throughout (one tick from the JAX state puts the JAX
    lanes up to 0.93 from the exact optimum, the port's up to 2.7). Each
    tick from the JAX state is held to what PANOC guarantees: finite, in
    the box, and no lane's QP cost above its warm start's."""
    a, bm = jdyn.linear_ab(JParams.single_wheel(), 0.1)
    qp = jqp.build_condensed_qp(a, bm, np.diag([5.0, 5.0, 1.0, 1.0]), 8)
    gen_ref = jref.make_gen_ref_raised_cosine(8)
    cost = jax.vmap(lambda x, u: jqp.qp_cost(qp, x, u, gen_ref(x).reshape(-1)))
    for jcarry, _, got in _ticks_from_the_jax_state(b, "panoc", "float32"):
        u = got[1].numpy()
        assert np.isfinite(u).all() and (np.abs(u) <= 30.0).all()
        x64 = jnp.asarray(np.asarray(jcarry[0]), jnp.float64)
        j_new = np.asarray(cost(x64, jnp.asarray(u, jnp.float64)))
        j_warm = np.asarray(cost(x64, jnp.asarray(np.clip(np.asarray(jcarry[1]), -30, 30), jnp.float64)))
        assert (j_new <= j_warm + 1e-4 * np.abs(j_warm) + 1e-3).all()


def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = cli.main(argv)
    return res, buf.getvalue()


@pytest.mark.parametrize("solver", ["newton", "panoc"])
def test_cli_qp_fleet_prints_the_jax_fields_and_parks(solver):
    res, out = _cli(["fleet", "--controller", "qp", "--qp-solver", solver, "--device", "cpu", "--scenarios", "16",
                     "--t-end", "1"])
    lines = [ln for ln in out.splitlines() if "parked=" in ln]
    assert len(lines) == 1 and res.ticks == 10
    for field in ("parked=", "upright=", "median|x|=", "scenario-ticks/s"):
        assert field in lines[0]
    assert res.upright == 1.0 and np.isfinite(res.carry[0].numpy()).all()
    # tests/test_scenario.py:163-176's rule, B = 16, seed 1, 3 s; float32
    # PANOC is noise-driven (above) and tips a tail scenario now and then in
    # both packages (B = 512 on the CPU: the JAX fleet 1-2, the port 5), so
    # it may lose one of the 16 here
    res3, _ = _cli(["fleet", "--controller", "qp", "--qp-solver", solver, "--device", "cpu", "--scenarios", "16",
                    "--t-end", "3", "--seed", "1"])
    assert res3.median_abs_x < 0.3 and res3.upright >= (1.0 if solver == "newton" else 15 / 16)


def test_cli_newton_qp_fleet_meets_the_acceptance_rule():
    """``apps/acceptance.py``'s ``fleet-qp``: B = 64, 3 s, parked ≥ 0.95 and
    every scenario upright (``acceptance.py:218-226, 318-321``)."""
    _, out = _cli(["fleet", "--controller", "qp", "--device", "cpu", "--scenarios", "64", "--t-end", "3"])
    parked = [float(ln.split("parked=")[1].split()[0]) for ln in out.splitlines() if "parked=" in ln]
    upright = [float(ln.split("upright=")[1].split()[0]) for ln in out.splitlines() if "upright=" in ln]
    assert parked[-1] >= 0.95 and upright[-1] == 1.0


def test_cli_qp_fleet_takes_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device runs")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["fleet", "--controller", "qp", "--scenarios", "4", "--t-end", "0.1"])
    args = cli.build_parser().parse_args(["fleet", "--controller", "qp"])
    assert args.qp_solver == "newton" and args.max_iter is None and args.device == "cuda"


def test_x0_spread_is_seeded():
    a = tfleet.build_qp_fleet(32, "cpu", seed=3).carry[0]
    b = tfleet.build_qp_fleet(32, "cpu", seed=3).carry[0]
    c = tfleet.build_qp_fleet(32, "cpu", seed=4).carry[0]
    assert torch.equal(a, b) and not torch.equal(a, c)
    dev = (a - torch.tensor([0.5, 0.0, 0.1, 0.0])) / 0.2
    assert abs(float(dev.mean())) < 0.5 and 0.6 < float(dev.std()) < 1.4
