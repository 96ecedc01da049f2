"""The MPPI application family of the port on the CPU: the models of mppi2,
mppi4 and the HW flagship against the JAX package, the plain K2 of each
(model, N) pair the kernels are built for against ``mppi_solve_pallas`` in
interpret mode on the same external noise, the plant-mode chain at N=20
against a sequential JAX chain, and the samplers' plain noise at N=20 and
N=40 (moments and layout-contract words). The kernels themselves are held
against these plain versions on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_rs_tpu.controllers import mppi as jmppi
from mpc_rs_tpu.models import costs as jcosts
from mpc_rs_tpu.models import dynamics as jdyn
from mpc_rs_tpu.models.params import CartPoleParams as JParams
from mpc_rs_tpu.ops.mppi_pallas import mppi_solve_pallas
from mpc_rs_tpu_torch.controllers.mppi import MppiConfig, MppiStatus
from mpc_rs_tpu_torch.models import costs
from mpc_rs_tpu_torch.models.params import CartPoleParams
from mpc_rs_tpu_torch.ops import mppi_cuda, philox
from mpc_rs_tpu_torch.ops.mppi_cuda import (
    CartPoleLinearShaped4,
    CartPoleShaped4,
    Commu4Cost4,
    DoubleIntegratorQuad2,
    Flagship4Diag4,
    mppi_chain_fused,
    mppi_solve_fused,
)

BS, LANES = 8, 128  # Pallas block: 8 sublanes x 128 lanes = 1024 rollouts
F32_BAND = dict(rtol=1e-3, atol=2e-4)  # tests/test_pallas.py:59
F64_TIGHT = dict(rtol=1e-12, atol=1e-14)
SW, TW = CartPoleParams.single_wheel(), CartPoleParams.two_wheel()
JSW, JTW = JParams.single_wheel(), JParams.two_wheel()

# (name, port model, JAX step, JAX cost, n_state, MppiConfig kwargs, x0): each
# app's controller at its reference horizon, λ, σ, limits and control term
FAMILY = {
    # mppi_examples.py:18-44: N=40, λ=2.5, σ=1, ±3, control_inv = λ/R = 2.5
    "mppi2": (DoubleIntegratorQuad2(2.0 / 40), jdyn.make_double_integrator(2.0 / 40), jcosts.quad2, 2,
              dict(n_horizon=40, lambda_=2.5, std_dev=1.0, limit=(-3.0, 3.0), control_inv=2.5), (1.0, 0.0)),
    # mppi_examples.py:47-80: N=8, λ=0.5, σ=3, ±20
    "mppi4": (CartPoleLinearShaped4(SW, 0.1), jdyn.make_cartpole_linear(JSW, 0.1), jcosts.shaped4, 4,
              dict(n_horizon=8, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0)), (0.5, 0.0, 0.1, 0.0)),
    # bench.py:230-288: N=20, λ=2, σ=2, ±10, x0 = [0, 0, 0.1, 0]
    "hw_flagship": (Commu4Cost4(TW, 0.05), jdyn.make_commu4(JTW, 0.05), jcosts.commu4, 4,
                    dict(n_horizon=20, lambda_=2.0, std_dev=2.0, limit=(-10.0, 10.0)), (0.0, 0.0, 0.1, 0.0)),
    # mppi_examples.py:173-325: flagship4 + diag4 on one solve, N=8, λ=1.4, σ=4, ±10
    "mppi4-non-liner-ukf": (Flagship4Diag4(TW, 0.15), jdyn.make_flagship4(JTW, 0.15),
                            jcosts.make_diag4(0.1, 0.1, 1.0, 0.5), 4,
                            dict(n_horizon=8, lambda_=1.4, std_dev=4.0, limit=(-10.0, 10.0)),
                            (0.0, 0.0, 0.05, 0.0)),
}


def _cfg(name, k, **kw):
    return MppiConfig(n_rollouts=k, **{**FAMILY[name][4], **kw})


def _jcfg(name, k, **kw):
    return jmppi.MppiConfig(n_rollouts=k, **{**FAMILY[name][4], **kw})


# --------------------------------------------------------------------------
# (i) the models and the costs against the JAX package


def _states(n_state, dtype, seed=0, m=257):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.5, 1.5, (n_state, m))
    return x.astype(dtype), rng.uniform(-10.0, 10.0, m).astype(dtype)


@pytest.mark.parametrize("name", ["mppi2", "mppi4", "hw_flagship"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_family_model_step_and_cost_match_jax(name, dtype):
    """Three steps of the model and its cost on 257 states: float64 within
    1e-12, float32 inside the f32 band (two evaluations of the same
    operations in float32)."""
    model, jstep, jcost, n_state, _, _ = FAMILY[name]
    x, u = _states(n_state, dtype)
    xt, xj = tuple(torch.tensor(c) for c in x), tuple(jnp.asarray(c) for c in x)
    ut, uj = torch.tensor(u), jnp.asarray(u)
    band = F64_TIGHT if dtype == np.float64 else dict(rtol=1e-5, atol=1e-6)
    for _ in range(3):
        xt, xj = model.step(*xt, ut), jstep(*xj, uj)
        for a, b in zip(xt, xj):
            assert a.dtype == torch.float64 if dtype == np.float64 else a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **band)
        np.testing.assert_allclose(model.cost(*xt).numpy(), np.asarray(jcost(*xj)), **band)


def test_commu4_cost_keeps_the_reference_constant():
    z = torch.zeros(3, dtype=torch.float64)
    assert costs.commu4(z, z, z, z).tolist() == [1.2] * 3
    x = (torch.tensor(v, dtype=torch.float64) for v in (5.0, -5.0, 0.5, -1.0))
    assert float(costs.commu4(*x)) == 1.2 + 3.0 * 0.5 * 0.5 + 3.0 * -1.0 * -1.0


def test_family_constants_fold_in_double():
    """The functors' constants are the Python-float products of the JAX
    models, each folded in double (rounded to float32 once by ctypes)."""
    assert DoubleIntegratorQuad2(0.05).constants() == [0.05]
    p, d = SW, SW.d_lin
    assert CartPoleLinearShaped4(p, 0.1).constants() == [
        p.mass_line / d * p.m2 * p.g * p.l, -p.m2 * p.l / d / p.r_w * p.kt,
        -p.m2 * p.m2 * p.g * p.l * p.l / d, (p.m2 * p.l * p.l + p.j2) / d / p.r_w * p.kt, 0.1]
    q = TW
    ml, mll_j2 = q.m2 * q.l, q.m2 * q.l * q.l + q.j2
    c = Commu4Cost4(q, 0.05).constants()
    assert len(c) == 11 and c[0] == q.d1_two and c[2] == mll_j2 * ml and c[3] == -(ml**2) * q.g
    assert c[8] == q.m2 * q.g * q.l * q.mass_line_two and c[9] == -2.0 * ml and c[10] == 0.05
    # the float32 model step of the plain version against the host-folded
    # constants in the kernel's order (what the functor computes)
    a32, b3, a12, b1, dt = (np.float32(v) for v in CartPoleLinearShaped4(p, 0.1).constants())
    x = np.float32([0.3, -0.2, 0.15, 0.4])
    u = np.float32(2.5)
    x3 = x[3] + (a32 * x[2] + b3 * u) * dt
    x2 = x[2] + x3 * dt
    x1 = x[1] + (a12 * x2 + b1 * u) * dt
    x0 = x[0] + x1 * dt
    got = CartPoleLinearShaped4(p, 0.1).step(*(torch.tensor(v) for v in x), torch.tensor(u))
    np.testing.assert_allclose([float(v) for v in got], [x0, x1, x2, x3], rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------------------
# (ii) the plain K2 of each built pair against the Pallas kernel in interpret mode


def _pallas_vs_plain(name, k, lam=None):
    model, jstep, jcost, n_state, kw, x0 = FAMILY[name]
    n = kw["n_horizon"]
    lam = kw["lambda_"] if lam is None else lam
    nb = -(-k // (BS * LANES))
    rng = np.random.default_rng(k + n)
    eps = (kw["std_dev"] * rng.standard_normal((nb, n, BS, LANES))).astype(np.float32)
    # poison the Pallas padding: it must not leak into either result
    flat = np.arange(nb * BS * LANES).reshape(nb, BS, LANES)
    for t in range(n):
        eps[:, t][flat >= k] = -1.2
    u_n = (0.5 * rng.standard_normal(n)).astype(np.float32)
    want_u, want_st = mppi_solve_pallas(
        _jcfg(name, k, lambda_=lam), jstep, jcost, n_state, 0, jnp.asarray(x0, jnp.float32),
        jnp.asarray(u_n), block_sublanes=BS, interpret=True, noise=jnp.asarray(eps),
    )
    eps_kn = eps.transpose(0, 2, 3, 1).reshape(-1, n)[:k]  # tests/test_pallas.py:37
    got_u, got_st = mppi_solve_fused(_cfg(name, k, lambda_=lam), model, torch.tensor(x0, dtype=torch.float32),
                                     torch.tensor(u_n), noise=torch.tensor(eps_kn))
    assert int(got_st) == int(want_st) == MppiStatus.OK
    np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u), **F32_BAND)


@pytest.mark.parametrize("k", [2048, 1324])  # a block multiple and a ragged K
@pytest.mark.parametrize("name", ["mppi2", "hw_flagship"])
def test_family_k2_plain_matches_pallas_interpret(name, k):
    """N=40 with control_inv (mppi2) and N=20 (the HW flagship)."""
    _pallas_vs_plain(name, k)


@pytest.mark.parametrize("name", ["mppi4", "mppi4-non-liner-ukf"])
def test_n8_family_k2_plain_matches_pallas_interpret(name):
    """The linear cart-pole, and flagship4 + diag4 on one solve, at N=8."""
    _pallas_vs_plain(name, 1324)


@pytest.mark.parametrize("name", ["mppi2", "hw_flagship"])
def test_family_k2_plain_f64_matches_mppi_solve(name):
    """Rows of 256 and of 1024 rollouts merged by log-sum-exp equal the
    one-pass JAX solve in float64 (control_inv included)."""
    model, jstep, jcost, n_state, kw, x0 = FAMILY[name]
    k, n = 4 * 256 * 2 + 37, kw["n_horizon"]
    rng = np.random.default_rng(3)
    eps = kw["std_dev"] * rng.standard_normal((k, n))
    u_n = 0.3 * rng.standard_normal(n)
    want = jmppi.mppi_solve(_jcfg(name, k), jstep, jcost, None, tuple(jnp.float64(c) for c in x0),
                            jnp.asarray(u_n), noise=jnp.asarray(eps))
    for rpt in (1, 4):
        got_u, got_st = mppi_solve_fused(_cfg(name, k), model, torch.tensor(x0, dtype=torch.float64),
                                         torch.tensor(u_n), noise=torch.tensor(eps), rollouts_per_thread=rpt)
        assert int(got_st) == int(want.status) == MppiStatus.OK
        np.testing.assert_allclose(got_u.numpy(), np.asarray(want.u_n), rtol=1e-9, atol=1e-12)


def test_mppi2_control_inv_enters_the_score():
    """mppi2's control term weighs u_n·v by control_inv = λ/R = 2.5, not by
    σ⁻² = 1: the plain solve differs between the two and matches the JAX
    solve with the same coefficient (controllers/mppi.py:63-83)."""
    name = "mppi2"
    model, jstep, jcost, _, kw, x0 = FAMILY[name]
    k, n = 1500, kw["n_horizon"]
    rng = np.random.default_rng(1)
    eps = rng.standard_normal((k, n))
    u_n = rng.standard_normal(n)
    for inv in (2.5, None):
        want = jmppi.mppi_solve(_jcfg(name, k, control_inv=inv), jstep, jcost, None,
                                tuple(jnp.float64(c) for c in x0), jnp.asarray(u_n), noise=jnp.asarray(eps))
        got = mppi_solve_fused(_cfg(name, k, control_inv=inv), model, torch.tensor(x0, dtype=torch.float64),
                               torch.tensor(u_n), noise=torch.tensor(eps))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want.u_n), rtol=1e-9, atol=1e-12)
        if inv is None:
            assert not np.allclose(got[0].numpy(), with_inv, rtol=1e-3)
        else:
            with_inv = got[0].numpy()


# --------------------------------------------------------------------------
# (iii) the plant-mode chain at N=20 against a sequential JAX chain


def test_hw_flagship_plain_chain_matches_sequential_jax_chain():
    """Eight warm-started solves of the HW flagship at N=20 in plant mode,
    in float64 at λ=200: the plant steps with the solve's model, as
    bench.py:255 does, and u0s, u_n and x equal the JAX chain's to 1e-9.
    The chain is held at λ=200, where it is well conditioned (the two
    packages stay 2e-13 apart over 8 solves): at λ=20 and at the app's λ=2
    it turns the last-bit difference of the port's f32(1/λ) multiply and
    the JAX division by λ into 5e-6 and 5e-9 by solve 8, a tenfold growth
    a solve at λ=20 (the app's λ is held per solve above)."""
    model, jstep, jcost, _, kw, x0 = FAMILY["hw_flagship"]
    k, n, j = 2000, kw["n_horizon"], 8
    noise = kw["std_dev"] * np.random.default_rng(9).standard_normal((j, k, n))
    got = mppi_chain_fused(_cfg("hw_flagship", k, lambda_=200.0), model, torch.tensor(x0, dtype=torch.float64),
                           torch.zeros(n, dtype=torch.float64), n_solves=j, noise=torch.tensor(noise), plant=True)
    x, u_n, u0s = jnp.asarray(x0, jnp.float64), jnp.zeros(n, jnp.float64), []
    for i in range(j):
        r = jmppi.mppi_solve(_jcfg("hw_flagship", k, lambda_=200.0), jstep, jcost, None, tuple(x), u_n,
                             noise=jnp.asarray(noise[i]))
        assert int(r.status) == 0
        u_n = r.u_n
        u0s.append(float(u_n[0]))
        x = jnp.stack(jstep(*x, u_n[0]))
    assert got.statuses.tolist() == [0] * j
    np.testing.assert_allclose(got.u0s.numpy(), u0s, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got.u_n.numpy(), np.asarray(u_n), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(x), rtol=1e-9, atol=1e-12)


def test_k1_plain_chain_with_seeds_is_sequential_k2_for_two_states():
    model, _, _, _, kw, x0 = FAMILY["mppi2"]
    cfg, n = _cfg("mppi2", 700), kw["n_horizon"]
    seeds = torch.tensor([3, -5, 11], dtype=torch.int32)
    chain = mppi_chain_fused(cfg, model, torch.tensor(x0), torch.zeros(n), seeds=seeds, plant=True,
                             sampler="clt4a")
    x, u = torch.tensor(x0), torch.zeros(n)
    for s in seeds.tolist():
        u, st = mppi_solve_fused(cfg, model, x, u, seed=s, sampler="clt4a")
        assert int(st) == 0
        x = torch.stack(model.step(*x.unbind(), u[0]))
    assert chain.x.shape == (2,) and torch.equal(chain.x, x) and torch.equal(chain.u_n, u)


# --------------------------------------------------------------------------
# which (model, N, tier) have a kernel


def test_built_pairs_and_their_checks():
    assert mppi_cuda.BUILT == {(0, 8), (1, 8), (2, 40), (3, 8), (4, 20), *((0, n) for n in range(9, 41))}
    for name, (model, *_rest) in FAMILY.items():
        mppi_cuda.check_built(model, FAMILY[name][4]["n_horizon"])
    with pytest.raises(ValueError, match="horizon N=8"):
        mppi_cuda.check_built(DoubleIntegratorQuad2(0.05), 8)
    with pytest.raises(ValueError, match="horizon N=8"):
        mppi_cuda.check_built(Commu4Cost4(TW, 0.05), 8)
    with pytest.raises(ValueError, match="no kernel for model"):
        mppi_cuda.check_built(object(), 8)

    class FastDoubleIntegrator(DoubleIntegratorQuad2):
        fast = True  # the family is built in the exact tier only

    with pytest.raises(ValueError, match="no fast-tier kernel"):
        mppi_cuda.check_built(FastDoubleIntegrator(0.05), 40)
    # serve's plan-streaming cart-pole at N = 9-40: the exact tier only
    mppi_cuda.check_built(CartPoleShaped4(SW, 0.01), 40)
    with pytest.raises(ValueError, match="no fast-tier kernel for CartPoleShaped4 at N=40"):
        mppi_cuda.check_built(CartPoleShaped4(SW, 0.01, fast=True), 40)
    # the batched entry takes every built pair too (a grid of B problems)
    u, st = mppi_cuda.mppi_solve_batch_fused(_cfg("mppi2", 300), DoubleIntegratorQuad2(0.05),
                                             torch.tensor([[1.0, 0.0], [0.5, -0.2]]), torch.zeros(2, 40),
                                             seeds=torch.tensor([1, 2], dtype=torch.int32), sampler="wallace")
    assert u.shape == (2, 40) and st.tolist() == [0, 0]


# --------------------------------------------------------------------------
# (viii) the samplers' plain noise at N=20 and N=40


@pytest.mark.parametrize("n", [20, 40])
@pytest.mark.parametrize("sampler", philox.SAMPLERS)
def test_sampler_moments_at_long_horizons(sampler, n):
    """Every step of every sampler is σ·N(0, 1) to within its standard
    error at N=20 and 40 (the windows that end mid-call included)."""
    z = philox.sample_noise(sampler, 21, 3, 1 << 14, n, 2.0)[0].double()
    assert z.shape == (1 << 14, n)
    se = 2.0 / math.sqrt(z.shape[0])
    assert float(z.mean(dim=0).abs().max()) < 5 * se
    assert float((z.std(dim=0) - 2.0).abs().max()) < 0.07


@pytest.mark.parametrize("sampler", philox.SAMPLERS)
def test_sampler_n20_is_the_prefix_of_n40(sampler):
    """Call c of rollout k covers the same steps at every N, so N=20's
    noise is N=40's first 20 steps (wallace's window 2 and clt2q's call 2
    end mid-window at N=20)."""
    a = philox.sample_noise(sampler, 7, 1, 999, 40, 3.0)
    b = philox.sample_noise(sampler, 7, 1, 999, 20, 3.0)
    assert torch.equal(a[..., :20], b)


def _words(k, c, key=7, stream=1):
    w = philox.philox4x32_10((torch.tensor(k, dtype=torch.int64), torch.tensor(c, dtype=torch.int64),
                              torch.tensor(stream, dtype=torch.int64), torch.tensor(0, dtype=torch.int64)),
                             (key, 0))
    return [int(v) for v in w]


def _u1(a):
    return 2.0 - float(np.float32(np.uint32((a >> 9) | 0x3F800000).view(np.float32)))


def _u2(b):
    return float(np.float32(np.uint32((b >> 9) | 0x3F800000).view(np.float32))) - 1.0


def test_sampler_layout_words_at_the_end_of_long_horizons():
    """The contract of ops/philox.py at the last steps of N=40 and N=20,
    entry by entry from the Philox words: box-muller step 39 is the sin of
    the pair (w2, w3) of call (k, 9); clt4 step 38 is word 2 of call
    (k, 9); clt2q step 19 is the high half of word 1 of call (k, 2); clt4a
    step 37 of rollout 2j+1 is −(word 1 of call (j, 9)); wallace step 17 is
    σ·b of call (k, 2) and step 19 mixes its a with a warp partner's b."""
    sd, k = 3.0, 45
    bm = philox.sample_noise("box-muller", 7, 1, 64, 40, sd)[0]
    w = _words(k, 9)
    r = sd * math.sqrt(-2.0 * math.log(_u1(w[2])))
    assert float(bm[k, 39]) == pytest.approx(r * math.sin(2.0 * math.pi * _u2(w[3])), rel=1e-5, abs=1e-6)

    def clt4(word):
        x2 = (word & 0x00FF00FF) + ((word >> 8) & 0x00FF00FF)
        z = ((x2 & 0xFFFF) + (x2 >> 16) - 510.0) * philox._CLT_INV_SIG
        return z * (philox._CLT_A * sd + philox._CLT_B * sd * z * z)

    c4 = philox.sample_noise("clt4", 7, 1, 64, 40, sd)[0]
    assert float(c4[k, 38]) == pytest.approx(clt4(_words(k, 9)[2]), rel=1e-5)
    c4a = philox.sample_noise("clt4a", 7, 1, 64, 40, sd)[0]
    assert float(c4a[2 * 22 + 1, 37]) == pytest.approx(-clt4(_words(22, 9)[1]), rel=1e-5)
    assert float(c4a[2 * 22, 37]) == -float(c4a[2 * 22 + 1, 37])
    c2 = philox.sample_noise("clt2q", 7, 1, 64, 20, sd)[0]
    x2 = (_words(k, 2)[1] & 0x00FF00FF) + ((_words(k, 2)[1] >> 8) & 0x00FF00FF)
    z = ((x2 >> 16) - 255.0) * philox._TRI_INV_SIG
    want = z * (philox._TRI_A * sd + z * z * (philox._TRI_B * sd + philox._TRI_C * sd * z * z))
    assert float(c2[k, 19]) == pytest.approx(want, rel=1e-5, abs=1e-6)
    wl = philox.sample_noise("wallace", 7, 1, 64, 20, sd)[0]

    def pool(kk):
        ww = _words(kk, 2)
        rr = math.sqrt(-2.0 * math.log(_u1(ww[0])))
        ang = 2.0 * math.pi * _u2(ww[1])
        return rr * math.cos(ang), rr * math.sin(ang), ww[2]

    a, b, w2 = pool(k)
    assert float(wl[k, 16]) == pytest.approx(sd * a, rel=1e-5, abs=1e-6)
    assert float(wl[k, 17]) == pytest.approx(sd * b, rel=1e-5, abs=1e-6)
    shift = (29 * 3 + 13) % 32
    partner = (k & ~31) | ((k - shift) & 31)
    sa = -a if (w2 << 1) & 0x80000000 else a
    assert float(wl[k, 19]) == pytest.approx(sd / math.sqrt(2.0) * (sa + pool(partner)[1]), rel=1e-5, abs=1e-6)


def test_profile_partials_reads_every_instantiation_of_the_build_log():
    """ptxas's report names each instantiation by its mangled name: the
    N = 8 models (their tier a template argument) and the family's (N = 20
    and 40, no tier argument) are both tagged N/model/tier/cost/fast/sampler/R."""
    from mpc_rs_tpu_torch.runtime.profile_partials import ptxas_partials

    names = ["_ZN3mpc20mppi_partials_kernelILi8ENS_9Flagship4ILb0EEENS_5Diag4ELb0ELi6ELi4ELi0EEEvT0_T1_",
             "_ZN3mpc20mppi_partials_kernelILi40ENS_16DoubleIntegratorENS_5Quad2ELb0ELi3ELi1ELi0EEEvT0_T1_",
             "_ZN3mpc20mppi_partials_kernelILi20ENS_6Commu4ENS_10Commu4CostELb0ELi1ELi4ELi0EEEvT0_T1_"]
    log = "".join(f"ptxas info    : Compiling entry function '{n}' for 'sm_90a'\n"
                  f"ptxas info    : Function properties for {n}\n"
                  "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
                  f"ptxas info    : Used {r} registers, used 1 barriers, 360 bytes smem\n"
                  for n, r in zip(names, (64, 141, 128)))
    lines = ptxas_partials(log)
    tags = [ln.split(": ", 1)[0] for ln in lines if "registers" in ln]
    assert tags == ["8/Flagship4/0/Diag4/0/6/4", "40/DoubleIntegrator/-/Quad2/0/3/1", "20/Commu4/-/Commu4Cost/0/1/4"]
    assert sum("spill stores" in ln for ln in lines) == 3


@pytest.mark.parametrize("k, want", [
    (8000, 1),  # mppi2 (N=40): 8 blocks at R = 4 (R=4 2.3x slower on the H100)
    (160_000, 1),  # N=40, 157 blocks at R = 4: under 528 (R=4 3 % faster there)
    (300_000, 1),  # N=20, 293 blocks at R = 4: one short wave (R=4 23 % slower)
    (800_000, 4),  # the HW flagship, 782 blocks (R=4 13-17 % faster)
    (500_000, 1),  # mppi4-non-liner-ukf, 489 blocks (R=4 8 % slower)
    (1_500_000, 4),  # mppi4-non-liner-s
])
def test_rollouts_per_thread_at_the_family_shapes(k, want):
    """The one threshold of the R rule (528 blocks at R = 4) also past N = 8,
    where R = 4 holds 2 (N=20) and 1 (N=40) blocks an SM: at the measured
    shapes it picks the faster R but at N=40, K=160 000 (PERF.md §6)."""
    assert mppi_cuda.rollouts_per_thread(k) == want


@pytest.mark.parametrize("control_inv", [2.5, None, 0.0])
def test_controller_control_inv_matches_jax(control_inv):
    """``controllers/mppi.py``'s scores and solve weigh the control term by
    ``control_inv`` (σ⁻² when None), as mpc_rs_tpu/controllers/mppi.py:63-83
    does: float64, mppi2's model at N=40."""
    from mpc_rs_tpu_torch.controllers import mppi as tmppi

    model, jstep, jcost, _, kw, x0 = FAMILY["mppi2"]
    k, n = 700, kw["n_horizon"]
    rng = np.random.default_rng(12)
    v = rng.uniform(-3.0, 3.0, (k, n))
    u_n = rng.standard_normal(n)
    x = tuple(torch.tensor(c, dtype=torch.float64) for c in x0)
    got = tmppi.rollout_scores(model.step, model.cost, x, torch.tensor(v), torch.tensor(u_n), 1.0, control_inv)
    want = jmppi.rollout_scores(jstep, jcost, tuple(jnp.float64(c) for c in x0), jnp.asarray(v), jnp.asarray(u_n),
                                1.0, control_inv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    eps = rng.standard_normal((k, n))
    cfg = dict(kw, control_inv=control_inv)
    got = tmppi.mppi_solve(tmppi.MppiConfig(n_rollouts=k, **cfg), model.step, model.cost, None, x,
                           torch.tensor(u_n), noise=torch.tensor(eps))
    want = jmppi.mppi_solve(jmppi.MppiConfig(n_rollouts=k, **cfg), jstep, jcost, None,
                            tuple(jnp.float64(c) for c in x0), jnp.asarray(u_n), noise=jnp.asarray(eps))
    assert int(got.status) == int(want.status) == 0
    np.testing.assert_allclose(got.u_n.numpy(), np.asarray(want.u_n), rtol=1e-10, atol=1e-12)
