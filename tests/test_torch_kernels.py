"""The fused MPPI kernels of the port: one solve (K2), the chain (K1), the
scenario batch (K5/K6), the samplers (K3) and the fast math (K4).

On the CPU the wrappers run their plain versions, which are held here
against the JAX package: K2 against ``mppi_solve_pallas`` in interpret mode
on the same external noise, K1 against sequential ``mppi_solve(noise=)``
calls with the JAX plant step between them, the batch against
``mppi_pallas_batch_partials`` in interpret mode at a one-block (K5) and a
two-block (K6) shape, the fast math against ``mpc_rs_tpu.ops.fastmath``.
The Philox samplers are held to the Random123 known answers, to the numpy
mirror of the clt4 transform and to the moments of a normal. The kernels
themselves are held against these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_rs_tpu.controllers import mppi as jmppi
from mpc_rs_tpu.models import costs as jcosts
from mpc_rs_tpu.models import dynamics as jdyn
from mpc_rs_tpu.models.params import CartPoleParams as JParams
from mpc_rs_tpu.ops import fastmath as jfm
from mpc_rs_tpu.ops import mppi_pallas as jpallas
from mpc_rs_tpu.ops.mppi_pallas import finalize_partials, mppi_pallas_batch_partials, mppi_solve_pallas
from mpc_rs_tpu_torch.controllers.mppi import MppiConfig, MppiStatus
from mpc_rs_tpu_torch.models.params import CartPoleParams
from mpc_rs_tpu_torch.ops import build, mppi_cuda, philox
from mpc_rs_tpu_torch.ops import fastmath as tfm
from mpc_rs_tpu_torch.ops.mppi_cuda import (
    CartPoleShaped4,
    Flagship4Diag4,
    finalize_batch_fused,
    mppi_batch_partials_fused,
    mppi_chain_fused,
    mppi_solve_batch_fused,
    mppi_solve_fused,
)
from mpc_rs_tpu_torch.ops.philox import philox4x32_10, philox_normal, sample_noise
from tests.test_fastmath import _clt2q_transform, _clt4_transform

N = 8
BS, LANES = 8, 128  # Pallas block: 8 sublanes x 128 lanes = 1024 rollouts
X0 = (0.5, 0.0, 0.1, 0.0)
MODEL = CartPoleShaped4(CartPoleParams.single_wheel(), 0.1)
JSTEP = jdyn.make_cartpole_nonlinear(JParams.single_wheel(), 0.1)
F32_BAND = dict(rtol=1e-3, atol=2e-4)  # tests/test_pallas.py:59
F64_BAND = dict(rtol=1e-9, atol=1e-12)  # same math, another summation order


def _cfg(k, lam=0.5, **kw):
    return MppiConfig(n_horizon=N, n_rollouts=k, lambda_=lam, std_dev=3.0, limit=(-20.0, 20.0), **kw)


def _jcfg(k, lam=0.5):
    return jmppi.MppiConfig(n_horizon=N, n_rollouts=k, lambda_=lam, std_dev=3.0, limit=(-20.0, 20.0))


# --------------------------------------------------------------------------
# K2 plain version


@pytest.mark.parametrize("k", [2048, 1324])  # a block multiple and a ragged K
def test_k2_plain_matches_pallas_interpret(k):
    nb = -(-k // (BS * LANES))
    rng = np.random.default_rng(k)
    eps = (3.0 * rng.standard_normal((nb, N, BS, LANES))).astype(np.float32)
    # poison the Pallas padding: it must not leak into either result
    flat = np.arange(nb * BS * LANES).reshape(nb, BS, LANES)
    for t in range(N):
        eps[:, t][flat >= k] = -1.2
    u_n = (0.5 * rng.standard_normal(N)).astype(np.float32)
    want_u, want_st = mppi_solve_pallas(
        _jcfg(k), JSTEP, jcosts.shaped4, 4, 0, jnp.asarray(X0, jnp.float32), jnp.asarray(u_n),
        block_sublanes=BS, interpret=True, noise=jnp.asarray(eps),
    )
    eps_kn = eps.transpose(0, 2, 3, 1).reshape(-1, N)[:k]  # tests/test_pallas.py:37
    got_u, got_st = mppi_solve_fused(
        _cfg(k), MODEL, torch.tensor(X0, dtype=torch.float32), torch.tensor(u_n),
        noise=torch.tensor(eps_kn),
    )
    assert int(got_st) == int(want_st) == MppiStatus.OK
    np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u), **F32_BAND)


@pytest.mark.parametrize("k", [1, 255, 1000, 3 * 256])
def test_k2_plain_f64_matches_mppi_solve(k):
    """Per-block partials merged by log-sum-exp equal the one-pass solve."""
    rng = np.random.default_rng(k)
    eps = 3.0 * rng.standard_normal((k, N))
    u_n = rng.standard_normal(N)
    want = jmppi.mppi_solve(_jcfg(k), JSTEP, jcosts.shaped4, None, tuple(jnp.float64(c) for c in X0),
                            jnp.asarray(u_n), noise=jnp.asarray(eps))
    got_u, got_st = mppi_solve_fused(_cfg(k), MODEL, torch.tensor(X0, dtype=torch.float64),
                                     torch.tensor(u_n), noise=torch.tensor(eps))
    assert int(got_st) == int(want.status) == MppiStatus.OK
    np.testing.assert_allclose(got_u.numpy(), np.asarray(want.u_n), **F64_BAND)


@pytest.mark.parametrize("lam", [0.5, 20.0])
@pytest.mark.parametrize("k", [1000, 4 * 256 * 3 + 17])
def test_k2_plain_rows_of_four_match_mppi_solve(k, lam):
    """With rows of 4·256 rollouts, and f32(1/λ)'s multiply in place of the
    JAX solver's division by λ, the plain solve stays within 1e-9 of
    ``mppi_solve`` in float64."""
    rng = np.random.default_rng(k)
    eps = 3.0 * rng.standard_normal((k, N))
    u_n = rng.standard_normal(N)
    want = jmppi.mppi_solve(_jcfg(k, lam), JSTEP, jcosts.shaped4, None, tuple(jnp.float64(c) for c in X0),
                            jnp.asarray(u_n), noise=jnp.asarray(eps))
    got_u, got_st = mppi_solve_fused(_cfg(k, lam), MODEL, torch.tensor(X0, dtype=torch.float64),
                                     torch.tensor(u_n), noise=torch.tensor(eps), rollouts_per_thread=4)
    assert int(got_st) == int(want.status) == MppiStatus.OK
    np.testing.assert_allclose(got_u.numpy(), np.asarray(want.u_n), **F64_BAND)


@pytest.mark.parametrize("k, b, want", [
    (1024, 1024, 4),  # cartpole4: 1 024 blocks
    (8192, 1024, 4),  # flagship6: 8 192 blocks
    (819_200, 1, 4),  # K1/K2 at the headline K: 800 blocks
    (800_000, 1, 4),  # mppi4-non-liner: 782 blocks
    (10_240, 1, 1),  # K1 at K=10 240: R=4 would be 10 blocks
    (65_536, 8, 1),  # K6's multi-block shape: 512 blocks at R=4
    (1224, 8, 1),  # the CPU tests' sizes keep today's rows
])
def test_rollouts_per_thread_at_the_paths_shapes(k, b, want):
    assert mppi_cuda.rollouts_per_thread(k, b) == want
    nb = -(-k // (mppi_cuda.BLOCK * want))
    assert nb * b >= mppi_cuda.MIN_BLOCKS or want == 1


@pytest.mark.parametrize("k", [1000, 4 * 256 * 3 + 17])
def test_plain_rows_of_four_blocks_merge_to_the_one_block_rows(k):
    """Rows of 4·256 rollouts hold the same sums as rows of 256, merged
    in another order: the two solves agree within 1e-12 in float64, and
    so does a fleet of two scenarios (a ragged last row in each)."""
    rng = np.random.default_rng(k)
    cfg = _cfg(k, 2.0)
    xs = torch.tensor(np.stack([X0, (0.3, 0.1, -0.1, 0.0)]))
    u_ns = torch.tensor(0.5 * rng.standard_normal((2, N)))
    noise = torch.tensor(3.0 * rng.standard_normal((2, k, N)))
    p1 = mppi_cuda.mppi_batch_partials_plain(cfg, MODEL, xs, u_ns, noise, rollouts_per_thread=1)
    p4 = mppi_cuda.mppi_batch_partials_plain(cfg, MODEL, xs, u_ns, noise, rollouts_per_thread=4)
    assert p1.shape == (2, -(-k // 256), N + 2) and p4.shape == (2, -(-k // 1024), N + 2)
    (u1, s1), (u4, s4) = mppi_cuda.finalize_batch_plain(cfg, p1), mppi_cuda.finalize_batch_plain(cfg, p4)
    assert s1.tolist() == s4.tolist() == [0, 0]
    np.testing.assert_allclose(u4.numpy(), u1.numpy(), rtol=1e-12, atol=1e-12)
    got = mppi_solve_batch_fused(cfg, MODEL, xs, u_ns, noise=noise, rollouts_per_thread=4)
    assert torch.equal(got[0], u4) and torch.equal(got[1], s4)
    with pytest.raises(ValueError, match="rollouts_per_thread"):
        mppi_cuda.mppi_batch_partials_plain(cfg, MODEL, xs, u_ns, noise, rollouts_per_thread=2)


def test_inv_lambda_folds_in_double_and_keeps_lambda_0_invalid():
    assert mppi_cuda.inv_lambda(0.5) == 2.0 and mppi_cuda.inv_lambda(1.4) == 1.0 / 1.4
    assert mppi_cuda.inv_lambda(0.0) == float("inf")
    u, st = mppi_solve_fused(_cfg(2048, 0.0), MODEL, torch.tensor(X0), torch.zeros(N), seed=5,
                             rollouts_per_thread=4)
    assert int(st) == MppiStatus.INVALID_U and torch.equal(u, torch.zeros(N))


def _probe(x=X0, lam=0.5, k=512, device="cpu"):
    x = torch.tensor(x, dtype=torch.float32, device=device)
    return mppi_solve_fused(_cfg(k, lam), MODEL, x, torch.zeros(N, device=device), seed=5)


@pytest.mark.parametrize("probe, status", [
    (dict(x=(float("nan"), 0.0, 0.1, 0.0)), MppiStatus.NO_FINITE),
    (dict(lam=0.0), MppiStatus.INVALID_U),
    (dict(k=1), MppiStatus.OK),
    (dict(k=1000), MppiStatus.OK),
])
def test_k2_plain_failure_probes(probe, status):
    u, st = _probe(**probe)
    assert int(st) == status
    if status != MppiStatus.OK:
        np.testing.assert_array_equal(u.numpy(), 0.0)
    else:
        assert np.isfinite(u.numpy()).all()


def test_k2_plain_partials_mask_empty_blocks():
    """A block with no finite rollout has m = NEG_BIG, s = uw = 0, and
    merges to exactly nothing."""
    cfg = _cfg(512)
    noise = torch.zeros(512, N)
    x = torch.tensor(X0)
    parts = mppi_cuda.mppi_partials_plain(cfg, MODEL, x, torch.zeros(N), noise)
    assert parts.shape == (2, N + 2)
    dead = torch.tensor([[mppi_cuda.NEG_BIG, 0.0] + [0.0] * N])
    u1, s1 = mppi_cuda.finalize_batch_plain(cfg, parts)
    u2, s2 = mppi_cuda.finalize_batch_plain(cfg, torch.cat([parts, dead]))
    assert int(s1) == int(s2) == 0 and torch.equal(u1, u2)
    u3, s3 = mppi_cuda.finalize_batch_plain(cfg, dead)
    assert int(s3) == MppiStatus.NO_FINITE and torch.equal(u3, torch.zeros(N))


# --------------------------------------------------------------------------
# Philox


@pytest.mark.parametrize("counter, key, want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, want):
    """Random123's known-answer vectors, on ints and on int64 tensors."""
    assert philox4x32_10(counter, key) == want
    got = philox4x32_10(tuple(torch.tensor([c]) for c in counter), key)
    assert tuple(int(g) for g in got) == want


def test_philox_normal_moments():
    """2**20 samples: mean and variance within 5e-3 of (0, 1), kurtosis
    within 0.02 of 3 (about 3.5 and 4 standard errors)."""
    z = philox_normal(11, 0, 1 << 17, N, 1.0, device="cpu").double()
    assert z.shape == (1 << 17, N) and z.numel() == 1 << 20
    assert abs(float(z.mean())) < 5e-3
    assert abs(float(z.var()) - 1.0) < 5e-3
    kurt = float(((z - z.mean()) ** 4).mean() / z.var() ** 2)
    assert abs(kurt - 3.0) < 0.02
    assert abs(float(philox_normal(11, 0, 4096, N, 3.0, device="cpu").std()) - 3.0) < 0.1


def test_philox_normal_is_deterministic_in_seed_solve_and_k():
    a = philox_normal(7, 2, 1000, N, 3.0, device="cpu")
    assert torch.equal(a, philox_normal(7, 2, 1000, N, 3.0, device="cpu"))
    # rollout k's row does not depend on K: a prefix is the smaller draw
    assert torch.equal(a[:300], philox_normal(7, 2, 300, N, 3.0, device="cpu"))
    # steps past 4 come from a second counter; a shorter horizon is a prefix
    assert torch.equal(a[:, :6], philox_normal(7, 2, 1000, 6, 3.0, device="cpu"))
    for other in [(8, 2), (7, 3), (-7, 2)]:
        assert not torch.equal(a, philox_normal(*other, 1000, N, 3.0, device="cpu"))
    # a negative seed keys the stream of its uint32 bit pattern
    assert torch.equal(philox_normal(-1, 0, 64, N, 1.0, device="cpu"),
                       philox_normal(0xFFFFFFFF, 0, 64, N, 1.0, device="cpu"))


def test_k2_sampled_solve_uses_philox_noise():
    cfg, x, u_n = _cfg(2048), torch.tensor(X0), torch.zeros(N)
    eps = philox_normal(9, 4, 2048, N, 3.0, device="cpu")
    want = mppi_solve_fused(cfg, MODEL, x, u_n, noise=eps)
    got = mppi_solve_fused(cfg, MODEL, x, u_n, seed=9, solve=4)
    assert torch.equal(want[0], got[0]) and int(got[1]) == 0


# --------------------------------------------------------------------------
# K1 plain version


# In float32 at the app's λ=0.5 and K=1024 the softmax has an effective
# sample size near 1: rounding decides which rollout wins, and the JAX f32
# chain itself drifts up to 0.1 from its f64 chain on some seeds. So the
# app's λ is held in f64, and the f32 band at λ=20 (ESS ~120), where the
# chain is well conditioned.
@pytest.mark.parametrize("dtype, lam, band", [
    (np.float64, 0.5, F64_BAND),
    (np.float32, 20.0, F32_BAND),
])
def test_k1_plain_matches_sequential_jax(dtype, lam, band):
    j, k = 8, 1024
    rng = np.random.default_rng(42)
    noise = 3.0 * rng.standard_normal((j, k, N))
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    got = mppi_chain_fused(_cfg(k, lam), MODEL, torch.tensor(X0, dtype=tdt), torch.zeros(N, dtype=tdt),
                           n_solves=j, noise=torch.tensor(noise.astype(dtype)), plant=True)
    x = tuple(jnp.asarray(c, dtype) for c in X0)
    u_n = jnp.zeros(N, dtype)
    u0s, sts = [], []
    for i in range(j):
        r = jmppi.mppi_solve(_jcfg(k, lam), JSTEP, jcosts.shaped4, None, x, u_n,
                             noise=jnp.asarray(noise[i], dtype))
        u_n = r.u_n
        u0s.append(float(u_n[0]))
        sts.append(int(r.status))
        x = JSTEP(*x, u_n[0])
    assert got.statuses.tolist() == sts == [0] * j
    np.testing.assert_allclose(got.u0s.numpy(), u0s, **band)
    np.testing.assert_allclose(got.u_n.numpy(), np.asarray(u_n), **band)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(x), **band)


def test_k1_plain_seed_modes():
    cfg, x, u_n = _cfg(512), torch.tensor(X0), torch.zeros(N)
    seeds = torch.tensor([3, -4, 5], dtype=torch.int32)
    per = mppi_chain_fused(cfg, MODEL, x, u_n, seeds=seeds)
    scal = mppi_chain_fused(cfg, MODEL, x, u_n, n_solves=3, base_seed=99)
    for r in (per, scal):
        assert r.u0s.shape == (3,) and r.statuses.shape == (3,) and r.statuses.dtype == torch.int32
        assert r.u_n.shape == (N,) and torch.equal(r.x, x)  # no plant: x held
        assert (r.statuses == 0).all()
    # per-solve seed j draws what a single solve with that seed draws;
    # scalar mode draws (base_seed, solve=j)
    u = u_n
    for j in range(3):
        u, _ = mppi_solve_fused(cfg, MODEL, x, u, seed=int(seeds[j]))
        assert float(per.u0s[j]) == float(u[0])
    u = u_n
    for j in range(3):
        u, _ = mppi_solve_fused(cfg, MODEL, x, u, seed=99, solve=j)
        assert float(scal.u0s[j]) == float(u[0])
    assert torch.equal(scal.u_n, u)


def test_k2_plant_x_steps_like_the_chain():
    """A chain with the plant on is J single solves with one model step of
    the plant state, by each solve's u0, between them."""
    cfg, u_n = _cfg(512), torch.zeros(N)
    chain = mppi_chain_fused(cfg, MODEL, torch.tensor(X0), u_n, n_solves=4, base_seed=8, plant=True)
    plant_x = torch.tensor(X0)
    for j in range(4):
        u_n, _ = mppi_solve_fused(cfg, MODEL, plant_x, u_n, seed=8, solve=j)
        assert float(chain.u0s[j]) == float(u_n[0])
        plant_x = torch.stack(MODEL.step(*plant_x.unbind(), u_n[0]))
    assert torch.equal(chain.x, plant_x) and not torch.equal(plant_x, torch.tensor(X0))


def test_k1_plain_no_finite_gives_zeros():
    x = torch.tensor((float("nan"), 0.0, 0.1, 0.0))
    r = mppi_chain_fused(_cfg(256), MODEL, x, torch.ones(N), n_solves=4)
    assert (r.statuses == MppiStatus.NO_FINITE).all()
    assert torch.equal(r.u0s, torch.zeros(4)) and torch.equal(r.u_n, torch.zeros(N))


def test_k1_rejects_bad_seeding():
    cfg, x, u_n = _cfg(256), torch.tensor(X0), torch.zeros(N)
    with pytest.raises(ValueError, match="exactly one"):
        mppi_chain_fused(cfg, MODEL, x, u_n)
    with pytest.raises(ValueError, match="exactly one"):
        mppi_chain_fused(cfg, MODEL, x, u_n, seeds=torch.zeros(2, dtype=torch.int32), n_solves=2)
    with pytest.raises(ValueError, match="solves"):
        mppi_chain_fused(cfg, MODEL, x, u_n, n_solves=2, noise=torch.zeros(3, 256, N))


# --------------------------------------------------------------------------
# build and dispatch without a card


def test_wrappers_reject_other_devices():
    x = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        mppi_solve_fused(_cfg(256), MODEL, x, torch.zeros(N, device="meta"))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_model_constants_fold_in_double():
    p = CartPoleParams.single_wheel()
    c = MODEL.constants()
    assert len(c) == 9 and c[5] == p.mass_line * p.m2 * p.g * p.l and c[8] == 0.1


# --------------------------------------------------------------------------
# K4: fast math outside a kernel


@pytest.fixture(scope="module")
def fm_inputs():
    rng = np.random.default_rng(42)  # the draws of tests/test_fastmath.py
    return dict(
        x=rng.uniform(-100.0, 100.0, 200_000).astype(np.float32),
        u=rng.uniform(1e-7, 100.0, 200_000).astype(np.float32),
        s=rng.uniform(1e-6, 1e4, 200_000).astype(np.float32),
    )


@pytest.mark.parametrize("fn, arg", [("fsin", "x"), ("fcos", "x"), ("flog", "u")])
def test_fastmath_bit_identical_to_jax(fm_inputs, fn, arg):
    """The same polynomials in the same order on float32: equal bits."""
    a = fm_inputs[arg]
    want = np.asarray(getattr(jfm, fn)(jnp.asarray(a)))
    got = getattr(tfm, fn)(torch.tensor(a)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn", ["frsqrt", "fsqrt"])
def test_fastmath_rsqrt_within_two_ulps_of_jax(fm_inputs, fn):
    """rsqrt itself is the library's (XLA's and PyTorch's may differ by an
    ulp); after the Newton step the two stay within 2 ulps."""
    a = fm_inputs["s"]
    want = np.asarray(getattr(jfm, fn)(jnp.asarray(a)))
    got = getattr(tfm, fn)(torch.tensor(a)).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=2)


def test_fastmath_error_bounds(fm_inputs):
    """The JAX package's bounds (tests/test_fastmath.py:20-46)."""
    x, u, s = (torch.tensor(fm_inputs[k]) for k in "xus")
    assert float((tfm.fsin(x) - torch.sin(x)).abs().max()) < 1e-5
    assert float((tfm.fcos(x) - torch.cos(x)).abs().max()) < 1e-5
    sn, cs = tfm.fsincos(x)
    assert torch.equal(sn, tfm.fsin(x)) and torch.equal(cs, tfm.fcos(x))
    assert float((tfm.flog(u) - torch.log(u)).abs().max()) < 2e-6
    assert float(((tfm.fsqrt(s) - torch.sqrt(s)).abs() / torch.sqrt(s)).max()) < 1e-6
    huge = torch.tensor([1e6, -1e6, 3.4e37, -3.4e37])
    assert torch.isfinite(tfm.fsin(huge)).all() and torch.isfinite(tfm.fcos(huge)).all()


def test_fastmath_division_is_exact_outside_a_kernel(fm_inputs):
    rng = np.random.default_rng(1)
    num = torch.tensor(rng.uniform(0.01, 10.0, 4096), dtype=torch.float32)
    den = torch.tensor(rng.uniform(0.5, 2.0, 4096), dtype=torch.float32)
    assert torch.equal(tfm.fdiv(num, den), num / den)
    assert torch.equal(tfm.freciprocal(den), 1.0 / den)
    # the CPU dispatch of the kernel probe runs these same functions
    assert torch.equal(mppi_cuda.fastmath_eval("fdiv", num, den), num / den)
    assert torch.equal(mppi_cuda.fastmath_eval("fsin", num), tfm.fsin(num))
    with pytest.raises(ValueError, match="fdiv takes"):
        mppi_cuda.fastmath_eval("fdiv", num)


# --------------------------------------------------------------------------
# K5/K6: the scenario batch, plain version

FLAG = Flagship4Diag4(CartPoleParams.two_wheel(), 0.15)
JFLAG = jdyn.make_flagship4(JParams.two_wheel(), 0.15)
JDIAG = jcosts.make_diag4(0.1, 0.1, 1.0, 0.5)


def _batch_case(k, nb, seed, b=8):
    rng = np.random.default_rng(seed)
    eps = (3.0 * rng.standard_normal((b, nb, N, BS, LANES))).astype(np.float32)
    flat = np.arange(nb * BS * LANES).reshape(nb, BS, LANES)
    for t in range(N):  # poison the Pallas padding
        eps[:, :, t][np.broadcast_to(flat >= k, (b, nb, BS, LANES))] = 55.5
    xs = np.stack([np.linspace(-0.3, 0.3, b), np.zeros(b), np.linspace(0.2, -0.2, b), np.zeros(b)],
                  axis=-1).astype(np.float32)
    u_ns = (0.5 * rng.standard_normal((b, N))).astype(np.float32)
    eps_bkn = eps.transpose(0, 1, 3, 4, 2).reshape(b, -1, N)[:, :k]  # _rollout_index order
    return eps, xs, u_ns, eps_bkn


# K5: one block per scenario (tests/test_pallas.py:302); K6: two K-blocks
# (tests/test_pallas.py:242), each with a ragged K.
@pytest.mark.parametrize("k, nb, which", [(BS * LANES - 300, 1, "cartpole"), (BS * LANES + 200, 2, "flagship")])
def test_batch_plain_matches_pallas_interpret(k, nb, which):
    model, jstep, jcost = (MODEL, JSTEP, jcosts.shaped4) if which == "cartpole" else (FLAG, JFLAG, JDIAG)
    eps, xs, u_ns, eps_bkn = _batch_case(k, nb, k)
    jc = jmppi.MppiConfig(n_horizon=N, n_rollouts=k, lambda_=2.5, std_dev=3.0, limit=(-20.0, 20.0))
    parts = mppi_pallas_batch_partials(jc, jstep, jcost, 4, jnp.zeros(8, jnp.int32), jnp.asarray(xs),
                                       jnp.asarray(u_ns), interpret=True, block_sublanes=BS,
                                       noise=jnp.asarray(eps))
    want_u, want_st = jax.vmap(lambda p, u: finalize_partials(jc, p, u))(parts, jnp.asarray(u_ns))
    cfg = _cfg(k, 2.5)
    got_p = mppi_batch_partials_fused(cfg, model, torch.tensor(xs), torch.tensor(u_ns),
                                      noise=torch.tensor(eps_bkn))
    assert got_p.shape == (8, -(-k // mppi_cuda.BLOCK), N + 2)
    got_u, got_st = finalize_batch_fused(cfg, got_p)
    assert got_st.tolist() == np.asarray(want_st).tolist() == [0] * 8
    np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u), **F32_BAND)


@pytest.mark.parametrize("which", ["cartpole", "flagship"])
def test_batch_plain_fast_tier_matches_jax_vmap_f64(which):
    """The fast tier outside a kernel (exact division), in float64: each
    scenario equals the JAX vmap solver with the fast model on its noise."""
    k, b = 700, 4
    model = CartPoleShaped4(CartPoleParams.single_wheel(), 0.1, fast=True) if which == "cartpole" else \
        Flagship4Diag4(CartPoleParams.two_wheel(), 0.15, fast=True)
    jstep, jcost = (jdyn.make_cartpole_nonlinear(JParams.single_wheel(), 0.1, fast=True), jcosts.shaped4) \
        if which == "cartpole" else (jdyn.make_flagship4(JParams.two_wheel(), 0.15, fast=True), JDIAG)
    rng = np.random.default_rng(3)
    noise = 3.0 * rng.standard_normal((b, k, N))
    xs = 0.2 * rng.standard_normal((b, 4))
    u_ns = rng.standard_normal((b, N))
    got_u, got_st = mppi_solve_batch_fused(_cfg(k), model, torch.tensor(xs), torch.tensor(u_ns),
                                           noise=torch.tensor(noise))
    for i in range(b):
        want = jmppi.mppi_solve(_jcfg(k), jstep, jcost, None, tuple(jnp.asarray(xs[i])), jnp.asarray(u_ns[i]),
                                noise=jnp.asarray(noise[i]))
        assert int(got_st[i]) == int(want.status) == 0
        np.testing.assert_allclose(got_u[i].numpy(), np.asarray(want.u_n), **F64_BAND)


def test_batch_plain_status_per_scenario():
    """NaN state in one scenario: status 1 and zeros there, the others OK;
    λ = 0 gives INVALID_U everywhere."""
    xs = torch.tensor([X0] * 4)
    xs[2, 0] = float("nan")
    seeds = torch.arange(4, dtype=torch.int32)
    u, st = mppi_solve_batch_fused(_cfg(512), MODEL, xs, torch.zeros(4, N), seeds=seeds, sampler="clt4")
    assert st.tolist() == [0, 0, MppiStatus.NO_FINITE, 0]
    assert torch.equal(u[2], torch.zeros(N)) and torch.isfinite(u).all()
    u, st = mppi_solve_batch_fused(_cfg(512, 0.0), MODEL, torch.tensor([X0] * 4), torch.zeros(4, N),
                                   seeds=seeds, sampler="clt4")
    assert (st == MppiStatus.INVALID_U).all() and torch.equal(u, torch.zeros(4, N))


@pytest.mark.parametrize("sampler", philox.SAMPLERS)
def test_batch_sampled_solve_uses_contract_noise(sampler):
    """In-kernel sampling on the CPU is the plain tier fed the contract's
    noise; scenario b's box-muller noise is a single solve's (seed b, solve b)."""
    cfg, b = _cfg(600), 3
    seeds = torch.tensor([5, -6, 7], dtype=torch.int32)
    xs, u_ns = torch.tensor([X0] * b), torch.zeros(b, N)
    noise = sample_noise(sampler, seeds, torch.arange(b), 600, N, 3.0)
    out = torch.empty(b, 600, N)
    got = mppi_batch_partials_fused(cfg, MODEL, xs, u_ns, seeds=seeds, sampler=sampler, noise_out=out)
    assert torch.equal(got, mppi_batch_partials_fused(cfg, MODEL, xs, u_ns, noise=noise))
    assert torch.equal(out, noise)
    if sampler == "box-muller":
        for i in range(b):
            assert torch.equal(noise[i], philox_normal(int(seeds[i]), i, 600, N, 3.0, device="cpu"))


def test_batch_wrapper_rejects_bad_arguments():
    cfg, xs, u_ns = _cfg(256), torch.tensor([X0] * 2), torch.zeros(2, N)
    with pytest.raises(ValueError, match="exactly one"):
        mppi_batch_partials_fused(cfg, MODEL, xs, u_ns)
    with pytest.raises(ValueError, match="sampler must be"):
        mppi_batch_partials_fused(cfg, MODEL, xs, u_ns, seeds=torch.zeros(2, dtype=torch.int32), sampler="clt8")
    meta = torch.zeros(2, 4, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        mppi_batch_partials_fused(cfg, MODEL, meta, torch.zeros(2, N, device="meta"),
                                  noise=torch.zeros(2, 256, N, device="meta"))


def test_flagship_constants_fold_in_double():
    p = CartPoleParams.two_wheel()
    ml, mll_j2 = p.m2 * p.l, p.m2 * p.l * p.l + p.j2
    c = FLAG.constants()
    assert len(c) == 17 and c[2] == mll_j2 * ml and c[13] == (2.0 * mll_j2 / p.r_w) * p.kt and c[16] == 0.15
    assert FLAG.cost_constants() == [0.1, 0.1, 1.0, 0.5]


# --------------------------------------------------------------------------
# K3: the clt4, clt4a and wallace samplers' plain versions


def _ks_normal(z: np.ndarray) -> float:
    from math import erf, sqrt

    zs = np.sort(z)
    grid = np.linspace(-3.5, 3.5, 141)
    phi = np.array([0.5 * (1 + erf(g / sqrt(2))) for g in grid])
    return float(np.abs(np.searchsorted(zs, grid) / len(zs) - phi).max())


def test_clt4_bits_match_the_numpy_mirror():
    """Each normal is the clt4 transform of its contract word, equal to
    tests/test_fastmath.py's mirror in float32."""
    k = 4096
    w = philox._words(torch.tensor([21]), torch.tensor([3]), k, 2)
    words = torch.stack(w, dim=-1).reshape(k, 8).numpy().astype(np.uint32)
    z = sample_noise("clt4", 21, 3, k, N, 2.5)[0].numpy()
    np.testing.assert_allclose(z, _clt4_transform(words, 2.5).astype(np.float32), rtol=1e-6, atol=1e-6)
    # the mirror's integer part, then its float ops in float32 as the kernel
    # rounds them (mppi_pallas.py:141-149): equal bits
    x2 = (words & 0x00FF00FF) + ((words >> 8) & 0x00FF00FF)
    s4 = ((x2 & 0xFFFF) + (x2 >> 16)).astype(np.float32)
    z32 = (s4 - np.float32(510.0)) * np.float32(philox._CLT_INV_SIG)
    e32 = z32 * (np.float32(philox._CLT_A * 2.5) + np.float32(philox._CLT_B * 2.5) * (z32 * z32))
    np.testing.assert_array_equal(z, e32)


def test_clt4_moments_and_ks():
    """2**20 samples: the bounds of tests/test_fastmath.py:165-178."""
    z = sample_noise("clt4", 9, 0, 1 << 17, N, 1.0)[0].double().numpy().ravel()
    assert abs(z.mean()) < 5e-3 and abs(z.var() - 1.0) < 5e-3
    assert abs(((z - z.mean()) ** 4).mean() / z.var() ** 2 - 3.0) < 0.02
    assert _ks_normal(z) < 0.005
    assert 0.8 * 0.0455 < (np.abs(z) > 2.0).mean() < 1.2 * 0.0455


@pytest.mark.parametrize("k", [1024, 1001])
def test_clt4a_pairs_have_exactly_zero_mean(k):
    """Rollouts 2j and 2j+1 carry +eps and -eps; with an odd K the last
    rollout is the +eps of its pair; the marginals are clt4's."""
    z = sample_noise("clt4a", 4, 1, k, N, 3.0)[0]
    full = z[: k - k % 2].reshape(-1, 2, N)
    assert torch.equal(full[:, 0] + full[:, 1], torch.zeros_like(full[:, 0]))
    eps = sample_noise("clt4", 4, 1, -(-k // 2), N, 3.0)[0]
    assert torch.equal(z[0::2], eps) and torch.equal(z[1::2], -eps[: k // 2])


def test_wallace_exact_marginals_and_uncorrelated_steps():
    """Every step is N(0, σ²) by KS (exact marginals: tighter than clt4's
    budget); steps of a window are uncorrelated; the pool steps are the
    exact Box-Muller pair."""
    k = 1 << 17
    z = sample_noise("wallace", 13, 2, k, N, 1.0)[0].double().numpy()
    for t in range(N):
        assert _ks_normal(z[:, t]) < 0.006, t
        assert abs(z[:, t].var() - 1.0) < 0.02
    corr = np.corrcoef(z.T)
    assert np.abs(corr - np.eye(N)).max() < 0.015
    z3 = sample_noise("wallace", 13, 2, 512, N, 3.0)[0]
    assert torch.allclose(z3, 3.0 * sample_noise("wallace", 13, 2, 512, N, 1.0)[0], rtol=1e-6, atol=1e-6)


def test_wallace_rotation_stays_in_the_warp():
    """Step ph of rollout k mixes the b of rollout (k & ~31) | ((k - s) & 31):
    a prefix of K draws the same noise, and whole warps are independent."""
    a = sample_noise("wallace", 3, 0, 300, N, 1.0)[0]
    b = sample_noise("wallace", 3, 0, 64, N, 1.0)[0]
    assert torch.equal(a[:64], b)
    w = philox._words(torch.tensor([3]), torch.tensor([0]), 256, 1)
    u1, u2 = philox._uniforms(w[0][0, :, 0], w[1][0, :, 0])
    pb = torch.sqrt(-2.0 * torch.log(u1)) * torch.sin(philox._TWO_PI_F32 * u2)
    ph, k = 2, 5
    s = (29 * ph + 13) % 32
    pa = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(philox._TWO_PI_F32 * u2)
    sign = -1.0 if (int(w[2][0, k, 0]) << (ph - 2)) & 0x80000000 else 1.0
    mix = torch.tensor(1.0 / np.sqrt(2.0), dtype=torch.float32)
    assert float(a[k, ph]) == float(mix * (sign * pa[k] + pb[(k & ~31) | ((k - s) & 31)]))


# --------------------------------------------------------------------------
# K3: clt2q and box-muller-a, the last two samplers


def test_samplers_are_the_jax_packages():
    assert philox.SAMPLERS == jpallas.SAMPLERS


def test_clt2q_bits_match_the_contract():
    """Steps 8c+2i and 8c+2i+1 of rollout k are the low and high halves of
    word i of call (k, c): the numpy mirror of tests/test_fastmath.py in
    float64, and in float32 as the kernel rounds (mppi_pallas.py:180-193)."""
    k, n = 2048, 12  # two calls per rollout, the second one cut at step 12
    w = philox._words(torch.tensor([21]), torch.tensor([3]), k, 2)
    words = torch.stack(w, dim=-1)[0].numpy().astype(np.uint32)  # (K, C, 4)
    z = sample_noise("clt2q", 21, 3, k, n, 2.5)[0].numpy()
    x2 = (words & 0x00FF00FF) + ((words >> 8) & 0x00FF00FF)
    halves = np.stack([x2 & 0xFFFF, x2 >> 16], axis=-1).reshape(k, -1)[:, :n]  # step 8c + 2i + h
    zz = (halves.astype(np.float32) - np.float32(255.0)) * np.float32(philox._TRI_INV_SIG)
    s2 = zz * zz
    qa, qb, qc = (np.float32(c * 2.5) for c in (philox._TRI_A, philox._TRI_B, philox._TRI_C))
    np.testing.assert_array_equal(z, zz * (qa + s2 * (qb + qc * s2)))
    mirror = _clt2q_transform(words[:, 0, 0], 2.5)  # word 0: steps 0 (low) and 1 (high)
    np.testing.assert_allclose(z[:, :2], mirror.reshape(2, k).T, rtol=1e-5, atol=1e-5)


def test_clt2q_moments_and_ks():
    """2**20 samples: the moments and the KS budget (0.012) of
    tests/test_fastmath.py:154-178."""
    z = sample_noise("clt2q", 9, 0, 1 << 17, N, 1.0)[0].double().numpy().ravel()
    assert abs(z.mean()) < 5e-3 and abs(z.var() - 1.0) < 5e-3
    assert abs(((z - z.mean()) ** 4).mean() / z.var() ** 2 - 3.0) < 0.02
    assert _ks_normal(z) < 0.012
    assert 0.8 * 0.0455 < (np.abs(z) > 2.0).mean() < 1.2 * 0.0455


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("k", [1024, 1001])
def test_box_muller_a_pairs_are_box_muller_with_exact_zero_sums(k, fast):
    """Rollouts 2j and 2j+1 carry +eps and -eps of pair j's box-muller draw
    (calls keyed by the pair index); a full pair sums to exactly 0."""
    z = sample_noise("box-muller-a", 4, 1, k, N, 3.0, fast=fast)[0]
    full = z[: k - k % 2].reshape(-1, 2, N)
    assert torch.equal(full[:, 0] + full[:, 1], torch.zeros_like(full[:, 0]))
    eps = sample_noise("box-muller", 4, 1, -(-k // 2), N, 3.0, fast=fast)[0]
    assert torch.equal(z[0::2], eps) and torch.equal(z[1::2], -eps[: k // 2])


def test_box_muller_a_exact_marginals():
    """Every step's marginal is N(0, σ²) by KS at the wallace budget."""
    z = sample_noise("box-muller-a", 13, 2, 1 << 17, N, 1.0)[0].double().numpy()
    for t in range(N):
        assert _ks_normal(z[:, t]) < 0.006, t
        assert abs(z[:, t].var() - 1.0) < 0.02


# --------------------------------------------------------------------------
# K1/K2: every sampler, both tiers


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("sampler", philox.SAMPLERS)
def test_k2_plain_sampler_and_tier_match_jax(sampler, fast):
    """A sampled K2 solve in float64 is the JAX solver with the model of the
    tier fed the contract's words for (seed, solve); the seeded solve uses
    exactly those words."""
    k, seed, solve = 700, 9, 4
    model = CartPoleShaped4(CartPoleParams.single_wheel(), 0.1, fast=fast)
    jstep = jdyn.make_cartpole_nonlinear(JParams.single_wheel(), 0.1, fast=fast)
    cfg, x, u_n = _cfg(k), torch.tensor(X0, dtype=torch.float64), 0.3 * torch.ones(N, dtype=torch.float64)
    words = mppi_cuda.solve_noise(cfg, model, seed, solve, sampler)
    assert torch.equal(words, sample_noise(sampler, seed, solve, k, N, 3.0, fast=fast)[0])
    got_u, got_st = mppi_solve_fused(cfg, model, x, u_n, seed=seed, solve=solve, sampler=sampler)
    want = jmppi.mppi_solve(_jcfg(k), jstep, jcosts.shaped4, None, tuple(jnp.float64(c) for c in X0),
                            jnp.asarray(u_n.numpy()), noise=jnp.asarray(words.double().numpy()))
    assert int(got_st) == int(want.status) == MppiStatus.OK
    np.testing.assert_allclose(got_u.numpy(), np.asarray(want.u_n), **F64_BAND)


@pytest.mark.parametrize("sampler, fast", [("clt4a", True), ("wallace", False)])
def test_k1_plain_bench_configs_match_sequential_jax(sampler, fast):
    """bench.py:97-101's two chain configurations (clt4a in the fast tier,
    wallace in the exact tier), plant on, at λ=20 in float32: J solves each
    equal to the JAX solver fed the contract's words of (base_seed, j),
    with the JAX model step of the tier between them."""
    j, k, base_seed = 6, 1024, 31
    model = CartPoleShaped4(CartPoleParams.single_wheel(), 0.1, fast=fast)
    jstep = jdyn.make_cartpole_nonlinear(JParams.single_wheel(), 0.1, fast=fast)
    got = mppi_chain_fused(_cfg(k, 20.0), model, torch.tensor(X0), torch.zeros(N), n_solves=j,
                           base_seed=base_seed, plant=True, sampler=sampler)
    x = tuple(jnp.float32(c) for c in X0)
    u_n = jnp.zeros(N, jnp.float32)
    u0s = []
    for i in range(j):
        words = mppi_cuda.solve_noise(_cfg(k, 20.0), model, base_seed, i, sampler).numpy()
        r = jmppi.mppi_solve(_jcfg(k, 20.0), jstep, jcosts.shaped4, None, x, u_n, noise=jnp.asarray(words))
        assert int(r.status) == 0
        u_n = r.u_n
        u0s.append(float(u_n[0]))
        x = jstep(*x, u_n[0])
    assert got.statuses.tolist() == [0] * j
    np.testing.assert_allclose(got.u0s.numpy(), u0s, **F32_BAND)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(x), **F32_BAND)


# --------------------------------------------------------------------------
# the merged row of a rank (the multi-GPU solve's partials)


@pytest.mark.parametrize("rpt", [1, 4])
@pytest.mark.parametrize("lam", [0.5, 0.0])
def test_merged_row_plain_is_the_rows_log_sum_exp(lam, rpt):
    """The merged row's plain version is ``finalize_batch_plain``'s
    log-sum-exp over the blocks' rows (m = max m_b, each row scaled by
    exp((m_b − m) f32(1/λ)), summed), with no ladder: finishing it as one
    row gives the solve. A scenario with no finite rollout writes NEG_BIG
    and zeros, and its solve is NO_FINITE; at λ = 0 the solve is INVALID_U."""
    b, k = 3, 4 * 256 * 3 + 17
    cfg = _cfg(k, lam)
    rng = np.random.default_rng(4)
    xs = torch.tensor(np.tile(X0, (b, 1)) + 0.05 * rng.normal(size=(b, 4)))
    xs[1, 0] = float("nan")
    u_ns = torch.tensor(0.3 * rng.normal(size=(b, N)))
    noise = torch.tensor(3.0 * rng.normal(size=(b, k, N)))
    rows = mppi_cuda.mppi_batch_partials_plain(cfg, MODEL, xs, u_ns, noise, rollouts_per_thread=rpt)
    merged = mppi_cuda.mppi_batch_partials_merged_plain(cfg, MODEL, xs, u_ns, noise, rollouts_per_thread=rpt)
    m_b = rows[..., 0]
    m = m_b.amax(-1)
    scale = torch.where(m_b > mppi_cuda.NO_FINITE_BELOW, torch.exp((m_b - m[:, None]) * mppi_cuda.inv_lambda(lam)),
                        0.0)
    want = torch.cat([m[:, None], (rows[..., 1:] * scale[..., None]).sum(1)], -1)
    assert torch.equal(merged, want) or (lam == 0.0 and torch.equal(merged.isnan(), want.isnan()))
    assert merged[1, 0] == torch.tensor(mppi_cuda.NEG_BIG, dtype=torch.float64) and bool((merged[1, 1:] == 0).all())
    u, st = finalize_batch_fused(cfg, merged[:, None])
    want_u, want_st = mppi_cuda.finalize_batch_plain(cfg, rows)
    assert st.tolist() == want_st.tolist()
    assert st[1] == MppiStatus.NO_FINITE and (st[0] == (MppiStatus.INVALID_U if lam == 0.0 else MppiStatus.OK))
    np.testing.assert_allclose(u.numpy(), want_u.numpy(), **F64_BAND)


@pytest.mark.parametrize("sampler", ["box-muller", "clt4a"])
def test_merged_row_wrappers_on_the_cpu(sampler):
    """On CPU tensors the merged-row wrappers run their plain version on
    the noise the kernel samples (``solve_noise`` at P = 1, ``batch_noise``
    from ``first_scenario`` in the batch), count no launch, and finishing
    the row gives ``mppi_solve_fused``'s solve, bit for bit in float32."""
    k = 2000
    cfg = _cfg(k)
    x, u_n = torch.tensor(X0, dtype=torch.float32), torch.zeros(N)
    mppi_cuda.reset_launches()
    row = mppi_cuda.mppi_partials_merged_fused(cfg, MODEL, x, u_n, seed=9, solve=3, sampler=sampler)
    noise = mppi_cuda.solve_noise(cfg, MODEL, 9, 3, sampler)
    assert torch.equal(row, mppi_cuda.mppi_partials_merged_plain(cfg, MODEL, x, u_n, noise))
    u, st = mppi_solve_fused(cfg, MODEL, x, u_n, seed=9, solve=3, sampler=sampler)
    fu, fst = finalize_batch_fused(cfg, row[None, None])
    assert torch.equal(fu[0], u) and int(fst[0]) == int(st) == MppiStatus.OK
    seeds = torch.tensor([5, 6, 7], dtype=torch.int32)
    xs, u_ns = x.expand(3, 4).contiguous(), torch.zeros(3, N)
    rows = mppi_cuda.mppi_batch_partials_merged_fused(cfg, MODEL, xs, u_ns, seeds=seeds, sampler=sampler,
                                                      first_scenario=4)
    want = mppi_cuda.mppi_batch_partials_merged_plain(cfg, MODEL, xs, u_ns,
                                                      mppi_cuda.batch_noise(cfg, MODEL, seeds, sampler, 4))
    assert torch.equal(rows, want)
    whole = mppi_cuda.mppi_solve_batch_fused(cfg, MODEL, x.expand(7, 4).contiguous(), torch.zeros(7, N),
                                             seeds=torch.tensor([0, 0, 0, 0, 5, 6, 7], dtype=torch.int32),
                                             sampler=sampler)
    assert torch.equal(finalize_batch_fused(cfg, rows[:, None])[0], whole[0][4:])
    assert mppi_cuda.launches["mppi_partials_merged_fused"] == mppi_cuda.launches[
        "mppi_batch_partials_merged_fused"] == 0
    with pytest.raises(ValueError, match="exactly one"):
        mppi_cuda.mppi_batch_partials_merged_fused(cfg, MODEL, xs, u_ns)
