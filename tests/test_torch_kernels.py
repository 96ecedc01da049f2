"""The fused MPPI solve (K2) and chain (K1) of the port.

On the CPU the wrappers run their plain versions, which are held here
against the JAX package: K2 against ``mppi_solve_pallas`` in interpret mode
on the same external noise, K1 against sequential ``mppi_solve(noise=)``
calls with the JAX plant step between them. The Philox sampler is held to
the Random123 known answers and to the moments of a normal. The kernels
themselves are held against these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

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
from mpc_rs_tpu_torch.models.params import CartPoleParams
from mpc_rs_tpu_torch.ops import build, mppi_cuda
from mpc_rs_tpu_torch.ops.mppi_cuda import CartPoleShaped4, mppi_chain_fused, mppi_solve_fused
from mpc_rs_tpu_torch.ops.philox import philox4x32_10, philox_normal

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
    u1, s1 = mppi_cuda.finalize_partials_plain(cfg, parts)
    u2, s2 = mppi_cuda.finalize_partials_plain(cfg, torch.cat([parts, dead]))
    assert int(s1) == int(s2) == 0 and torch.equal(u1, u2)
    u3, s3 = mppi_cuda.finalize_partials_plain(cfg, dead)
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
