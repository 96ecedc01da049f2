"""The CUDA kernels of the port against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips without a CUDA device.

This file imports neither JAX nor the JAX package, so it also runs where
only the port is installed; ``tests/conftest.py`` sets JAX up, so on such a
machine run it without the conftest:

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from mpc_rs_tpu_torch.controllers.mppi import MppiConfig, MppiStatus
from mpc_rs_tpu_torch.models.params import CartPoleParams
from mpc_rs_tpu_torch.ops import mppi_cuda
from mpc_rs_tpu_torch.ops.mppi_cuda import CartPoleShaped4, mppi_chain_fused, mppi_solve_fused
from mpc_rs_tpu_torch.ops.philox import philox_normal

N = 8
X0 = (0.5, 0.0, 0.1, 0.0)
MODEL = CartPoleShaped4(CartPoleParams.single_wheel(), 0.1)
# the band the JAX package holds its own kernel to (tests/test_pallas.py:59)
F32_BAND = dict(rtol=1e-3, atol=2e-4)


def _cfg(k, lam=0.5, n=N):
    return MppiConfig(n_horizon=n, n_rollouts=k, lambda_=lam, std_dev=3.0, limit=(-20.0, 20.0))


def _probe(x=X0, lam=0.5, k=512, device="cpu"):
    x = torch.tensor(x, dtype=torch.float32, device=device)
    return mppi_solve_fused(_cfg(k, lam), MODEL, x, torch.zeros(N, device=device), seed=5)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card (see the module docstring)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 1000, 10240])
def test_cuda_k2_matches_plain(card, k):
    rng = np.random.default_rng(k)
    noise = torch.tensor(3.0 * rng.standard_normal((k, N)), dtype=torch.float32, device=card)
    u_n = torch.tensor(rng.standard_normal(N), dtype=torch.float32, device=card)
    x = torch.tensor(X0, device=card)
    got_u, got_st = mppi_solve_fused(_cfg(k), MODEL, x, u_n, noise=noise)
    want_u, want_st = mppi_cuda.mppi_solve_plain(_cfg(k), MODEL, x.double(), u_n.double(),
                                                 noise=noise.double())
    torch.cuda.synchronize()
    assert int(got_st) == int(want_st) == 0
    np.testing.assert_allclose(got_u.cpu().numpy(), want_u.cpu().numpy(), **F32_BAND)


@pytest.mark.cuda
def test_cuda_k2_philox_matches_plain(card):
    cfg, x, u_n = _cfg(10240), torch.tensor(X0, device=card), torch.zeros(N, device=card)
    got_u, got_st = mppi_solve_fused(cfg, MODEL, x, u_n, seed=17, solve=3)
    eps = philox_normal(17, 3, 10240, N, 3.0, device=card)
    want_u, want_st = mppi_cuda.mppi_solve_plain(cfg, MODEL, x.double(), u_n.double(), noise=eps.double())
    assert int(got_st) == int(want_st) == 0
    np.testing.assert_allclose(got_u.cpu().numpy(), want_u.cpu().numpy(), **F32_BAND)


@pytest.mark.cuda
@pytest.mark.parametrize("probe, status", [
    (dict(x=(float("nan"), 0.0, 0.1, 0.0)), MppiStatus.NO_FINITE),
    (dict(lam=0.0), MppiStatus.INVALID_U),
    (dict(k=1), MppiStatus.OK),
])
def test_cuda_k2_failure_probes(card, probe, status):
    u, st = _probe(**probe, device=card)
    assert int(st) == status
    if status != MppiStatus.OK:
        assert torch.equal(u.cpu(), torch.zeros(N))


# The plant-on chains run at λ=20: at the app's λ=0.5 the softmax's effective
# sample size is near 1, and a closed loop turns a last-bit difference in the
# plant step into another winning rollout within a few solves.
CHAIN_LAMBDA = 20.0


@pytest.mark.cuda
def test_cuda_k1_matches_sequential_k2(card):
    """The chain with the plant on equals J single K2 solves with the plant
    stepped by the plain model step (float32, on the card) between them."""
    cfg, x, u_n = _cfg(10240, CHAIN_LAMBDA), torch.tensor(X0, device=card), torch.zeros(N, device=card)
    seeds = torch.arange(16, dtype=torch.int32, device=card) * 7 - 30
    chain = mppi_chain_fused(cfg, MODEL, x, u_n, seeds=seeds, plant=True)
    u0s, sts = [], []
    for j in range(16):
        u_n, st = mppi_solve_fused(cfg, MODEL, x, u_n, seed=int(seeds[j]))
        x = torch.stack(MODEL.step(*x.unbind(), u_n[0]))
        u0s.append(float(u_n[0]))
        sts.append(int(st))
    assert chain.statuses.tolist() == sts == [0] * 16
    np.testing.assert_allclose(chain.u0s.cpu().numpy(), u0s, **F32_BAND)
    np.testing.assert_allclose(chain.x.cpu().numpy(), x.cpu().numpy(), **F32_BAND)


@pytest.mark.cuda
@pytest.mark.parametrize("seeding", ["seeds", "base_seed"])
def test_cuda_k1_plant_matches_plain_chain(card, seeding):
    """The chain with the plant on against its plain version in float64."""
    cfg, x, u_n = _cfg(10240, CHAIN_LAMBDA), torch.tensor(X0, device=card), torch.zeros(N, device=card)
    kw = (dict(seeds=torch.arange(16, dtype=torch.int32, device=card) * 7 - 30) if seeding == "seeds"
          else dict(n_solves=16, base_seed=77))
    got = mppi_chain_fused(cfg, MODEL, x, u_n, plant=True, **kw)
    want = mppi_cuda.mppi_chain_plain(cfg, MODEL, x.double(), u_n.double(), plant=True, **kw)
    assert got.statuses.tolist() == want.statuses.tolist() == [0] * 16
    for a, b in [(got.u0s, want.u0s), (got.u_n, want.u_n), (got.x, want.x)]:
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), **F32_BAND)


@pytest.mark.cuda
def test_cuda_k1_plant_step_matches_model_step(card):
    """One plant step of the finalize kernel against the plain model step in
    float64, on the kernel's own u0."""
    x = torch.tensor(X0, device=card)
    one = mppi_chain_fused(_cfg(10240), MODEL, x, torch.zeros(N, device=card), n_solves=1,
                           base_seed=3, plant=True)
    want = torch.stack(MODEL.step(*x.double().unbind(), one.u0s[0].double()))
    assert int(one.statuses[0]) == 0 and float(one.u0s[0]) != 0.0
    np.testing.assert_allclose(one.x.cpu().numpy(), want.cpu().numpy(), **F32_BAND)


@pytest.mark.cuda
def test_cuda_wrappers_check_inputs(card):
    cfg, x, u_n = _cfg(256), torch.tensor(X0, device=card), torch.zeros(N, device=card)
    with pytest.raises(TypeError, match="dtype"):
        mppi_solve_fused(cfg, MODEL, x.double(), u_n)
    with pytest.raises(ValueError, match="shape"):
        mppi_solve_fused(cfg, MODEL, x, torch.zeros(N + 1, device=card))
    with pytest.raises(ValueError, match="contiguous"):
        mppi_solve_fused(cfg, MODEL, x, torch.zeros(2 * N, device=card)[::2])
    with pytest.raises(ValueError, match="horizon"):
        mppi_solve_fused(_cfg(256, n=3), MODEL, x, torch.zeros(3, device=card))
