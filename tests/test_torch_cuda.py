"""The CUDA kernels of the port against their plain PyTorch versions, on the
card: K2 and K1 (each sampler, both tiers), the scenario batch (K5/K6)
with each sampler (K3), the solve merged inside the partials launch at
R = 1 and 4 rollouts a thread, the fast-math device functions (K4), the
fused estimator chain (K7) and the two diagnostic probes (D1, D2). Every
test here is marked ``cuda`` and skips without a CUDA device.

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
from mpc_rs_tpu_torch.apps.fleet import build_fleet
from mpc_rs_tpu_torch.ops import diag_cuda, estimator_cuda, mppi_cuda, philox
from mpc_rs_tpu_torch.ops.mppi_cuda import CartPoleShaped4, Flagship4Diag4, mppi_chain_fused, mppi_solve_fused
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


# --------------------------------------------------------------------------
# the scenario batch (K5/K6), its samplers (K3) and the fast math (K4)

FLAG = Flagship4Diag4(CartPoleParams.two_wheel(), 0.15, fast=True)
CART_FAST = CartPoleShaped4(CartPoleParams.single_wheel(), 0.1, fast=True)


def _fleet_inputs(card, b, which, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    xs = 0.2 * torch.randn((b, 4), generator=g, device=card)
    if which == "cartpole":
        xs = xs + torch.tensor(X0, device=card)
    u_ns = 0.5 * torch.randn((b, N), generator=g, device=card)
    return xs, u_ns


# The fleets' σ and limits at λ=20 (cartpole) and λ=50 (flagship), where
# the f32 solve is well conditioned. At the apps' λ (0.5, 1.4) the flagship's
# f32 solve is ill-conditioned in itself: 1.2 s of an unstable pendulum
# amplifies the last bit of a rollout about a thousandfold, and the plain
# f32 version misses the float64 one by up to 7e-3 (PERF.md). The
# kernel is held to the band where the problem allows it, and at the app's
# λ to the plain f32 version's own distance from float64.
def _fleet_cfg(k, which, lam=None):
    sd = 10.0 if which == "cartpole" else 4.0
    lam = lam or (20.0 if which == "cartpole" else 50.0)
    return MppiConfig(n_horizon=N, n_rollouts=k, lambda_=lam, std_dev=sd, limit=(-10.0, 10.0))


@pytest.mark.cuda
@pytest.mark.parametrize("which, b, k", [("cartpole", 64, 1024), ("flagship", 16, 8192), ("cartpole", 2, 65536)])
def test_cuda_batch_external_noise_matches_plain(card, which, b, k):
    model = CART_FAST if which == "cartpole" else FLAG
    cfg = _fleet_cfg(k, which)
    xs, u_ns = _fleet_inputs(card, b, which)
    noise = cfg.std_dev * torch.randn((b, k, N), device=card)
    got_u, got_st = mppi_cuda.mppi_solve_batch_fused(cfg, model, xs, u_ns, noise=noise)
    want_u, want_st = mppi_cuda.mppi_solve_batch_fused(cfg, model, xs.cpu().double(), u_ns.cpu().double(),
                                                       noise=noise.cpu().double())
    torch.cuda.synchronize()
    assert got_st.cpu().tolist() == want_st.tolist() == [0] * b
    np.testing.assert_allclose(got_u.cpu().numpy(), want_u.numpy(), **F32_BAND)


@pytest.mark.cuda
def test_cuda_batch_app_lambda_as_close_as_f32_allows(card):
    """flagship6's λ=1.4: the kernel's distance from the float64 plain
    version is within twice the plain float32 version's own distance."""
    cfg = _fleet_cfg(8192, "flagship", lam=1.4)
    xs, u_ns = _fleet_inputs(card, 64, "flagship")
    noise = cfg.std_dev * torch.randn((64, 8192, N), device=card)
    got, _ = mppi_cuda.mppi_solve_batch_fused(cfg, FLAG, xs, u_ns, noise=noise)
    f32, _ = mppi_cuda.mppi_solve_batch_fused(cfg, FLAG, xs.cpu(), u_ns.cpu(), noise=noise.cpu())
    f64, _ = mppi_cuda.mppi_solve_batch_fused(cfg, FLAG, xs.cpu().double(), u_ns.cpu().double(),
                                              noise=noise.cpu().double())
    err = float((got.cpu().double() - f64).abs().max())
    assert err <= 2.0 * float((f32.double() - f64).abs().max()) + 2e-4


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", philox.SAMPLERS)
@pytest.mark.parametrize("fast", [False, True])
def test_cuda_batch_sampler_matches_plain(card, sampler, fast):
    """The kernel's in-kernel noise is the contract's (checked through
    noise_out), and the solve equals the plain version fed that noise."""
    b, k = 32, 1000  # a ragged K: a partial last block, an even pair count
    model = CartPoleShaped4(CartPoleParams.single_wheel(), 0.1, fast=fast)
    cfg = _fleet_cfg(k, "cartpole")
    xs, u_ns = _fleet_inputs(card, b, "cartpole", seed=1)
    seeds = torch.arange(b, dtype=torch.int32, device=card) * 977 - 5000
    out = torch.empty((b, k, N), device=card)
    parts = mppi_cuda.mppi_batch_partials_fused(cfg, model, xs, u_ns, seeds=seeds, sampler=sampler, noise_out=out)
    got_u, got_st = mppi_cuda.finalize_batch_fused(cfg, parts)
    want_noise = mppi_cuda.batch_noise(cfg, model, seeds, sampler)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.cpu().numpy(), want_noise.cpu().numpy(), rtol=1e-5, atol=1e-5)
    want_u, want_st = mppi_cuda.finalize_batch_plain(cfg, mppi_cuda.mppi_batch_partials_plain(
        cfg, model, xs.double(), u_ns.double(), out.double()))
    assert got_st.cpu().tolist() == want_st.cpu().tolist() == [0] * b
    np.testing.assert_allclose(got_u.cpu().numpy(), want_u.cpu().numpy(), **F32_BAND)
    if sampler in ("clt4a", "box-muller-a"):
        assert torch.equal(out[:, 0::2] + out[:, 1::2], torch.zeros_like(out[:, 0::2]))
    if sampler in ("clt4", "clt2q", "clt4a"):  # integer ops and a polynomial: the same bits
        assert torch.equal(out, want_noise)


@pytest.mark.cuda
def test_cuda_batch_failure_probes(card):
    cfg = _fleet_cfg(1024, "cartpole")
    xs = torch.tensor([X0] * 8, device=card)
    xs[5, 0] = float("nan")
    seeds = torch.arange(8, dtype=torch.int32, device=card)
    u, st = mppi_cuda.mppi_solve_batch_fused(cfg, CART_FAST, xs, torch.zeros(8, N, device=card),
                                             seeds=seeds, sampler="clt4")
    assert st.cpu().tolist() == [0, 0, 0, 0, 0, MppiStatus.NO_FINITE, 0, 0]
    assert torch.equal(u[5].cpu(), torch.zeros(N)) and bool(torch.isfinite(u).all())
    lam0 = MppiConfig(n_horizon=N, n_rollouts=1024, lambda_=0.0, std_dev=10.0, limit=(-10.0, 10.0))
    u, st = mppi_cuda.mppi_solve_batch_fused(lam0, CART_FAST, torch.tensor([X0] * 8, device=card),
                                             torch.zeros(8, N, device=card), seeds=seeds, sampler="clt4")
    assert (st == MppiStatus.INVALID_U).all() and torch.equal(u.cpu(), torch.zeros(8, N))
    # K1/K2 take the flagship at N = 8 (mppi4-non-liner-ukf's solve); no other N
    with pytest.raises(ValueError, match="no kernel for horizon N=20"):
        mppi_solve_fused(_cfg(256, n=20), FLAG, torch.tensor(X0, device=card), torch.zeros(20, device=card))


@pytest.mark.cuda
@pytest.mark.parametrize("fn", mppi_cuda.FASTMATH_FNS)
def test_cuda_fastmath_matches_plain(card, fn):
    """The device functions against ops/fastmath.py on the same inputs; the
    bounds of tests/test_fastmath.py (rcp: relative error < 3e-5)."""
    rng = np.random.default_rng(42)
    lo, hi = {"fsin": (-100, 100), "fcos": (-100, 100), "flog": (1e-7, 100)}.get(fn, (1e-3, 1e4))
    a = torch.tensor(rng.uniform(lo, hi, 1 << 20), dtype=torch.float32, device=card)
    b = torch.tensor(rng.uniform(0.5, 2.0, 1 << 20), dtype=torch.float32, device=card) if fn == "fdiv" else None
    got = mppi_cuda.fastmath_eval(fn, a, b).double().cpu()
    want = mppi_cuda.fastmath_eval(fn, a.cpu(), None if b is None else b.cpu()).double()
    if fn in ("freciprocal", "fdiv"):
        assert float(((got - want).abs() / want.abs()).max()) < 3e-5
    elif fn in ("frsqrt", "fsqrt"):
        assert float(((got - want).abs() / want.abs()).max()) < 1e-6
    else:
        assert float((got - want).abs().max()) < (2e-6 if fn == "flog" else 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("fn", mppi_cuda.FASTMATH_FNS)
def test_cuda_fastmath_scalar_paths_match_vector_path(card, fn):
    """The probe's scalar instantiation (a view 4 bytes off 16-byte
    alignment) and its count % 4 tail give the bits of the vector path."""
    rng = np.random.default_rng(7)
    a = torch.tensor(rng.uniform(0.5, 50.0, 4099), dtype=torch.float32, device=card)
    b = torch.tensor(rng.uniform(0.5, 2.0, 4099), dtype=torch.float32, device=card) if fn == "fdiv" else None
    full = mppi_cuda.fastmath_eval(fn, a, b)
    tail_b = None if b is None else b[1:]
    off = mppi_cuda.fastmath_eval(fn, a[1:], tail_b)
    tail = mppi_cuda.fastmath_eval(fn, a[1:].clone(), None if b is None else tail_b.clone())
    assert a[1:].data_ptr() % 16 != 0
    for got in (off, tail):
        assert torch.equal(got.view(torch.int32), full[1:].view(torch.int32))


# --------------------------------------------------------------------------
# the merged solve: R rollouts a thread, the merge inside the launch

SOURCES = ("external", *philox.SAMPLERS)
RAGGED_K = (1000, 4 * 256 * 3 + 17)  # a ragged last block at R = 1 and at R = 4


def _tickets_zero(card, p):
    torch.cuda.synchronize()
    return bool((mppi_cuda.merge_tickets(card, p) == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("rpt", [1, 4])
@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("which", ["cartpole", "flagship"])
def test_cuda_merged_solve_matches_plain(card, which, fast, source, rpt):
    """The batched solve in one launch, each scenario's last block merging
    its rows, against the plain version in float64 on the noise the kernel
    used (rows of 256·R rollouts), at the f32 band; equal to the rows-only
    launch merged by ``finalize_batch_fused``; its noise bit for bit the
    same at the other R; the tickets zero after it."""
    b, k = 16, RAGGED_K[1]
    model = (CartPoleShaped4(CartPoleParams.single_wheel(), 0.1, fast=fast) if which == "cartpole"
             else Flagship4Diag4(CartPoleParams.two_wheel(), 0.15, fast=fast))
    cfg = _fleet_cfg(k, which)
    xs, u_ns = _fleet_inputs(card, b, which, seed=rpt)
    if source == "external":
        kw = dict(noise=cfg.std_dev * torch.randn((b, k, N), generator=torch.Generator(device=card).manual_seed(2),
                                                  device=card))
    else:
        kw = dict(seeds=torch.arange(b, dtype=torch.int32, device=card) * 613 - 999, sampler=source)
    out = torch.empty((b, k, N), device=card)
    got_u, got_st = mppi_cuda.mppi_solve_batch_fused(cfg, model, xs, u_ns, noise_out=out, rollouts_per_thread=rpt, **kw)
    assert _tickets_zero(card, b)
    want_u, want_st = mppi_cuda.finalize_batch_plain(cfg, mppi_cuda.mppi_batch_partials_plain(
        cfg, model, xs.double(), u_ns.double(), out.double(), rollouts_per_thread=rpt))
    assert got_st.cpu().tolist() == want_st.cpu().tolist() == [0] * b
    np.testing.assert_allclose(got_u.cpu().numpy(), want_u.cpu().numpy(), **F32_BAND)
    other = torch.empty_like(out)
    rows = mppi_cuda.mppi_batch_partials_fused(cfg, model, xs, u_ns, noise_out=other, rollouts_per_thread=rpt, **kw)
    assert rows.shape == (b, -(-k // (256 * rpt)), N + 2)
    fin_u, fin_st = mppi_cuda.finalize_batch_fused(cfg, rows)
    assert torch.equal(fin_u, got_u) and torch.equal(fin_st, got_st)
    mppi_cuda.mppi_batch_partials_fused(cfg, model, xs, u_ns, noise_out=other, rollouts_per_thread=5 - rpt, **kw)
    assert torch.equal(other, out)


@pytest.mark.cuda
@pytest.mark.parametrize("rpt", [1, 4])
@pytest.mark.parametrize("k", [*RAGGED_K, 819_200])
def test_cuda_k2_merged_at_r_matches_plain(card, k, rpt):
    """A K2 solve in one launch at R forced, with external noise and with
    in-kernel box-muller, against the plain version in float64 with the
    same rows; the ticket zero after each."""
    g = torch.Generator(device=card).manual_seed(k)
    noise = 3.0 * torch.randn((k, N), generator=g, device=card)
    u_n = 0.5 * torch.randn(N, generator=g, device=card)
    x = torch.tensor(X0, device=card)
    got_u, got_st = mppi_solve_fused(_cfg(k), MODEL, x, u_n, noise=noise, rollouts_per_thread=rpt)
    want_u, want_st = mppi_cuda.mppi_solve_plain(_cfg(k), MODEL, x.double(), u_n.double(), noise=noise.double(),
                                                 rollouts_per_thread=rpt)
    assert int(got_st) == int(want_st) == 0 and _tickets_zero(card, 1)
    np.testing.assert_allclose(got_u.cpu().numpy(), want_u.cpu().numpy(), **F32_BAND)
    got_u, got_st = mppi_solve_fused(_cfg(k), MODEL, x, u_n, seed=17, solve=3, rollouts_per_thread=rpt)
    eps = philox_normal(17, 3, k, N, 3.0, device=card)
    want_u, want_st = mppi_cuda.mppi_solve_plain(_cfg(k), MODEL, x.double(), u_n.double(), noise=eps.double(),
                                                 rollouts_per_thread=rpt)
    assert int(got_st) == int(want_st) == 0 and _tickets_zero(card, 1)
    np.testing.assert_allclose(got_u.cpu().numpy(), want_u.cpu().numpy(), **F32_BAND)


@pytest.mark.cuda
@pytest.mark.parametrize("rpt", [1, 4])
def test_cuda_k1_plant_at_r_matches_plain_chain(card, rpt):
    """K1 with the plant on, J launches whose last blocks step the plant,
    against the plain chain in float64 with the same rows, at R forced."""
    cfg, x, u_n = _cfg(RAGGED_K[1], CHAIN_LAMBDA), torch.tensor(X0, device=card), torch.zeros(N, device=card)
    got = mppi_chain_fused(cfg, MODEL, x, u_n, n_solves=12, base_seed=77, plant=True, rollouts_per_thread=rpt)
    want = mppi_cuda.mppi_chain_plain(cfg, MODEL, x.double(), u_n.double(), n_solves=12, base_seed=77, plant=True,
                                      rollouts_per_thread=rpt)
    assert got.statuses.tolist() == want.statuses.tolist() == [0] * 12 and _tickets_zero(card, 1)
    for a, b in [(got.u0s, want.u0s), (got.u_n, want.u_n), (got.x, want.x)]:
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), **F32_BAND)


@pytest.mark.cuda
@pytest.mark.parametrize("rpt", [1, 4])
def test_cuda_merged_failure_probes(card, rpt):
    """λ = 0 and a NaN state through the last block, with several blocks a
    problem: the statuses and zero fallbacks of the two-launch solve."""
    k = RAGGED_K[1]
    for kw, status in ((dict(x=(float("nan"), 0.0, 0.1, 0.0)), MppiStatus.NO_FINITE), (dict(lam=0.0), MppiStatus.INVALID_U)):
        x = torch.tensor(kw.get("x", X0), device=card)
        u, st = mppi_solve_fused(_cfg(k, kw.get("lam", 0.5)), MODEL, x, torch.ones(N, device=card), seed=5,
                                 rollouts_per_thread=rpt)
        assert int(st) == status and torch.equal(u.cpu(), torch.zeros(N))
        chain = mppi_chain_fused(_cfg(k, kw.get("lam", 0.5)), MODEL, x, torch.ones(N, device=card), n_solves=3,
                                 rollouts_per_thread=rpt)
        assert chain.statuses.tolist() == [status] * 3 and torch.equal(chain.u_n.cpu(), torch.zeros(N))
    xs = torch.tensor([X0] * 8, device=card)
    xs[5] = float("nan")
    seeds = torch.arange(8, dtype=torch.int32, device=card)
    u, st = mppi_cuda.mppi_solve_batch_fused(_fleet_cfg(k, "cartpole"), CART_FAST, xs, torch.zeros(8, N, device=card),
                                             seeds=seeds, sampler="clt4a", rollouts_per_thread=rpt)
    assert st.cpu().tolist() == [0, 0, 0, 0, 0, MppiStatus.NO_FINITE, 0, 0]
    assert torch.equal(u[5].cpu(), torch.zeros(N)) and bool(torch.isfinite(u).all()) and _tickets_zero(card, 8)


@pytest.mark.cuda
def test_cuda_tickets_are_zero_after_calls_and_kept_per_stream(card):
    """Every wrapper leaves its tickets at zero, after one call and after
    two in a row; another stream gets a buffer of its own."""
    cfg, x, u_n = _cfg(RAGGED_K[1]), torch.tensor(X0, device=card), torch.zeros(N, device=card)
    xs, u_ns = _fleet_inputs(card, 64, "cartpole")
    seeds = torch.arange(64, dtype=torch.int32, device=card)
    for _ in range(2):
        mppi_solve_fused(cfg, MODEL, x, u_n, seed=1)
        mppi_solve_fused(cfg, MODEL, x, u_n, seed=2)
        mppi_chain_fused(cfg, MODEL, x, u_n, n_solves=4, plant=True)
        mppi_cuda.mppi_solve_batch_fused(_fleet_cfg(1024, "cartpole"), CART_FAST, xs, u_ns, seeds=seeds, sampler="clt4")
        assert _tickets_zero(card, 1) and _tickets_zero(card, 64)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        u, st = mppi_solve_fused(cfg, MODEL, x, u_n, seed=1)
        side_tickets = mppi_cuda.merge_tickets(card, 1)
    torch.cuda.synchronize()
    assert side_tickets.data_ptr() != mppi_cuda.merge_tickets(card, 1).data_ptr()
    assert int(st) == 0 and bool((side_tickets == 0).all())


# --------------------------------------------------------------------------
# K1/K2 in bench.py's configurations, and the estimator chain (K7)


@pytest.mark.cuda
@pytest.mark.parametrize("sampler, fast", [("clt4a", True), ("wallace", False)])
def test_cuda_k2_k1_bench_configs_match_plain(card, sampler, fast):
    """clt4a in the fast tier and wallace in the exact tier (bench.py:97-101):
    a K2 solve against the plain version in float64 fed the contract's
    words, and the seeded chain equal to sequential K2 solves."""
    model = CartPoleShaped4(CartPoleParams.single_wheel(), 0.1, fast=fast)
    cfg, x, u_n = _cfg(10240), torch.tensor(X0, device=card), torch.zeros(N, device=card)
    got_u, got_st = mppi_solve_fused(cfg, model, x, u_n, seed=17, solve=3, sampler=sampler)
    words = mppi_cuda.solve_noise(cfg, model, 17, 3, sampler, device=card)
    want_u, want_st = mppi_cuda.mppi_solve_plain(cfg, model, x.double(), u_n.double(), noise=words.double())
    assert int(got_st) == int(want_st) == 0
    np.testing.assert_allclose(got_u.cpu().numpy(), want_u.cpu().numpy(), **F32_BAND)
    seeds = torch.arange(6, dtype=torch.int32, device=card) * 11 - 7
    chain = mppi_chain_fused(cfg, model, x, u_n, seeds=seeds, sampler=sampler)
    u, u0s = u_n, []
    for j in range(6):
        u, _ = mppi_solve_fused(cfg, model, x, u, seed=int(seeds[j]), sampler=sampler)
        u0s.append(float(u[0]))
    assert chain.statuses.tolist() == [0] * 6
    assert chain.u0s.cpu().tolist() == u0s  # the same launches, the same bits


# flagship6's float32 filter is ill-conditioned in a few x̂ entries at B ≥ 1 000:
# there two float32 evaluations in one order of operations differ past the
# band (on the card the kernel and its plain version in 2 entries at each B;
# on the CPU the JAX package's chain and the plain version,
# tests/test_torch_estimator_chain.py). At most this many may leave the band.
K7_ILL_MAX = 4


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3, 100, 1000, 1024])
@pytest.mark.parametrize("model", ["cartpole4", "flagship6"])
def test_cuda_estimator_chain_matches_plain(card, model, b):
    """K7 against its plain version on the same inputs: in float32 every
    entry within the band (flagship6 at B ≥ 1 000: all but at most
    ``K7_ILL_MAX``), and against float64 within twice the plain float32
    version's own distance + 2e-4; a NaN estimate comes back finite. At
    B = 1 and 3 a lane group of a half-filled warp has no scenario."""
    fl = build_fleet(model, None, card, scenarios=b, estimator_chain=True)
    chain = fl.tick.chain
    args = estimator_cuda.chain_inputs(chain, fl.carry.x, fl.carry.ukf.x)
    got = estimator_cuda.estimator_chain_fused(chain, *args)
    want = estimator_cuda.estimator_chain_plain(chain, *args)
    f64 = estimator_cuda.estimator_chain_plain(chain, *(a.double() for a in args))
    torch.cuda.synchronize()
    ill = model == "flagship6" and b >= 1000
    outside = 0
    for g32, w32, w64 in zip(got, want, f64):
        g32, w32, w64 = g32.double().cpu(), w32.double().cpu(), w64.cpu()
        out = (g32 - w32).abs() > F32_BAND["atol"] + F32_BAND["rtol"] * w32.abs()
        outside += int(out.sum())
        keep = ~out if ill else torch.ones_like(out)
        np.testing.assert_allclose(g32[keep].numpy(), w32[keep].numpy(), **F32_BAND)
        err, ref = float((g32 - w64).abs().max()), float((w32 - w64).abs().max())
        assert err <= 2.0 * ref + 2e-4
    assert outside <= K7_ILL_MAX
    assert torch.isfinite(got[1]).all() and torch.isfinite(got[2]).all()
    if chain.n_substeps == 1:  # the guard fired in the last substep: P is p_reset
        assert torch.equal(got[2][:, min(5, b - 1)].cpu(), chain.p_reset.flatten().cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3, 1024])
def test_cuda_estimator_chain_on_scaled_observations_matches_plain(card, b):
    """K7's instantiation on flagship6's scaled sensor (``obs_normalize``:
    hx / σ a channel, unit injected noise, R = diag(1/σ)) against its plain
    version, held as the raw chain is (the same allowance at B ≥ 1 000), but
    against float64 within twice the larger of the plain float32 version's
    distance on the card and on the CPU: on the CPU the JAX package's
    float32 chain and the plain one both sit 4.2e-4 from float64 in
    x̂[:, 5] at B = 3, the card's plain version 0.9e-4. One launch a call."""
    fl = build_fleet("flagship6", None, card, scenarios=b, estimator_chain=True, obs_normalize=True)
    chain = fl.tick.chain
    assert chain.model.obs_sigma is not None
    args = estimator_cuda.chain_inputs(chain, fl.carry.x, fl.carry.ukf.x)
    estimator_cuda.reset_launches()
    got = estimator_cuda.estimator_chain_fused(chain, *args)
    want = estimator_cuda.estimator_chain_plain(chain, *args)
    f64 = estimator_cuda.estimator_chain_plain(chain, *(a.double() for a in args))
    cpu_chain = build_fleet("flagship6", None, "cpu", scenarios=b, estimator_chain=True, obs_normalize=True).tick.chain
    cpu32 = estimator_cuda.estimator_chain_plain(cpu_chain, *(a.cpu() for a in args))
    torch.cuda.synchronize()
    assert estimator_cuda.launches["estimator_chain_fused"] == 1
    outside = 0
    for g32, w32, w64, c32 in zip(got, want, f64, cpu32):
        g32, w32, w64, c32 = g32.double().cpu(), w32.double().cpu(), w64.cpu(), c32.double()
        out = (g32 - w32).abs() > F32_BAND["atol"] + F32_BAND["rtol"] * w32.abs()
        outside += int(out.sum())
        keep = ~out if b >= 1000 else torch.ones_like(out)
        np.testing.assert_allclose(g32[keep].numpy(), w32[keep].numpy(), **F32_BAND)
        yardstick = max(float((w32 - w64).abs().max()), float((c32 - w64).abs().max()))
        assert float((g32 - w64).abs().max()) <= 2.0 * yardstick + 2e-4
    assert outside <= K7_ILL_MAX
    assert torch.isfinite(got[1]).all() and torch.isfinite(got[2]).all()


@pytest.mark.cuda
def test_cuda_raw_estimator_chain_keeps_the_parents_bits(card):
    """The raw instantiations' outputs on ``runtime/profile_fleet.py``'s
    inputs are the bits they had before the scaled sensor's instantiation
    was added (``chip_smoke.K7_RAW_DIGEST``)."""
    from chip_smoke import K7_RAW_DIGEST
    from mpc_rs_tpu_torch.runtime.profile_fleet import k7_digest, k7_outputs

    assert k7_digest(k7_outputs(estimator_cuda.chain_inputs)) == K7_RAW_DIGEST


# --------------------------------------------------------------------------
# the diagnostic probes: the op-mix chain (D1) and the mul-add chain (D2)


# ragged K for D1: 16 401 = 16 384 + 17 and 818 201 = 799·1024 + 25 leave a
# last block of 17 (25) rollouts at R = 1 and at R = 4. The partials tests'
# RAGGED_K are too few rollouts for the f32 band in a warm-started chain at
# λ = 0.5: at K = 3 089 the plain float32 version itself misses float64 by
# twice the band in `full` (the softmax weighs one or two rollouts).
D1_RAGGED_K = (16_401, 818_201)


def _d1(card, k, mode, j=8, seed=9, plain=None, **kw):
    cfg = _cfg(k)
    x, u_n = torch.tensor(X0, device=card), torch.zeros(N, device=card)
    if plain is None:
        return diag_cuda.kernel_mix_chain_fused(cfg, CART_FAST, x, u_n, mode=mode, n_solves=j, base_seed=seed, **kw)
    return diag_cuda.kernel_mix_chain_plain(cfg, CART_FAST, x.to(plain), u_n.to(plain), mode=mode, n_solves=j,
                                            base_seed=seed)


@pytest.mark.cuda
@pytest.mark.parametrize("k, rpt", [(16384, None), (819200, None), (D1_RAGGED_K[0], 1), (D1_RAGGED_K[0], 4),
                                    (D1_RAGGED_K[1], 4)])
@pytest.mark.parametrize("mode", diag_cuda.MODES)
def test_cuda_d1_kernel_mix_matches_plain(card, mode, k, rpt):
    """Eight held-state solves against the plain version in float64 on the
    same Philox words, at the probe's λ=0.5: at K=16 384 (R = 1 by the
    wrapper's rule), at the probe's K=819 200 (R = 4; nosample's ramp runs
    over all 100 of its blocks) and at a K that is no multiple of 256·R at
    R forced to 1 and 4, where the last block's rollouts past K weigh
    nothing; the ticket zero after each chain."""
    got = _d1(card, k, mode, rollouts_per_thread=rpt)
    want = _d1(card, k, mode, plain=torch.float64)
    assert _tickets_zero(card, 1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), **F32_BAND)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [D1_RAGGED_K[0], 819200])
@pytest.mark.parametrize("mode", ["full", "nosample", "noroll", "clt2q"])
def test_cuda_d1_r1_and_r4_agree(card, mode, k):
    """The R = 1 and R = 4 builds give the same chain within the band (the
    log-sum-exp folds in another order)."""
    r1, r4 = _d1(card, k, mode, rollouts_per_thread=1), _d1(card, k, mode, rollouts_per_thread=4)
    for a, b in zip(r1, r4):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), **F32_BAND)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16384, 819200])
def test_cuda_d1_chain_repeats_bit_for_bit(card, k):
    """The same chain twice with the same seed gives the same bits: every
    solve's merging block resets the ticket, so no solve merges early or
    waits; another seed gives other u0s."""
    first, again = _d1(card, k, "full", j=16), _d1(card, k, "full", j=16)
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
    assert not torch.equal(first[0], _d1(card, k, "full", j=16, seed=10)[0])
    assert _tickets_zero(card, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16384, 819200])
def test_cuda_d1_is_one_launch_a_solve(card, k):
    """torch.profiler sees J kernel_mix_partials_kernel launches in a chain
    of J solves, and no other kernel (no finalize). Dropped device events
    make it retry, up to five times."""
    cfg, x, u_n = _cfg(k), torch.tensor(X0, device=card), torch.zeros(N, device=card)

    def chain(j):
        return diag_cuda.kernel_mix_chain_fused(cfg, CART_FAST, x, u_n, mode="full", n_solves=j, base_seed=9)

    chain(6)  # the first call of a chain length captures its graph (and fills its buffers)
    torch.cuda.synchronize()
    names = []
    for _ in range(5):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            chain(6)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.name.startswith(("Memcpy", "Memset"))]
        assert len(names) <= 6 and all("kernel_mix_partials_kernel" in n for n in names), names
        if len(names) == 6:
            break
    assert len(names) == 6, names


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, rows", [(torch.float32, 64), (torch.bfloat16, 64), (torch.bfloat16, 128)])
def test_cuda_d2_fma_chain_bit_for_bit(card, dtype, rows):
    rng = np.random.default_rng(rows)
    x = torch.tensor(rng.choice([-1.0, 1.0], (rows, 128)) * rng.uniform(1.0, 2.0, (rows, 128)),
                     dtype=torch.float32, device=card).to(dtype)
    got = diag_cuda.fma_chain_fused(x, 256, 300)
    assert torch.equal(got, diag_cuda.fma_chain_plain(x, 256))
    with pytest.raises(ValueError, match="tiles"):
        diag_cuda.fma_chain_fused(torch.zeros((16, 128), dtype=dtype, device=card), 256, 1)


# --------------------------------------------------------------------------
# the MPPI application family: K1/K2 at each app's model and horizon

_SW, _TW = CartPoleParams.single_wheel(), CartPoleParams.two_wheel()
# app: (model, N, λ, σ, limit, x0, control_inv)
FAMILY = {
    "mppi2": (mppi_cuda.DoubleIntegratorQuad2(0.05), 40, 2.5, 1.0, 3.0, (1.0, 0.0), 2.5),
    "mppi4": (mppi_cuda.CartPoleLinearShaped4(_SW, 0.1), 8, 0.5, 3.0, 20.0, X0, None),
    "hw_flagship": (mppi_cuda.Commu4Cost4(_TW, 0.05), 20, 2.0, 2.0, 10.0, (0.0, 0.0, 0.1, 0.0), None),
    "flagship_k2": (Flagship4Diag4(_TW, 0.15), 8, 50.0, 4.0, 10.0, (0.0, 0.0, 0.05, 0.0), None),
}


def _family(app, k, lam=None):
    m, n, lam0, sd, lim, x0, inv = FAMILY[app]
    cfg = MppiConfig(n_horizon=n, n_rollouts=k, lambda_=lam0 if lam is None else lam, std_dev=sd,
                     limit=(-lim, lim), control_inv=inv)
    return m, n, cfg, x0


@pytest.mark.cuda
@pytest.mark.parametrize("rpt", [1, 4])
@pytest.mark.parametrize("k", [1000, 40_000])  # one block, and 157 blocks at R = 1 (the block's merge)
@pytest.mark.parametrize("app", list(FAMILY))
def test_cuda_family_k2_matches_plain(card, app, k, rpt):
    m, n, cfg, x0 = _family(app, k)
    rng = np.random.default_rng(k + n)
    noise = torch.tensor(cfg.std_dev * rng.standard_normal((k, n)), dtype=torch.float32, device=card)
    u_n = torch.tensor(0.3 * rng.standard_normal(n), dtype=torch.float32, device=card)
    x = torch.tensor(x0, dtype=torch.float32, device=card)
    got_u, got_st = mppi_solve_fused(cfg, m, x, u_n, noise=noise, rollouts_per_thread=rpt)
    want_u, want_st = mppi_cuda.mppi_solve_plain(cfg, m, x.double(), u_n.double(), noise=noise.double(),
                                                 rollouts_per_thread=rpt)
    assert int(got_st) == int(want_st) == 0
    np.testing.assert_allclose(got_u.cpu().numpy(), want_u.cpu().numpy(), **F32_BAND)
    rows = mppi_cuda.mppi_batch_partials_fused(cfg, m, x[None], u_n[None], noise=noise[None],
                                               rollouts_per_thread=rpt)
    want_rows = mppi_cuda.mppi_batch_partials_plain(cfg, m, x[None].double(), u_n[None].double(),
                                                    noise[None].double(), rollouts_per_thread=rpt)
    assert rows.shape == want_rows.shape == (1, -(-k // (256 * rpt)), n + 2)
    got_fin = mppi_cuda.finalize_batch_plain(cfg, rows.double())[0]
    np.testing.assert_allclose(got_fin.cpu().numpy(), want_u.cpu().numpy()[None], **F32_BAND)


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", philox.SAMPLERS)
@pytest.mark.parametrize("app", ["mppi2", "hw_flagship"])
def test_cuda_family_sampler_words_at_long_horizons(card, app, sampler):
    """The in-kernel noise at N=40 and N=20 is ops/philox.py's, and the
    sampled solve is the plain solve fed it."""
    m, n, cfg, x0 = _family(app, 3001)
    x, u_n = torch.tensor(x0, dtype=torch.float32, device=card), torch.zeros(n, device=card)
    out = torch.empty((1, 3001, n), device=card)
    mppi_cuda.mppi_batch_partials_fused(cfg, m, x[None], u_n[None], sampler=sampler, noise_out=out,
                                        seeds=torch.tensor([7], dtype=torch.int32, device=card))
    words = mppi_cuda.solve_noise(cfg, m, 7, 0, sampler, device=card)
    if sampler in ("clt4", "clt4a", "clt2q"):
        assert torch.equal(out[0], words)
    np.testing.assert_allclose(out[0].cpu().numpy(), words.cpu().numpy(), rtol=1e-5, atol=1e-5)
    got_u, got_st = mppi_solve_fused(cfg, m, x, u_n, seed=7, sampler=sampler)
    want_u, _ = mppi_cuda.mppi_solve_plain(cfg, m, x.double(), u_n.double(), noise=words.double())
    assert int(got_st) == 0
    np.testing.assert_allclose(got_u.cpu().numpy(), want_u.cpu().numpy(), **F32_BAND)


@pytest.mark.cuda
@pytest.mark.parametrize("app", ["mppi2", "hw_flagship", "flagship_k2"])
def test_cuda_family_plant_chain_matches_plain(card, app):
    """K1 in plant mode steps the solve's model (two states for mppi2), at
    a λ where the chain is well conditioned, against the float64 plain
    chain."""
    m, n, cfg, x0 = _family(app, 20_000, lam=200.0)
    x = torch.tensor(x0, dtype=torch.float32, device=card)
    chain = mppi_chain_fused(cfg, m, x, torch.zeros(n, device=card), n_solves=6, base_seed=4, plant=True,
                             sampler="wallace")
    plain = mppi_cuda.mppi_chain_plain(cfg, m, x.double(), torch.zeros(n, dtype=torch.float64, device=card),
                                       n_solves=6, base_seed=4, plant=True, sampler="wallace")
    assert chain.statuses.tolist() == plain.statuses.tolist() == [0] * 6 and chain.x.shape == (len(x0),)
    for a, b in ((chain.u0s, plain.u0s), (chain.u_n, plain.u_n), (chain.x, plain.x)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), **F32_BAND)
    assert bool((mppi_cuda.merge_tickets(card, 1) == 0).all())


def _sharded_case(app, k):
    """The family's pair past N = 8 at its app's λ, for the finalize and the
    K-sharded solve; ``serve_n<N>``: serve's cart-pole at N (steps of
    0.8/N s), built for box-muller alone."""
    if app.startswith("serve_n"):
        n = int(app[len("serve_n"):])
        return CartPoleShaped4(_SW, 0.8 / n), n, _cfg(k, n=n), X0
    return _family(app, k)


# the finalize's cases: the family's pairs with external noise and box-muller
# at R = 1 and 4; serve's cart-pole, box-muller alone, at R = 1 and 4 at
# N = 40 and at R = 1 at N = 9-39 (each end of the row's sums, odd N)
FINALIZE_CASES = [(app, k, b, source, rpt) for app, k, b in (("hw_flagship", 65_536, 1), ("hw_flagship", 8192, 8),
                                                              ("mppi2", 8000, 8))
                  for source in ("external", "box-muller") for rpt in (1, 4)] + [
    ("serve_n40", 8192, 8, "box-muller", 1), ("serve_n40", 8192, 8, "box-muller", 4),
    *((f"serve_n{n}", 8192, 8, "box-muller", 1) for n in (9, 16, 31, 32, 39))]


@pytest.mark.cuda
@pytest.mark.parametrize("app, k, b, source, rpt", FINALIZE_CASES)
def test_cuda_finalize_at_n20_and_n40_matches_plain(card, app, k, b, source, rpt):
    """``fleet_finalize_kernel`` at N = 20 and 40, and at serve's N = 9-39: the merged rows finished
    are the merged-in-launch solve bit for bit; the rows-only launch's rows
    finished match ``finalize_batch_plain`` in float64 on the same rows (the
    f32 band, the same statuses) and, merged by one warp in the launch too
    (nb ≤ 128), the solve's bits; a row with no finite rollout is NO_FINITE
    with zeros. One launch a call, counted at its horizon."""
    m, n, cfg, x0 = _sharded_case(app, k)
    gen = torch.Generator(device=card).manual_seed(k + b + rpt)
    xs = torch.tensor(x0, device=card) + 0.05 * torch.randn((b, len(x0)), generator=gen, device=card)
    u_ns = 0.3 * torch.randn((b, n), generator=gen, device=card)
    kw = (dict(noise=cfg.std_dev * torch.randn((b, k, n), generator=gen, device=card)) if source == "external"
          else dict(seeds=torch.arange(b, dtype=torch.int32, device=card) + 5, sampler=source))
    merged = mppi_cuda.mppi_batch_partials_merged_fused(cfg, m, xs, u_ns, rollouts_per_thread=rpt, **kw)
    solve_u, solve_st = mppi_cuda.mppi_solve_batch_fused(cfg, m, xs, u_ns, rollouts_per_thread=rpt, **kw)
    mppi_cuda.reset_launches()
    fin_u, fin_st = mppi_cuda.finalize_batch_fused(cfg, merged[:, None].contiguous())
    assert mppi_cuda.launches["finalize_batch_fused"] == mppi_cuda.launches[f"finalize:N={n}"] == 1
    assert torch.equal(fin_u, solve_u) and torch.equal(fin_st, solve_st)
    parts = mppi_cuda.mppi_batch_partials_fused(cfg, m, xs, u_ns, rollouts_per_thread=rpt, **kw)
    got_u, got_st = mppi_cuda.finalize_batch_fused(cfg, parts)
    want_u, want_st = mppi_cuda.finalize_batch_plain(cfg, parts.double())
    torch.cuda.synchronize()
    assert torch.equal(got_st, want_st) and bool((got_st == MppiStatus.OK).all())
    np.testing.assert_allclose(got_u.double().cpu().numpy(), want_u.cpu().numpy(), **F32_BAND)
    if parts.shape[1] <= 128:
        assert torch.equal(got_u, solve_u)
    bad = torch.zeros((1, 1, n + 2), device=card)
    bad[0, 0, 0] = mppi_cuda.NEG_BIG
    u_bad, st_bad = mppi_cuda.finalize_batch_fused(cfg, bad)
    assert int(st_bad[0]) == MppiStatus.NO_FINITE and bool((u_bad == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("app", ["hw_flagship", "mppi2", "serve_n40", "serve_n16"])
def test_cuda_sharded_solve_at_world_1_is_the_one_rank_solve(card, app):
    """The K-sharded solve on a world of one rank (no group: no collective)
    at N = 20 (the HW flagship at K = 800 000), N = 40 and serve's N = 16: one merged-row
    launch and one finalize launch at its horizon, and ``mppi_solve_fused``'s
    bits, with external noise and in-kernel sampling alike; serve's
    cart-pole, built for box-muller alone, refuses external noise before
    any launch."""
    from mpc_rs_tpu_torch.parallel.mesh import make_mesh
    from mpc_rs_tpu_torch.parallel.sharded_mppi import make_sharded_mppi

    m, n, cfg, x0 = _sharded_case(app, 800_000 if app == "hw_flagship" else 8192)
    x, u_n = torch.tensor(x0, device=card), torch.zeros(n, device=card)
    noise = cfg.std_dev * torch.randn((cfg.n_rollouts, n), generator=torch.Generator(device=card).manual_seed(3),
                                      device=card)
    mesh = make_mesh()
    mppi_cuda.reset_launches()
    if app.startswith("serve_n"):
        with pytest.raises(ValueError, match="noise source 'external'"):
            make_sharded_mppi(cfg, m, mesh, external_noise=True)(noise, x, u_n)
        assert not any(mppi_cuda.launches.values())
    else:
        u, st = make_sharded_mppi(cfg, m, mesh, external_noise=True)(noise, x, u_n)
        assert mppi_cuda.launches["mppi_partials_merged_fused"] == 1 and mppi_cuda.launches[f"finalize:N={n}"] == 1
        want_u, want_st = mppi_solve_fused(cfg, m, x, u_n, noise=noise)
        assert int(st) == int(want_st) == 0 and torch.equal(u, want_u)
    u, st = make_sharded_mppi(cfg, m, mesh)(11, x, u_n)
    want_u, want_st = mppi_solve_fused(cfg, m, x, u_n, seed=11)
    assert int(st) == int(want_st) == 0 and torch.equal(u, want_u)


@pytest.mark.cuda
def test_cuda_family_unbuilt_pairs_raise(card):
    m, n, cfg, x0 = _family("mppi2", 256)
    x = torch.tensor(x0, dtype=torch.float32, device=card)
    with pytest.raises(ValueError, match="no kernel for horizon N=8"):
        mppi_solve_fused(_cfg(256), m, x, torch.zeros(N, device=card))


# --------------------------------------------------------------------------
# serve: the cart-pole at the plan-streaming N = 9-40, and the batch solver


@pytest.mark.cuda
@pytest.mark.parametrize("n, rpt", [(40, 1), (40, 4), (9, 1), (16, 1), (20, 1), (31, 1), (32, 1), (39, 1)])
def test_cuda_serve_horizons_match_plain(card, n, rpt):
    """The (cart-pole, N) instantiations serve reaches, box-muller alone, on
    serve's batch of 8 robots at K = 8192 and on one problem, against the
    float64 plain version fed the kernel's noise (λ = 20, where the f32
    solve is well conditioned): N = 31 ends in warp 0, N = 32 in two warps,
    odd N half uses its last box-muller pair. The kernel's noise is
    ops/philox.py's, and the merge tickets are back to zero."""
    m = CartPoleShaped4(CartPoleParams.single_wheel(), 0.8 / n)
    cfg = _cfg(8192, lam=20.0, n=n)
    rng = np.random.default_rng(n + rpt)
    xs = torch.tensor(np.c_[np.zeros((8, 2)), rng.uniform(-0.1, 0.1, (8, 2))], dtype=torch.float32, device=card)
    u_ns = torch.tensor(0.3 * rng.standard_normal((8, n)), dtype=torch.float32, device=card)
    seeds = torch.arange(8, dtype=torch.int32, device=card) + 9
    noise = torch.empty((8, 8192, n), device=card)
    got_u, got_st = mppi_cuda.mppi_solve_batch_fused(cfg, m, xs, u_ns, seeds=seeds, sampler="box-muller",
                                                     noise_out=noise, rollouts_per_thread=rpt)
    np.testing.assert_allclose(noise.cpu().numpy(), mppi_cuda.batch_noise(cfg, m, seeds, "box-muller").cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    parts = mppi_cuda.mppi_batch_partials_plain(cfg, m, xs.double(), u_ns.double(), noise.double(),
                                                rollouts_per_thread=rpt)
    want_u, want_st = mppi_cuda.finalize_batch_plain(cfg, parts)
    assert got_st.tolist() == want_st.tolist() == [0] * 8
    np.testing.assert_allclose(got_u.cpu().numpy(), want_u.cpu().numpy(), **F32_BAND)
    one_u, one_st = mppi_solve_fused(cfg, m, xs[0], u_ns[0], seed=int(seeds[0]), rollouts_per_thread=rpt)
    want_one = mppi_cuda.mppi_solve_plain(cfg, m, xs[0].double(), u_ns[0].double(), rollouts_per_thread=rpt,
                                          noise=mppi_cuda.solve_noise(cfg, m, int(seeds[0]), 0, device=card).double())
    assert int(one_st) == int(want_one[1]) == 0
    np.testing.assert_allclose(one_u.cpu().numpy(), want_one[0].cpu().numpy(), **F32_BAND)
    assert bool((mppi_cuda.merge_tickets(card, 8) == 0).all()) and bool((mppi_cuda.merge_tickets(card, 1) == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n, source, rpt", [(16, "external", 1), (16, "clt4a", 1), (16, "box-muller", 4),
                                             (32, "box-muller", 4), (40, "wallace", 1), (40, "external", 4)])
def test_cuda_serve_unbuilt_source_or_r_raises_before_launch(card, n, source, rpt):
    """On the card each wrapper refuses a (N, source, R) of serve's cart-pole
    that is not built, with a ValueError before any launch: no fallback to
    the plain version."""
    m, cfg = CartPoleShaped4(CartPoleParams.single_wheel(), 0.8 / n), _cfg(1024, n=n)
    xs, u_ns = torch.zeros((2, 4), device=card), torch.zeros((2, n), device=card)
    kw = (dict(noise=torch.zeros((2, 1024, n), device=card)) if source == "external"
          else dict(seeds=torch.arange(2, dtype=torch.int32, device=card), sampler=source))
    one = dict(noise=kw["noise"][0]) if source == "external" else dict(sampler=source)
    mppi_cuda.reset_launches()
    calls = (lambda: mppi_cuda.mppi_solve_batch_fused(cfg, m, xs, u_ns, rollouts_per_thread=rpt, **kw),
             lambda: mppi_cuda.mppi_batch_partials_fused(cfg, m, xs, u_ns, rollouts_per_thread=rpt, **kw),
             lambda: mppi_cuda.mppi_batch_partials_merged_fused(cfg, m, xs, u_ns, rollouts_per_thread=rpt, **kw),
             lambda: mppi_solve_fused(cfg, m, xs[0], u_ns[0], rollouts_per_thread=rpt, **one),
             lambda: mppi_cuda.mppi_partials_merged_fused(cfg, m, xs[0], u_ns[0], rollouts_per_thread=rpt, **one),
             lambda: mppi_chain_fused(cfg, m, xs[0], u_ns[0], n_solves=2, rollouts_per_thread=rpt,
                                      **(dict(noise=kw["noise"]) if source == "external" else one)))
    for call in calls:
        with pytest.raises(ValueError, match="noise source" if rpt == 1 or source != "box-muller" else "rollouts a"):
            call()
    assert not any(mppi_cuda.launches.values())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 16, 32, 40])
def test_cuda_serve_batch_solver_matches_its_plain_path(card, n):
    """serve's batch solver on the card (one counted launch a dispatch, the
    zero fallback on the device, the read-back into pinned memory behind an
    event) against the same solver on the CPU: three dispatches queued
    before the first is read, the state table rewritten after each call,
    the later two warm starts advanced two steps at the plan-streaming
    horizons (N = 16, 32 and 40), robot 3's NaN state zeroed, the others in
    the f32 band."""
    from mpc_rs_tpu_torch.apps.serve import make_batch_solver

    m = CartPoleShaped4(CartPoleParams.single_wheel(), 0.1 if n == 8 else 0.8 / n)
    cfg = _cfg(8192, lam=20.0, n=n)  # a well-conditioned λ: the warm starts chain
    xs = np.zeros((8, 4), np.float32)
    xs[:, 2] = np.linspace(-0.1, 0.1, 8)
    xs[3, 2] = np.nan
    gpu, cpu = make_batch_solver(cfg, m, card, plan=True), make_batch_solver(cfg, m, "cpu", plan=True)
    mppi_cuda.reset_launches()
    u_g, u_c, pending = torch.zeros((8, n), device=card), torch.zeros((8, n)), []
    for d in range(3):
        seeds = np.arange(8, dtype=np.int32) + 8 * d
        x_now = xs.copy()
        advance = 2 if n != 8 and d else 0
        dg = gpu(seeds, xs, u_g, advance)
        xs[:, 0] += 0.01  # the table is rewritten while the solve may be queued
        dc = cpu(seeds, x_now, u_c, advance)
        u_g, u_c = dg.u_n, dc.u_n
        pending.append((dg, dc))
    assert mppi_cuda.launches["mppi_solve_batch_fused"] == 3
    for dg, dc in pending:
        got, want = dg.result(), dc.result()
        assert np.all(got[3] == 0.0) and np.all(want[3] == 0.0)
        keep = [b for b in range(8) if b != 3]
        np.testing.assert_allclose(got[keep], want[keep], **F32_BAND)


# --------------------------------------------------------------------------
# tune's sweep launch, PANOC's graph replay, and the apps on the card


def _sweep_grid(card, lams=(0.1, 0.5, 1.4, 2.5), sigs=(1.0, 3.0, 10.0), seeds=8):
    """tune's default grid, B = 96: (λ, σ, seed) per episode, float32 on the card."""
    cells = [(lam, sig, s) for lam in lams for sig in sigs for s in range(seeds)]
    return tuple(torch.tensor([c[i] for c in cells], dtype=dt, device=card)
                 for i, dt in ((0, torch.float32), (1, torch.float32), (2, torch.int32)))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1024, 800_000])
@pytest.mark.parametrize("source", ["external", "box-muller"])
def test_cuda_sweep_matches_plain(card, k, source):
    """The sweep launch (``mppi_sweep_kernel``) at B = 96 against its
    float64 plain version at 1 and 4 tiles a block and the wrapper's own
    (16 at K = 800 000): the statuses equal, u_n' and the ESS in the f32
    band, or, in the cells where the float32 problem is ill-conditioned
    (tune's λ = 0.1 weighs one or two rollouts), within twice the plain
    float32 version's own distance; in-kernel box-muller against
    ``sweep_noise``'s words (each problem keyed by its seed, the tick in the
    counter)."""
    lam, sig, seeds = _sweep_grid(card)
    b = lam.numel()
    gen = torch.Generator(device=card).manual_seed(k)
    xs = (torch.randn((b, 4), generator=gen, device=card) * torch.tensor([0.3, 0.1, 0.1, 0.1], device=card))
    u_ns = torch.randn((b, N), generator=gen, device=card)
    cfg = _cfg(k)
    if source == "external":
        noise = torch.randn((b, k, N), generator=gen, device=card) * sig[:, None, None]
        kw = dict(noise=noise)
    else:
        kw = dict(seeds=seeds, solve=7)
        noise = mppi_cuda.sweep_noise(cfg, seeds, 7, sig)
    for tiles in (1, 4, None):
        u, st, ess = mppi_cuda.mppi_sweep_batch_fused(cfg, MODEL, xs, u_ns, lam, sig, tiles_per_block=tiles, **kw)
        want_u, want_st, want_ess = mppi_cuda.mppi_sweep_batch_plain(cfg, MODEL, xs.double(), u_ns.double(), lam, sig,
                                                                      noise=noise, tiles_per_block=tiles)
        u32, _, ess32 = mppi_cuda.mppi_sweep_batch_plain(cfg, MODEL, xs, u_ns, lam, sig, noise=noise,
                                                         tiles_per_block=tiles)
        torch.cuda.synchronize()
        assert torch.equal(st, want_st) and bool((st == 0).all())
        for got, want, f32 in ((u, want_u, u32), (ess, want_ess, ess32)):
            got, want, f32 = (t.double().cpu() for t in (got, want, f32))
            tol = torch.maximum(F32_BAND["atol"] + F32_BAND["rtol"] * want.abs(), 2.0 * (f32 - want).abs())
            assert bool(((got - want).abs() <= tol).all()), float(((got - want).abs() / tol).max())
        assert bool(((ess >= 1.0 - 1e-4) & (ess <= k)).all())
    assert bool((mppi_cuda.merge_tickets(card, b) == 0).all())


# the horizons where the kernel's R changes (10/11, 20/21), the tile's
# warps split the sums unevenly (N + 2 = 32, 33, 41, 42), box-muller's last
# pair is half used (odd N), and past the parent's 40 up to the maximum
SWEEP_HORIZONS = (1, 8, 9, 20, 21, 30, 31, 32, 39, 40, 41, 64, mppi_cuda.SWEEP_MAX_HORIZON)
# K = 8192 gives a problem 32 tiles of 256, one block of 32 tiles at the
# wrapper's 1 (32 rows merged); K = 65 536 at N = 31 and 40 gives 64 rows at the
# wrapper's 4 tiles a block
SWEEP_HORIZON_KS = [(n, 8192) for n in SWEEP_HORIZONS] + [(31, 65_536), (40, 65_536)]


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["external", "box-muller"])
@pytest.mark.parametrize("n, k", SWEEP_HORIZON_KS)
def test_cuda_sweep_at_horizons_matches_plain(card, n, k, source):
    """The sweep launch at horizon N on tune's default grid (B = 96) at K =
    8192, and at N = 31 and 40 also at K = 65 536, against its float64
    plain version at the wrapper's tiles a block and at 4 (R = 4 up to N =
    10, 2 up to 20), as ``test_cuda_sweep_matches_plain``; past N = 8 the
    step is 0.8 s / N and λ scaled by N/8
    (``tests/test_torch_tune.py::_horizon``). In-kernel box-muller against
    ``sweep_noise``'s words, its last pair half used at odd N; each launch
    counted under its horizon."""
    lam, sig, seeds = _sweep_grid(card)
    dt, scale = (0.1, 1.0) if n <= N else (0.8 / n, n / N)
    lam = lam * scale
    model = CartPoleShaped4(CartPoleParams.single_wheel(), dt)
    b = lam.numel()
    gen = torch.Generator(device=card).manual_seed(n)
    xs = torch.randn((b, 4), generator=gen, device=card) * torch.tensor([0.3, 0.1, 0.1, 0.1], device=card)
    u_ns = torch.randn((b, n), generator=gen, device=card)
    cfg = _cfg(k, n=n)
    if source == "external":
        noise = torch.randn((b, k, n), generator=gen, device=card) * sig[:, None, None]
        kw = dict(noise=noise)
    else:
        kw = dict(seeds=seeds, solve=5)
        noise = mppi_cuda.sweep_noise(cfg, seeds, 5, sig)
    mppi_cuda.reset_launches()
    for tiles in (None, 4):
        u, st, ess = mppi_cuda.mppi_sweep_batch_fused(cfg, model, xs, u_ns, lam, sig, tiles_per_block=tiles, **kw)
        want_u, want_st, want_ess = mppi_cuda.mppi_sweep_batch_plain(cfg, model, xs.double(), u_ns.double(), lam, sig,
                                                                      noise=noise, tiles_per_block=tiles)
        u32, _, ess32 = mppi_cuda.mppi_sweep_batch_plain(cfg, model, xs, u_ns, lam, sig, noise=noise,
                                                         tiles_per_block=tiles)
        torch.cuda.synchronize()
        assert u.shape == (b, n) and torch.equal(st, want_st) and bool((st == 0).all())
        for got, want, f32 in ((u, want_u, u32), (ess, want_ess, ess32)):
            got, want, f32 = (t.double().cpu() for t in (got, want, f32))
            tol = torch.maximum(F32_BAND["atol"] + F32_BAND["rtol"] * want.abs(), 2.0 * (f32 - want).abs())
            assert bool(((got - want).abs() <= tol).all()), float(((got - want).abs() / tol).max())
    assert mppi_cuda.launches["mppi_sweep_batch_fused"] == mppi_cuda.launches[f"sweep:N={n}"] == 2
    assert bool((mppi_cuda.merge_tickets(card, b) == 0).all())


@pytest.mark.cuda
def test_cuda_sweep_unbuilt_horizon_or_r_raises_before_launch(card):
    """N past ``SWEEP_MAX_HORIZON`` (its block would not fit the card's
    shared memory), N = 0 or a tile count below 1 raise a ValueError before
    any launch, through the wrapper and through ``make_sweep``."""
    from mpc_rs_tpu_torch.apps import tune

    lam, sig, seeds = _sweep_grid(card, seeds=1)
    b = lam.numel()
    top = mppi_cuda.SWEEP_MAX_HORIZON + 1
    mppi_cuda.reset_launches()
    for n, tiles, match in ((top, None, f"horizon N={top}"), (0, None, "horizon N=0"),
                            (20, 0, "tiles_per_block must be at least 1")):
        with pytest.raises(ValueError, match=match):
            mppi_cuda.mppi_sweep_batch_fused(_cfg(1024, n=n), MODEL, torch.zeros((b, 4), device=card),
                                             torch.zeros((b, n), device=card), lam, sig, seeds=seeds,
                                             tiles_per_block=tiles)
    with pytest.raises(ValueError, match=f"horizon N={top}"):
        tune.make_sweep(k=1024, n_horizon=top, device=card)
    assert not any(mppi_cuda.launches.values())


@pytest.mark.cuda
def test_cuda_plain_step_divides_by_a_python_float_once(card):
    """The plain cart-pole's kt·u / r_w on a CUDA tensor (``dynamics._div``)
    is one IEEE division, bit for bit numpy's, as in the kernels
    (``CartPoleNonlinearT``) and on the CPU; PyTorch's own tensor / float
    on a CUDA tensor multiplies by the float32 reciprocal instead, which put
    the plain float32 sweep an ulp off the kernel's states in most rollouts
    at N = 224. The plain step then matches the kernel's rollout bit for
    bit, so the band's twice-the-plain-float32 term measures the same
    float32 function."""
    from mpc_rs_tpu_torch.models import dynamics

    a = np.random.default_rng(3).uniform(-40.0, 40.0, 1 << 20).astype(np.float32)
    got = dynamics._div(torch.tensor(a, device=card), 0.05).cpu().numpy()
    np.testing.assert_array_equal(got, a / np.float32(0.05))


@pytest.mark.cuda
def test_cuda_sweep_occupancy_holds_at_every_horizon(card):
    """The one kernel's registers and blocks an SM: at most 64 registers and
    no spill at every N (one kernel), at least 4 blocks an SM up to N = 40,
    and one block at the maximum, whose shared memory the card takes. The
    dynamic shared bytes the C side gives a launch equal
    ``sweep_shared_bytes`` at every N of 1-``SWEEP_MAX_HORIZON`` and every
    R the wrapper passes."""
    rows = [mppi_cuda.sweep_occupancy(n, 16, card) for n in (1, 8, 10, 11, 20, 21, 40)]
    rows.append(mppi_cuda.sweep_occupancy(mppi_cuda.SWEEP_MAX_HORIZON, 1, card))
    assert len({r["registers"] for r in rows}) == 1 and rows[0]["registers"] <= 64, rows
    assert all(r["blocks_per_sm"] >= 4 for r in rows[:-1]) and rows[-1]["blocks_per_sm"] == 1, rows
    for n in range(1, mppi_cuda.SWEEP_MAX_HORIZON + 1):
        for tiles in (1, 2, 4):
            got = mppi_cuda.sweep_occupancy(n, tiles, card)
            assert got["shared_bytes"] == mppi_cuda.sweep_shared_bytes(n, tiles), got


@pytest.mark.cuda
def test_cuda_sweep_failure_probes(card):
    lam, sig, seeds = _sweep_grid(card, seeds=1)
    xs = torch.tensor(X0, device=card).repeat(lam.numel(), 1)
    xs[0, 0] = float("nan")
    lam[1] = 0.0
    for n, k, tiles in ((N, 512, None), (N, 3000, 4), (20, 70_000, 8), (40, 512, 1)):
        u, st, ess = mppi_cuda.mppi_sweep_batch_fused(_cfg(k, n=n), MODEL, xs,
                                                      torch.zeros((lam.numel(), n), device=card), lam, sig,
                                                      seeds=seeds, solve=0, tiles_per_block=tiles)
        assert st[:3].tolist() == [MppiStatus.NO_FINITE, MppiStatus.INVALID_U, MppiStatus.OK]
        assert bool((u[:2] == 0).all()) and float(ess[0]) == 0.0 and bool(torch.isnan(ess[1]))


@pytest.mark.cuda
def test_cuda_tune_tick_is_one_launch(card):
    """A tune tick launches one sweep kernel (torch.profiler), and the
    wrapper counts one launch a tick."""
    from mpc_rs_tpu_torch.apps import tune

    lam, sig, seeds = _sweep_grid(card)
    run = tune.make_sweep(k=8192, n_ticks=3, device=card)
    run(lam, sig, seeds)  # built and warm
    mppi_cuda.reset_launches()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        run(lam, sig, seeds)
        torch.cuda.synchronize()
    assert mppi_cuda.launches["mppi_sweep_batch_fused"] == 3
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    sweeps = [n for n in names if "mppi_sweep_kernel" in n]
    assert len(sweeps) <= 3 and not any("mppi_partials_kernel" in n for n in names)


@pytest.mark.cuda
def test_cuda_tune_default_grid_at_the_main_paths_k(card):
    """The default 4×3×8 grid at K = 800 000 over 100 ticks: the reference
    operating point (0.5, 3) survives every seed, every surviving cell's
    mean ESS lies in [1, K]."""
    from mpc_rs_tpu_torch.apps import tune

    cells = tune.sweep_grid([0.1, 0.5, 1.4, 2.5], [1.0, 3.0, 10.0], seeds=8, k=800_000, n_ticks=100, device=card)
    ref = next(c for c in cells if c["lambda"] == 0.5 and c["sigma"] == 3.0)
    assert ref["survival"] == 1.0
    assert all(1.0 <= c["mean_ess"] <= 800_000 for c in cells if c["mean_ess"] is not None)


def _qp_solves(card, app):
    """(value-and-grad factory, config, box, n, states) of a condensed-QP app."""
    from mpc_rs_tpu_torch.controllers import panoc
    from mpc_rs_tpu_torch.controllers.qp import build_condensed_qp, make_qp_value_and_grad
    from mpc_rs_tpu_torch.models import dynamics, reference

    rng = np.random.default_rng(1)
    if app == "op-mpc-x-calc":
        a, b = dynamics.linear_ab(CartPoleParams.single_wheel(), 0.1)
        qp = build_condensed_qp(a, b, np.diag([5.0, 5.0, 1.0, 1.0]), 8, device=card)
        return (make_qp_value_and_grad(qp, reference.make_gen_ref_raised_cosine(8)),
                panoc.PanocConfig(tol=1e-6, max_iter=80, lbfgs_mem=20), panoc.box_projection(-30.0, 30.0), 8,
                rng.normal(size=(20, 4)) * [0.5, 0.2, 0.1, 0.2])
    a, b = dynamics.linear_ab(CartPoleParams.two_wheel(), 1.2 / 40, two_wheel=True)
    qp = build_condensed_qp(a, b, np.diag([0.0, 0.0, 10.0, 3.0]), 40, device=card)
    return (make_qp_value_and_grad(qp, reference.make_gen_ref_raised_cosine(40, velocity_gain=-0.75)),
            panoc.PanocConfig(tol=1e-6, max_iter=60, lbfgs_mem=20), panoc.box_projection(-10.0, 10.0), 40,
            rng.normal(size=(20, 4)) * [0.3, 0.2, 0.05, 0.2])


@pytest.mark.cuda
@pytest.mark.parametrize("app", ["op-mpc-x-calc", "mpc-ukf-commu"])
def test_cuda_panoc_graph_solve_equals_the_eager_solve(card, app):
    """Warm-started solves from 20 states: the graph-replayed solve (the
    QP's closure) and the eager one (the same closure behind a lambda) give
    the same iterations and read-backs, and u within 1e-12."""
    from mpc_rs_tpu_torch.controllers import panoc

    vg_factory, cfg, proj, n, states = _qp_solves(card, app)
    u = torch.zeros(n, dtype=torch.float64, device=card)
    for x in states:
        vg = vg_factory(torch.tensor(x, dtype=torch.float64, device=card))
        panoc.reset_readbacks()
        graph = panoc.panoc_solve(cfg, None, proj, u, value_and_grad=vg)
        n_graph = panoc.readbacks
        panoc.reset_readbacks()
        eager = panoc.panoc_solve(cfg, None, proj, u, value_and_grad=lambda v: vg(v))
        assert panoc.readbacks == n_graph and int(graph.iterations) == int(eager.iterations)
        assert float((graph.u - eager.u).abs().max()) <= 1e-12
        u = graph.u


@pytest.mark.cuda
def test_cuda_mpc_ukf_commu_meets_its_acceptance_spec(card):
    """The JAX spec's argv (``--sim-mcu --t-end 3 --time-scale 0.5``):
    at least 100 solves in the 6 s window."""
    from mpc_rs_tpu_torch.apps import run as cli

    res = cli.main(["mpc-ukf-commu", "--sim-mcu", "--t-end", "3", "--time-scale", "0.5"])
    assert int(res) >= 100


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tune", "uart", "op-en2", "mpc-ukf-commu"])
def test_cuda_acceptance_specs_pass(card, name):
    from mpc_rs_tpu_torch.apps import acceptance

    ok, detail, _ = acceptance.run_one(name, 0, device="cuda")
    assert ok, detail


@pytest.mark.cuda
@pytest.mark.parametrize("rpt", [1, 4])
@pytest.mark.parametrize("source", ["external", "box-muller", "clt4a"])
@pytest.mark.parametrize("b, k", [(1, 800_000), (64, 1024), (16, 8192)])
def test_cuda_merged_row_matches_plain(card, b, k, source, rpt):
    """The partials launch's merged-row output (``row_out``) against its
    plain version on the kernel's own noise, in the f32 band at λ = 20;
    finished by ``finalize_batch_fused`` it is the merged-in-launch solve,
    bit for bit; a problem with no finite rollout writes NEG_BIG and zeros.
    Two launches a sharded call: the merged rows and the finalize."""
    cfg = _cfg(k, lam=20.0)
    gen = torch.Generator(device=card).manual_seed(b + k)
    xs = torch.tensor(X0, device=card) + 0.1 * torch.randn((b, 4), generator=gen, device=card)
    xs[-1, 0] = float("nan") if b > 1 else xs[-1, 0]
    u_ns = 0.3 * torch.randn((b, N), generator=gen, device=card)
    seeds = torch.arange(b, dtype=torch.int32, device=card) * 17 + 3
    noise = (3.0 * torch.randn((b, k, N), generator=gen, device=card) if source == "external"
             else torch.empty((b, k, N), device=card))
    kw = dict(noise=noise) if source == "external" else dict(seeds=seeds, sampler=source, noise_out=noise)
    mppi_cuda.reset_launches()
    if b == 1:
        one = dict(noise=noise[0]) if source == "external" else dict(seed=3, sampler=source, noise_out=noise[0])
        rows = mppi_cuda.mppi_partials_merged_fused(cfg, MODEL, xs[0], u_ns[0], rollouts_per_thread=rpt, **one)[None]
        one.pop("noise_out", None)
        want_u, want_st = mppi_solve_fused(cfg, MODEL, xs[0], u_ns[0], rollouts_per_thread=rpt, **one)
        want_u, want_st = want_u[None], want_st[None]
    else:
        rows = mppi_cuda.mppi_batch_partials_merged_fused(cfg, MODEL, xs, u_ns, rollouts_per_thread=rpt, **kw)
        kw.pop("noise_out", None)
        want_u, want_st = mppi_cuda.mppi_solve_batch_fused(cfg, MODEL, xs, u_ns, rollouts_per_thread=rpt, **kw)
    u, st = mppi_cuda.finalize_batch_fused(cfg, rows[:, None].contiguous())
    torch.cuda.synchronize()
    merged = "mppi_partials_merged_fused" if b == 1 else "mppi_batch_partials_merged_fused"
    assert mppi_cuda.launches[merged] == 1 and mppi_cuda.launches["finalize_batch_fused"] == 1
    assert torch.equal(u, want_u) and torch.equal(st, want_st)
    plain = mppi_cuda.mppi_batch_partials_merged_plain(cfg, MODEL, xs.double(), u_ns.double(), noise.double(),
                                                       rollouts_per_thread=rpt)
    ok = slice(None, -1) if b > 1 else slice(None)
    np.testing.assert_allclose(rows[ok].double().cpu().numpy(), plain[ok].cpu().numpy(), **F32_BAND)
    if b > 1:
        assert float(rows[-1, 0]) == float(torch.tensor(mppi_cuda.NEG_BIG)) and bool((rows[-1, 1:] == 0).all())
        assert int(st[-1]) == MppiStatus.NO_FINITE
