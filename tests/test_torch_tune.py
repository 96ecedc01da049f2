"""``tune`` and the sweep's plain version against the JAX package, on the CPU.

- ``mppi_sweep_batch_plain`` (what the sweep's kernel computes, and what
  the wrapper runs on CPU tensors) per problem of a (λ, σ) grid against JAX
  ``mppi_solve(noise=)``: u_n', status, min_cost and ESS within 1e-9 in
  float64, in the f32 band (``tests/test_pallas.py:59``) in float32; the
  failure probes (NaN x₀ → NO_FINITE, λ = 0 → INVALID_U) with their zero
  fallback.
- A 20-tick batch of ``tune`` episodes in lockstep with a JAX scan composed
  as ``mpc_rs_tpu/apps/tune.py:54-79`` composes it, on the port's noise, at
  λ ≥ 5 (in float32 where the loop is well conditioned, in float64 on all
  its cells). At λ = 0.5 the softmax weighs one or two rollouts and a
  closed loop amplifies a last-bit difference about tenfold a tick (ROADMAP
  §3), so there it is held per solve only (the grid above).
- The cell reduction, the printed table and ``tune.json`` against JAX
  ``sweep_grid``/``tune`` fed the port's per-episode arrays (its
  ``make_sweep`` replaced in the test), with an all-tipped cell and the
  best-cell choice.
- Common random numbers: episodes of one seed draw the same standard
  normals at a tick, whatever their σ.
- The horizon: the JAX ``make_sweep`` takes any N, so the three checks
  above also run at N ∈ {1, 9, 30, 31, 32, 40} beside tune's N = 8 (N = 30
  and 31 are the last rows whose N + 2 sums fit in warp 0 on the card and
  the first that do not; N = 1 and odd N half use a box-muller pair), and
  the sweep's build table and its refusal on a card: N = 41 raises before
  any launch.
"""

import contextlib
import io
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_rs_tpu.apps import tune as jtune
from mpc_rs_tpu.controllers import mppi as jmppi
from mpc_rs_tpu.models import costs as jcosts
from mpc_rs_tpu.models import dynamics as jdyn
from mpc_rs_tpu.models.params import CartPoleParams as JParams
from mpc_rs_tpu_torch.apps import run as cli
from mpc_rs_tpu_torch.apps import tune
from mpc_rs_tpu_torch.controllers.mppi import MppiConfig, MppiStatus
from mpc_rs_tpu_torch.models.params import CartPoleParams
from mpc_rs_tpu_torch.ops import mppi_cuda
from mpc_rs_tpu_torch.ops.mppi_cuda import CartPoleShaped4

N = 8  # tune's horizon (the CLI's and sweep_grid's)
HORIZONS = (1, 9, 30, 31, 32, 40)  # the other horizons the checks run at
MODEL = CartPoleShaped4(CartPoleParams.single_wheel(), 0.1)
JSTEP = jdyn.make_cartpole_nonlinear(JParams.single_wheel(), 0.1)
F32_BAND = dict(rtol=1e-3, atol=2e-4)  # tests/test_pallas.py:59
GRID = [(lam, sig) for lam in (0.5, 5.0, 50.0) for sig in (1.0, 3.0)]


def _cfg(k, n=N):
    # the sweep reads N, K and the box from the config; λ and σ are per problem
    return MppiConfig(n_horizon=n, n_rollouts=k, lambda_=1.0, std_dev=1.0, limit=(-20.0, 20.0))


def _horizon(n):
    """(step dt, λ scale) at horizon ``n``: tune's 0.1 s and its λ up to
    N = 8; past it the step is 0.8 s / N, so the horizon spans tune's 0.8 s
    (serve's rule; at dt = 0.1 a 3-4 s horizon drives the random states of
    these inputs into the fall, where the softmax weighs one or two
    rollouts in either package), and λ is scaled by N/8, as a rollout's
    cost sums N stage costs over those 0.8 s, so that each cell keeps its
    softmax temperature."""
    return (0.1, 1.0) if n <= N else (0.8 / n, n / N)


def _models(n):
    """The port's model and the JAX step at horizon ``n``'s dt."""
    dt = _horizon(n)[0]
    return CartPoleShaped4(CartPoleParams.single_wheel(), dt), jdyn.make_cartpole_nonlinear(JParams.single_wheel(), dt)


def _jax_solve(lam, sig, x, u_n, noise, dtype):
    n = noise.shape[1]
    jcfg = jmppi.MppiConfig(n_horizon=n, n_rollouts=noise.shape[0], lambda_=lam, std_dev=sig, limit=(-20.0, 20.0))
    return jmppi.mppi_solve(jcfg, JSTEP if n == N else _models(n)[1], jcosts.shaped4, None,
                            tuple(jnp.asarray(v, dtype) for v in x), jnp.asarray(u_n, dtype),
                            noise=jnp.asarray(noise, dtype))


def _grid_inputs(k, seed=0, n=N):
    rng = np.random.default_rng(seed)
    lam = np.array([g[0] for g in GRID]) * _horizon(n)[1]
    sig = np.array([g[1] for g in GRID])
    b = len(GRID)
    xs = rng.normal(size=(b, 4)) * [0.3, 0.1, 0.1, 0.1]
    u_n = rng.normal(size=(b, n))
    noise = rng.standard_normal((b, k, n)) * sig[:, None, None]
    return lam, sig, xs, u_n, noise


def _by_horizon(*values):
    """(n, value) cases: tune's N = 8 under the value's own id, then each of
    ``HORIZONS`` as ``n<N>-<value>``."""
    return ([pytest.param(N, v, id=str(v)) for v in values]
            + [pytest.param(n, v, id=f"n{n}-{v}") for n in HORIZONS for v in values])


@pytest.mark.parametrize("n, dtype", _by_horizon("float64", "float32"))
def test_sweep_plain_matches_jax_per_problem(n, dtype):
    """K=256 on the (λ, σ) grid, each problem against its own JAX solve, at
    horizon ``n``."""
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    lam, sig, xs, u_n, noise = _grid_inputs(256, n=n)
    args = (torch.tensor(xs, dtype=td), torch.tensor(u_n, dtype=td))
    lam_t, sig_t = torch.tensor(lam, dtype=td), torch.tensor(sig, dtype=td)
    model = _models(n)[0]
    u, st, ess = mppi_cuda.mppi_sweep_batch_fused(_cfg(256, n), model, *args, lam_t, sig_t,
                                                  noise=torch.tensor(noise, dtype=td))
    rows = mppi_cuda.sweep_partials_plain(_cfg(256, n), model, *args, torch.tensor(noise), lam_t, sig_t)
    assert u.dtype == td and u.shape == (len(GRID), n) and ess.shape == (len(GRID),)
    assert rows.shape == (len(GRID), 1, n + 3)
    for b in range(len(GRID)):
        want = _jax_solve(lam[b], sig[b], xs[b], u_n[b], noise[b], jd)
        assert int(st[b]) == int(want.status) == MppiStatus.OK
        got = (u[b].numpy(), float(-rows[b, :, 0].max()), float(ess[b]))
        ref = (np.asarray(want.u_n), float(want.min_cost), float(want.ess))
        for g, w in zip(got, ref):
            if dtype == "float64":
                np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9)
            else:
                np.testing.assert_allclose(g, w, **F32_BAND)


@pytest.mark.parametrize("n, dtype", _by_horizon("float64", "float32"))
def test_sweep_plain_failure_probes(n, dtype):
    """NaN x₀ → NO_FINITE (ESS 0, as JAX's all-zero weights give), λ = 0 →
    INVALID_U (ESS NaN), each with the zero fallback; the other problems
    of the batch unaffected; at horizon ``n``."""
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    lam, sig, xs, u_n, noise = _grid_inputs(64, seed=1, n=n)
    xs[0, 0] = np.nan
    lam[1] = 0.0
    u, st, ess = mppi_cuda.mppi_sweep_batch_fused(_cfg(64, n), _models(n)[0], torch.tensor(xs, dtype=td),
                                                  torch.tensor(u_n, dtype=td), torch.tensor(lam), torch.tensor(sig),
                                                  noise=torch.tensor(noise, dtype=td))
    assert st[:3].tolist() == [MppiStatus.NO_FINITE, MppiStatus.INVALID_U, MppiStatus.OK]
    assert bool((u[:2] == 0).all())
    band = dict(rtol=1e-9, atol=1e-9) if dtype == "float64" else F32_BAND
    for b in range(3):
        want = _jax_solve(float(lam[b]), float(sig[b]), xs[b], u_n[b], noise[b], jd)
        assert int(want.status) == int(st[b])
        np.testing.assert_allclose(float(ess[b]), float(want.ess), equal_nan=True, **band)
        np.testing.assert_allclose(u[b].numpy(), np.asarray(want.u_n), **band)


def test_sweep_wrapper_samples_the_sweep_noise():
    """With seeds, the wrapper's plain path draws ``sweep_noise``: problem b
    keyed seeds[b], the tick in the counter."""
    lam, sig, xs, u_n, _ = _grid_inputs(128, seed=2)
    seeds = torch.arange(len(GRID), dtype=torch.int32) % 2
    args = (_cfg(128), MODEL, torch.tensor(xs, dtype=torch.float32), torch.tensor(u_n, dtype=torch.float32),
            torch.tensor(lam, dtype=torch.float32), torch.tensor(sig, dtype=torch.float32))
    got = mppi_cuda.mppi_sweep_batch_fused(*args, seeds=seeds, solve=4)
    noise = mppi_cuda.sweep_noise(_cfg(128), seeds, 4, args[-1])
    want = mppi_cuda.mppi_sweep_batch_plain(*args, noise=noise)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_common_random_numbers_across_cells():
    """Episodes of one seed draw the same standard normals at a tick, scaled
    by their σ (σ = 2 is an exact doubling); another seed or tick draws
    others."""
    cfg = _cfg(64)
    seeds = torch.tensor([7, 7, 7, 8], dtype=torch.int32)
    noise = mppi_cuda.sweep_noise(cfg, seeds, 3, torch.tensor([1.0, 2.0, 3.0, 1.0]))
    assert torch.equal(noise[1], 2.0 * noise[0])
    torch.testing.assert_close(noise[2] / 3.0, noise[0], rtol=1e-6, atol=1e-7)
    assert not torch.equal(noise[3], noise[0])
    assert not torch.equal(mppi_cuda.sweep_noise(cfg, seeds, 4, torch.ones(4))[0], noise[0])
    np.testing.assert_allclose(float(noise[0].std()), 1.0, atol=0.05)


def _jax_episodes(lam, sig, noise_seq, dtype, dt=0.1):
    """The JAX scan of ``tune.py:54-79`` (tick, tip latch, unmasked cost,
    ESS while upright) over given noise (T, B, K, N), vmapped over the
    episodes, in ``dtype`` (the JAX sweep's float32, or float64), the plant
    and the controller's model at step ``dt``."""
    deg60 = np.radians(60.0)
    n = noise_seq.shape[-1]
    jstep = jdyn.make_cartpole_nonlinear(JParams.single_wheel(), dt)

    def episode(lam_b, sig_b, noise_b):
        cfg = jmppi.MppiConfig(n_horizon=n, n_rollouts=noise_b.shape[1], lambda_=lam_b, std_dev=sig_b,
                               limit=(-20.0, 20.0))
        x0 = tuple(jnp.asarray(v, dtype) for v in (0.5, 0.0, 0.1, 0.0))

        def tick(carry, eps):
            x, u_n, tipped, c_acc, ess_acc, alive = carry
            r = jmppi.mppi_solve(cfg, jstep, jcosts.shaped4, None, x, u_n, noise=eps)
            x = jstep(*x, r.u_n[0])
            was_tipped = tipped
            tipped = tipped | (jnp.abs(x[2]) > deg60)
            c_acc = c_acc + jcosts.shaped4(*x)
            ess_acc = ess_acc + jnp.where(was_tipped, 0.0, r.ess)
            alive = alive + (~was_tipped).astype(dtype)
            return (x, r.u_n, tipped, c_acc, ess_acc, alive), None

        zero = jnp.asarray(0.0, dtype)
        init = (x0, jnp.zeros(n, dtype), jnp.bool_(False), zero, zero, zero)
        (_, _, tipped, c_acc, ess_acc, alive), _ = jax.lax.scan(tick, init, noise_b)
        return ~tipped, c_acc, ess_acc / jnp.maximum(alive, 1.0)

    return jax.jit(jax.vmap(episode, in_axes=(0, 0, 1)))(jnp.asarray(lam, jnp.float32), jnp.asarray(sig, jnp.float32),
                                                          jnp.asarray(noise_seq, dtype))


WELL_CONDITIONED = ((5.0, 1.0), (50.0, 1.0), (50.0, 3.0))


@pytest.mark.parametrize("n, dtype, rtol", [
    *(pytest.param(N, d, r, id=f"{d}-{r}") for d, r in (("float64", 1e-9), ("float32", 1e-4))),
    *(pytest.param(n, d, r, id=f"n{n}-{d}-{r}") for n in HORIZONS for d, r in (("float64", 1e-9), ("float32", 1e-4))),
])
def test_tune_episodes_match_a_jax_scan_on_the_ports_noise(n, dtype, rtol):
    """20 ticks of episodes (λ, σ) ∈ {(5, 1), (50, 1), (50, 3)}, 2 seeds
    each, K=256, through the port's ``make_sweep`` and the JAX scan on the
    same noise: survival equal, the accumulated cost and the mean ESS
    within ``rtol`` (float32: the two packages' solves differ in the last
    bits, 1/λ multiplied here and divided there, carried 20 ticks). The
    (5, 3) loop, whose softmax weighs a handful of rollouts, amplifies a
    last-bit difference about tenfold every two or three ticks, as λ = 0.5
    does every tick (the port's float64 loop against the JAX package's
    per-solve float64 loop: 1e-16 of the state at tick 3, 4e-8 at tick 19;
    against the jitted scan 8e-5 of the cost): it is held per solve
    (``test_sweep_plain_matches_jax_per_problem``).

    Past N = 8 the step and λ follow ``_horizon``: at dt = 0.1 a 3-4 s
    horizon of 256 rollouts tips the pendulum, and a falling loop is as
    ill-conditioned as λ = 0.5; at λ = 5 unscaled, N = 30-40 weigh few
    enough rollouts that float32 parts from the JAX package by 1.7e-4 of
    the cost over 20 ticks, as (5, 3) does at N = 8. A one-step horizon
    (N = 1) tips in both packages, alike."""
    cells = WELL_CONDITIONED
    dt, scale = _horizon(n)
    k, ticks = 256, 20
    lam = np.repeat([c[0] * scale for c in cells], 2).astype(np.float32)
    sig = np.repeat([c[1] for c in cells], 2).astype(np.float32)
    seeds = np.tile([0, 1], len(cells)).astype(np.int32)
    run = tune.make_sweep(k=k, n_horizon=n, dt=dt, n_ticks=ticks, device="cpu", dtype=getattr(torch, dtype))
    surv, cost, ess = run(lam, sig, seeds)
    noise = np.stack([mppi_cuda.sweep_noise(_cfg(k, n), torch.tensor(seeds), t, torch.tensor(sig)).numpy()
                      for t in range(ticks)])
    jsurv, jcost, jess = _jax_episodes(lam, sig, noise, getattr(jnp, dtype), dt)
    np.testing.assert_array_equal(surv.numpy(), np.asarray(jsurv))
    assert bool(surv.all()) if n >= N else not bool(surv.any())
    np.testing.assert_allclose(cost.numpy(), np.asarray(jcost), rtol=rtol)
    np.testing.assert_allclose(ess.numpy(), np.asarray(jess), rtol=rtol)


TIP_GRID = dict(lambdas=[0.5, 50.0], sigmas=[0.02, 30.0], seeds=2, k=64, n_ticks=30)


def _port_arrays_as_jax_sweep(monkeypatch):
    """Replace the JAX ``make_sweep`` by the port's per-episode arrays."""
    real = tune.make_sweep

    def fake(*, k, n_ticks, **kw):
        run = real(k=k, n_ticks=n_ticks, device="cpu")
        return lambda lam, sig, seeds: tuple(jnp.asarray(a.numpy()) for a in run(np.asarray(lam), np.asarray(sig),
                                                                                   np.asarray(seeds)))

    monkeypatch.setattr(jtune, "make_sweep", fake)


def test_cells_match_jax_sweep_grid_on_the_ports_episodes(monkeypatch):
    """An all-tipped cell (σ = 0.02 cannot hold the pendulum at K=64) gives
    null cost and ESS; the others average over their survivors."""
    _port_arrays_as_jax_sweep(monkeypatch)
    got = tune.sweep_grid(TIP_GRID["lambdas"], TIP_GRID["sigmas"], seeds=2, k=64, n_ticks=30, device="cpu")
    want = jtune.sweep_grid(TIP_GRID["lambdas"], TIP_GRID["sigmas"], seeds=2, k=64, n_ticks=30)
    assert got == want
    by = {(c["lambda"], c["sigma"]): c for c in got}
    assert by[(0.5, 0.02)]["survival"] == 0.0 and by[(0.5, 0.02)]["mean_cost"] is None
    assert by[(50.0, 30.0)]["survival"] == 1.0 and by[(50.0, 30.0)]["mean_ess"] >= 1.0


def test_tune_cli_output_and_json_match_jax(monkeypatch, tmp_path):
    """The table, the best-cell line and ``tune.json`` (keys, ``indent=1``)
    as the JAX ``tune`` prints and writes them from the same episodes."""
    _port_arrays_as_jax_sweep(monkeypatch)
    argv = ["--lambdas", "0.5,50", "--sigmas", "0.02,30", "--tune-seeds", "2", "--k", "64", "--t-end", "3"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = cli.main(["tune", "--device", "cpu", "--log-dir", str(tmp_path / "port"), *argv])
    jargs = types.SimpleNamespace(lambdas="0.5,50", sigmas="0.02,30", tune_seeds=2, k=64, t_end=3.0, seed=0,
                                  log_dir=str(tmp_path / "jax"))
    jbuf = io.StringIO()
    with contextlib.redirect_stdout(jbuf):
        want = jtune.tune(jargs)
    assert got == want
    port_lines, jax_lines = buf.getvalue().splitlines(), jbuf.getvalue().splitlines()
    # the header names the port's launch a tick where JAX's says one device call
    assert port_lines[0].split("—")[0] == jax_lines[0].split("—")[0]
    assert port_lines[1:-1] == jax_lines[1:-1]
    assert "best cell: lambda=50 sigma=30" in buf.getvalue()
    port_json = (tmp_path / "port" / "tune" / "tune.json").read_text()
    assert port_json == (tmp_path / "jax" / "tune" / "tune.json").read_text()
    assert json.loads(port_json)["n_ticks"] == 30


def test_tune_cli_defaults_and_card_default():
    args = cli.build_parser().parse_args(["tune"])
    assert (args.lambdas, args.sigmas, args.tune_seeds, args.k, args.device) == ("0.1,0.5,1.4,2.5", "1,3,10", 8,
                                                                                 None, "cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main(["tune", "--k", "64", "--t-end", "0.1"])


# --------------------------------------------------------------------------
# the sweep's build table and its refusal on a card


def test_sweep_built_table_and_rollouts_per_thread():
    """The sweep's kernel is built at every N of 1-40 for box-muller and
    external noise at R = 1, and at N = 8 also at R = 4; the R rule takes
    R = 1 wherever R = 4 is not built, at any K, and R = 4 at tune's N = 8
    on its default grid at K = 800 000."""
    assert tuple(mppi_cuda.SWEEP_HORIZONS) == tuple(range(1, 41))
    sweep = mppi_cuda.SweepModel(MODEL)
    for n in mppi_cuda.SWEEP_HORIZONS:
        assert mppi_cuda.built_for(sweep, n) == (("external", "box-muller"), (1, 4) if n == N else (1,))
        assert mppi_cuda.rollouts_per_thread(800_000, 96, sweep, n) == (4 if n == N else 1)
        mppi_cuda.check_built(sweep, n, "box-muller", 1)
        mppi_cuda.check_built(sweep, n, "external", 1)
    # the solve's table is not the sweep's: serve's cart-pole draws box-muller alone
    assert mppi_cuda.built_for(MODEL, 20) == (("box-muller",), (1,))


@pytest.mark.parametrize("model, n, source, rpt, match", [
    (MODEL, 41, None, None, r"no sweep kernel for horizon N=41; it is built for N=1-40"),
    (MODEL, 0, None, None, r"no sweep kernel for horizon N=0"),
    (MODEL, 20, "clt4", 1, r"no kernel for noise source 'clt4' with SweepModel at N=20; it is built for external, "
                           r"box-muller"),
    (MODEL, 20, "box-muller", 4, r"no kernel at 4 rollouts a thread with SweepModel at N=20; it is built for R=\[1\]"),
    (MODEL, 31, "external", 4, r"4 rollouts a thread with SweepModel at N=31"),
    (CartPoleShaped4(CartPoleParams.single_wheel(), 0.1, fast=True), 8, None, None, "exact CartPoleShaped4"),
    (mppi_cuda.Commu4Cost4(CartPoleParams.two_wheel(), 0.06), 20, None, None, "exact CartPoleShaped4"),
])
def test_unbuilt_sweep_is_refused(model, n, source, rpt, match):
    """What ``mppi_sweep_batch_fused`` checks on a CUDA device before any
    launch (``check_built`` on the sweep's ``SweepModel``)."""
    with pytest.raises(ValueError, match=match):
        mppi_cuda.check_built(mppi_cuda.SweepModel(model), n, source, rpt)


def test_make_sweep_at_n41_on_a_card_raises_before_a_launch(monkeypatch):
    """``make_sweep(n_horizon=41)`` on a CUDA device raises a ValueError
    when it is made, before any tensor or launch (the card is mocked: the
    library must not be asked for); on the CPU it runs, as the JAX sweep
    takes any N."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def no_library():
        raise AssertionError("the kernels' library was asked for")

    monkeypatch.setattr(mppi_cuda, "_library", no_library)
    mppi_cuda.reset_launches()
    with pytest.raises(ValueError, match=r"no sweep kernel for horizon N=41; it is built for N=1-40"):
        tune.make_sweep(k=64, n_horizon=41, device="cuda")
    for n in (1, 20, 40):  # built: made without a launch
        tune.make_sweep(k=64, n_horizon=n, device="cuda")
    assert not any(mppi_cuda.launches.values())
    monkeypatch.undo()
    surv, cost, ess = tune.make_sweep(k=64, n_horizon=41, n_ticks=2, device="cpu")([50.0], [1.0], [0])
    assert surv.shape == cost.shape == ess.shape == (1,) and bool(torch.isfinite(cost).all())


def test_every_sweep_horizon_is_instantiated_once_in_the_sources():
    """Each of ``build.SOURCES`` instantiates its horizons: the sweep at
    every N of 1-40, serve's cart-pole at N = 9-40 and the rows' finalize
    at N = 8-40, each exactly once over the sources (a missing one fails at
    load, a second one at link time, on the card only)."""
    import re

    from mpc_rs_tpu_torch.ops import build

    found = {"SWEEP": [], "SERVE": [], "FINALIZE": []}
    for src in build.SOURCES:
        for kind, n in re.findall(r"^MPC_(SWEEP|SERVE|FINALIZE)_HORIZON\((\d+)\)", (build.CSRC / src).read_text(),
                                  flags=re.M):
            found[kind].append(int(n))
    assert sorted(found["SWEEP"]) == list(mppi_cuda.SWEEP_HORIZONS)
    assert sorted(found["SERVE"]) == list(mppi_cuda.SERVE_HORIZONS)
    # MPC_SERVE_HORIZON(N) holds the finalize at N too
    assert sorted(found["FINALIZE"] + found["SERVE"]) == sorted(mppi_cuda.FINALIZE_HORIZONS)


def test_sweep_kernel_names_are_read_by_r_and_horizon(tmp_path):
    """The tools that read the sweep's instantiations by name: ptxas rows
    by (R, N) (``profile_sweep.sweep_ptxas``), tune's N = 8 in the SASS
    counts (``profile_partials.SWEEP_RE``) and in the bit comparison of two
    checkouts (``sweep_bits``), whose comparison holds every case."""
    from mpc_rs_tpu_torch.runtime import profile_partials, profile_sweep, sweep_bits

    def name(r, n):
        return (f"_ZN3mpc17mppi_sweep_kernelILi{r}ELi{n}ELi0EEEvNS_18CartPoleNonlinearTILb0EEENS_12PartialsArgsE"
                f"NS_10PartialsIOENS_9MppiSweepE")

    log = []
    for (r, n), regs in {(1, 8): 46, (4, 8): 64, (1, 31): 115, (1, 40): 134}.items():
        log += [f"ptxas info    : Compiling entry function '{name(r, n)}' for 'sm_90a'",
                f"ptxas info    : Function properties for {name(r, n)}",
                "    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
                f"ptxas info    : Used {regs} registers, used 1 barriers, 32 bytes cumulative stack size"]
    rows = profile_sweep.sweep_ptxas("\n".join(log))
    assert [(r["rpt"], r["n"], r["registers"], r["spill_bytes"]) for r in rows] == [
        (1, 8, 46, 0), (4, 8, 64, 0), (1, 31, 115, 0), (1, 40, 134, 0)]
    assert [bool(sweep_bits.N8_RE.search(name(r, n))) for r, n in ((1, 8), (4, 8), (1, 9), (1, 18))] == [
        True, True, False, False]
    assert profile_partials.SWEEP_RE.search(name(4, 8)).groups() == ("4", "8")
    outs = {"K1024/external/R1": [torch.zeros(2, 8), torch.zeros(2, dtype=torch.int32), torch.ones(2)]}
    for label, ess in (("a", 1.0), ("b", 1.0), ("c", 2.0)):
        torch.save({"out": {k: [v[0], v[1], v[2] * ess] for k, v in outs.items()}, "ptxas": [], "build_s": 0.0},
                   tmp_path / f"{label}.pt")
    for other, equal in (("b", True), ("c", False)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            sweep_bits.compare(tmp_path / "a.pt", tmp_path / f"{other}.pt")
        assert json.loads(buf.getvalue())["all_equal"] is equal
