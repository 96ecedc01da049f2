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
  above also run at N ∈ {1, 9, 30, 31, 32, 40, 41, 64} beside tune's N = 8
  (N = 1 and odd N half use a box-muller pair; past 40 the horizons the
  kernel took no more before it took N at run time), and the sweep's one
  kernel: the horizons it runs (1 to ``SWEEP_MAX_HORIZON``, what a block's
  shared memory holds), its refusal on a card before any launch at 0 and
  past the maximum, the tiles a block and R the wrapper picks, and the
  tools that read its build.
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
HORIZONS = (1, 9, 30, 31, 32, 40, 41, 64)  # the other horizons the checks run at
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
    """The sweep's one kernel runs every N of 1 to ``SWEEP_MAX_HORIZON`` =
    224 for box-muller and external noise, at any tiles a block (the R of
    the solves' table does not apply to it); 224 is the largest N whose
    block fits an H100's 232 448 bytes of shared memory a block; the
    solves' R rule is unchanged."""
    assert mppi_cuda.SWEEP_MAX_HORIZON == 224
    assert mppi_cuda.sweep_shared_bytes(224) <= mppi_cuda.SWEEP_SHARED_MAX < mppi_cuda.sweep_shared_bytes(225)
    sweep = mppi_cuda.SweepModel(MODEL)
    for n in range(1, mppi_cuda.SWEEP_MAX_HORIZON + 1):
        mppi_cuda.check_built(sweep, n, "box-muller")
        mppi_cuda.check_built(sweep, n, "external")
    assert {key[0] for key in mppi_cuda.BUILT_FOR} == {MODEL.model_id}  # serve's rows alone
    # the solve's table is not the sweep's: serve's cart-pole draws box-muller alone
    assert mppi_cuda.built_for(MODEL, 20) == (("box-muller",), (1,))
    assert mppi_cuda.rollouts_per_thread(800_000, 96, MODEL, 8) == 4


@pytest.mark.parametrize("model, n, source, match", [
    (MODEL, 225, None, r"no sweep kernel for horizon N=225; it runs N=1-224 \(a block's shared memory, 233328 bytes"),
    (MODEL, 0, None, r"no sweep kernel for horizon N=0; it runs N=1-224"),
    (MODEL, 1000, "box-muller", r"no sweep kernel for horizon N=1000"),
    (MODEL, 20, "clt4", r"no kernel for noise source 'clt4' with SweepModel at N=20; it is built for external, "
                        r"box-muller"),
    (MODEL, 224, "wallace", r"no kernel for noise source 'wallace' with SweepModel at N=224"),
    (CartPoleShaped4(CartPoleParams.single_wheel(), 0.1, fast=True), 8, None, "exact CartPoleShaped4"),
    (mppi_cuda.Commu4Cost4(CartPoleParams.two_wheel(), 0.06), 20, None, "exact CartPoleShaped4"),
])
def test_unbuilt_sweep_is_refused(model, n, source, match):
    """What ``mppi_sweep_batch_fused`` checks on a CUDA device before any
    launch (``check_built`` on the sweep's ``SweepModel``)."""
    with pytest.raises(ValueError, match=match):
        mppi_cuda.check_built(mppi_cuda.SweepModel(model), n, source)


def test_make_sweep_at_n41_on_a_card_raises_before_a_launch(monkeypatch):
    """``make_sweep`` on a CUDA device (the card is mocked: the library must
    not be asked for): N = 41 and 64, which the kernel took no more before it
    took N at run time, are made without a launch as 1, 20, 40 and 224 are;
    past ``SWEEP_MAX_HORIZON`` (225) and at 0 it raises a ValueError when it
    is made, before any tensor or launch. On the CPU N = 225 runs, as the
    JAX sweep takes any N."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def no_library():
        raise AssertionError("the kernels' library was asked for")

    monkeypatch.setattr(mppi_cuda, "_library", no_library)
    mppi_cuda.reset_launches()
    for n in (225, 0):
        with pytest.raises(ValueError, match=rf"no sweep kernel for horizon N={n}; it runs N=1-224"):
            tune.make_sweep(k=64, n_horizon=n, device="cuda")
    for n in (1, 20, 40, 41, 64, 224):  # made without a launch
        tune.make_sweep(k=64, n_horizon=n, device="cuda")
    assert not any(mppi_cuda.launches.values())
    monkeypatch.undo()
    surv, cost, ess = tune.make_sweep(k=64, n_horizon=225, n_ticks=2, device="cpu")([50.0], [1.0], [0])
    assert surv.shape == cost.shape == ess.shape == (1,) and bool(torch.isfinite(cost).all())


def test_every_sweep_horizon_is_instantiated_once_in_the_sources():
    """The sweep is one kernel, defined in ``sweep.cuh`` and instantiated by
    one source of ``build.SOURCES`` (``sweep.cu``, with its C entries), not
    a horizon at a time; so are serve's cart-pole at N = 9-40 and the rows'
    finalize at N = 8-40, one kernel each that takes N at run time, defined
    once in ``horizons.cu`` (a source of ``build.SOURCES``), with no
    instantiation a horizon left in any source."""
    import re

    from mpc_rs_tpu_torch.ops import build

    found = {"SWEEP": [], "SERVE": [], "FINALIZE": []}
    including = []
    for src in build.SOURCES:
        text = (build.CSRC / src).read_text()
        for kind, n in re.findall(r"^MPC_(SWEEP|SERVE|FINALIZE)_HORIZON\((\d+)\)", text, flags=re.M):
            found[kind].append(int(n))
        if re.search(r'^#include "sweep\.cuh"', text, flags=re.M):
            including.append(src)
    assert including == ["sweep.cu"] and "sweep.cuh" in build.HEADERS
    assert found["SWEEP"] == []
    # one kernel, not a template: a line of launch bounds, then its name
    kernels = re.findall(r"^(.*)\n__global__ void __launch_bounds__\(kThreads, kSweepMinBlocks\)\nmppi_sweep_kernel\(",
                         (build.CSRC / "sweep.cuh").read_text(), flags=re.M)
    assert len(kernels) == 1 and not kernels[0].startswith("template")
    assert found == {"SWEEP": [], "SERVE": [], "FINALIZE": []}
    assert "horizons.cu" in build.SOURCES and not any(src.startswith("horizons_") for src in build.SOURCES)
    horizons = (build.CSRC / "horizons.cu").read_text()
    for name in ("mppi_horizons_kernel", "fleet_finalize_kernel"):
        defined = re.findall(rf"^(.*)\n__global__ void __launch_bounds__\(kThreads[^)]*\)\n{name}\(", horizons,
                             flags=re.M)
        assert len(defined) == 1 and not defined[0].startswith("template"), name
        assert all(f"{name}(" not in (build.CSRC / src).read_text() for src in build.SOURCES if src != "horizons.cu")


def test_sweep_kernel_names_are_read_by_r_and_horizon(tmp_path):
    """The tools that read the sweep's one kernel by name: its ptxas row
    (``profile_sweep.sweep_ptxas``: registers, spill, stack), the SASS
    counts (``profile_partials.SWEEP_RE``) and the comparison of two
    checkouts (``sweep_bits``), which reads the parent's N = 8
    instantiations too and holds each sweep case to its tolerance and each
    solve to its bits."""
    from mpc_rs_tpu_torch.runtime import profile_partials, profile_sweep, sweep_bits

    name = "_ZN3mpc17mppi_sweep_kernelENS_18CartPoleNonlinearTILb0EEENS_8TileArgsE"
    old = lambda r, n: (f"_ZN3mpc17mppi_sweep_kernelILi{r}ELi{n}ELi0EEEvNS_18CartPoleNonlinearTILb0EEENS_"  # noqa: E731
                        f"12PartialsArgsENS_10PartialsIOENS_9MppiSweepE")
    other = "_ZN3mpc20mppi_partials_kernelILi8ENS_18CartPoleNonlinearTILb0EEENS_7Shaped4ELb0ELi1ELi4ELi0EEEvT0_"
    log = []
    for func, regs in ((other, 64), (name, 46)):
        log += [f"ptxas info    : Compiling entry function '{func}' for 'sm_90a'",
                f"ptxas info    : Function properties for {func}",
                "    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
                f"ptxas info    : Used {regs} registers, used 1 barriers, 32 bytes cumulative stack size"]
    rows = profile_sweep.sweep_ptxas("\n".join(log))
    assert [(r["registers"], r["spill_bytes"], r["stack_bytes"]) for r in rows] == [(46, 0, 32)]
    assert profile_partials.SWEEP_RE.search(name) and not profile_partials.SWEEP_RE.search(old(4, 8))
    assert [bool(sweep_bits.SWEEP_RE.search(f)) for f in (name, old(1, 8), old(4, 8), old(1, 9), other)] == [
        True, True, True, False, False]
    assert profile_sweep.parse_horizons("1,8,20-23,224") == [1, 8, 20, 21, 22, 23, 224]
    f64, f32 = str(torch.float64), str(torch.float32)
    want = [torch.tensor([[1.0, 2.0]]), torch.zeros(1, dtype=torch.int32), torch.tensor([10.0])]
    plain = {"K1024/external": {f64: want, f32: [want[0] + 1e-3, want[1], want[2] + 1e-3]}}
    solves = {"K2": [torch.ones(8), torch.zeros((), dtype=torch.int32)]}
    for label, du, bits in (("a", 0.0, 0.0), ("b", 1e-4, 0.0), ("c", 1e-2, 0.0), ("d", 0.0, 1e-7)):
        out = {"K1024/external": [want[0] + du, want[1], want[2]]}
        torch.save({"out": out, "plain": plain, "solves": {"K2": [solves["K2"][0] + bits, solves["K2"][1]]},
                    "ptxas": [], "build_s": 0.0}, tmp_path / f"{label}.pt")
    for label, within, solves_equal in (("b", True, True), ("c", False, True), ("d", True, False)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            sweep_bits.compare(tmp_path / "a.pt", tmp_path / f"{label}.pt")
        got = json.loads(buf.getvalue())
        assert (got["sweep_within_tol"], got["solves_equal"]) == (within, solves_equal), label


# --------------------------------------------------------------------------
# the sweep's tiles a block, R and shared memory


def test_sweep_tiles_keep_the_grid_and_grow_to_the_cap():
    """The wrapper's tiles a block on an H100 (132 SMs): tune's grid (B =
    96, K = 800 000) takes 16, 196 blocks a problem, 18 816 in all; a grid
    that holds fewer than ``SWEEP_MIN_BLOCKS_AN_SM`` blocks an SM at one
    tile a block takes 1; otherwise the largest power of two up to
    ``SWEEP_MAX_TILES`` whose grid keeps them (doubling it would not)."""
    least = mppi_cuda.SWEEP_MIN_BLOCKS_AN_SM * mppi_cuda.H100_SMS
    assert mppi_cuda.sweep_tiles(800_000, 96) == 16
    for k, b in ((1024, 96), (4096, 96), (800_000, 1), (65_536, 8), (1, 1)):
        assert mppi_cuda.sweep_tiles(k, b) == 1
    for k, b in ((800_000, 96), (800_000, 24), (10_000_000, 96), (2_000_000, 16), (65_536, 1024), (300_000, 300)):
        t = mppi_cuda.sweep_tiles(k, b)
        tiles = -(-k // 256)
        assert t in (1, 2, 4, 8, 16) and t <= mppi_cuda.SWEEP_MAX_TILES
        assert -(-tiles // t) * b >= least or t == 1
        assert t == mppi_cuda.SWEEP_MAX_TILES or -(-tiles // (2 * t)) * b < least
    assert mppi_cuda.sweep_tiles(10_000_000, 96) == mppi_cuda.SWEEP_MAX_TILES == 16
    assert mppi_cuda.sweep_tiles(65_536, 96) == 4


@pytest.mark.parametrize("tiles", [1, 2, 3, 4, 16, 64])
def test_sweep_shared_bytes_at_every_horizon(tiles):
    """The kernel's dynamic shared memory at every N of 1-224 at ``tiles``
    tiles a block, as the kernel lays it out: R (4 up to N = 10, 2 up to
    20, else 1, where R divides the tiles) times 256 columns of N controls
    and a score, u_n and the running Σ w v, 26 floats of scratch. Every N
    up to the maximum stays under 232 448 bytes, N = 225 passes it; up to
    N = 40 a block takes at most 45 240 bytes (R N ≤ 40), so that shared
    memory holds five blocks an SM."""
    for n in range(1, mppi_cuda.SWEEP_MAX_HORIZON + 2):
        r = mppi_cuda.sweep_rollouts_a_thread(n, tiles)
        assert r in (1, 2, 4) and tiles % r == 0 and (r == 1 or r * n <= 40)
        assert r == (4 if n <= 10 and tiles % 4 == 0 else 2 if n <= 20 and tiles % 2 == 0 else 1)
        size = mppi_cuda.sweep_shared_bytes(n, tiles)
        assert size == 4 * (256 * r * n + 256 * r + 2 * n + 26)
        assert (size <= 232_448) == (n <= mppi_cuda.SWEEP_MAX_HORIZON)
        if n <= 40:
            assert size <= 45_240


def test_sweep_plain_rows_follow_the_blocks():
    """The plain version's rows group the rollouts as the kernel's blocks do,
    256 tiles a row (the last row ragged), and its answer does not depend on
    the grouping but in the last bits (float64); a tile count below 1 is
    refused."""
    lam, sig, xs, u_n, noise = _grid_inputs(1000, seed=3)
    args = (_cfg(1000), MODEL, torch.tensor(xs), torch.tensor(u_n), torch.tensor(noise), torch.tensor(lam),
            torch.tensor(sig))
    want = mppi_cuda.finalize_sweep_plain(mppi_cuda.sweep_partials_plain(*args, tiles_per_block=1), args[-2])
    for tiles, rows in ((1, 4), (2, 2), (3, 2), (4, 1), (16, 1)):
        parts = mppi_cuda.sweep_partials_plain(*args, tiles_per_block=tiles)
        assert parts.shape == (len(GRID), rows, N + 3)
        for g, w in zip(mppi_cuda.finalize_sweep_plain(parts, args[-2]), want):
            torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="tiles_per_block must be at least 1"):
        mppi_cuda.mppi_sweep_batch_fused(_cfg(1000), MODEL, *args[2:4], args[5], args[6], noise=args[4],
                                         tiles_per_block=0)


def test_sweep_tiles_read_the_cards_sms(monkeypatch):
    """The wrapper's tiles a block scale with the card's SMs, read from the
    device (an H100's 132 on the CPU): at B = 96, K = 65 536 a card of half
    the SMs takes twice the tiles, one of twice the SMs half, up to the cap;
    a CPU tensor's plain rows group as an H100's blocks would."""

    class Props:
        def __init__(self, sms):
            self.multi_processor_count = sms

    for sms, want in ((132, 4), (66, 8), (264, 2), (16, 16)):
        monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev, sms=sms: Props(sms))
        assert mppi_cuda.sweep_tiles(65_536, 96, "cuda:0") == want, sms
    monkeypatch.undo()
    assert mppi_cuda.sweep_tiles(800_000, 96, "cpu") == mppi_cuda.sweep_tiles(800_000, 96) == 16
