"""serve's plan-streaming horizons in the port, on the CPU: the horizon the
port's ``serve`` picks against the JAX ``serve``'s own lines, the kernels'
build table (``BUILT``, ``BUILT_FOR``) and the refusal rule the wrappers
apply on a CUDA device, the R rule at N = 9-39, the plain box-muller words
at odd N, the warm start's advance at N = 16 and a ``serve`` run at N = 16
through the CLI. The batch solver against the JAX ``mppi_solve`` at these
horizons is ``tests/test_torch_commu.py``'s
``test_serve_batch_solver_matches_jax_robot_by_robot``.
"""

import contextlib
import inspect
import io
import textwrap
import types

import numpy as np
import pytest
import torch

from mpc_rs_tpu.apps import serve as jserve
from mpc_rs_tpu_torch.apps import run as cli
from mpc_rs_tpu_torch.apps import serve as tserve
from mpc_rs_tpu_torch.controllers.mppi import MppiConfig
from mpc_rs_tpu_torch.models.params import CartPoleParams
from mpc_rs_tpu_torch.ops import mppi_cuda, philox
from mpc_rs_tpu_torch.ops.mppi_cuda import CartPoleShaped4, Commu4Cost4, Flagship4Diag4

SW = CartPoleParams.single_wheel()
PERIODS = (0.001, 0.01, 0.0195, 0.02, 0.0205, 0.021, 0.025, 0.03, 0.04, 0.05, 0.0615, 0.07, 0.08, 0.09,
           0.094, 0.095, 0.1, 0.12, 0.2)


def _jax_horizon(period: float, m: int) -> tuple[int, float]:
    """(N, dt) by the JAX ``serve``'s own lines (``mpc_rs_tpu/apps/serve.py:
    186-203``, from ``t_hor, n = 0.8, 8`` to the ``else`` branch), run on
    ``args`` with that period and M."""
    lines = inspect.getsource(jserve.serve).splitlines()
    first = next(i for i, ln in enumerate(lines) if ln.strip() == "t_hor, n = 0.8, 8")
    last = next(i for i, ln in enumerate(lines) if ln.strip() == "dt = t_hor / n")
    scope = {"np": np, "args": types.SimpleNamespace(control_period=period, ticks_per_dispatch=m, time_scale=1.0)}
    exec(textwrap.dedent("\n".join(lines[first:last + 1])), scope)
    return scope["n"], scope["dt"]


@pytest.mark.parametrize("m", [1, 2, 3, 4, 8, 9, 16, 31, 32, 39, 40, 41])
def test_plan_horizon_is_the_jax_serves(m):
    """Every period of the grid at this M: the JAX lines' N and dt, and a
    horizon the kernels are built for."""
    for period in PERIODS:
        n, dt = tserve.plan_horizon(period, m)
        assert (n, dt) == _jax_horizon(period, m), (period, m)
        mppi_cuda.check_built(CartPoleShaped4(SW, dt), n, "box-muller", 1)


def test_plan_horizon_reaches_every_n_of_9_to_39():
    """Through the period alone (M = 2) or through M alone (at the default
    0.01 s period the horizon is 40, so M raises it no further): periods of
    about 0.021-0.094 s give N = 9-38 and 0.0205 gives 39."""
    by_period = {tserve.plan_horizon(p, 2)[0] for p in np.arange(0.0200, 0.0950, 0.0005)}
    assert set(range(9, 40)) <= by_period
    assert tserve.plan_horizon(0.05, 2) == (16, 0.05) and tserve.plan_horizon(0.025, 4) == (32, 0.025)
    assert {tserve.plan_horizon(0.1, m)[0] for m in range(9, 40)} == set(range(9, 40))


def test_built_table_at_serves_horizons():
    """The cart-pole is built at every N of 8-40; past N = 8 for box-muller
    alone, at R = 1 (and R = 4 at N = 40); the finalize at every horizon of
    ``BUILT``."""
    assert {n for i, n in mppi_cuda.BUILT if i == 0} == set(range(8, 41))
    assert mppi_cuda.FINALIZE_HORIZONS == frozenset(range(8, 41))
    model = CartPoleShaped4(SW, 0.05)
    assert mppi_cuda.built_for(model, 8) == (mppi_cuda.NOISE_SOURCES, (1, 4))
    for n in range(9, 40):
        assert mppi_cuda.built_for(model, n) == (("box-muller",), (1,))
    assert mppi_cuda.built_for(model, 40) == (("box-muller",), (1, 4))
    assert mppi_cuda.built_for(Commu4Cost4(SW, 0.05), 20) == (mppi_cuda.NOISE_SOURCES, (1, 4))


@pytest.mark.parametrize("n, source, rpt, match", [
    (16, "clt4", 1, r"noise source 'clt4' with CartPoleShaped4 at N=16; it is built for box-muller"),
    (16, "external", 1, r"noise source 'external' with CartPoleShaped4 at N=16"),
    (16, "box-muller", 4, r"4 rollouts a thread with CartPoleShaped4 at N=16; it is built for R=\[1\]"),
    (31, "box-muller", 4, r"4 rollouts a thread with CartPoleShaped4 at N=31"),
    (40, "wallace", 4, r"noise source 'wallace' with CartPoleShaped4 at N=40"),
    (40, "external", 1, r"noise source 'external' with CartPoleShaped4 at N=40"),
    (41, "box-muller", 1, r"no kernel for horizon N=41 with CartPoleShaped4"),
])
def test_unbuilt_source_or_r_is_refused(n, source, rpt, match):
    """What the wrappers check on a CUDA device before any launch
    (``_kernel_args``, ``_batch_kernel_args``): a sampler, external noise or
    an R that the pair is not built for raises a ValueError."""
    with pytest.raises(ValueError, match=match):
        mppi_cuda.check_built(CartPoleShaped4(SW, 0.8 / n), n, source, rpt)


@pytest.mark.parametrize("n, source, rpt", [(9, "box-muller", 1), (31, "box-muller", 1), (32, "box-muller", 1),
                                             (39, "box-muller", 1), (40, "box-muller", 4), (8, "clt4a", 4),
                                             (8, "external", 1)])
def test_built_source_and_r_pass(n, source, rpt):
    mppi_cuda.check_built(CartPoleShaped4(SW, 0.8 / n), n, source, rpt)


def test_fast_tier_past_n8_and_other_models_are_refused():
    with pytest.raises(ValueError, match="no fast-tier kernel for CartPoleShaped4 at N=16"):
        mppi_cuda.check_built(CartPoleShaped4(SW, 0.05, fast=True), 16, "box-muller", 1)
    with pytest.raises(ValueError, match=r"N=12 with Flagship4Diag4; it is built for N=\[8\]"):
        mppi_cuda.check_built(Flagship4Diag4(SW, 0.05), 12)


@pytest.mark.parametrize("k", [66_561, 100_000, 800_000, 1_500_000])
def test_rollouts_per_thread_is_1_where_r4_is_not_built(k):
    """At 8 robots R = 4 is chosen from K = 66 561 (528 blocks); at serve's
    N = 9-39 only R = 1 is built, so the rule takes R = 1 there, and R = 4
    at N = 8 and 40."""
    model = CartPoleShaped4(SW, 0.05)
    assert mppi_cuda.rollouts_per_thread(k, 8) == 4
    assert all(mppi_cuda.rollouts_per_thread(k, 8, model, n) == 1 for n in range(9, 40))
    assert mppi_cuda.rollouts_per_thread(k, 8, model, 40) == mppi_cuda.rollouts_per_thread(k, 8, model, 8) == 4
    assert mppi_cuda.rollouts_per_thread(66_560, 8, model, 40) == 1


@pytest.mark.parametrize("n", [9, 16, 31, 32, 39])
def test_plain_rows_take_the_pairs_r(n):
    """The plain batch's rows at K = 66 561 and 8 problems are blocks of 256
    rollouts (R = 1) at N = 9-39, as the kernel's, and of 1 024 at N = 40."""
    k = 66_561
    cfg = MppiConfig(n_horizon=n, n_rollouts=k, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
    model = CartPoleShaped4(SW, 0.8 / n)
    xs, u_ns = torch.zeros(8, 4), torch.zeros(8, n)
    noise = torch.zeros(8, k, n)
    assert mppi_cuda.mppi_batch_partials_plain(cfg, model, xs[:1], u_ns[:1], noise[:1]).shape == (1, 261, n + 2)
    rows = mppi_cuda.mppi_batch_partials_plain(cfg, model, xs, u_ns, noise)
    assert rows.shape == (8, 261, n + 2)
    cfg40 = MppiConfig(n_horizon=40, n_rollouts=k, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
    rows40 = mppi_cuda.mppi_batch_partials_plain(cfg40, CartPoleShaped4(SW, 0.01), xs, torch.zeros(8, 40),
                                                 torch.zeros(8, k, 40))
    assert rows40.shape == (8, 66, 42)


@pytest.mark.parametrize("n", [9, 16, 31, 32, 39])
def test_box_muller_words_at_n_are_a_prefix_of_n40s(n):
    """box-muller draws a pair per two steps, four steps a Philox call; at odd
    N the last pair is half used. Rollout k's N steps are the first N of its
    40 at the same key and stream, in both tiers, for a batch and a single
    solve."""
    seeds = torch.tensor([5, 36, 2**31 - 1], dtype=torch.int32)
    for fast in (False, True):
        at_n = philox.sample_noise("box-muller", seeds, torch.arange(3), 300, n, 3.0, fast=fast)
        at_40 = philox.sample_noise("box-muller", seeds, torch.arange(3), 300, 40, 3.0, fast=fast)
        assert at_n.shape == (3, 300, n) and torch.equal(at_n, at_40[:, :, :n])
    cfg = MppiConfig(n_horizon=n, n_rollouts=300, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
    one = mppi_cuda.solve_noise(cfg, CartPoleShaped4(SW, 0.05), 36, 1, "box-muller")
    assert torch.equal(one, philox.sample_noise("box-muller", seeds, torch.arange(3), 300, 40, 3.0)[1, :, :n])


def test_warm_start_advance_at_n16():
    """``_solve``'s ``advance`` shifts a (B, 16) warm start by the plan steps
    gone by, its last entry repeated, as at N = 40; it never drops more than
    N - 1 steps."""
    model = CartPoleShaped4(SW, 0.05)
    cfg = MppiConfig(n_horizon=16, n_rollouts=256, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
    rng = np.random.default_rng(16)
    xs = torch.tensor(np.c_[np.zeros((3, 2)), rng.uniform(-0.1, 0.1, (3, 1)), np.zeros((3, 1))], dtype=torch.float32)
    seeds = torch.arange(3, dtype=torch.int32)
    u = torch.tensor(rng.standard_normal((3, 16)), dtype=torch.float32)
    for adv in (1, 3, 15, 40):
        k = min(adv, 15)
        moved = torch.cat([u[:, k:], u[:, -1:].expand(-1, k)], dim=1)
        want, _ = tserve._solve(cfg, model, "box-muller", True, seeds, xs, moved)
        got, plan = tserve._solve(cfg, model, "box-muller", True, seeds, xs, u, adv)
        assert got.shape == (3, 16) and torch.equal(got, want) and torch.equal(plan, got)


def test_serve_cli_at_a_plan_streaming_horizon():
    """``serve --ticks-per-dispatch 2 --control-period 0.05`` runs N = 16 on
    the plain path (the JAX ``serve``'s horizon for that period) and serves
    every robot."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summary = cli.main(["serve", "--sim-mcu", "--robots", "8", "--ticks-per-dispatch", "2", "--control-period",
                            "0.05", "--device", "cpu", "--k", "128", "--time-scale", "0.2", "--t-end", "1.0",
                            "--seed", "3"])
    assert summary["horizon"] == 16 and summary["plan_dt"] == 0.05 and summary["ticks_per_dispatch"] == 2
    assert summary["ticks"] > 5 and summary["dispatches"] >= 2
    assert all(n > 0 for n in summary["rx"]) and all(n > 0 for n in summary["tx"])
    assert summary["bad_frames"] == 0 and "robots upright" in buf.getvalue()
