"""The port's slice as a whole: the ``mppi4-non-liner`` closed loop against
the same loop written with the JAX package, the CLI on the CPU, the CSV
schema, and the port's isolation from JAX."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_rs_tpu.apps.common import np_step as jax_np_step
from mpc_rs_tpu.controllers import mppi as jmppi
from mpc_rs_tpu.models import costs as jcosts
from mpc_rs_tpu.models import dynamics as jdyn
from mpc_rs_tpu.models.params import CartPoleParams as JParams
from mpc_rs_tpu_torch.apps import run as cli
from mpc_rs_tpu_torch.apps.common import make_mppi_solver, np_step, resolve_device
from mpc_rs_tpu_torch.apps.mppi_examples import closed_loop
from mpc_rs_tpu_torch.controllers import mppi as tmppi
from mpc_rs_tpu_torch.models import costs as tcosts
from mpc_rs_tpu_torch.models import dynamics as tdyn
from mpc_rs_tpu_torch.models.params import CartPoleParams
from mpc_rs_tpu_torch.ops.mppi_cuda import CartPoleShaped4
from mpc_rs_tpu_torch.runtime.logger import CsvLogger

ROOT = Path(__file__).resolve().parents[1]
N, K, TICKS = 8, 1024, 20
X0 = (0.5, 0.0, 0.1, 0.0)
KW = dict(n_horizon=N, n_rollouts=K, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))


# At the app's λ=0.5 the softmax weights one or two rollouts (ESS near 1),
# and the closed loop amplifies a difference about tenfold per tick: the two
# packages' float64 sin/cos differ in the last bit at tick 3 (2e-14), and
# by tick 19 the trajectories are 0.7 apart. The loop is held at λ=5
# (ESS ~30), where it is well conditioned (2e-14 after 20 ticks); λ=0.5 is held per solve and
# per chain in tests/test_torch_mppi.py and tests/test_torch_kernels.py.
@pytest.mark.parametrize("lam", [5.0])
def test_closed_loop_matches_jax_loop(tmp_path, capsys, lam):
    """20 ticks of the mppi4-non-liner loop in float64, the same noise per
    tick in both packages: the port's trajectory equals the JAX one to 1e-9."""
    noise = 3.0 * np.random.default_rng(0).standard_normal((TICKS, K, N))
    tstep = tdyn.make_cartpole_nonlinear(CartPoleParams.single_wheel(), 0.1)
    kw = {**KW, "lambda_": lam}
    tcfg = tmppi.MppiConfig(**kw)

    def solve(seed, x, u_n):
        r = tmppi.mppi_solve(tcfg, tstep, tcosts.shaped4, None,
                             tuple(torch.tensor(c, dtype=torch.float64) for c in x), u_n,
                             noise=torch.tensor(noise[seed]))
        return r.u_n, r.status

    with CsvLogger(str(tmp_path / "port.csv")) as log:
        # t_end 1.95: the float t of the 20th tick is 1.9000000000000004
        res = closed_loop(solve, tstep, X0, torch.zeros(N, dtype=torch.float64),
                          t_end=1.95, dt=0.1, seed=0, logger=log)
    got = np.loadtxt(tmp_path / "port.csv", delimiter=",")
    assert got.shape == (TICKS, 6) and res.statuses == [0] * TICKS and not res.tipped

    jstep = jdyn.make_cartpole_nonlinear(JParams.single_wheel(), 0.1)
    jsolve = jax.jit(lambda x, u_n, eps: jmppi.mppi_solve(
        jmppi.MppiConfig(**kw), jstep, jcosts.shaped4, None, x, u_n, noise=eps))
    x, u_n, want = np.asarray(X0), jnp.zeros(N, jnp.float64), []
    for i in range(TICKS):
        r = jsolve(tuple(jnp.float64(c) for c in x), u_n, jnp.asarray(noise[i]))
        u_n = r.u_n
        x = jax_np_step(jstep, x, float(u_n[0]))
        want.append([0.1 * i, float(u_n[0]), *x])
    want = np.asarray(want)
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got[:, 0], want[:, 0], atol=1e-12)
    np.testing.assert_allclose(res.x, x, rtol=1e-9, atol=1e-12)


def test_np_step_is_a_float64_host_step():
    p = CartPoleParams.single_wheel()
    x = np.array([0.3, -0.2, 0.15, 0.4])
    got = np_step(tdyn.make_cartpole_nonlinear(p, 0.1), x, 2.5)
    want = jax_np_step(jdyn.make_cartpole_nonlinear(JParams.single_wheel(), 0.1), x, 2.5)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-15)


def test_cpu_solver_samples_philox_noise():
    cfg = tmppi.MppiConfig(**{**KW, "n_rollouts": 2048})
    solve = make_mppi_solver(cfg, CartPoleShaped4(CartPoleParams.single_wheel(), 0.1), "cpu")
    u1, st1 = solve(3, np.asarray(X0), torch.zeros(N))
    u2, _ = solve(3, np.asarray(X0), torch.zeros(N))
    u3, _ = solve(4, np.asarray(X0), torch.zeros(N))
    assert u1.dtype == torch.float32 and int(st1) == 0
    assert torch.equal(u1, u2) and not torch.equal(u1, u3)


def test_cli_default_device_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device runs")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["mppi4-non-liner", "--t-end", "0.1", "--log-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")


def test_cli_runs_on_cpu_and_writes_the_plot_schema(tmp_path):
    """The entry point on the plain path: 2 s at K=4096, no tip, a CSV of
    t, u, x[0..3] that scripts/plot_logs.py reads unchanged."""
    out = subprocess.run(
        [sys.executable, "-m", "mpc_rs_tpu_torch.apps.run", "mppi4-non-liner", "--device", "cpu",
         "--k", "4096", "--t-end", "2", "--log-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    assert "over 60 degrees" not in out.stdout and "elapsed:" in out.stdout
    csv = tmp_path / "mppi" / "mppi.csv"
    data = np.loadtxt(csv, delimiter=",")
    assert data.shape[1] == 6 and data.shape[0] >= 20 and np.isfinite(data).all()
    assert np.abs(data[:, 4]).max() < np.radians(60.0)
    plot = subprocess.run(
        [sys.executable, "scripts/plot_logs.py", str(csv), "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
    )
    assert plot.returncode == 0, plot.stderr
    assert "saved:" in plot.stdout


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port imports in a fresh process without pulling
    in jax or mpc_rs_tpu, and without nvcc or triton."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import mpc_rs_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'mpc_rs_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "import mpc_rs_tpu_torch.ops.mppi_cuda\n"
        "print('ok', len([m for m in sys.modules if m.startswith('mpc_rs_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=ROOT, env={"PATH": "/nonexistent", "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_profile_fleet_reads_ptxas_and_compares_k7_dumps(tmp_path):
    """profile_fleet's helpers: the estimator chain's lines of a ptxas
    report, the comparison of two K7 output files; it refuses to measure
    without a card."""
    from mpc_rs_tpu_torch.runtime import profile_fleet

    log = ("ptxas info    : Compiling entry function '_ZN3mpc22estimator_chain_kernelILi6E' for 'sm_90a'\n"
           "ptxas info    : Function properties for _ZN3mpc22estimator_chain_kernelILi6E\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 96 registers, used 1 barriers, 480 bytes cmem[0]\n"
           "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120fastmath_eval_kernel' for 'sm_90a'\n"
           "ptxas info    : Used 12 registers\n")
    lines = profile_fleet.ptxas_kernel(log, "estimator_chain_kernel")
    assert len(lines) == 2 and "0 bytes spill stores" in lines[0] and "96 registers" in lines[1]
    a = {"m/B=1/x": torch.tensor([1.0, float("nan")]), "m/B=1/p": torch.tensor([0.5])}
    torch.save(a, tmp_path / "a.pt")
    torch.save({**a, "m/B=1/p": torch.tensor([0.25])}, tmp_path / "b.pt")
    row = profile_fleet.compare_k7(str(tmp_path / "a.pt"), str(tmp_path / "b.pt"))
    assert not row["all_same_bits"] and row["outputs"]["m/B=1/x"]["same_bits"]
    assert row["outputs"]["m/B=1/p"]["max_abs_diff"] == 0.25
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="is_available"):
            profile_fleet.main([])


def test_profile_tick_busy_share_merges_overlaps():
    """The device's busy time is the union of its intervals, and the
    profiler refuses to run without a card."""
    from mpc_rs_tpu_torch.runtime import profile_tick

    assert profile_tick._union_us([(0, 2), (1, 3), (5, 6), (5.5, 5.7), (10, 10)]) == 4.0
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="is_available"):
            profile_tick.main([])
