"""The HW flagship's float32 filter (UKF2(6,5) at Merwe α = 1e-3) in the JAX
package and in the port, on mppi4-ukf-commu's simulated MCU loop at the
test's size (``--sim-mcu --k 1024 --time-scale 0.2 --t-end 1.0``): how
often a solve made on a finite estimate fails, and how far apart two
evaluations of one filter step land (run manually; prints JSON lines).

    python tests/hil_float32_witness.py --package jax --runs 16
    python tests/hil_float32_witness.py --package torch --runs 32
    python tests/hil_float32_witness.py --one-step

``--package`` runs the app ``--runs`` times, each in a process of its own
on one CPU thread, eight at a time, and counts the runs that break each of
two claims: the old one, that every solve made on a finite estimate
returned OK and the run reached 20 solves; and the float32 claim of
``tests/test_torch_commu.py::test_mppi4_ukf_commu_sim_mcu``, that every
solve made on an estimate inside the plant's physical range
(``F32_PHYSICAL_RANGE`` there) returned OK and the run reached 20 solves
unless the tip-over guard ended it. Each run also reports the largest
|component| of the estimates its OK solves were made on. ``--one-step``
records the port's first packets, takes the JAX package's jitted estimate
after the first, and steps it over the second three ways: the JAX step
jitted, the JAX step eager, the port's step.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
ARGV = ["mppi4-ukf-commu", "--sim-mcu", "--k", "1024", "--time-scale", "0.2", "--t-end", "1.0"]
GUARD_LINE = "x[2] is over pi/2"  # both apps print it when the tip-over guard ends the run


def physical_range() -> tuple[float, ...]:
    """``F32_PHYSICAL_RANGE`` of tests/test_torch_commu.py, read from its file."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("_commu_tests", os.path.join(ROOT, "tests", "test_torch_commu.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.F32_PHYSICAL_RANGE
ONE_THREAD = {"OMP_NUM_THREADS": "1", "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"}


def _jax_run() -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from mpc_rs_tpu.apps import commu_examples, run

    seen = []
    real = commu_examples.make_mppi_solver

    def recording(*a, **kw):
        solve = real(*a, **kw)

        def solve_and_record(seed, x, u_n):
            out = solve(seed, x, u_n)
            seen.append((bool(np.isfinite(np.asarray(x)).all()), int(out[1]), [float(v) for v in x]))
            return out

        return solve_and_record

    commu_examples.make_mppi_solver = recording
    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as d, contextlib.redirect_stdout(buf):
        run.main([*ARGV, "--log-dir", d])
    return {"solves": seen[1:], "guard": GUARD_LINE in buf.getvalue()}  # past the solve made before traffic


def _torch_run() -> dict:
    import numpy as np

    from mpc_rs_tpu_torch.apps import commu_examples, run

    seen = []
    real = commu_examples.make_mppi_solver

    def recording(*a, **kw):
        solve = real(*a, **kw)

        def solve_and_record(seed, x, u_n):
            out = solve(seed, x, u_n)
            seen.append((bool(np.isfinite(np.asarray(x)).all()), int(out[1]), [float(v) for v in x]))
            return out

        return solve_and_record

    commu_examples.make_mppi_solver = recording
    with tempfile.TemporaryDirectory() as d, contextlib.redirect_stdout(io.StringIO()):
        res = run.main([*ARGV, "--device", "cpu", "--ukf-dtype", "float32", "--log-dir", d])
    return {"solves": seen[1:], "guard": not res.upright}


def _child(package: str) -> None:
    out = _jax_run() if package == "jax" else _torch_run()
    bounds = physical_range()
    solves = out["solves"]
    finite = next((i for i, (f, _, _) in enumerate(solves) if not f), len(solves))
    bad = [i for i, (_, s, _) in enumerate(solves[:finite]) if s != 0]
    inside = [i for i, (f, _, x) in enumerate(solves) if f and all(abs(v) <= b for v, b in zip(x, bounds))]
    bad_inside = [i for i in inside if solves[i][1] != 0]
    ok_x = [x for f, s, x in solves if f and s == 0]
    print(json.dumps({"package": package, "solves": len(solves), "finite_solves": finite, "guard": out["guard"],
                      "failed_on_a_finite_estimate": bad,
                      "x4_there": [[round(v, 3) for v in solves[i][2]] for i in bad],
                      "failed_inside_the_range": bad_inside,
                      "old_claim": not bad and len(solves) >= 20,
                      "f32_claim": not bad_inside and (len(solves) >= 20 or out["guard"]),
                      "ok_estimates_max_abs": [max((abs(x[j]) for x in ok_x), default=None) for j in range(4)]}))


def _runs(package: str, runs: int) -> None:
    env = {**os.environ, **ONE_THREAD}
    rows = []
    for first in range(0, runs, 8):
        procs = [subprocess.Popen([sys.executable, __file__, "--child", package], env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for _ in range(first, min(runs, first + 8))]
        for p in procs:
            out, err = p.communicate()
            if p.returncode:
                raise RuntimeError(f"a {package} run exited {p.returncode}: {err[-2000:]}")
            rows.append(json.loads(out.strip().splitlines()[-1]))
            print(json.dumps(rows[-1]))
    failing = sum(bool(r["failed_on_a_finite_estimate"]) for r in rows)
    print(json.dumps({"package": package, "runs": len(rows), "runs_with_a_failed_solve_on_a_finite_estimate": failing,
                      "runs_breaking_the_old_claim": sum(not r["old_claim"] for r in rows),
                      "runs_breaking_the_f32_claim": sum(not r["f32_claim"] for r in rows),
                      "physical_range": physical_range(), "solves": [r["solves"] for r in rows]}))


def _one_step() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch

    from mpc_rs_tpu.estimators.ukf import ukf_init, ukf_predict, ukf_update
    from mpc_rs_tpu.models import dynamics, noise, observation
    from mpc_rs_tpu.models.params import CartPoleParams
    from mpc_rs_tpu_torch.apps import commu_examples, run
    from mpc_rs_tpu_torch.models.params import CartPoleParams as TorchParams

    torch.set_num_threads(1)
    packets = []
    real = commu_examples.commu_estimator

    def recording(*a, **kw):
        params, state0, step = real(*a, **kw)

        def step_and_record(state, u, z, dt_est, mask):
            packets.append((float(u), [float(v) for v in z], float(dt_est), [float(v) for v in mask]))
            return step(state, u, z, dt_est, mask)

        return params, state0, step_and_record

    commu_examples.commu_estimator = recording
    with tempfile.TemporaryDirectory() as d, contextlib.redirect_stdout(io.StringIO()):
        run.main([*ARGV, "--device", "cpu", "--ukf-dtype", "float32", "--log-dir", d])
    first, second = packets[1:3]  # past the filter step made before traffic, whose result is dropped

    # the JAX app's filter (mpc_rs_tpu/apps/commu_examples.py, mppi4_ukf_commu)
    p, dt = CartPoleParams.two_wheel(), 1.2 / 20
    plant6 = dynamics.make_accel6(p, with_force=False, quirk_denominator=True)
    hx = observation.make_hx_imu6(p)
    r_diag = jnp.asarray([200.0, 200.0, 20.0, 0.5, 0.5], jnp.float32)
    phy = (50.0, 50.0, 10.0)
    params, state0 = ukf_init(jnp.zeros(6, jnp.float32), 10.0 * jnp.eye(6, dtype=jnp.float32),
                              noise.gen_q6(jnp.float32(dt), phy=phy), jnp.diag(r_diag))

    def step(state, u, z, dt_est, enable_mask):
        def fxd(xv, uu):
            out = plant6(*(xv[..., i] for i in range(6)), uu, dt_est, 0.0)
            return jnp.stack(jnp.broadcast_arrays(*out), axis=-1)

        state = state._replace(q=noise.gen_q6(dt_est, phy=phy).astype(state.q.dtype),
                               r=noise.gen_r_mask(r_diag, enable_mask).astype(state.r.dtype))
        state = ukf_predict(params, state, u, fxd)
        return ukf_update(params, state, z, observation.make_masked_hx(hx, enable_mask))

    def jax_args(pkt):
        u, z, dt_est, mask = pkt
        return u, jnp.asarray(z, jnp.float32), jnp.float32(dt_est), jnp.asarray(mask, jnp.float32)

    jit_step = jax.jit(step)
    s1 = jit_step(state0, *jax_args(first))
    jitted = jit_step(s1, *jax_args(second))
    with jax.disable_jit():
        eager = step(s1, *jax_args(second))
    _, t0, t_step = real(TorchParams.two_wheel(), dt, torch.float32)
    t1 = t0._replace(**{f: torch.tensor(np.asarray(getattr(s1, f))) for f in ("x", "p", "q", "r", "sigma_f")})
    u, z, dt_est, mask = second
    ported = t_step(t1, u, torch.tensor(z), dt_est, torch.tensor(mask))
    p1 = np.asarray(s1.p, np.float64)
    print(json.dumps({"packets": [first, second], "p_after_first_cond": float(np.linalg.cond(p1)),
                      "x_after_second": {"jax_jit": [float(v) for v in np.asarray(jitted.x)],
                                         "jax_eager": [float(v) for v in np.asarray(eager.x)],
                                         "port": [float(v) for v in ported.x.numpy()]}}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=["jax", "torch"])
    ap.add_argument("--runs", type=int, default=16)
    ap.add_argument("--one-step", action="store_true")
    ap.add_argument("--child", choices=["jax", "torch"], help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        _child(args.child)
    elif args.one_step:
        _one_step()
    else:
        _runs(args.package, args.runs)


if __name__ == "__main__":
    main()
