"""Where the HIL apps' host time goes on a CUDA card: the cost of a read-back
and of a launch on a fresh process and after torch.profiler sessions, the
mpc-ukf-commu solve alone and beside a fake MCU's thread, and the apps
``mpc-ukf-commu`` and ``serve --ticks-per-dispatch 2`` at their acceptance
specs' argv.

    python -m mpc_rs_tpu_torch.runtime.profile_hil [--runs 2] [--out profile_hil.jsonl]

Run it as a process of its own: a torch.profiler session earlier in the
process is one of the things it measures. Prints one JSON line per
measurement, each with the card's ``nvidia-smi`` name and power limit, and
writes them to ``--out``. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import statistics
import subprocess
import time

import numpy as np
import torch


def _smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=2, help="runs of each app")
    ap.add_argument("--out", default=None, help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_hil needs a CUDA card")

    from mpc_rs_tpu_torch.apps import acceptance, commu_examples
    from mpc_rs_tpu_torch.apps import run as cli

    card = {"nvidia_smi": _smi()}
    rows = []

    def emit(row):
        row = {**row, **card}
        rows.append(row)
        print(json.dumps(row), flush=True)

    dev = torch.device("cuda")
    solve, _, _ = commu_examples.mpc_ukf_commu_parts(dev)
    f64 = dict(dtype=torch.float64, device=dev)
    states = np.random.default_rng(0).normal(size=(40, 4)) * [0.05, 0.05, 0.02, 0.05]
    flag = torch.zeros((), dtype=torch.bool, device=dev)
    small = torch.zeros(16, device=dev)

    def host_costs(case):
        """Median µs of a flag's read-back and of a small launch, and the
        median ms of warm-started mpc-ukf-commu solves."""
        readback, launch = [], []
        for _ in range(300):
            flag.logical_not_()
            t0 = time.perf_counter()
            flag.tolist()
            readback.append(time.perf_counter() - t0)
        for _ in range(300):
            t0 = time.perf_counter()
            small.add_(1.0)
            launch.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        solves, u = [], torch.zeros(commu_examples.MPC_COMMU_N, **f64)
        for x in states:
            t0 = time.perf_counter()
            r = solve(torch.tensor(x, **f64), u)
            r.u.cpu()
            solves.append(time.perf_counter() - t0)
            u = r.u
        emit({"case": case, "readback_us": 1e6 * statistics.median(readback),
              "launch_us": 1e6 * statistics.median(launch), "solve_ms_median": 1e3 * statistics.median(solves),
              "solve_ms_p90": 1e3 * float(np.percentile(solves, 90))})

    solve(torch.zeros(4, **f64), torch.zeros(commu_examples.MPC_COMMU_N, **f64))  # captures the graphs
    host_costs("fresh_process")
    mcu = commu_examples.SimMcu(mode="sensor3", seed=0, duration=120, time_scale=0.5).start()
    try:
        host_costs("beside_a_fake_mcu_thread")
    finally:
        mcu.stop()
    for _ in range(2):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.zeros(8, device=dev).sum()
            torch.cuda.synchronize()
        len(prof.events())
    host_costs("after_two_profiler_sessions")

    for run in range(args.runs):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = cli.main(["mpc-ukf-commu", *acceptance.SPECS["mpc-ukf-commu"][1], "--seed", str(run)])
        emit({"app": "mpc-ukf-commu", "run": run, "solves": res.solves, "upright": res.upright,
              "solve_ms_median": 1e3 * statistics.median(res.solve_seconds),
              "solve_ms_p99": 1e3 * float(np.percentile(res.solve_seconds, 99)),
              "est_ms_median": 1e3 * statistics.median(res.est_seconds)})
        with contextlib.redirect_stdout(io.StringIO()):
            summary = cli.main(["serve", *acceptance.SPECS["serve-stream"][1], "--seed", str(run)])
        emit({"app": "serve-stream", "run": run, "ticks_per_s": summary["ticks_per_s"],
              "solve_ms_p50": summary["solve_ms_p50"], "dispatch_ms_p50": summary["dispatch_ms_p50"],
              "upright": sum(th < math.radians(60.0) for th in summary["max_abs_theta"])})
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in rows))


if __name__ == "__main__":
    main()
