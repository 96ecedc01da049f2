"""Where the time of one ``mppi4-non-liner`` tick goes, on a CUDA card.

    python -m mpc_rs_tpu_torch.runtime.profile_tick [--out FILE]

For K = 10 240 and the app's 800 000 it runs the app's closed loop (``apps/mppi_examples.closed_loop``
with the app's solver, host plant step and CSV logger; the per-tick print
goes to a buffer) and measures:

- the tick on the host clock (``LoopResult.tick_seconds``: solve, u0 read
  and plant step), median, p99 and max over 200 ticks;
- under ``torch.profiler``, over 50 more ticks: the device µs
  per tick of each kernel and copy, and the device's busy share of the
  profiled loop's wall time (the union of device intervals over the span
  of the loop's ``record_function`` range), and the device µs per tick as a
  share of the untraced median tick;
- the K2 wrapper's host cost: the median µs of one ``mppi_solve_fused``
  call on the host clock, the stream synchronised between calls, over 500
  calls.

It prints one JSON line per K, each with the card's name and power limit
from ``nvidia-smi``, and writes the lines to ``--out``. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType

from mpc_rs_tpu_torch.apps.common import make_mppi_solver
from mpc_rs_tpu_torch.apps.mppi_examples import closed_loop
from mpc_rs_tpu_torch.controllers.mppi import MppiConfig
from mpc_rs_tpu_torch.models import dynamics
from mpc_rs_tpu_torch.models.params import CartPoleParams
from mpc_rs_tpu_torch.ops.mppi_cuda import CartPoleShaped4, mppi_solve_fused
from mpc_rs_tpu_torch.runtime.logger import CsvLogger

N, DT, X0 = 8, 0.1, (0.5, 0.0, 0.1, 0.0)
KS = (10_240, 800_000)
TICKS, PROF_TICKS, WRAPPER_CALLS = 200, 50, 500
LOG_DIR = Path("logs/profile_tick")  # the app's CSV, as the app writes it
RANGE = "profiled_ticks"


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _loop(solve, plant, ticks: int, seed: int):
    with CsvLogger(str(LOG_DIR / "mppi.csv")) as logger, contextlib.redirect_stdout(io.StringIO()):
        return closed_loop(solve, plant, X0, torch.zeros(N, device="cuda"),
                           t_end=(ticks - 0.5) * DT, dt=DT, seed=seed, logger=logger)


def _union_us(intervals) -> float:
    total, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _label(name: str) -> str:
    return "mppi_partials_kernel" if "mppi_partials_kernel" in name else name[:60]


def profile_k(k: int) -> dict:
    p = CartPoleParams.single_wheel()
    cfg = MppiConfig(n_horizon=N, n_rollouts=k, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
    model = CartPoleShaped4(p, DT)
    solve = make_mppi_solver(cfg, model, "cuda")
    plant = dynamics.make_cartpole_nonlinear(p, DT)

    _loop(solve, plant, 10, 1000)  # build and warm up
    res = _loop(solve, plant, TICKS, 0)
    tick_us = [1e6 * s for s in res.tick_seconds]

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(RANGE):
            prof_res = _loop(solve, plant, PROF_TICKS, 0)
        torch.cuda.synchronize()
    events = prof.events()
    span = next(e.time_range for e in events if e.name == RANGE)
    # kernels and copies; the range itself also appears on the device timeline
    device = [e for e in events if e.device_type == DeviceType.CUDA and e.name != RANGE
              and span.start <= e.time_range.start <= span.end]
    n_prof = len(prof_res.statuses)
    per_tick: dict[str, float] = {}
    for e in device:
        label = _label(e.name)
        per_tick[label] = per_tick.get(label, 0.0) + e.time_range.elapsed_us() / n_prof
    busy = _union_us((e.time_range.start, min(e.time_range.end, span.end)) for e in device)

    x = torch.tensor(X0, dtype=torch.float32, device="cuda")
    u_n = torch.zeros(N, device="cuda")
    call_us = []
    for i in range(10 + WRAPPER_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mppi_solve_fused(cfg, model, x, u_n, seed=i)
        t1 = time.perf_counter()
        if i >= 10:
            call_us.append(1e6 * (t1 - t0))
    torch.cuda.synchronize()

    return {
        "k": k, "n": N, "ticks": len(tick_us), "statuses_ok": all(s == 0 for s in res.statuses),
        "tipped": res.tipped or prof_res.tipped,
        "tick_us_median": statistics.median(tick_us), "tick_us_p99": float(np.percentile(tick_us, 99)),
        "tick_us_max": max(tick_us),
        "profiled_ticks": n_prof, "profiled_wall_us_per_tick": span.elapsed_us() / n_prof,
        "device_us_per_tick": per_tick if device else "not measured (no device events traced)",
        "device_busy_share": busy / span.elapsed_us() if device else None,
        # the profiler slows the host loop; this share uses the untraced tick
        "device_share_of_median_tick": (sum(per_tick.values()) / statistics.median(tick_us)
                                        if device else None),
        "wrapper_host_us_median": statistics.median(call_us),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(LOG_DIR / "profile_tick.jsonl"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_tick: torch.cuda.is_available() is false; this needs a CUDA card")
    LOG_DIR.mkdir(parents=True, exist_ok=True)
    smi = nvidia_smi_line()
    lines = []
    for k in KS:
        row = {**profile_k(k), "nvidia_smi": smi}
        print(json.dumps(row), flush=True)
        lines.append(json.dumps(row))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
