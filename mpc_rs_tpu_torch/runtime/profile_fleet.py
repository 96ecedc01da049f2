"""Where the time of one fleet tick goes, on a CUDA card.

    python -m mpc_rs_tpu_torch.runtime.profile_fleet [--scenarios B] [--estimator-chain] [--out FILE]

For each fleet model (cartpole4, flagship6) at its default K and sampler it
builds the fleet (``apps/fleet.build_fleet``; with ``--estimator-chain`` the
tick runs the fused estimator chain, K7), warms up, and measures:

- the tick on the host clock, each tick ended by a device synchronise,
  median, p99 and max over ``TICKS`` ticks, and scenario-ticks/s;
- under ``torch.profiler``, over ``PROF_TICKS`` more ticks: the device µs
  per tick by kernel (the batched MPPI kernel and the estimator chain by
  name, the rest summed as ``torch ops``), the device launches per tick, and
  the device's busy share
  of the profiled ticks' wall time (the union of device intervals over the
  ``record_function`` range).

It prints one JSON line per model, each with the card's name and power
limit from ``nvidia-smi``, and writes the lines to ``--out``. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType

from mpc_rs_tpu_torch.apps.fleet import build_fleet
from mpc_rs_tpu_torch.runtime.profile_tick import _union_us, nvidia_smi_line

TICKS, PROF_TICKS, WARMUP = 100, 20, 10
RANGE = "profiled_fleet_ticks"
KERNELS = ("mppi_partials_kernel", "estimator_chain_kernel")


def _label(name: str) -> str:
    return next((k for k in KERNELS if k in name), "torch ops")


def profile_model(model: str, scenarios: int, estimator_chain: bool = False) -> dict:
    fl = build_fleet(model, None, "cuda", scenarios=scenarios, estimator_chain=estimator_chain)
    carry = fl.carry
    for _ in range(WARMUP):
        carry = fl.tick(carry, fl.generator)
    torch.cuda.synchronize()
    tick_us = []
    for _ in range(TICKS):
        t0 = time.perf_counter()
        carry = fl.tick(carry, fl.generator)
        torch.cuda.synchronize()
        tick_us.append(1e6 * (time.perf_counter() - t0))

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(RANGE):
            for _ in range(PROF_TICKS):
                carry = fl.tick(carry, fl.generator)
            torch.cuda.synchronize()
    events = prof.events()
    span = next(e.time_range for e in events if e.name == RANGE)
    device = [e for e in events if e.device_type == DeviceType.CUDA and e.name != RANGE
              and span.start <= e.time_range.start <= span.end]
    per_tick: dict[str, float] = {}
    for e in device:
        label = _label(e.name)
        per_tick[label] = per_tick.get(label, 0.0) + e.time_range.elapsed_us() / PROF_TICKS
    busy = _union_us((e.time_range.start, min(e.time_range.end, span.end)) for e in device)
    med = statistics.median(tick_us)
    return {
        "model": model, "scenarios": scenarios, "k": fl.cfg.n_rollouts, "sampler": fl.sampler,
        "estimator_chain": estimator_chain,
        "ticks": len(tick_us), "tick_us_median": med, "tick_us_p99": float(np.percentile(tick_us, 99)),
        "tick_us_max": max(tick_us), "scenario_ticks_per_s": scenarios * 1e6 / med,
        "profiled_ticks": PROF_TICKS, "profiled_wall_us_per_tick": span.elapsed_us() / PROF_TICKS,
        "device_us_per_tick": per_tick if device else "not measured (no device events traced)",
        "device_launches_per_tick": len(device) / PROF_TICKS,
        "device_busy_share": busy / span.elapsed_us() if device else None,
        "device_share_of_median_tick": sum(per_tick.values()) / med if device else None,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenarios", type=int, default=1024)
    ap.add_argument("--estimator-chain", action="store_true",
                    help="run the tick's plant, sensor and UKF as the fused estimator chain (K7)")
    ap.add_argument("--out", default="logs/profile_fleet/profile_fleet.jsonl")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_fleet: torch.cuda.is_available() is false; this needs a CUDA card")
    smi = nvidia_smi_line()
    lines = []
    for model in ("cartpole4", "flagship6"):
        row = {**profile_model(model, args.scenarios, args.estimator_chain), "nvidia_smi": smi}
        print(json.dumps(row), flush=True)
        lines.append(json.dumps(row))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
