"""Where the time of one fleet tick goes, on a CUDA card.

    python mpc_rs_tpu_torch/runtime/profile_fleet.py [--root DIR] [--label NAME] [--scenarios B]
        [--estimator-chain] [--k7-out FILE] [--out FILE]
    python mpc_rs_tpu_torch/runtime/profile_fleet.py --compare-k7 A.pt B.pt

Imports ``mpc_rs_tpu_torch`` from ``--root`` (default: the checkout this
file is in), so that one command on the card can measure two checkouts in
turns (parent, change, change, parent) with this one script; run it as a
file for that (``python -m`` imports the package of the working directory
first). For that checkout it reports the build (``nvcc`` seconds, ptxas's
registers and spills of each estimator chain instantiation, K7), then for
each fleet model (cartpole4, flagship6) at its default K and sampler it
builds the fleet (``apps/fleet.build_fleet``; with ``--estimator-chain``
the tick runs the fused estimator chain, K7), warms up, and measures:

- the tick on the host clock, each tick ended by a device synchronise,
  median, p99 and max over ``TICKS`` ticks, and scenario-ticks/s;
- under ``torch.profiler``, over ``PROF_TICKS`` more ticks: the device µs
  per tick by kernel (the batched MPPI kernel and the estimator chain by
  name, the rest summed as ``torch ops``), the device launches per tick, and
  the device's busy share of the profiled ticks' wall time (the union of
  device intervals over the ``record_function`` range);
- with ``--estimator-chain``, one K7 call at B = ``--scenarios`` on the
  inputs of ``ops/estimator_cuda.chain_inputs``: its device µs by
  ``torch.profiler`` and its µs by CUDA events (the wrapper's host time
  included), median of 50.

A variant of a kernel is measured the same way: ``--root`` at a copy of
the checkout with the one source changed.

``--k7-out`` saves K7's outputs on those inputs at B = 1, 3, 100, 1000 and
1024 for both models, and prints their digest (``k7_digest``, which
``chip_smoke.py`` holds the raw instantiations to); ``--compare-k7``
prints, for two such files, whether each output is the same bits and the
largest difference.

It prints one JSON line per model, each with ``--label`` and the card's name
and power limit from ``nvidia-smi``, and writes the lines to ``--out``.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType

TICKS, PROF_TICKS, WARMUP, K7_CALLS = 100, 20, 10, 50
RANGE = "profiled_fleet_ticks"
KERNELS = ("mppi_partials_kernel", "estimator_chain_kernel")
K7_BATCHES = (1, 3, 100, 1000, 1024)
MODELS = ("cartpole4", "flagship6")
ROOT = Path(__file__).resolve().parents[2]


def _label(name: str) -> str:
    return next((k for k in KERNELS if k in name), "torch ops")


def ptxas_kernel(log: str, kernel: str) -> list[str]:
    """ptxas's register and spill lines of each instantiation of ``kernel``,
    each with the function it reports on."""
    out, func = [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            func = line.split("'")[1] if "'" in line else line.split()[-1]
        elif ("registers" in line or "spill" in line) and kernel in func:
            out.append(f"{func}: {line.strip()}")
    return out


def profile_model(model: str, scenarios: int, chain_inputs=None) -> dict:
    from mpc_rs_tpu_torch.apps.fleet import build_fleet
    from mpc_rs_tpu_torch.runtime.profile_tick import _union_us

    estimator_chain = chain_inputs is not None
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
    row = {
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
    if estimator_chain:
        row.update(k7_call(fl, scenarios, chain_inputs))
    return row


def k7_call(fl, b: int, chain_inputs) -> dict:
    """One K7 call on ``chain_inputs``: device µs by torch.profiler (mean of the
    launches caught) and CUDA-event µs (median), over ``K7_CALLS`` calls."""
    from mpc_rs_tpu_torch.ops import estimator_cuda

    args = chain_inputs(fl.tick.chain, fl.carry.x, fl.carry.ukf.x)
    call = lambda: estimator_cuda.estimator_chain_fused(fl.tick.chain, *args)  # noqa: E731
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(K7_CALLS):
            call()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and "estimator_chain_kernel" in e.name]
    times = []
    for _ in range(K7_CALLS):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        call()
        e1.record()
        e1.synchronize()
        times.append(1e3 * e0.elapsed_time(e1))
    return {"k7_b": b, "k7_device_us": sum(us) / len(us) if us else "not measured (no device events traced)",
            "k7_launches_caught": len(us), "k7_event_us": statistics.median(times)}


def k7_outputs(chain_inputs) -> dict:
    """K7's outputs (x', x̂', P') on ``chain_inputs`` at each of ``K7_BATCHES``
    for both models, on the CPU."""
    from mpc_rs_tpu_torch.apps.fleet import build_fleet
    from mpc_rs_tpu_torch.ops import estimator_cuda

    out = {}
    for model in MODELS:
        for b in K7_BATCHES:
            fl = build_fleet(model, None, "cuda", scenarios=b, estimator_chain=True)
            chain = fl.tick.chain
            got = estimator_cuda.estimator_chain_fused(chain, *chain_inputs(chain, fl.carry.x, fl.carry.ukf.x))
            for name, v in zip(("x", "ukf_x", "p"), got):
                out[f"{model}/B={b}/{name}"] = v.cpu()
    return out


def k7_digest(outputs: dict) -> str:
    """sha256 of ``k7_outputs``' tensors (float32 bytes), in the order of
    ``MODELS``, ``K7_BATCHES`` and (x, ukf_x, p)."""
    h = hashlib.sha256()
    for model in MODELS:
        for b in K7_BATCHES:
            for name in ("x", "ukf_x", "p"):
                h.update(outputs[f"{model}/B={b}/{name}"].cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def own_chain_inputs(root: Path):
    """This checkout's ``ops/estimator_cuda.chain_inputs``, then ``root`` on
    the import path: the K7 inputs stay the same whichever package is
    measured (a parent's may predate the function, which needs only torch).
    The package is dropped from ``sys.modules`` before ``root``'s is
    imported."""
    sys.path.insert(0, str(ROOT))
    from mpc_rs_tpu_torch.ops.estimator_cuda import chain_inputs

    if root != ROOT:
        for name in [m for m in sys.modules if m.split(".")[0] == "mpc_rs_tpu_torch"]:
            del sys.modules[name]
        sys.path.insert(0, str(root))
    return chain_inputs


def compare_k7(a_path: str, b_path: str) -> dict:
    a, b = torch.load(a_path), torch.load(b_path)
    rows = {key: {"same_bits": torch.equal(a[key].view(torch.int32), b[key].view(torch.int32)),
                  "max_abs_diff": float((a[key].double() - b[key].double()).abs().nan_to_num(0.0).max())}
            for key in a}
    return {"compare_k7": [a_path, b_path], "all_same_bits": all(r["same_bits"] for r in rows.values()),
            "outputs": rows}


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--label", default="")
    ap.add_argument("--scenarios", type=int, default=1024)
    ap.add_argument("--estimator-chain", action="store_true",
                    help="run the tick's plant, sensor and UKF as the fused estimator chain (K7)")
    ap.add_argument("--k7-out", help="save K7's outputs on fixed inputs to this file (torch.save)")
    ap.add_argument("--compare-k7", nargs=2, metavar=("A", "B"), help="compare two --k7-out files and exit")
    ap.add_argument("--out", default="logs/profile_fleet/profile_fleet.jsonl")
    args = ap.parse_args(argv)
    if args.compare_k7:
        row = compare_k7(*args.compare_k7)
        print(json.dumps(row), flush=True)
        return [row]
    if not torch.cuda.is_available():
        raise SystemExit("profile_fleet: torch.cuda.is_available() is false; this needs a CUDA card")
    chain_inputs = own_chain_inputs(Path(args.root).resolve())
    from mpc_rs_tpu_torch.ops import build
    from mpc_rs_tpu_torch.runtime.profile_tick import nvidia_smi_line

    head = {"label": args.label, "root": args.root, "nvidia_smi": nvidia_smi_line()}
    lines = []

    def emit(row):
        row = {**head, **row}
        print(json.dumps(row), flush=True)
        lines.append(row)

    t0 = time.perf_counter()
    so, build_s = build.build()
    build.load_library()
    log = so.with_suffix(".log").read_text() if so.with_suffix(".log").is_file() else ""
    emit({"phase": "build", "build_s": build_s, "build_wall_s": time.perf_counter() - t0,
          "package": str(Path(build.__file__).resolve().parents[1]),
          "ptxas_estimator_chain": ptxas_kernel(log, "estimator_chain_kernel")})
    for model in MODELS:
        emit(profile_model(model, args.scenarios, chain_inputs if args.estimator_chain else None))
    if args.k7_out:
        Path(args.k7_out).parent.mkdir(parents=True, exist_ok=True)
        outputs = k7_outputs(chain_inputs)
        torch.save(outputs, args.k7_out)
        emit({"phase": "k7_outputs", "file": args.k7_out, "batches": list(K7_BATCHES),
              "digest": k7_digest(outputs)})
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in lines))
    return lines


if __name__ == "__main__":
    main()
