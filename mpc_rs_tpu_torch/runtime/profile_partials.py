"""The MPPI partials kernel on every solve path, on a CUDA card: device time
by kernel, launches per call, and what the compiler made of it.

    python mpc_rs_tpu_torch/runtime/profile_partials.py [--root DIR] [--label NAME] [--out FILE]

Imports ``mpc_rs_tpu_torch`` from ``--root`` (default: the checkout this
file is in), so that one command on the card can measure two checkouts in
turns (parent, change, change, parent) with this one script; it uses only
wrapper calls that every checkout of the port since its fourth slice has.
For that checkout it measures:

- the build: ``nvcc`` seconds, and ptxas's registers and spill stores of
  each partials instantiation;
- ``cuobjdump -sass`` of the built library, for the partials
  instantiations of the three production solves (cart-pole exact
  box-muller: ``mppi4-non-liner``; cart-pole fast clt4: cartpole4; flagship
  fast clt4a: flagship6; each rollouts-per-thread variant the library has)
  and for the finalize kernels: the static SASS instruction count and the
  SHFL, BAR, MUFU and ATOM/RED counts;
- device µs per call by kernel (``torch.profiler``), the device kernels a
  call launches, and the CUDA-event µs of a call, at the shapes of the
  paths: K2 at K = 800 000 (exact, box-muller: ``mppi4-non-liner``'s
  solve); K1 per solve of a chain of 64 at K = 10 240 and 819 200 (exact
  box-muller and fast clt4a); the fleet's solve at B = 1024 (cartpole4:
  K = 1024 fast clt4; flagship6: K = 8192 fast clt4a) and K6's B = 8,
  K = 65 536 (exact wallace), each also as the rows-only launch
  (``mppi_batch_partials_fused``); where the checkout has the MPPI
  application family's models, K2 at each app's reference K (mppi2: N=40,
  K=8000; mppi4: K=800 000; mppi4-non-liner-s: K=1.5 M, σ=10;
  mppi4-non-liner-ukf: flagship4, K=5e5) and K1 on the HW flagship
  (``bench.py:230-288``: commu4 at N=20, K=800 000, λ=2, σ=2, ±10, the plant
  on, clt4a and wallace), and two shapes that test the R rule past N=8
  (N=20, K=300 000; N=40, K=160 000). Where the checkout's wrappers take
  ``rollouts_per_thread``, each shape is also measured with it forced to 1
  and to 4, in turns with the wrapper's own choice;
- the HW-flagship chain against its 0.06 s budget: µs a solve by device
  time, by CUDA events over a chain of J, and by the host-clock marginal of
  two chain lengths (J = 64 and 320), with the headroom.

Prints one JSON line per measurement, each with ``--label`` and the card's
``nvidia-smi`` name and power limit, and writes them to ``--out``. Needs a
CUDA card. ``--u-out FILE`` also saves every path's outputs (u_n', the
statuses, u0s and x of a chain, the rows of a rows-only call) at each R, and
``--compare-u A B`` (no card needed) says, path by path, whether two such
files hold the same bits: the check that a change left the solves' outputs
as the parent's.
"""

from __future__ import annotations

import argparse
import inspect
import json
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import torch
from torch.autograd import DeviceType

N = 8
X0 = (0.5, 0.0, 0.1, 0.0)
KERNELS = ("mppi_partials_kernel", "mppi_finalize_kernel", "fleet_finalize_kernel")
# mangled partials instantiation: horizon, model (and its tier where it is a
# template), cost, tier, sampler ID, then the rollouts per thread where the
# kernel has that parameter
PARTIALS_RE = re.compile(r"mppi_partials_kernelILi(\d+)ENS_\d+"
                         r"(CartPoleNonlinearT|Flagship4|DoubleIntegrator|CartPoleLinear|Commu4)(?:ILb([01])EE)?ENS_\d+"
                         r"(Shaped4|Diag4|Quad2|Commu4Cost)ELb([01])ELi(\d+)E(?:Li(\d+)E)?")
# tune's sweep: one kernel for every horizon (ops/csrc/sweep.cuh), not a template
SWEEP_RE = re.compile(r"mpc17mppi_sweep_kernelE")
HW_BUDGET_S = 0.06  # the HW flagship's control budget a solve (SURVEY §6)
PRODUCTION = {("CartPoleNonlinearT", False, 1): "cartpole_exact_box-muller (mppi4-non-liner)",
              ("CartPoleNonlinearT", True, 2): "cartpole_fast_clt4 (cartpole4)",
              ("Flagship4", True, 3): "flagship_fast_clt4a (flagship6)"}
SASS_OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)")


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sass_counts(so: Path, cuobjdump: Path, sass: str | None = None) -> list[dict]:
    """Static SASS counts of the production partials instantiations, of the
    sweep's (tune) and of the finalize kernels in library ``so``; ``sass``:
    its ``cuobjdump -sass`` text where the caller has it already."""
    if sass is None:
        sass = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True,
                              timeout=600, check=True).stdout
    rows = []
    for func in sass.split("Function : ")[1:]:
        name = func.split()[0]
        m = PARTIALS_RE.search(name)
        sweep = SWEEP_RE.search(name)
        if m:
            key = (m.group(2), m.group(5) == "1", int(m.group(6)))
            if m.group(1) != str(N) or key not in PRODUCTION:
                continue
            what = PRODUCTION[key] + (f" R={m.group(7)}" if m.group(7) else "")
        elif sweep:
            what = "sweep (tune), every N"
        elif "finalize_kernel" in name:
            what = name
        else:
            continue
        ops = Counter(SASS_OP.findall(func))
        rows.append({"kernel": what, "instructions": sum(ops.values()),
                     "SHFL": sum(c for op, c in ops.items() if op.startswith("SHFL")),
                     "BAR": sum(c for op, c in ops.items() if op.startswith("BAR")),
                     "MUFU": sum(c for op, c in ops.items() if op.startswith("MUFU")),
                     "ATOM": sum(c for op, c in ops.items() if op.startswith(("ATOM", "RED"))),
                     "MEMBAR": sum(c for op, c in ops.items() if op.startswith(("MEMBAR", "FENCE")))})
    return rows


def ptxas_partials(log: str) -> list[str]:
    """ptxas's 'Used N registers' lines of the partials instantiations, each
    with its tag N/model/model tier/cost/tier/sampler ID/R ('-' where the
    mangled name has no such part)."""
    out, func = [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            func = line.split("'")[1] if "'" in line else line
        elif ("registers" in line or "spill" in line) and "mppi_partials_kernel" in func:
            m = PARTIALS_RE.search(func)
            tag = "/".join(g or "-" for g in m.groups()) if m else func[:60]
            out.append(f"{tag}: {line.strip()}")
    return out


def device_us(fn, reps: int) -> tuple[dict, float]:
    """(device µs per call by kernel, kernels launched per call) under
    torch.profiler over ``reps`` calls; retried when no event was caught."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if events:
            break
    per: dict[str, float] = {}
    kernels = 0
    for e in events:
        label = next((k for k in KERNELS if k in e.name), e.name[:40])
        per[label] = per.get(label, 0.0) + e.time_range.elapsed_us() / reps
        kernels += not e.name.startswith(("Memcpy", "Memset"))
    return per, kernels / reps


def event_us(fn, reps: int) -> float:
    """Median CUDA-event µs of one call (host cost of the wrapper included)."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(1e3 * e0.elapsed_time(e1))
    return sorted(times)[len(times) // 2]


def compare_outputs(a: str, b: str) -> dict:
    """{path: True when every tensor of the path is the same bits in both
    ``--u-out`` files}, over the paths both files hold."""
    ua, ub = torch.load(a), torch.load(b)
    return {name: len(ua[name]) == len(ub[name]) and all(torch.equal(x, y) for x, y in zip(ua[name], ub[name]))
            for name in ua if name in ub}


def measure(emit, name, call, per, reps, ev_reps, variants) -> None:
    """Device µs by kernel, kernels a call and CUDA-event µs of ``call``
    at each R variant, in turns (variants, then the same reversed), per
    measured unit (``per`` calls)."""
    for turn, kw in enumerate([*variants, *reversed(variants)]):
        by_kernel, launches = device_us(lambda: call(**kw), reps)
        emit({"phase": "time", "path": name, "rpt": kw.get("rollouts_per_thread", "wrapper"), "turn": turn,
              "device_us": {k: v / per for k, v in by_kernel.items()},
              "device_us_total": sum(by_kernel.values()) / per, "kernels_per_call": launches,
              "event_us": event_us(lambda: call(**kw), ev_reps) / per})


def hw_flagship(mppi_cuda, MppiConfig, CartPoleParams, dev):
    """(model, config, x0) of the HW flagship (bench.py:230-288): two-wheel
    parameters, commu4 + costs.commu4, N=20, K=800 000, λ=2, σ=2, ±10,
    x0 = [0, 0, 0.1, 0]."""
    cfg = MppiConfig(n_horizon=20, n_rollouts=800_000, lambda_=2.0, std_dev=2.0, limit=(-10.0, 10.0))
    return mppi_cuda.Commu4Cost4(CartPoleParams.two_wheel(), 0.05), cfg, torch.tensor((0.0, 0.0, 0.1, 0.0), device=dev)


def family_cases(mppi_cuda, MppiConfig, CartPoleParams, dev, jj) -> dict:
    """The family's K2 at each app's reference shape and the HW-flagship
    K1 chain, where the checkout has the family's models; else {}."""
    if not hasattr(mppi_cuda, "Commu4Cost4"):
        return {}
    sw, tw = CartPoleParams.single_wheel(), CartPoleParams.two_wheel()

    def k2(model, n, k, lam, sd, lim, x0, sampler="box-muller", **kw):
        cfg = MppiConfig(n_horizon=n, n_rollouts=k, lambda_=lam, std_dev=sd, limit=(-lim, lim), **kw)
        x, u = torch.tensor(x0, device=dev), torch.zeros(n, device=dev)
        return lambda **r: mppi_cuda.mppi_solve_fused(cfg, model, x, u, seed=3, sampler=sampler, **r)

    hw, hw_cfg, hw_x = hw_flagship(mppi_cuda, MppiConfig, CartPoleParams, dev)
    out = {
        "K2 mppi2 N=40 K=8000 exact box-muller": (
            k2(mppi_cuda.DoubleIntegratorQuad2(0.05), 40, 8000, 2.5, 1.0, 3.0, (1.0, 0.0), control_inv=2.5), 1, 20, 50),
        "K2 mppi4 K=800000 exact box-muller": (
            k2(mppi_cuda.CartPoleLinearShaped4(sw, 0.1), 8, 800_000, 0.5, 3.0, 20.0, X0), 1, 20, 50),
        "K2 mppi4-non-liner-s K=1500000 sigma=10 exact box-muller": (
            k2(mppi_cuda.CartPoleShaped4(sw, 0.1), 8, 1_500_000, 0.5, 10.0, 10.0, (0.0, 0.0, 0.01, 0.0)), 1, 20, 50),
        "K2 mppi4-non-liner-ukf flagship4 K=500000 exact box-muller": (
            k2(mppi_cuda.Flagship4Diag4(tw, 0.15), 8, 500_000, 1.4, 4.0, 10.0, (0.0, 0.0, 0.05, 0.0)), 1, 20, 50),
    }
    # the R rule past N = 8, where R = 4 holds 2 (N=20) and 1 (N=40) blocks
    # an SM: grids of 293 and 157 blocks at R = 4, under the rule's 528
    out["K2 HW flagship N=20 K=300000 exact clt4a (R rule)"] = (
        k2(hw, 20, 300_000, 2.0, 2.0, 10.0, (0.0, 0.0, 0.1, 0.0), sampler="clt4a"), 1, 20, 50)
    out["K2 mppi2 N=40 K=160000 exact box-muller (R rule)"] = (
        k2(mppi_cuda.DoubleIntegratorQuad2(0.05), 40, 160_000, 2.5, 1.0, 3.0, (1.0, 0.0), control_inv=2.5), 1, 20, 50)
    for s in ("clt4a", "wallace"):
        out[f"K1 HW flagship N=20 K=800000 {s} plant (per solve of {jj})"] = (
            (lambda s=s, **kw: mppi_cuda.mppi_chain_fused(hw_cfg, hw, hw_x, torch.zeros(20, device=dev), n_solves=jj,
                                                          base_seed=1, plant=True, sampler=s, **kw)), jj, 3, 5)
    return out


def hw_budget(emit, mppi_cuda, MppiConfig, CartPoleParams, dev) -> None:
    """µs a solve of the HW-flagship chain (plant on) by the host-clock
    marginal of two chain lengths, J = 64 and 320, three turns each, beside
    the 0.06 s budget; the device and event µs are the K1 rows above."""
    hw, cfg, x = hw_flagship(mppi_cuda, MppiConfig, CartPoleParams, dev)
    for s in ("clt4a", "wallace"):
        def wall(j):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mppi_cuda.mppi_chain_fused(cfg, hw, x, torch.zeros(20, device=dev), n_solves=j, base_seed=1,
                                       plant=True, sampler=s)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        wall(64)
        marg = [(wall(320) - wall(64)) / 256 for _ in range(3)]
        us = sorted(marg)[1] * 1e6
        emit({"phase": "hw_flagship_budget", "sampler": s, "marginal_us_per_solve": us,
              "marginal_us_turns": [m * 1e6 for m in marg], "budget_us": HW_BUDGET_S * 1e6,
              "headroom": HW_BUDGET_S * 1e6 / us})


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default="logs/profile_partials/profile_partials.jsonl")
    ap.add_argument("--u-out", default=None, help="save every path's outputs at each R to this file")
    ap.add_argument("--compare-u", nargs=2, metavar=("A", "B"), help="compare two --u-out files and exit")
    ap.add_argument("--hw-only", action="store_true",
                    help="build, then measure the HW-flagship chain and the family's K2 paths only")
    args = ap.parse_args(argv)
    if args.compare_u:
        same = compare_outputs(*args.compare_u)
        row = {"phase": "compare_outputs", "files": args.compare_u, "paths": len(same),
               "all_same_bits": all(same.values()), "differ": [n for n, ok in same.items() if not ok]}
        print(json.dumps(row), flush=True)
        return [row]
    if not torch.cuda.is_available():
        raise SystemExit("profile_partials: torch.cuda.is_available() is false; this needs a CUDA card")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from mpc_rs_tpu_torch.controllers.mppi import MppiConfig
    from mpc_rs_tpu_torch.models.params import CartPoleParams
    from mpc_rs_tpu_torch.ops import build, mppi_cuda
    from mpc_rs_tpu_torch.ops.mppi_cuda import CartPoleShaped4, Flagship4Diag4

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
          "package": str(Path(mppi_cuda.__file__).resolve()), "ptxas_partials": ptxas_partials(log)})
    for row in sass_counts(so, Path(build.find_nvcc()).parent / "cuobjdump"):
        emit({"phase": "sass", **row})

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    cart = {fast: CartPoleShaped4(CartPoleParams.single_wheel(), 0.1, fast=fast) for fast in (False, True)}
    x, u0 = torch.tensor(X0, device=dev), torch.zeros(N, device=dev)

    def k2cfg(k):
        return MppiConfig(n_horizon=N, n_rollouts=k, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))

    def fleet_case(which, b, k, fast, sampler):
        m = cart[fast] if which == "cartpole4" else Flagship4Diag4(CartPoleParams.two_wheel(), 0.15, fast=fast)
        sd, lam = (10.0, 0.5) if which == "cartpole4" else (4.0, 1.4)
        cfg = MppiConfig(n_horizon=N, n_rollouts=k, lambda_=lam, std_dev=sd, limit=(-10.0, 10.0))
        xs = 0.2 * torch.randn((b, 4), generator=gen, device=dev)
        if which == "cartpole4":
            xs = xs + torch.tensor(X0, device=dev)
        u_ns = 0.5 * torch.randn((b, N), generator=gen, device=dev)
        seeds = torch.randint(0, 2**31 - 1, (b,), generator=gen, device=dev, dtype=torch.int32)
        def call(rows_only=False, **kw):
            fn = mppi_cuda.mppi_batch_partials_fused if rows_only else mppi_cuda.mppi_solve_batch_fused
            return fn(cfg, m, xs, u_ns, seeds=seeds, sampler=sampler, **kw)
        return call

    jj = 64
    family = family_cases(mppi_cuda, MppiConfig, CartPoleParams, dev, jj)
    if args.hw_only:
        for name, (call, per, reps, ev_reps) in family.items():
            measure(emit, name, call, per, reps, ev_reps, ({}, {"rollouts_per_thread": 1}, {"rollouts_per_thread": 4}))
        hw_budget(emit, mppi_cuda, MppiConfig, CartPoleParams, dev)
        return lines
    cases = {  # name: (call, calls per measured unit, reps for the profiler, reps for events)
        "K2 K=800000 exact box-muller": (
            lambda **kw: mppi_cuda.mppi_solve_fused(k2cfg(800_000), cart[False], x, u0, seed=3, **kw), 1, 20, 50),
        **{f"K1 K={k} {'fast' if fast else 'exact'} {s} (per solve of {jj})": (
            (lambda k=k, fast=fast, s=s, **kw: mppi_cuda.mppi_chain_fused(
                k2cfg(k), cart[fast], x, u0, n_solves=jj, base_seed=1, sampler=s, **kw)), jj, 3, 5)
           for k in (10_240, 819_200) for fast, s in ((False, "box-muller"), (True, "clt4a"))},
        "K5 cartpole4 B=1024 K=1024 fast clt4": (fleet_case("cartpole4", 1024, 1024, True, "clt4"), 1, 20, 50),
        "K5 flagship6 B=1024 K=8192 fast clt4a": (fleet_case("flagship6", 1024, 8192, True, "clt4a"), 1, 10, 30),
        "K6 cartpole B=8 K=65536 exact wallace": (fleet_case("cartpole4", 8, 65_536, False, "wallace"), 1, 20, 50),
    }
    cases.update(family)
    # the partials launch without its merge (rows only), at the fleet shapes
    for name in [n for n in cases if n.startswith(("K5", "K6"))]:
        call = cases[name][0]
        cases[name + " rows only"] = ((lambda call=call, **kw: call(rows_only=True, **kw)), *cases[name][1:])
    forcing = "rollouts_per_thread" in inspect.signature(mppi_cuda.mppi_solve_fused).parameters
    variants = ({}, {"rollouts_per_thread": 1}, {"rollouts_per_thread": 4}) if forcing else ({},)
    if args.u_out:
        outs = {}
        for name, (call, *_) in cases.items():
            for kw in variants:
                res = call(**kw)
                res = tuple(res) if isinstance(res, tuple) else (res,)
                outs[f"{name} rpt={kw.get('rollouts_per_thread', 'wrapper')}"] = [t.cpu() for t in res]
        Path(args.u_out).parent.mkdir(parents=True, exist_ok=True)
        torch.save(outs, args.u_out)
        emit({"phase": "outputs", "file": args.u_out, "paths": len(outs)})
    for name, (call, per, reps, ev_reps) in cases.items():
        measure(emit, name, call, per, reps, ev_reps, variants)
    if family:
        hw_budget(emit, mppi_cuda, MppiConfig, CartPoleParams, dev)
    torch.cuda.synchronize()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in lines))
    return lines


if __name__ == "__main__":
    main()
