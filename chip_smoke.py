#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout (printing ptxas's
registers and spills and the static SASS counts of the production partials
instantiations beside the build seconds, and failing on a spill in a
partials, sweep, horizons, finalize, D1 or estimator chain kernel, or
when a partials instantiation's registers leave ``PARTIALS_PTXAS``), holds
each against its plain
PyTorch version on the card (the fast-math probe also on a misaligned view
and a ragged count, bit for bit against its vector path), counts by
torch.profiler the kernels a solve,
a chain and a fleet tick launch, drives the main paths (the
``mppi4-non-liner`` closed loop through the CLI entry function and the
device-resident chain of the same loop; the scenario fleet through the CLI
entry function, cartpole4 over 10 s and flagship6 over 3 s with the pulse,
at B = 1024, plus short runs of the other samplers and the exact tier; and
both fleets again on the fused estimator chain; the two diagnostic entry
points, the kernel op-mix probe D1 in all eleven modes at K = 819 200 and
the mul-add probe D2 in its three configurations; a D1 chain of J solves
is J launches), replays the AoS UKF's float32 α = 1 fidelity check on the
card, and times kernels
against plain versions with CUDA events, and the partials kernel at R = 1
against the wrapper's R (rollouts a thread) in turns. Each path is driven
with the launch counts set to 0 just before it and read just after.

Every kernel's entry of the kernels line carries its bound: the larger of
the operations over the FP32 peak and the bytes over the HBM rate of an
H100 SXM (NVIDIA's data sheet: 67 TFLOP/s outside the tensor cores,
3.35 TB/s; bf16 operations, D2's elementwise ones, at twice the float32
rate outside the tensor cores, 134 TFLOP/s, by the CUDA C++ Programming
Guide's throughput table for compute capability 9.0: 256 16-bit results a
clock an SM against 128 float32; the data sheet's 989 TFLOP/s bf16 is the
tensor cores', which an elementwise chain cannot use). The
operations are counted on this run's inputs by running the
plain version under a ``TorchFunctionMode`` that adds up the elements of
every floating-point arithmetic result (each +, −, ×, ÷, select, clamp and
transcendental counts one; comparisons and integer ops, such as Philox's,
are not counted), so the bound is a lower one; the bytes are each input
read once and each output written once.

The MPPI application family (mppi2, mppi4, mppi4-non-liner-s,
mppi4-non-liner-ukf) and the HW-flagship chain run on the same kernel built
for each app's model and horizon: each instantiation is held against its
plain version at its app's reference shape with every noise source at R = 1
and 4, its samplers' words at N = 20 and 40 against ``ops/philox.py``; the
four apps run through the CLI entry function at the JAX package's acceptance
settings and pass rules, the HW chain (N = 20, K = 800 000, the plant on,
clt4a and wallace) as a main path; each app's tick at its reference K and
the HW chain's µs a solve against its 0.06 s budget are printed.

The hardware-in-the-loop layer runs against fake MCUs behind PTYs: the
native COBS codec (loaded, never rebuilt in place) against the Python codec
on 1 000 seeded payloads; the cart-pole at every plan-streaming horizon
of serve, N = 9-40, on its one kernel that takes N at run time
(``mppi_horizons_kernel``: single solve and the batch of 8 robots at
K = 8192, box-muller alone, serve's only sampler, at R = 1, and at N = 40
R = 4) against its float64 plain version, with its noise against
``ops/philox.py``'s words, its one register count
(``HORIZONS_REGISTERS``), no spill and its blocks an SM at every N; and,
through the CLI entry, ``uart``, ``mppi4-commu`` (K = 800 000),
``mppi4-ukf-commu`` (K = 800 000, N = 20, the filter in float32 and in
float64) and ``serve`` (8 robots, K = 8192: M = 1 at depth 0 and 2, M = 4
at depth 1, which is N = 40, M = 2 at a 0.05 s tick, N = 16, at depth 1
and 0, and M = 4 at 0.025 s, N = 32), each solve or dispatch one counted
launch.

The gradient-MPC slice (float64 batched torch ops, no kernel of its own)
runs the six ``mpc_examples`` apps on the card at their JAX acceptance
criteria (``op-mpc-x`` a prefix of its ticks) with each app's solve times
and PANOC iterations beside the 0.03 s budget, ``op-mpc-x-calc-nl`` on the
card against the CPU tick by tick, the QP fleet at B = 1024 on both
solvers (timed and profiled), and 200 ``qp-parking`` episodes against a
fresh oracle, written to ``PARITY_DIST_TORCH.json``.

tune's sweep launch (``mppi_sweep_kernel``, one kernel that takes the
horizon at run time, each problem at its own (λ, σ), returning the ESS) is
held against its float64 plain version at tune's default grid (B = 96) at
K = 1 024 and 800 000 and at every horizon N = 1-40, 41, 64 and the largest
(224) at K = 4 096 (both noise sources), with its registers, no spill and
its blocks an SM at N = 1, 8, 20, 40 and 224, and ``tune`` runs through
the CLI entry at its acceptance spec and at the default grid at
K = 800 000 over 100 ticks, one launch a tick, and ``make_sweep(k=800 000,
n_horizon=N)`` over that grid at N = 20 and 40 for 50 ticks, one launch a
tick (their launches timed beside N = 8's and held against the float64
plain version at that shape). ``mpc-ukf-commu`` runs at its
acceptance spec against a fake MCU (at least 100 solves in its 6 s window),
PANOC's CUDA-graph replay is held to the eager solve on the card
(op-mpc-x-calc's and mpc-ukf-commu's QPs), and the acceptance harness runs
the specs of ``tune``, ``mpc-ukf-commu``, ``uart``, ``mppi4-commu``,
``serve-stream`` and ``op-en2`` at seed 0; every acceptance check comes from
``mpc_rs_tpu_torch/apps/acceptance.py``.

The multi-GPU phases hold ``fleet_finalize_kernel`` (one kernel for
N = 8-40) at N = 8, 20 and 40
and at serve's N = 9, 16, 31, 32 and 39 against its plain version and the
merged-in-launch solve, run the K-sharded solve at the family's pairs past
N = 8 (the HW flagship at N = 20, K = 800 000, bit for bit
``mppi_solve_fused`` at NCCL world 1, in the band on two gloo ranks
sharing the card; mppi2 at N = 40; serve's cart-pole at N = 9, 16, 31, 32,
39 and 40, sampling box-muller) and time the HW flagship's solves/s at 1 → W ranks
(``parallel/scaling.py::measure_scaling``) beside its 0.06 s budget. K7 is
also held on flagship6's scaled sensor (``obs_normalize``) at every B and
as a main path at its survival gate, and its raw instantiations' outputs
against the parent's digest.

It prints one JSON line per phase, then the kernels line, the ``nvidia-smi``
name and power limit, and last the line ``{"ok": true, "device": {...}}``.
Any failure raises and exits non-zero; so does a machine without CUDA, or a
directory without the ``mpc_rs_tpu_torch`` package. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import faulthandler
import functools
import io
import json
import math
import re
import statistics
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path

import torch
from torch.overrides import TorchFunctionMode

N = 8
X0 = (0.5, 0.0, 0.1, 0.0)
F32_BAND = dict(rtol=1e-3, atol=2e-4)  # the JAX package's band (tests/test_pallas.py:59)
SOURCE = "mpc_rs_tpu_torch/ops/csrc/mppi_kernels.cu"
FASTMATH_SOURCE = "mpc_rs_tpu_torch/ops/csrc/fastmath.cuh"
COMMON_SOURCE = "mpc_rs_tpu_torch/ops/csrc/mppi_common.cuh"  # the partials kernel, the samplers
SWEEP_SOURCE = "mpc_rs_tpu_torch/ops/csrc/sweep.cuh"  # tune's sweep kernel
ESTIMATOR_SOURCE = "mpc_rs_tpu_torch/ops/csrc/estimator_chain.cuh"
DIAG_SOURCE = "mpc_rs_tpu_torch/ops/csrc/diag_kernels.cuh"  # D1, D2
PALLAS = "mpc_rs_tpu/ops/mppi_pallas.py"
SAMPLER_LINES = {"box-muller": 194, "clt4": 140, "clt2q": 179, "clt4a": 150, "box-muller-a": 208,
                 "wallace": 238}  # _fill_vbuf branches
PEAK_FP32 = 67e12  # FLOP/s, H100 SXM outside the tensor cores (NVIDIA data sheet)
PEAK_HBM = 3.35e12  # bytes/s, H100 SXM HBM3
PEAK_BF16 = 2 * PEAK_FP32  # FLOP/s, H100 SXM bf16 outside the tensor cores (Programming Guide, cc 9.0)
CLT_FAMILY_SPREAD = 0.02  # cltone/cltbig/cltreg launch clt's kernel: their D1 times agree this closely
# ptxas registers of the partials instantiations, by (model, N, fast tier, R):
# one per noise source (external, box-muller, clt4, clt4a, wallace, clt2q,
# box-muller-a), each with no spill; what CUDA 12.8's ptxas made of them on
# the H100 machine (runtime/profile_partials.py's build report): the main
# paths' 56 at N = 8 before D1 shared their body, and the MPPI application
# family's 42 (linear cart-pole at N = 8, commu4 at N = 20, the double
# integrator at N = 40) as they were built first (the linear cart-pole's
# three at R = 4 clt4, clt4a and R = 1 clt2q as they were rebuilt with the
# merge's merged-row output: 58, 57 and 45 registers, from 56, 59 and 44).
# The build must keep them. The cart-pole past N = 8 runs on one kernel,
# mppi_horizons_kernel (HORIZONS_REGISTERS).
PARTIALS_PTXAS = {
    ("CartPoleNonlinearT", 8, 0, 1): (44, 46, 46, 44, 45, 45, 45),
    ("CartPoleNonlinearT", 8, 0, 4): (64, 64, 64, 64, 64, 64, 64),
    ("CartPoleNonlinearT", 8, 1, 1): (46, 45, 45, 45, 45, 45, 45),
    ("CartPoleNonlinearT", 8, 1, 4): (64, 72, 64, 73, 75, 76, 73),
    ("Flagship4", 8, 0, 1): (46, 45, 45, 45, 45, 45, 45),
    ("Flagship4", 8, 0, 4): (64, 64, 64, 64, 64, 64, 64),
    ("Flagship4", 8, 1, 1): (48, 48, 48, 48, 48, 48, 48),
    ("Flagship4", 8, 1, 4): (64, 64, 64, 64, 64, 64, 64),
    ("CartPoleLinear", 8, 0, 1): (47, 48, 45, 48, 48, 45, 48),
    ("CartPoleLinear", 8, 0, 4): (58, 64, 58, 57, 60, 56, 64),
    ("Commu4", 20, 0, 1): (71, 80, 72, 80, 72, 72, 80),
    ("Commu4", 20, 0, 4): (123, 128, 128, 127, 128, 128, 127),
    ("DoubleIntegrator", 40, 0, 1): (127, 135, 134, 141, 130, 134, 167),
    ("DoubleIntegrator", 40, 0, 4): (255, 244, 254, 254, 254, 254, 254),
}
# ptxas registers of mppi_horizons_kernel (ops/csrc/horizons.cu: the
# cart-pole at N = 9-40, one kernel that takes N at run time), with no
# spill, at every N; its launch bounds allow at most 48
HORIZONS_REGISTERS = 48
# flagship6's float32 filter is ill-conditioned in a few x̂ entries at B >= 1 000:
# two float32 evaluations in one order of operations differ past the band
# there (PERF.md §6); at most this many K7 entries may leave it
K7_ILL_MAX = 4


START = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase's line also gets the run's seconds so far."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": round(time.perf_counter() - START, 1)}
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).abs().max())


def check_band(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """|got − want| ≤ atol + rtol·|want| elementwise; returns the max abs error."""
    g, w = got.double().cpu(), want.double().cpu()
    out = (g - w).abs() > F32_BAND["atol"] + F32_BAND["rtol"] * w.abs()
    if bool(out.any()):
        i = int(((g - w).abs() / (F32_BAND["atol"] + F32_BAND["rtol"] * w.abs())).flatten().argmax())
        check(False, f"{what}: {int(out.sum())} of {g.numel()} outside rtol 1e-3 / atol 2e-4, worst "
                     f"got {g.flatten()[i].item()} want {w.flatten()[i].item()}")
    return max_err(g, w)


def check_band_or_own(got: torch.Tensor, want: torch.Tensor, want_f32: torch.Tensor, what: str) -> float:
    """|got − want| within the f32 band, or, where the float32 problem is
    ill-conditioned (a softmax weighing a few rollouts), within twice the
    plain float32 version's own distance from ``want`` (float64), element by
    element; returns the max abs error."""
    g, w, w32 = got.double().cpu(), want.double().cpu(), want_f32.double().cpu()
    tol = torch.maximum(F32_BAND["atol"] + F32_BAND["rtol"] * w.abs(), 2.0 * (w32 - w).abs())
    out = (g - w).abs() > tol
    if bool(out.any()):
        i = int(((g - w).abs() / tol).flatten().argmax())
        check(False, f"{what}: {int(out.sum())} of {g.numel()} outside the f32 band and twice the plain f32 "
                     f"distance, worst got {g.flatten()[i].item()} want {w.flatten()[i].item()} "
                     f"(plain f32 {w32.flatten()[i].item()})")
    return max_err(g, w)


def median_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median device-timeline milliseconds of one call, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


PROFILED = "chip_smoke_profiled_calls"
GAP_S = 2e-3  # host idle time around the profiled calls
PROFILE_TRIES = 8  # profiles taken before a call counts as having caught none of its events


def is_kernel(name: str) -> bool:
    """A device event that is a kernel, not a copy or a fill by the driver."""
    return not name.startswith(("Memcpy", "Memset"))


def device_events(fn, reps: int = 1, keep=None) -> list[tuple[str, float]]:
    """(name, µs) of every device event of ``reps`` calls under
    torch.profiler. The profiler drops some device events, most at the start
    of a session, so one call runs first and only the events that start
    inside the measured range count. The host idles ``GAP_S`` after that
    call, at the start of the range and at its end, so an event whose device
    time the profiler places up to ``GAP_S`` off the host clock still falls
    on the right side of the range's ends. ``keep`` (a test of an event's
    name; default every event) picks the events returned, and a profile that
    caught none of them is taken again, up to ``PROFILE_TRIES`` times: the
    profiler can catch a call's copies and drop its kernel."""
    events = []
    for _ in range(PROFILE_TRIES):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            time.sleep(GAP_S)
            with torch.profiler.record_function(PROFILED):
                time.sleep(GAP_S)
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                time.sleep(GAP_S)
        span = next(e.time_range for e in prof.events() if e.name == PROFILED)
        events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA and e.name != PROFILED
                  and span.start <= e.time_range.start <= span.end and (keep is None or keep(e.name))]
        if events:
            break
    return events


def check_kernels_per_call(fn, want: int, what: str, kernel: str = "mppi_partials_kernel") -> int:
    """Fail unless a call of ``fn`` launches ``want`` kernels, each
    ``kernel`` (default the partials kernel). A profile that caught fewer
    (the profiler drops events) is taken again, up to five times; one
    kernel too many, or another kernel, fails at once."""
    names = []
    for _ in range(5):
        names = [n for n, _ in device_events(fn, keep=is_kernel)]
        check(len(names) <= want and all(kernel in n for n in names),
              f"{what}: kernels launched {names}, want {want} {kernel} launches")
        if len(names) == want:
            return want
    check(False, f"{what}: the profiler caught {len(names)} of the {want} kernels in five profiles")
    return 0


def device_ms(fn, reps: int = 20, kernels: int = 1) -> float:
    """Device milliseconds of one call of ``kernels`` kernels: the mean
    duration of the kernels torch.profiler caught over ``reps`` calls, times
    ``kernels`` (the wrapper's host cost is not in it). The profiler drops
    some device events, so the mean over the caught kernels is taken, not
    the sum over ``reps``."""
    fn()
    torch.cuda.synchronize()
    us = [t for _, t in device_events(fn, reps, keep=is_kernel)]
    check(bool(us), f"torch.profiler caught no kernel of the call in {PROFILE_TRIES} profiles")
    return kernels * sum(us) / len(us) / 1e3


class _FlopCount(TorchFunctionMode):
    """Adds up the elements of every floating-point arithmetic result (and
    the input elements of every reduction) computed under it."""

    ELEMENTWISE = {"add", "sub", "mul", "div", "__radd__", "__rsub__", "__rmul__", "__rdiv__",
                   "__rtruediv__", "neg", "pow", "square", "sqrt", "rsqrt", "reciprocal", "sin", "cos",
                   "exp", "log", "abs", "sign", "clamp", "maximum", "minimum", "where"}
    REDUCTIONS = {"sum", "amax", "amin", "mean"}

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = getattr(func, "__name__", "")
        if isinstance(out, torch.Tensor) and out.is_floating_point():
            if name in self.ELEMENTWISE:
                self.flops += out.numel()
            elif name in self.REDUCTIONS and isinstance(args[0], torch.Tensor):
                self.flops += args[0].numel()
        return out


def flops_of(fn) -> int:
    """The floating-point operations of one call of the plain version ``fn``."""
    with _FlopCount() as count:
        fn()
    return count.flops


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flops: float, n_bytes: float, peak: float = PEAK_FP32) -> dict:
    """The least time of the work on an H100 SXM, and what sets it; ``peak``
    is the FLOP/s of the operations' type. ``no_fma_ms``: the operations at
    half the peak, one instruction each, the ceiling of a build with
    ``-fmad=false`` (``ops/build.py``)."""
    t_ops, t_bytes = flops / peak, n_bytes / PEAK_HBM
    return {"bound_ms": 1e3 * max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "no_fma_ms": 2e3 * t_ops, "flops": flops, "bytes": n_bytes}


def r_turns(call, per: int) -> dict:
    """The wrapper's R against R = 1, in turns (wrapper, 1, 1, wrapper): the
    device µs by torch.profiler and the CUDA-event µs of a call, each over
    ``per`` solves."""
    out = {"wrapper": {"device_us": [], "event_us": []}, "1": {"device_us": [], "event_us": []}}
    for label in ("wrapper", "1", "1", "wrapper"):
        kw = {} if label == "wrapper" else {"rollouts_per_thread": 1}
        out[label]["device_us"].append(1e3 * device_ms(lambda: call(**kw), reps=5, kernels=per) / per)
        out[label]["event_us"].append(1e3 * median_ms(lambda: call(**kw), reps=10, warmup=1) / per)
    return out


@functools.cache
def library_sass_job(so: Path) -> Future:
    """``cuobjdump -sass`` of the built library, started once a run on a
    thread of its own: its ~280 kernels take it over a minute of one host
    core, which the phases after the build do not need."""
    from mpc_rs_tpu_torch.ops import build

    return ThreadPoolExecutor(max_workers=1).submit(
        subprocess.run, [str(Path(build.find_nvcc()).parent / "cuobjdump"), "-sass", str(so)],
        capture_output=True, text=True, timeout=600, check=True)


def library_sass(so: Path) -> str:
    return library_sass_job(so).result().stdout


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def fleet_phases(dev: torch.device, card: dict) -> list[dict]:
    """The scenario fleet's kernels and main path: the fast-math device
    functions, the batched kernel with external noise and with each
    in-kernel sampler, the per-scenario failure probes, the fleet CLI runs,
    and the timings. Returns the kernels line's entries."""
    from mpc_rs_tpu_torch.apps import run as cli
    from mpc_rs_tpu_torch.controllers.mppi import MppiConfig, MppiStatus
    from mpc_rs_tpu_torch.models.params import CartPoleParams
    from mpc_rs_tpu_torch.ops import fastmath, mppi_cuda, philox
    from mpc_rs_tpu_torch.ops.mppi_cuda import CartPoleShaped4, Flagship4Diag4

    def model(which, fast=True):
        if which == "cartpole4":
            return CartPoleShaped4(CartPoleParams.single_wheel(), 0.1, fast=fast)
        return Flagship4Diag4(CartPoleParams.two_wheel(), 0.15, fast=fast)

    def fcfg(which, k, lam):
        sd = 10.0 if which == "cartpole4" else 4.0
        return MppiConfig(n_horizon=N, n_rollouts=k, lambda_=lam, std_dev=sd, limit=(-10.0, 10.0))

    app_lambda = {"cartpole4": 0.5, "flagship6": 1.4}
    # where each model's f32 solve is well conditioned (the plain f32
    # version is then within a tenth of the band of float64; PERF.md)
    band_lambda = {"cartpole4": 20.0, "flagship6": 50.0}
    gen = torch.Generator(device=dev).manual_seed(99)

    def inputs(b, which):
        xs = 0.2 * torch.randn((b, 4), generator=gen, device=dev)
        if which == "cartpole4":
            xs = xs + torch.tensor(X0, device=dev)
        return xs, 0.5 * torch.randn((b, N), generator=gen, device=dev)

    def plain_solve(cfg, m, xs, u_ns, noise, dtype):
        parts = mppi_cuda.mppi_batch_partials_plain(cfg, m, xs.to(dtype), u_ns.to(dtype), noise.to(dtype))
        return mppi_cuda.finalize_batch_plain(cfg, parts)

    # F1. the fast-math device functions over 2**20 points against the plain
    # versions on the card, with the bounds of tests/test_fastmath.py
    n_pts = 1 << 20
    ranges = {"fsin": (-100, 100), "fcos": (-100, 100), "flog": (1e-7, 100)}
    exact = {"fsin": torch.sin, "fcos": torch.cos, "flog": torch.log, "frsqrt": torch.rsqrt,
             "fsqrt": torch.sqrt, "freciprocal": torch.reciprocal}
    fm_err = 0.0
    bits = lambda t: t.view(torch.int32)  # noqa: E731
    for fn in mppi_cuda.FASTMATH_FNS:
        lo, hi = ranges.get(fn, (1e-3, 1e4))
        a = lo + (hi - lo) * torch.rand(n_pts, generator=gen, device=dev)
        b = 0.5 + 1.5 * torch.rand(n_pts, generator=gen, device=dev) if fn == "fdiv" else None
        raw = mppi_cuda.fastmath_eval(fn, a, b)  # 16-byte aligned, 2**20 points: the vector instantiation
        # a view 4 bytes off (the scalar instantiation over every point) and an
        # aligned copy of 2**20 − 1 points (vectors, then a scalar tail of 3)
        # give the same bits on the same points
        b_tail = None if b is None else b[1:]
        check(a[1:].data_ptr() % 16 != 0, "the misaligned view is 16-byte aligned")
        off = mppi_cuda.fastmath_eval(fn, a[1:], b_tail)
        tail = mppi_cuda.fastmath_eval(fn, a[1:].clone(), None if b is None else b_tail.clone())
        check(torch.equal(bits(off), bits(raw[1:])) and torch.equal(bits(tail), bits(raw[1:])),
              f"{fn}: the scalar instantiation or the tail differs from the vector path")
        got = raw.double()
        plain = (getattr(fastmath, fn)(a) if b is None else fastmath.fdiv(a, b)).double()
        ref = (exact[fn](a.double()) if b is None else a.double() / b.double())
        abs_err, rel_err = float((got - plain).abs().max()), float(((got - ref) / ref).abs().max())
        if fn in ("fsin", "fcos"):
            check(float((got - ref).abs().max()) < 1e-5 and abs_err < 1e-6, f"{fn}: {abs_err}")
        elif fn == "flog":
            check(float((got - ref).abs().max()) < 2e-6 and abs_err < 1e-6, f"{fn}: {abs_err}")
        elif fn in ("frsqrt", "fsqrt"):
            check(rel_err < 1e-6, f"{fn}: relative error {rel_err}")
        else:
            check(rel_err < 3e-5, f"{fn}: relative error {rel_err} (rcp budget 3e-5)")
        if fn in ("fsin", "fcos", "flog"):
            fm_err = max(fm_err, abs_err)
        emit({"phase": "fastmath", "fn": fn, "points": n_pts, "max_abs_err_vs_plain": abs_err,
              "max_rel_err_vs_exact": rel_err, "misaligned_and_tail_same_bits": True})

    # F2. the batched kernel with external noise against the plain version in
    # float64, at the fleets' shapes and a multi-block one. The band holds at
    # band_lambda; at the apps' λ the f32 problem itself is ill-conditioned
    # (1.2 s of an unstable pendulum amplifies a rollout's last bit about a
    # thousandfold: the plain f32 version misses float64 by ~1e-3), so there
    # the kernel is held to twice the plain f32 version's distance.
    batch_err = 0.0
    for which, b, k, fast in (("cartpole4", 1024, 1024, True), ("flagship6", 1024, 8192, True),
                              ("cartpole4", 8, 65_536, False)):
        m = model(which, fast)
        for lam in (band_lambda[which], app_lambda[which]):
            cfg = fcfg(which, k, lam)
            xs, u_ns = inputs(b, which)
            noise = cfg.std_dev * torch.randn((b, k, N), generator=gen, device=dev)
            got_u, got_st = mppi_cuda.mppi_solve_batch_fused(cfg, m, xs, u_ns, noise=noise)
            want_u, want_st = plain_solve(cfg, m, xs, u_ns, noise, torch.float64)
            check(bool((got_st == 0).all()) and bool((want_st == 0).all()), f"batch {which} K={k} statuses")
            row = {"phase": "batch_external_noise", "model": which, "b": b, "k": k, "fast": fast, "lambda": lam}
            if lam == band_lambda[which]:
                row["max_abs_err"] = check_band(got_u, want_u, f"batch {which} B={b} K={k}")
                batch_err = max(batch_err, row["max_abs_err"])
            else:
                f32_u, _ = plain_solve(cfg, m, xs, u_ns, noise, torch.float32)
                row["max_abs_err"] = max_err(got_u, want_u)
                row["plain_f32_max_abs_err"] = max_err(f32_u, want_u)
                check(row["max_abs_err"] <= 2.0 * row["plain_f32_max_abs_err"] + 2e-4,
                      f"batch {which} at λ={lam}: {row}")
            emit(row)
            del noise

    # F3. in-kernel sampling: the kernel's noise (written through noise_out)
    # against ops/philox.py's words on the card, the solve against the
    # plain version fed that noise, and the noise's moments
    sampler_err = {}
    b, k = 1024, 1024
    for sampler in philox.SAMPLERS:
        for fast in (True, False):
            m, cfg = model("cartpole4", fast), fcfg("cartpole4", k, 20.0)
            xs, u_ns = inputs(b, "cartpole4")
            seeds = torch.randint(-2**31, 2**31 - 1, (b,), generator=gen, device=dev, dtype=torch.int32)
            out, out_r1 = torch.empty((b, k, N), device=dev), torch.empty((b, k, N), device=dev)
            got_u, got_st = mppi_cuda.mppi_solve_batch_fused(cfg, m, xs, u_ns, seeds=seeds, sampler=sampler,
                                                             noise_out=out)
            parts = mppi_cuda.mppi_batch_partials_fused(cfg, m, xs, u_ns, seeds=seeds, sampler=sampler,
                                                        noise_out=out_r1, rollouts_per_thread=1)
            # R = 4 draws every rollout's noise as R = 1 does, and the rows-only
            # launch merged by finalize_batch_fused gives the same solve at R = 1
            check(torch.equal(out, out_r1), f"{sampler} fast={fast}: noise at R=4 differs from R=1")
            fin_u, fin_st = mppi_cuda.finalize_batch_fused(cfg, parts)
            check(bool((fin_st == got_st).all()), f"{sampler} fast={fast}: R=1 rows + finalize statuses")
            check_band(fin_u, got_u, f"{sampler} fast={fast}: R=1 rows + finalize vs the merged R=4 solve")
            words = mppi_cuda.batch_noise(cfg, m, seeds, sampler)
            noise_err = max_err(out, words)
            if sampler in ("clt4", "clt2q", "clt4a"):  # integer ops and a polynomial: the same bits
                check(torch.equal(out, words), f"{sampler}: kernel noise differs from the plain words")
            else:
                check(noise_err < 1e-4, f"{sampler} fast={fast}: kernel noise vs plain {noise_err}")
            want_u, want_st = plain_solve(cfg, m, xs, u_ns, out, torch.float64)
            check(bool((got_st == 0).all()) and bool((want_st == 0).all()), f"{sampler} statuses")
            err = check_band(got_u, want_u, f"{sampler} fast={fast} solve vs plain")
            sampler_err[sampler] = max(sampler_err.get(sampler, 0.0), err, noise_err)
            z = (out / cfg.std_dev).double().flatten()
            mean, var = float(z.mean()), float(z.var())
            kurt = float(((z - z.mean()) ** 4).mean() / z.var() ** 2)
            check(abs(mean) < 5e-3 and abs(var - 1.0) < 5e-3 and abs(kurt - 3.0) < 0.02,
                  f"{sampler} moments: mean {mean} var {var} kurtosis {kurt}")
            row = {"phase": "batch_sampler", "sampler": sampler, "fast": fast, "b": b, "k": k,
                   "rollouts_per_thread": mppi_cuda.rollouts_per_thread(k, b), "noise_r4_equals_r1": True,
                   "noise_max_abs_err": noise_err, "max_abs_err": err, "mean": mean, "var": var, "kurtosis": kurt}
            if sampler in ("clt4a", "box-muller-a"):
                row["pair_sum_max_abs"] = float((out[:, 0::2] + out[:, 1::2]).abs().max())
                check(row["pair_sum_max_abs"] == 0.0, f"{sampler}: a pair's noise does not sum to exactly 0")
            emit(row)
            del out, out_r1, words
    check(bool((mppi_cuda.merge_tickets(dev, b) == 0).all()), "fleet tickets not zero after the sampler phase")

    # F4. failure probes, per scenario
    seeds = torch.arange(8, dtype=torch.int32, device=dev)
    xs = torch.tensor([X0] * 8, device=dev)
    xs[3, 0] = float("nan")
    u, st = mppi_cuda.mppi_solve_batch_fused(fcfg("cartpole4", 1024, 0.5), model("cartpole4"), xs,
                                             torch.zeros(8, N, device=dev), seeds=seeds, sampler="clt4")
    check(st.tolist() == [0, 0, 0, MppiStatus.NO_FINITE, 0, 0, 0, 0], f"NaN x0 probe: statuses {st.tolist()}")
    check(bool((u[3] == 0).all()) and bool(torch.isfinite(u).all()), "NaN x0 probe: zeros there, finite elsewhere")
    emit({"phase": "batch_failure_probe", "probe": "nan_x0_in_scenario_3", "statuses": st.tolist()})
    u, st = mppi_cuda.mppi_solve_batch_fused(fcfg("flagship6", 8192, 0.0), model("flagship6"),
                                             torch.zeros(8, 4, device=dev), torch.zeros(8, N, device=dev),
                                             seeds=seeds, sampler="clt4a")
    check(bool((st == MppiStatus.INVALID_U).all()) and bool((u == 0).all()), f"λ=0 probe: {st.tolist()}")
    emit({"phase": "batch_failure_probe", "probe": "lambda_0", "statuses": sorted(set(st.tolist()))})

    # a tick's MPPI is one launch (torch.profiler): the tick's MPPI call at
    # its fleet's shape launches one partials kernel, and three ticks of the
    # estimator chain's fleet (the same MPPI call, 7-9 device events a tick)
    # launch no finalize kernel and at most three partials kernels (the
    # profiler drops some device events, so it may catch fewer). This runs
    # before F5: after the torch-op fleet runs (some 10^6 small launches) a
    # profile of one call has caught no event at all. The torch-op tick
    # (~8 000 device events) is not profiled: after a profile that large the
    # profiler caught no event of the next calls.
    from mpc_rs_tpu_torch.apps.fleet import build_fleet
    for which in ("cartpole4", "flagship6"):
        fl = build_fleet(which, None, dev, scenarios=1024, estimator_chain=True)
        xs, u_ns = inputs(1024, which)
        seeds = torch.arange(1024, dtype=torch.int32, device=dev)
        call = lambda: mppi_cuda.mppi_solve_batch_fused(fl.cfg, model(which, True), xs, u_ns,  # noqa: E731
                                                        seeds=seeds, sampler=fl.sampler)
        per_call = check_kernels_per_call(call, 1, f"{which}: the tick's MPPI call")
        carry = fl.tick(fl.carry, fl.generator)
        names = [n for n, _ in device_events(lambda: fl.tick(carry, fl.generator), reps=3)]
        mppi = [n for n in names if "mppi_partials_kernel" in n or "finalize" in n]
        check(not any("finalize" in n for n in mppi) and 1 <= len(mppi) <= 3,
              f"{which}: three chain ticks' MPPI kernels {mppi} among {len(names)} events")
        emit({"phase": "fleet_tick_mppi_launches", "model": which, "mppi_call_kernels": per_call,
              "chain_ticks_profiled": 3, "mppi_kernels_caught": len(mppi), "device_events_caught": len(names)})

    # F5. the main path: the fleet through the CLI entry function
    runs = (
        (["--model", "cartpole4", "--t-end", "10"], 0.99),
        (["--model", "flagship6", "--t-end", "3"], 0.95),
        (["--model", "cartpole4", "--t-end", "2", "--no-fast-math"], 0.99),  # exact tier, wallace
        (["--model", "flagship6", "--t-end", "1.5", "--sampler", "box-muller"], 0.95),
        (["--model", "cartpole4", "--t-end", "1", "--sampler", "clt2q"], 0.99),
        (["--model", "flagship6", "--t-end", "1", "--sampler", "box-muller-a"], 0.95),
    )
    mppi_cuda.reset_launches()
    ticks = 0
    for extra, min_survival in runs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cli.main(["fleet", "--scenarios", "1024", *extra])
        run_s = time.perf_counter() - t0
        ticks += res.ticks
        tick_ms = [1e3 * t for t in res.tick_seconds]
        check(res.survival >= min_survival, f"fleet {extra}: survival {res.survival} < {min_survival}")
        check(res.statuses_ok, f"fleet {extra}: a status was not 0")
        check(bool(torch.isfinite(res.carry.x).all()) and bool(torch.isfinite(res.carry.ukf.x).all()),
              f"fleet {extra}: non-finite states")
        emit({"phase": "fleet_main_path", "args": extra, "scenarios": res.scenarios,
              "survived": res.scenarios - res.tipped, "ticks": res.ticks, "survival": res.survival,
              "statuses_ok": res.statuses_ok, "median_max_theta": res.median_max_theta,
              "tick_ms_median": statistics.median(tick_ms), "tick_ms_p99": sorted(tick_ms)[int(0.99 * len(tick_ms))],
              "scenario_ticks_per_s": res.scenario_ticks_per_s, "run_s": run_s, **card})
    counts = dict(mppi_cuda.launches)
    check(counts["mppi_solve_batch_fused"] >= ticks and counts["finalize_batch_fused"] == 0,
          f"merged batched launches {counts}: want >= ticks {ticks}, and no finalize launch")
    for key in ("fast_tier", *(f"sampler:{s_}" for s_ in philox.SAMPLERS)):
        check(counts[key] >= 1, f"{key} was not launched on the fleet's main path")
    emit({"phase": "fleet_main_path_launches", "ticks": ticks, "launches": counts})

    # F6. timings by CUDA events, kernel and plain in turns, on one card
    timing = {}
    for label, which, b, k, fast, sampler in (
        ("cartpole4", "cartpole4", 1024, 1024, True, "clt4"),
        ("flagship6", "flagship6", 1024, 8192, True, "clt4a"),
        ("flagship6_exact", "flagship6", 1024, 8192, False, "wallace"),
        ("multi_block", "cartpole4", 8, 65_536, False, "wallace"),
        *(("cartpole4:" + s_, "cartpole4", 1024, 1024, True, s_) for s_ in philox.SAMPLERS),
    ):
        m, cfg = model(which, fast), fcfg(which, k, app_lambda[which])
        xs, u_ns = inputs(b, which)
        seeds = torch.randint(0, 2**31 - 1, (b,), generator=gen, device=dev, dtype=torch.int32)
        kern = median_ms(lambda: mppi_cuda.mppi_solve_batch_fused(cfg, m, xs, u_ns, seeds=seeds,
                                                                  sampler=sampler), reps=50)
        # the merge's cost inside the launch: the merged call less the rows-only call
        parts_dev = device_ms(lambda: mppi_cuda.mppi_batch_partials_fused(cfg, m, xs, u_ns, seeds=seeds,
                                                                          sampler=sampler))
        solve_dev = device_ms(lambda: mppi_cuda.mppi_solve_batch_fused(cfg, m, xs, u_ns, seeds=seeds,
                                                                       sampler=sampler))
        plain = lambda: plain_solve(cfg, m, xs, u_ns, mppi_cuda.batch_noise(cfg, m, seeds, sampler),  # noqa: E731
                                    torch.float32)
        plain_t = median_ms(plain, reps=5, warmup=1)
        kern2 = median_ms(lambda: mppi_cuda.mppi_solve_batch_fused(cfg, m, xs, u_ns, seeds=seeds,
                                                                   sampler=sampler), reps=50)
        # in: xs, u_ns, seeds; out: u_n' (B, N), status (B,)
        timing[label] = (min(kern, kern2), plain_t,
                         bound(flops_of(plain), nbytes(xs, u_ns, seeds, u_ns, seeds)))
        row = {"phase": "timing_batch", "shape": label, "b": b, "k": k, "fast": fast, "sampler": sampler,
               "rollouts_per_thread": mppi_cuda.rollouts_per_thread(k, b),
               "kernel_us_per_solve": [1e3 * kern, 1e3 * kern2], "device_us_solve": 1e3 * solve_dev,
               "device_us_rows_only": 1e3 * parts_dev, "device_us_merge": 1e3 * (solve_dev - parts_dev),
               "plain_us_per_solve": 1e3 * plain_t, **timing[label][2], **card}
        if label in ("cartpole4", "flagship6", "flagship6_exact", "multi_block"):
            row["r_turns"] = r_turns(lambda **kw: mppi_cuda.mppi_solve_batch_fused(
                cfg, m, xs, u_ns, seeds=seeds, sampler=sampler, **kw), 1)
        emit(row)
    a = 200.0 * torch.rand(n_pts, generator=gen, device=dev) - 100.0
    fm_kern = median_ms(lambda: mppi_cuda.fastmath_eval("fsin", a), reps=50)
    fm_plain = median_ms(lambda: fastmath.fsin(a), reps=20)
    fm_library = median_ms(lambda: torch.sin(a), reps=50)
    # the event window above holds each wrapper's host time too (ctypes and
    # torch.empty, or PyTorch's dispatch); the kernels' own device time:
    fm_dev = device_ms(lambda: mppi_cuda.fastmath_eval("fsin", a))
    fm_library_dev = device_ms(lambda: torch.sin(a))
    fm_bound = bound(flops_of(lambda: fastmath.fsin(a)), 2 * nbytes(a))
    emit({"phase": "timing_fastmath", "fn": "fsin", "points": n_pts, "kernel_us": 1e3 * fm_kern,
          "kernel_device_us": 1e3 * fm_dev, "plain_us": 1e3 * fm_plain, "library_us_torch_sin": 1e3 * fm_library,
          "library_device_us_torch_sin": 1e3 * fm_library_dev,
          "probe_launches_on_the_fleet_main_path": counts["fastmath_eval"], **fm_bound, **card})

    def timed(label):
        kern, plain_t, bnd = timing[label]
        return {"ms": kern, "plain_ms": plain_t, "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"],
                "library_ms": None}

    fleet_launches = counts["mppi_solve_batch_fused"]
    return [
        {"name": "mppi_partials_kernel, merged in the launch (K5, mppi_solve_batch_fused)", "route": "cuda",
         "source": COMMON_SOURCE, "replaces": f"{PALLAS}:692", "launches": fleet_launches,
         "max_abs_err": batch_err, **timed("flagship6")},
        {"name": "mppi_partials_kernel, merged in the launch, multi-block K (K6)", "route": "cuda",
         "source": COMMON_SOURCE, "replaces": f"{PALLAS}:739", "launches": fleet_launches,
         "max_abs_err": batch_err, **timed("multi_block")},
        *({"name": f"mppi_partials_kernel sampler={s_} (K3, _fill_vbuf)", "route": "cuda",
           "source": COMMON_SOURCE, "replaces": f"{PALLAS}:{SAMPLER_LINES[s_]}",
           "launches": counts[f"sampler:{s_}"], "max_abs_err": sampler_err[s_], **timed("cartpole4:" + s_)}
          for s_ in philox.SAMPLERS),
        {"name": "fastmath.cuh fsin/fcos/flog/frsqrt/fsqrt/freciprocal/fdiv (K4: inlined in the fast-tier partials "
                 "launches counted here; probe fsin over 2**20 points, device time)", "route": "cuda",
         "source": FASTMATH_SOURCE, "replaces": "mpc_rs_tpu/ops/fastmath.py:64",
         "launches": counts["fast_tier"], "max_abs_err": fm_err, "ms": fm_dev, "plain_ms": fm_plain,
         "bound_ms": fm_bound["bound_ms"], "bound_by": fm_bound["bound_by"], "library_ms": fm_library_dev},
    ]


# the raw K7 instantiations' outputs on runtime/profile_fleet.py's inputs
# (``k7_digest``): the parent's bits, which adding the scaled sensor's
# instantiation must keep (its ``--k7-out`` digest on the H100 machine)
K7_RAW_DIGEST = "e5148abfc940cc91609dc12a315ac4c84e1bea859a805d9e4a3212ec09ec01ae"
K7_VARIANTS = (("cartpole4", False), ("flagship6", False), ("flagship6", True))  # (model, obs_normalize)


def k7_label(model: str, norm: bool) -> str:
    return f"{model}-obs-normalize" if norm else model


def estimator_phases(dev: torch.device, card: dict) -> list[dict]:
    """The fused estimator chain (K7): each fleet model's kernel, and
    flagship6's on the scaled sensor (``obs_normalize``), against its plain
    version at B = 1024, 1000, 100, 3 and 1 (at 3 and 1 a group of a
    half-filled warp has no scenario) with a NaN estimate in scenario
    min(5, B − 1); the raw instantiations' outputs against the digest of
    the parent's (``K7_RAW_DIGEST``); the timings; then both fleets on the
    chain as a main path, and flagship6 on the normalised chain. Returns the
    kernels line's entries."""
    from mpc_rs_tpu_torch.apps.fleet import build_fleet, run_fleet
    from mpc_rs_tpu_torch.ops import estimator_cuda, mppi_cuda
    from mpc_rs_tpu_torch.runtime.profile_fleet import k7_digest

    # E1. the kernel against the plain version: in float32 within the band
    # (flagship6 at B >= 1 000: all but at most K7_ILL_MAX entries, listed
    # with the plain version's float32 value on the CPU and the float64
    # value), and in float64 within twice the plain float32 version's own
    # distance + 2e-4; on the scaled sensor, twice the larger of that
    # distance on the card and on the CPU (there the JAX package's float32
    # chain and the plain one both sit 4.2e-4 from float64 in x̂[:, 5] at
    # B = 3, and the card's plain version 0.9e-4)
    err, timing, raw = {}, {}, {}
    for model, norm in K7_VARIANTS:
        label = k7_label(model, norm)
        for b in (1024, 1000, 100, 3, 1):
            nan_b = min(5, b - 1)
            fl = build_fleet(model, None, dev, scenarios=b, estimator_chain=True, obs_normalize=norm)
            chain = fl.tick.chain
            args = estimator_cuda.chain_inputs(chain, fl.carry.x, fl.carry.ukf.x)
            got = estimator_cuda.estimator_chain_fused(chain, *args)
            if not norm:
                raw.update({f"{model}/B={b}/{name}": v.cpu() for name, v in zip(("x", "ukf_x", "p"), got)})
            want = estimator_cuda.estimator_chain_plain(chain, *args)
            f64 = estimator_cuda.estimator_chain_plain(chain, *(a_.double() for a_ in args))
            ill = model == "flagship6" and b >= 1000
            if ill or norm:  # the plain version in float32 on the CPU, the filter's constants there too
                cpu_chain = build_fleet(model, None, "cpu", scenarios=b, estimator_chain=True,
                                        obs_normalize=norm).tick.chain
                cpu32 = estimator_cuda.estimator_chain_plain(cpu_chain, *(a_.cpu() for a_ in args))
            else:
                cpu32 = want
            row = {"phase": "estimator_chain", "model": label, "b": b, "n_substeps": chain.n_substeps,
                   "outside_band": []}
            for name, *vals in zip(("x", "ukf_x", "p"), got, want, f64, cpu32):
                g, w32, w64, c32 = (v.double().cpu() for v in vals)
                out = (g - w32).abs() > F32_BAND["atol"] + F32_BAND["rtol"] * w32.abs()
                if ill:
                    row["outside_band"] += [
                        {"output": name, "index": idx, "kernel": g[idx].item(), "plain_f32": w32[idx].item(),
                         "plain_f32_cpu": c32[idx].item(), "plain_f64": w64[idx].item()}
                        for idx in map(tuple, torch.nonzero(out).tolist())]
                keep = ~out if ill else torch.ones_like(out)
                check_band(g[keep], w32[keep], f"K7 {label} B={b} {name} vs plain")
                row[f"{name}_max_abs_err"] = max_err(g, w32)  # over every entry
                row[f"{name}_f64_err"], row[f"{name}_plain_f64_err"] = max_err(g, w64), max_err(w32, w64)
                yardstick = row[f"{name}_plain_f64_err"]
                if norm:
                    row[f"{name}_plain_cpu_f64_err"] = max_err(c32, w64)
                    yardstick = max(yardstick, row[f"{name}_plain_cpu_f64_err"])
                check(row[f"{name}_f64_err"] <= 2.0 * yardstick + 2e-4, f"K7 {label} B={b} {name}: {row}")
                err[label] = max(err.get(label, 0.0), row[f"{name}_max_abs_err"])
            check(len(row["outside_band"]) <= K7_ILL_MAX, f"K7 {label} B={b}: outside the band {row['outside_band']}")
            check(bool(torch.isfinite(got[1]).all()) and bool(torch.isfinite(got[2]).all()),
                  f"K7 {label} B={b}: the NaN estimate did not come back finite")
            if chain.n_substeps == 1:  # the guard fired in the last substep
                check(torch.equal(got[2][:, nan_b], chain.p_reset.flatten()), f"K7 {label} B={b}: P is not p_reset")
            row["nan_scenario"] = nan_b
            row["nan_scenario_p_diag"] = got[2][:, nan_b].reshape(chain.params.n, -1).diagonal().tolist()
            emit(row)
            if b == 1024:
                kern = median_ms(lambda: estimator_cuda.estimator_chain_fused(chain, *args), reps=50)
                plain_t = median_ms(lambda: estimator_cuda.estimator_chain_plain(chain, *args), reps=3, warmup=1)
                kern2 = median_ms(lambda: estimator_cuda.estimator_chain_fused(chain, *args), reps=50)
                dev_ms = device_ms(lambda: estimator_cuda.estimator_chain_fused(chain, *args))
                bnd = bound(flops_of(lambda: estimator_cuda.estimator_chain_plain(chain, *args)),
                            nbytes(*args) + nbytes(*got))
                timing[label] = (min(kern, kern2), plain_t, bnd, dev_ms)
                emit({"phase": "timing_estimator_chain", "model": label, "b": b,
                      "kernel_us": [1e3 * kern, 1e3 * kern2], "device_us": 1e3 * dev_ms, "plain_us": 1e3 * plain_t,
                      **bnd, **card})
    digest = k7_digest(raw)
    emit({"phase": "estimator_chain_raw_bits", "digest": digest, "parent_digest": K7_RAW_DIGEST,
          "device_us_b1024": {k: 1e3 * t[3] for k, t in timing.items()}})
    check(digest == K7_RAW_DIGEST, f"the raw K7 instantiations' outputs are not the parent's: {digest}")

    # E2. the main path: both fleets on the chain, B = 1024, and flagship6 on
    # the normalised chain (obs_normalize) at its survival gate
    launches = {}
    for model, norm, t_end, min_survival in (("cartpole4", False, 10.0, 0.99), ("flagship6", False, 3.0, 0.95),
                                             ("flagship6", True, 3.0, 0.95)):
        label = k7_label(model, norm)
        fl = build_fleet(model, None, dev, scenarios=1024, estimator_chain=True, obs_normalize=norm)
        torch.cuda.synchronize()
        mppi_cuda.reset_launches()
        estimator_cuda.reset_launches()
        t0 = time.perf_counter()
        res = run_fleet(fl, t_end=t_end, report_every=1.0)
        run_s = time.perf_counter() - t0
        counts = {**mppi_cuda.launches, **estimator_cuda.launches}
        launches[label] = counts["estimator_chain_fused"]
        check(res.survival >= min_survival, f"chain fleet {label}: survival {res.survival} < {min_survival}")
        check(res.statuses_ok, f"chain fleet {label}: a status was not 0")
        check(bool(torch.isfinite(res.carry.x).all()) and bool(torch.isfinite(res.carry.ukf.x).all()),
              f"chain fleet {label}: non-finite states")
        check(counts["estimator_chain_fused"] >= res.ticks and counts["mppi_solve_batch_fused"] >= res.ticks
              and counts["finalize_batch_fused"] == 0,
              f"chain fleet {label}: launches {counts}: want >= ticks {res.ticks}, and no finalize launch")
        # the device launches of one tick, from the profiler
        carry = res.carry
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            carry = fl.tick(carry, fl.generator)
            torch.cuda.synchronize()
        per_tick = [e.name.split("<")[0].split("(")[0][:60] for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
        tick_ms = [1e3 * t_ for t_ in res.tick_seconds]
        emit({"phase": "chain_fleet_main_path", "model": label, "scenarios": res.scenarios,
              "survived": res.scenarios - res.tipped, "ticks": res.ticks, "survival": res.survival,
              "statuses_ok": res.statuses_ok, "median_max_theta": res.median_max_theta,
              "tick_ms_median": statistics.median(tick_ms), "tick_ms_p99": sorted(tick_ms)[int(0.99 * len(tick_ms))],
              "scenario_ticks_per_s": res.scenario_ticks_per_s, "run_s": run_s, "launches": counts,
              "device_launches_per_tick": len(per_tick), "device_kernels_of_a_tick": per_tick, **card})

    return [
        {"name": f"estimator_chain_kernel {label} (K7, estimator_chain_fused)", "route": "cuda",
         "source": ESTIMATOR_SOURCE, "replaces": "mpc_rs_tpu/ops/estimator_pallas.py:211",
         "launches": launches[label], "max_abs_err": err[label], "ms": timing[label][0],
         "plain_ms": timing[label][1], "bound_ms": timing[label][2]["bound_ms"],
         "bound_by": timing[label][2]["bound_by"], "library_ms": None}
        for label in (k7_label(m, norm) for m, norm in K7_VARIANTS)
    ]


def diag_phases(dev: torch.device, card: dict) -> list[dict]:
    """The two diagnostic probes: D1's kernel against its plain version in
    float64 in each mode (J = 8, at K = 16 384 and at the main path's
    K = 819 200), D2's kernel against its plain version bit for bit in its
    three configurations, both entry points' ``main`` at the scripts' full
    sizes as a main path, and the timings. Returns the kernels line's
    entries."""
    from mpc_rs_tpu_torch.controllers.mppi import MppiConfig
    from mpc_rs_tpu_torch.models.params import CartPoleParams
    from mpc_rs_tpu_torch.ops import build, diag_cuda, mppi_cuda
    from mpc_rs_tpu_torch.ops.mppi_cuda import CartPoleShaped4
    from mpc_rs_tpu_torch.scripts import diag_bf16_fma, diag_kernel_mix

    model = CartPoleShaped4(CartPoleParams.single_wheel(), 0.1, fast=True)
    x, u = torch.tensor(X0, device=dev), torch.zeros(N, device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)

    def cfg(k):
        return MppiConfig(n_horizon=N, n_rollouts=k, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))

    def chain(k, mode, j, plain=None, seed=21):
        if plain is None:
            return diag_cuda.kernel_mix_chain_fused(cfg(k), model, x, u, mode=mode, n_solves=j, base_seed=seed)
        return diag_cuda.kernel_mix_chain_plain(cfg(k), model, x.to(plain), u.to(plain), mode=mode,
                                                n_solves=j, base_seed=seed)

    # D1-1. each mode's chain against the plain version fed the same Philox
    # words, in float64 (the f32 band) and in float32 (its distance shown)
    d1_err = 0.0
    for mode in diag_cuda.MODES:
        for k in (16_384, 819_200):
            got_u0s, got_un = chain(k, mode, 8)
            want_u0s, want_un = chain(k, mode, 8, torch.float64)
            f32_u0s, _ = chain(k, mode, 8, torch.float32)
            check(bool(torch.isfinite(got_u0s).all()) and bool(torch.isfinite(got_un).all()),
                  f"D1 {mode} K={k}: non-finite u")
            err = max(check_band(got_u0s, want_u0s, f"D1 {mode} K={k} u0s vs plain float64"),
                      check_band(got_un, want_un, f"D1 {mode} K={k} final u_n vs plain float64"))
            d1_err = max(d1_err, err)
            emit({"phase": "d1_kernel_mix", "mode": mode, "k": k, "j": 8, "max_abs_err": err,
                  "plain_f32_max_abs_err": max_err(f32_u0s, want_u0s), "u0s": got_u0s.tolist()})

    # D1-1b. a chain of J solves is J launches of the D1 kernel and nothing
    # else (no finalize), at R = 1 (K = 16 384) and R = 4 (K = 819 200); the
    # ticket is zero after them, and the same chain twice gives the same bits
    d1_per_call = {}
    for k in (16_384, 819_200):
        d1_per_call[f"k{k}_j8"] = check_kernels_per_call(lambda: chain(k, "full", 8), 8, f"D1 full K={k} J=8",
                                                         "kernel_mix_partials_kernel")
        again = [chain(k, "full", 8) for _ in range(2)]
        check(torch.equal(again[0][0], again[1][0]), f"D1 full K={k}: the same chain gave other bits")
    check(bool((mppi_cuda.merge_tickets(dev, 1) == 0).all()), "D1 tickets not zero")
    emit({"phase": "d1_kernels_per_call", **d1_per_call,
          "rollouts_per_thread": {k: mppi_cuda.rollouts_per_thread(k) for k in (16_384, 819_200)},
          "repeat_bit_for_bit": True})

    # D2-1. each configuration bit for bit against the plain version, on
    # the script's tile of 1.5s and on a tile of ±[1, 2)
    d2_err = {}
    for dtype, rows in diag_bf16_fma.CONFIGS:
        mag = 1.0 + torch.rand((rows, 128), generator=gen, device=dev)
        sign = torch.where(torch.rand((rows, 128), generator=gen, device=dev) < 0.5, -1.0, 1.0)
        for label, tile in (("1.5", torch.full((rows, 128), 1.5, device=dev)), ("pm_1_2", sign * mag)):
            xt = tile.to(dtype)
            got = diag_cuda.fma_chain_fused(xt, 256, 264)
            want = diag_cuda.fma_chain_plain(xt, 256)
            err = max_err(got, want)
            check(torch.equal(got, want), f"D2 {dtype} rows={rows} tile {label}: max |Δ| {err}")
            d2_err[dtype] = max(d2_err.get(dtype, 0.0), err)
            emit({"phase": "d2_fma", "dtype": str(dtype), "rows": rows, "tile": label, "inner": 256,
                  "steps": 264, "bit_for_bit": True, "max_abs_err": err,
                  "max_abs": float(got.float().abs().max())})

    # D2-2. what the compiler made of the chains through -fmad=false
    # (cuobjdump -sass of the library): float32 fused mul-adds and no
    # separate add; bf16 packed bf16 ops, with at most the conversion of a
    # in the prologue
    so, _ = build.build()
    sass = library_sass(so)
    seen = 0
    for func in sass.split("Function : ")[1:]:
        name = func.split()[0]
        if "fma_chain_kernel" not in name:
            continue
        seen += 1
        ops = Counter(re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", func))
        per_thread = 32 if "Li32E" in name else 16
        if "bfloat162" in name:
            packed = sum(c for op, c in ops.items() if op.startswith(("HMUL2.BF16", "HADD2.BF16", "HFMA2")))
            converts = sum(c for op, c in ops.items() if op.startswith(("F2F", "F2FP", "I2F")))
            scalar = sum(ops[op] for op in ("FFMA", "FADD", "FMUL"))
            check(packed >= 2 * per_thread and converts <= 2 and scalar == 0, f"D2 SASS {name}: {dict(ops)}")
        else:
            check(ops["FFMA"] >= per_thread and ops["FADD"] == 0, f"D2 SASS {name}: {dict(ops)}")
        emit({"phase": "d2_sass", "kernel": name, "ops": dict(ops.most_common())})
    check(seen == 4, f"D2 SASS: {seen} fma_chain_kernel functions in the library, expected 4")

    # D1-2 and D2-3. the main path: both entry points at the scripts' full sizes
    torch.cuda.synchronize()
    diag_cuda.reset_launches()
    t0 = time.perf_counter()
    mix = diag_kernel_mix.main(list(diag_cuda.MODES))
    fma = diag_bf16_fma.main([])
    run_s = time.perf_counter() - t0
    counts = dict(diag_cuda.launches)
    for mode in diag_cuda.MODES:
        check(counts[f"mode:{mode}"] >= 1, f"D1 mode {mode} was not launched on the main path")
        check(mix["modes"][mode]["us_per_solve"] > 0, f"D1 {mode}: {mix['modes'][mode]}")
    check(counts["fma:float32"] >= 1 and counts["fma:bfloat16"] >= 1, f"D2 launches {counts}")
    check(all(c["us_per_step"] > 0 for c in fma["configs"]), f"D2: {fma['configs']}")
    clt_family = [mix["modes"][m]["us_per_solve"] for m in ("clt", "cltone", "cltbig", "cltreg")]
    spread = (max(clt_family) - min(clt_family)) / min(clt_family)
    emit({"phase": "diag_main_path", "run_s": run_s, "launches": counts, "d1": mix, "d2": fma,
          "clt_family_spread": spread, **card})
    # the four modes run one instantiation, so the timing harness must time
    # them alike (PERF.md: 0.1-0.6 % in four runs; cltf, its own kernel, 3-4 % off)
    check(spread < CLT_FAMILY_SPREAD, f"D1 clt/cltone/cltbig/cltreg times spread {spread:.4f}: {clt_family}")

    # timings by CUDA events: D1 per solve (a chain of 64) in each mode at
    # K = 819 200, against the plain float32 version (one solve); D2 per step
    # at 16 000 steps, against the plain version of the one tile
    jj, k = 64, 819_200
    d1_timing = {}
    for mode in diag_cuda.MODES:
        kern = median_ms(lambda: chain(k, mode, jj), reps=5, warmup=1) / jj
        dev_ms = device_ms(lambda: chain(k, mode, 8), reps=3, kernels=8) / 8  # one kernel a solve
        plain_t = median_ms(lambda: chain(k, mode, 1, torch.float32), reps=3, warmup=1)
        kern2 = median_ms(lambda: chain(k, mode, jj), reps=5, warmup=1) / jj
        # in: x, u_n; out: u0, u_n' (per solve)
        bnd = bound(flops_of(lambda: chain(k, mode, 1, torch.float32)), nbytes(x, u, u[:1], u))
        d1_timing[mode] = (min(kern, kern2), plain_t, bnd)
        emit({"phase": "timing_d1", "mode": mode, "k": k, "j": jj, "kernel_us_per_solve": [1e3 * kern, 1e3 * kern2],
              "device_us_per_solve": 1e3 * dev_ms, "plain_us_per_solve": 1e3 * plain_t, **bnd, **card})
    # D1 beside K1 on the same solve (fast tier, K = 819 200, chains of 64):
    # clt against K1's clt4 and full against K1's box-muller, in turns, and
    # the device µs per solve of each kernel by torch.profiler
    def k1(sampler):
        return lambda: mppi_cuda.mppi_chain_fused(cfg(k), model, x, u, n_solves=jj, base_seed=1, sampler=sampler)

    pairs = {"k1_clt4": k1("clt4"), "d1_clt": lambda: chain(k, "clt", jj, seed=1),
             "k1_box_muller": k1("box-muller"), "d1_full": lambda: chain(k, "full", jj, seed=1)}
    turns = {name: [] for name in pairs}
    for rnd in range(6):
        for name in list(pairs) if rnd % 2 == 0 else list(reversed(pairs)):
            turns[name].append(1e3 * median_ms(pairs[name], reps=1, warmup=int(rnd == 0)) / jj)
    by_kernel = {}
    for name, fn in pairs.items():
        per = by_kernel.setdefault(name, {})
        for event, us in device_events(fn):
            event = event.replace("(anonymous namespace)::", "")
            label = event.split("<")[0].split("(")[0].split("::")[-1].strip().removeprefix("void ")
            per[label] = per.get(label, 0.0) + us / jj
    emit({"phase": "timing_d1_vs_k1", "k": k, "j": jj,
          "us_per_solve_median": {n: statistics.median(t) for n, t in turns.items()}, "us_per_solve": turns,
          "device_us_per_solve": by_kernel, **card})

    d2_timing = {}
    steps = 16_000
    for dtype, rows in diag_bf16_fma.CONFIGS:
        xt = torch.full((rows, 128), 1.5, dtype=dtype, device=dev)
        kern = median_ms(lambda: diag_cuda.fma_chain_fused(xt, 256, steps), reps=10) / steps
        plain_t = median_ms(lambda: diag_cuda.fma_chain_plain(xt, 256), reps=3, warmup=1)
        bnd = bound(flops_of(lambda: diag_cuda.fma_chain_plain(xt, 256)), 2 * nbytes(xt),
                    PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32)
        d2_timing[(dtype, rows)] = (kern, plain_t, bnd)
        emit({"phase": "timing_d2", "dtype": str(dtype), "rows": rows, "inner": 256, "steps": steps,
              "kernel_us_per_step": 1e3 * kern, "g_fma_per_s": rows * 128 * 256 / kern / 1e6,
              "plain_us_per_tile": 1e3 * plain_t, **bnd, **card})

    def timed(t):
        return {"ms": t[0], "plain_ms": t[1], "bound_ms": t[2]["bound_ms"], "bound_by": t[2]["bound_by"],
                "library_ms": None}

    return [
        {"name": "kernel_mix_partials_kernel mode=full, one launch a solve, R=4 (D1, kernel_mix_chain_fused, "
                 "per solve)", "route": "cuda", "source": DIAG_SOURCE, "replaces": "scripts/diag_kernel_mix.py:283",
         "launches": counts["kernel_mix_chain_fused"], "max_abs_err": d1_err, **timed(d1_timing["full"]),
         "no_fma_ms": d1_timing["full"][2]["no_fma_ms"]},
        {"name": "fma_chain_kernel<float> rows=64 (D2, fma_chain_fused, per step)", "route": "cuda",
         "source": DIAG_SOURCE, "replaces": "scripts/diag_bf16_vpu.py:38", "launches": counts["fma:float32"],
         "max_abs_err": d2_err[torch.float32], **timed(d2_timing[(torch.float32, 64)])},
        {"name": "fma_chain_kernel<__nv_bfloat162> rows=128 (D2, fma_chain_fused, per step)", "route": "cuda",
         "source": DIAG_SOURCE, "replaces": "scripts/diag_bf16_vpu.py:38", "launches": counts["fma:bfloat16"],
         "max_abs_err": d2_err[torch.bfloat16], **timed(d2_timing[(torch.bfloat16, 128)])},
    ]


def ukf_fidelity_phase(dev: torch.device, card: dict) -> None:
    """The AoS UKF's owed check on the card (tests/test_torch_ukf.py; the
    JAX package's tests/test_ukf.py:443-536): a 300-tick flagship6 truth
    (float64 plant on the host, stabilising feedback on (x, dx, θ, dθ),
    noisy IMU observations, numpy seed 42) replayed through the port's
    float32 and float64 α=1 filters (eigh root) on CUDA tensors, and through
    the float64 filter on the CPU. Claim (a): the float32 filter's settled
    RMS against the truth on the controller channels is under 1.3 × the
    float64 filter's + 1e-4."""
    import numpy as np

    from mpc_rs_tpu_torch.estimators import ukf
    from mpc_rs_tpu_torch.models import dynamics, noise, observation
    from mpc_rs_tpu_torch.models.params import CartPoleParams

    p, dt, ticks = CartPoleParams.two_wheel(), 0.01, 300
    plant6, hx = dynamics.make_flagship6(p), observation.make_hx_imu6(p)
    sens = np.array([200.0, 200.0, 10.0, 0.05, 0.05])
    rng = np.random.default_rng(42)
    gains = np.array([2.0, 3.0, 30.0, 6.0])
    x = np.zeros(6)
    us, zs, truth = [], [], []
    for _ in range(ticks):
        u = float(np.clip(-gains @ x[[0, 1, 3, 4]], -10.0, 10.0))
        x = np.array([float(v) for v in plant6(*(torch.tensor(c, dtype=torch.float64) for c in x),
                                               torch.tensor(u, dtype=torch.float64), dt, 0.0)])
        zs.append(hx(torch.tensor(x)).numpy() + sens * rng.standard_normal(5))
        us.append(u)
        truth.append(x.copy())
    truth = np.asarray(truth)

    def fx(xv, uu):
        return torch.stack(torch.broadcast_tensors(*plant6(*(xv[..., i] for i in range(6)), uu, dt, 0.0)), dim=-1)

    def replay(dtype, where):
        params, est = ukf.ukf_init(torch.zeros(6, dtype=dtype, device=where), 0.1 * np.eye(6),
                                   noise.gen_q6(2.15 * dt).to(dtype), np.diag(sens), alpha=1.0)
        u_d = torch.tensor(us, dtype=dtype, device=where)
        z_d = torch.tensor(np.asarray(zs), dtype=dtype, device=where)
        xs = []
        for i in range(ticks):
            est = ukf.ukf_step(params, est, u_d[i], z_d[i], fx, hx)
            xs.append(est.x)
        return torch.stack(xs).double().cpu().numpy()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t32 = replay(torch.float32, dev)
    t32_s = time.perf_counter() - t0
    t64 = replay(torch.float64, dev)
    t64_cpu = replay(torch.float64, "cpu")
    sl = [0, 1, 3, 4]

    def settled_rms(traj):
        return np.sqrt(np.mean((traj[100:, sl] - truth[100:, sl]) ** 2, axis=0))

    r32, r64 = settled_rms(t32), settled_rms(t64)
    check(bool(np.isfinite(t32).all()) and bool(np.isfinite(t64).all()), "UKF replay: non-finite estimates")
    check(bool(np.all(r32 < 1.3 * r64 + 1e-4)), f"UKF f32 α=1 fidelity (a): settled RMS {r32} vs f64 {r64}")
    emit({"phase": "ukf_f32_fidelity", "ticks": ticks, "settled_rms_f32": r32.tolist(),
          "settled_rms_f64": r64.tolist(), "bound": (1.3 * r64 + 1e-4).tolist(),
          "f32_vs_f64_rms_max": float(np.sqrt(np.mean((t32 - t64)[100:] ** 2, axis=0)).max()),
          "f64_card_vs_cpu_max_abs": float(np.abs(t64 - t64_cpu).max()), "f32_replay_s": t32_s, **card})


FAMILY_SOURCES = {"mppi2": "mpc_rs_tpu_torch/ops/csrc/family_mppi2.cu",
                  "mppi4": "mpc_rs_tpu_torch/ops/csrc/family_mppi4.cu",
                  "hw_flagship": "mpc_rs_tpu_torch/ops/csrc/family_commu4.cu"}
HW_BUDGET_S = 0.06  # the HW flagship's control budget a solve (SURVEY §6)


def family_phases(dev: torch.device, card: dict) -> list[dict]:
    """The MPPI application family on K1/K2: each (model, N) instantiation
    against its plain version at its app's reference shape, every noise
    source at R = 1 and 4, the in-kernel samplers' words at N = 20 and 40
    against ``ops/philox.py``; the HW-flagship chain (N = 20, K = 800 000,
    the plant on, clt4a and wallace) against the plain chain; the four apps
    through the CLI entry at the JAX package's acceptance settings and rules
    (``mpc_rs_tpu/apps/acceptance.py:39-52,246-262``) and the HW chain as
    main paths (counts reset before each, read after); each app's tick at
    its reference K; the HW chain's µs a solve against its 0.06 s budget.
    Returns the kernels line's entries."""
    import numpy as np

    from mpc_rs_tpu_torch.apps import run as cli
    from mpc_rs_tpu_torch.controllers.mppi import MppiConfig, MppiStatus
    from mpc_rs_tpu_torch.models.params import CartPoleParams
    from mpc_rs_tpu_torch.ops import mppi_cuda, philox
    from mpc_rs_tpu_torch.ops.mppi_cuda import (CartPoleLinearShaped4, CartPoleShaped4, Commu4Cost4,
                                                DoubleIntegratorQuad2, Flagship4Diag4)

    sw, tw = CartPoleParams.single_wheel(), CartPoleParams.two_wheel()
    # app: (model, N, reference K, λ, σ, limit, x0, control_inv, λ where the f32 solve is well conditioned)
    apps = {
        "mppi2": (DoubleIntegratorQuad2(0.05), 40, 8000, 2.5, 1.0, 3.0, (1.0, 0.0), 2.5, 2.5),
        "mppi4": (CartPoleLinearShaped4(sw, 0.1), 8, 800_000, 0.5, 3.0, 20.0, X0, None, 0.5),
        "mppi4-non-liner-s": (CartPoleShaped4(sw, 0.1), 8, 1_500_000, 0.5, 10.0, 10.0, (0.0, 0.0, 0.01, 0.0),
                              None, 0.5),
        "mppi4-non-liner-ukf": (Flagship4Diag4(tw, 0.15), 8, 500_000, 1.4, 4.0, 10.0, (0.0, 0.0, 0.05, 0.0),
                                None, 50.0),
        "hw_flagship": (Commu4Cost4(tw, 0.05), 20, 800_000, 2.0, 2.0, 10.0, (0.0, 0.0, 0.1, 0.0), None, 2.0),
    }

    def cfg_of(app, lam=None, k=None):
        _, n, k_ref, lam_ref, sd, lim, _, inv, _ = apps[app]
        return MppiConfig(n_horizon=n, n_rollouts=k or k_ref, lambda_=lam_ref if lam is None else lam,
                          std_dev=sd, limit=(-lim, lim), control_inv=inv)

    def x_of(app):
        return torch.tensor(apps[app][6], dtype=torch.float32, device=dev)

    gen = torch.Generator(device=dev).manual_seed(808)
    err = {app: 0.0 for app in apps}
    noise_rows = []
    # FA1. each instantiation against its plain version in float64 on the
    # same noise, at the app's reference shape, every source at R = 1 and 4;
    # the kernel's in-kernel noise (written by the same partials kernel on a
    # grid of one problem through the batched entry) against ops/philox.py's
    # words. mppi4-non-liner-ukf's f32 solve is ill-conditioned at its λ=1.4
    # (PERF.md): the band holds at λ=50, and at the app's λ the kernel is
    # held to twice the plain f32 version's own distance from float64.
    for app, (m, n, k, *_rest) in apps.items():
        band_lam = apps[app][8]
        cfg = cfg_of(app, band_lam)
        x = x_of(app)
        u_n = 0.3 * torch.randn(n, generator=gen, device=dev)
        for source in ("external", *philox.SAMPLERS):
            for rpt in (1, 4):
                if source == "external":
                    words = apps[app][4] * torch.randn((k, n), generator=gen, device=dev)
                    got_u, got_st = mppi_cuda.mppi_solve_fused(cfg, m, x, u_n, noise=words, rollouts_per_thread=rpt)
                else:
                    out = torch.empty((1, k, n), device=dev)
                    mppi_cuda.mppi_batch_partials_fused(cfg, m, x[None], u_n[None], sampler=source, noise_out=out,
                                                        seeds=torch.tensor([21], dtype=torch.int32, device=dev),
                                                        rollouts_per_thread=rpt)
                    words = mppi_cuda.solve_noise(cfg, m, 21, 0, source, device=dev)
                    same = bool(torch.equal(out[0], words))
                    noise_err = max_err(out[0], words)
                    check(same if source in ("clt4", "clt4a", "clt2q") else noise_err < 1e-4,
                          f"{app} {source} R={rpt}: kernel noise vs ops/philox.py words {noise_err}")
                    if rpt == 1:
                        noise_rows.append({"app": app, "n": n, "sampler": source, "same_bits": same,
                                           "max_abs_err": noise_err})
                    got_u, got_st = mppi_cuda.mppi_solve_fused(cfg, m, x, u_n, seed=21, sampler=source,
                                                               rollouts_per_thread=rpt)
                want_u, want_st = mppi_cuda.mppi_solve_plain(cfg, m, x.double(), u_n.double(), noise=words.double(),
                                                             rollouts_per_thread=rpt)
                check(int(got_st) == int(want_st) == MppiStatus.OK,
                      f"{app} {source} R={rpt} statuses {int(got_st)}/{int(want_st)}")
                err[app] = max(err[app], check_band(got_u, want_u, f"{app} {source} R={rpt} vs plain"))
        if band_lam != apps[app][3]:  # the app's λ: twice the plain f32 version's own distance
            cfg_app = cfg_of(app)
            got_u, got_st = mppi_cuda.mppi_solve_fused(cfg_app, m, x, u_n, seed=21)
            words = mppi_cuda.solve_noise(cfg_app, m, 21, 0, device=dev)
            want = mppi_cuda.mppi_solve_plain(cfg_app, m, x.double(), u_n.double(), noise=words.double())[0]
            own = max_err(mppi_cuda.mppi_solve_plain(cfg_app, m, x, u_n, noise=words)[0], want)
            app_err = max_err(got_u, want)
            check(int(got_st) == 0 and app_err <= 2 * own + F32_BAND["atol"],
                  f"{app} at the app's λ: {app_err} against twice the plain f32 distance {own}")
            emit({"phase": "family_app_lambda", "app": app, "lambda": apps[app][3], "max_abs_err": app_err,
                  "plain_f32_vs_f64": own})
        emit({"phase": "family_vs_plain", "app": app, "n": n, "k": k, "lambda": band_lam,
              "sources": ["external", *philox.SAMPLERS], "rollouts_per_thread": [1, 4], "max_abs_err": err[app]})
    emit({"phase": "family_sampler_words", "rows": noise_rows})

    # FA2. the HW-flagship chain (K1 at N = 20): plant on at λ=200, where the
    # chain is well conditioned (tests/test_torch_mppi_family.py), against
    # the plain chain in float64; the app's λ=2 with the state held; a
    # seeded chain, the state held, is sequential K2 solves bit for bit
    hw, _, k_hw = apps["hw_flagship"][:3]
    x_hw, zeros20 = x_of("hw_flagship"), torch.zeros(20, device=dev)
    hw_err = 0.0
    for sampler in ("clt4a", "wallace"):
        for lam, plant in ((200.0, True), (2.0, False)):
            c = cfg_of("hw_flagship", lam)
            chain = mppi_cuda.mppi_chain_fused(c, hw, x_hw, zeros20, n_solves=8, base_seed=5, plant=plant,
                                               sampler=sampler)
            plain = mppi_cuda.mppi_chain_plain(c, hw, x_hw.double(), zeros20.double(), n_solves=8, base_seed=5,
                                               plant=plant, sampler=sampler)
            check(chain.statuses.tolist() == plain.statuses.tolist() == [0] * 8, f"HW chain {sampler} statuses")
            e = max(check_band(chain.u0s, plain.u0s, f"HW chain {sampler} λ={lam} u0s"),
                    check_band(chain.u_n, plain.u_n, f"HW chain {sampler} λ={lam} u_n"),
                    check_band(chain.x, plain.x, f"HW chain {sampler} λ={lam} x"))
            hw_err = max(hw_err, e)
            emit({"phase": "hw_chain_vs_plain", "sampler": sampler, "lambda": lam, "plant": plant, "j": 8,
                  "max_abs_err": e})
        seeds = torch.arange(4, dtype=torch.int32, device=dev) * 17 + 3
        c = cfg_of("hw_flagship")
        chain = mppi_cuda.mppi_chain_fused(c, hw, x_hw, zeros20, seeds=seeds, sampler=sampler)
        u, u0s = zeros20, []
        for j in range(4):
            u, _ = mppi_cuda.mppi_solve_fused(c, hw, x_hw, u, seed=int(seeds[j]), sampler=sampler)
            u0s.append(u[0])
        check(torch.equal(chain.u0s, torch.stack(u0s)) and torch.equal(chain.u_n, u),
              f"HW chain {sampler}: not the sequential K2 solves")
    err["hw_flagship"] = max(err["hw_flagship"], hw_err)

    # FA3. the main paths: the four apps through the CLI entry at the
    # acceptance settings and pass rules, and the HW chain; counts reset
    # just before each and read just after
    runs = {}

    def drive(label, argv, model_key):
        mppi_cuda.reset_launches()
        t0 = time.perf_counter()
        res = cli.main(argv)
        torch.cuda.synchronize()
        counts = dict(mppi_cuda.launches)
        runs[label] = (res, counts, time.perf_counter() - t0)
        check(counts[model_key] >= 1 and counts["mppi_solve_fused"] == counts[model_key],
              f"{label}: {model_key} launches {counts[model_key]} of {counts['mppi_solve_fused']}")
        return res, counts

    log_dir = ["--log-dir", "logs/chip_smoke_family"]
    res, counts = drive("mppi2", ["mppi2"], "model:DoubleIntegratorQuad2")
    check(bool(np.isfinite(res.x).all()) and abs(res.x[0]) < 0.3 and abs(res.x[1]) < 0.3
          and len(res.statuses) >= 100, f"mppi2 did not regulate |x| < 0.3 in 5 s: {res.x}")
    res, counts = drive("mppi4", ["mppi4", "--k", "65536", *log_dir], "model:CartPoleLinearShaped4")
    check(not res.tipped and bool(np.isfinite(res.x).all()) and len(res.statuses) >= 100,
          f"mppi4 at K=65 536 tipped past 60 degrees in 10 s: {res.x}")
    for label, argv, key in (
        ("mppi4-non-liner-s", ["mppi4-non-liner-s", "--k", "16384"], "model:CartPoleShaped4"),
        ("mppi4-non-liner-ukf", ["mppi4-non-liner-ukf", "--k", "16384"], "model:Flagship4Diag4"),
        ("mppi4-non-liner-ukf+est", ["mppi4-non-liner-ukf", "--k", "16384", "--use-ukf-estimate",
                                     "--control-period", "0.02"], "model:Flagship4Diag4"),
    ):
        res, counts = drive(label, [*argv, *log_dir], key)
        check(not res.tipped and res.t >= 9.5, f"{label} did not survive to 9.5 s: t={res.t}, tipped={res.tipped}")
        # every controller call solves, but the flagship's past its π/2 guard
        check(counts[key] == res.n_solves if label == "mppi4-non-liner-s" else 0 < counts[key] <= res.n_solves,
              f"{label}: {counts[key]} launches, {res.n_solves} controller calls")
    for label, (res, counts, secs) in runs.items():
        n_solves = len(res.statuses) if hasattr(res, "statuses") else res.n_solves
        emit({"phase": "family_main_path", "app": label, "solves": n_solves,
              "final_x": np.asarray(res.x).tolist(), "t": getattr(res, "t", None),
              "launches": {k: v for k, v in counts.items() if v}, "wall_s": secs, **card})
    hw_counts = {}
    for sampler in ("clt4a", "wallace"):
        mppi_cuda.reset_launches()
        chain = mppi_cuda.mppi_chain_fused(cfg_of("hw_flagship"), hw, x_hw, zeros20, n_solves=200, base_seed=9,
                                           plant=True, sampler=sampler)
        torch.cuda.synchronize()
        hw_counts[sampler] = dict(mppi_cuda.launches)
        check(hw_counts[sampler]["model:Commu4Cost4"] == 1 and hw_counts[sampler]["mppi_chain_fused"] == 1,
              f"HW chain {sampler}: launches {hw_counts[sampler]}")
        check(bool((chain.statuses == 0).all()) and bool(torch.isfinite(chain.x).all())
              and abs(float(chain.x[2])) < math.pi / 2, f"HW chain {sampler}: statuses or x {chain.x.tolist()}")
        emit({"phase": "hw_chain_main_path", "sampler": sampler, "j": 200, "final_x": chain.x.tolist(),
              "launches": {k: v for k, v in hw_counts[sampler].items() if v}, **card})

    # FA4. timings: each app's K2 at its reference K (CUDA events, device
    # time, the plain float32 version, the bound); each app's tick at its
    # reference K over a short run; the HW chain a solve by device time, by
    # events over 64 solves and by the marginal of 64 and 320 solves
    timing = {}
    for app, (m, n, k, *_rest) in apps.items():
        c, x, u = cfg_of(app), x_of(app), torch.zeros(n, device=dev)
        kern = median_ms(lambda: mppi_cuda.mppi_solve_fused(c, m, x, u, seed=3), reps=30)
        dev_ms = device_ms(lambda: mppi_cuda.mppi_solve_fused(c, m, x, u, seed=3), reps=10)
        plain = lambda: mppi_cuda.mppi_solve_plain(c, m, x, u, seed=3)  # noqa: E731
        plain_t = median_ms(plain, reps=5, warmup=1)
        bnd = bound(flops_of(plain), 2 * nbytes(x, u) - nbytes(x) + 4)
        timing[app] = (kern, plain_t, bnd)
        emit({"phase": "timing_family_k2", "app": app, "n": n, "k": k,
              "rollouts_per_thread": mppi_cuda.rollouts_per_thread(k), "kernel_us_per_solve": 1e3 * kern,
              "device_us_per_solve": 1e3 * dev_ms, "plain_us_per_solve": 1e3 * plain_t, **bnd, **card})
    ticks = {"mppi2": runs["mppi2"][0].tick_seconds}
    short = {"mppi4": ["mppi4", "--t-end", "2", *log_dir],
             "mppi4-non-liner-s": ["mppi4-non-liner-s", "--t-end", "1", *log_dir],
             "mppi4-non-liner-ukf": ["mppi4-non-liner-ukf", "--t-end", "0.5", *log_dir]}
    for app, argv in short.items():
        res = cli.main(argv)
        ticks[app] = res.tick_seconds if hasattr(res, "tick_seconds") else res.solve_seconds
    for app, secs in ticks.items():
        ms = sorted(1e3 * t for t in secs)
        emit({"phase": "family_tick", "app": app, "k": apps[app][2], "ticks": len(ms),
              "what": "solve + host plant step" if app in ("mppi2", "mppi4") else "controller call (solve, u_n read back)",
              "tick_ms_median": statistics.median(ms), "tick_ms_p99": ms[min(len(ms) - 1, int(0.99 * len(ms)))],
              **card})
    hw_cfg = cfg_of("hw_flagship")
    hw_timing = {}
    for sampler in ("clt4a", "wallace"):
        chain = lambda **kw: mppi_cuda.mppi_chain_fused(hw_cfg, hw, x_hw, zeros20, n_solves=64,  # noqa: E731
                                                        base_seed=1, plant=True, sampler=sampler, **kw)
        ev = median_ms(chain, reps=5, warmup=1) / 64
        dv = device_ms(chain, reps=2, kernels=64) / 64

        def wall(j):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mppi_cuda.mppi_chain_fused(hw_cfg, hw, x_hw, zeros20, n_solves=j, base_seed=1, plant=True,
                                       sampler=sampler)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        wall(64)
        marg = sorted((wall(320) - wall(64)) / 256 for _ in range(3))[1]
        plain = lambda: mppi_cuda.mppi_solve_plain(hw_cfg, hw, x_hw, zeros20, seed=3, sampler=sampler)  # noqa: E731
        plain_t = median_ms(plain, reps=3, warmup=1)
        bnd = bound(flops_of(plain), 2 * nbytes(x_hw, zeros20) - nbytes(x_hw) + 4)
        hw_timing[sampler] = (ev, plain_t, bnd)
        emit({"phase": "hw_flagship_budget", "sampler": sampler, "k": k_hw, "n": 20,
              "rollouts_per_thread": mppi_cuda.rollouts_per_thread(k_hw),
              "device_us_per_solve": 1e3 * dv, "event_us_per_solve": 1e3 * ev, "marginal_us_per_solve": 1e6 * marg,
              "budget_us": 1e6 * HW_BUDGET_S, "headroom": HW_BUDGET_S / marg, "plain_us_per_solve": 1e3 * plain_t,
              "r_turns": r_turns(chain, 64), **bnd, **card})

    def timed(t):
        kern, plain_t, bnd = t
        return {"ms": kern, "plain_ms": plain_t, "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"],
                "library_ms": None}

    def launched(app, key):
        return runs[app][1][key]

    return [
        {"name": "mppi_partials_kernel<40, DoubleIntegrator, Quad2> on one problem (K2, mppi2, N=40, K=8000)",
         "route": "cuda", "source": FAMILY_SOURCES["mppi2"], "replaces": f"{PALLAS}:438",
         "launches": launched("mppi2", "model:DoubleIntegratorQuad2"), "max_abs_err": err["mppi2"],
         **timed(timing["mppi2"])},
        {"name": "mppi_partials_kernel<8, CartPoleLinear, Shaped4> on one problem (K2, mppi4, K=800000)",
         "route": "cuda", "source": FAMILY_SOURCES["mppi4"], "replaces": f"{PALLAS}:438",
         "launches": launched("mppi4", "model:CartPoleLinearShaped4"), "max_abs_err": err["mppi4"],
         **timed(timing["mppi4"])},
        {"name": "mppi_partials_kernel<8, CartPoleNonlinearT, Shaped4> (K2, mppi4-non-liner-s, K=1.5M, sigma=10)",
         "route": "cuda", "source": COMMON_SOURCE, "replaces": f"{PALLAS}:438",
         "launches": launched("mppi4-non-liner-s", "model:CartPoleShaped4"), "max_abs_err": err["mppi4-non-liner-s"],
         **timed(timing["mppi4-non-liner-s"])},
        {"name": "mppi_partials_kernel<8, Flagship4, Diag4> on one problem (K2, mppi4-non-liner-ukf, K=5e5)",
         "route": "cuda", "source": COMMON_SOURCE, "replaces": f"{PALLAS}:438",
         "launches": launched("mppi4-non-liner-ukf", "model:Flagship4Diag4")
         + launched("mppi4-non-liner-ukf+est", "model:Flagship4Diag4"),
         "max_abs_err": err["mppi4-non-liner-ukf"], **timed(timing["mppi4-non-liner-ukf"])},
        *({"name": f"mppi_partials_kernel<20, Commu4, Commu4Cost> chain, {s_} (K1, HW flagship, K=800000, "
                   f"per solve of 64)", "route": "cuda", "source": FAMILY_SOURCES["hw_flagship"],
           "replaces": f"{PALLAS}:1004", "launches": hw_counts[s_]["model:Commu4Cost4"],
           "max_abs_err": err["hw_flagship"], **timed(hw_timing[s_])} for s_ in ("clt4a", "wallace")),
    ]


# the cart-pole at serve's N = 9-40 (mppi_horizons_kernel) and
# fleet_finalize_kernel at N = 8-40, one kernel each that takes N at run time
HORIZONS_SOURCE = "mpc_rs_tpu_torch/ops/csrc/horizons.cu"
NATIVE_FILES = ("native/mpcio.cpp", "native/libmpcio.so", "native/libmpcio.so.src.sha256", "native/oracle.cpp",
                "native/liboracle.so", "native/liboracle.so.src.sha256")


def native_digests() -> dict:
    import hashlib

    return {f: hashlib.sha256(Path(f).read_bytes()).hexdigest() for f in NATIVE_FILES if Path(f).is_file()}


def ms_quantiles(seconds) -> dict:
    ms = sorted(1e3 * t for t in seconds)
    check(bool(ms), "no timed calls")
    return {"median_ms": statistics.median(ms), "p99_ms": ms[min(len(ms) - 1, int(0.99 * len(ms)))]}


def hil_phases(dev: torch.device, card: dict) -> list[dict]:
    """The hardware-in-the-loop layer and the serve bridge: the native COBS
    codec against the Python one; the cart-pole's partials kernel at every
    plan-streaming horizon of serve, N = 9-40, box-muller alone (single
    solve and the B = 8 batch; R = 1, and R = 4 at N = 40) against its
    float64 plain version, its noise against ``ops/philox.py``'s words, its
    registers and blocks an SM; and, as main paths through the CLI entry
    (counts reset before each, read after), ``uart``, ``mppi4-commu``
    (K = 800 000), ``mppi4-ukf-commu`` (K = 800 000, N = 20) and ``serve``
    (8 robots, K = 8192; M = 1 at depth 0 and 2, M = 4 at depth 1, which
    is N = 40, and N = 16 and N = 32 by the tick period), each against a
    fake MCU behind a PTY, then serve's batch timed at N = 8-40. ``native/``
    must be the same bytes after. Returns the kernels line's entries."""
    import numpy as np

    from mpc_rs_tpu_torch.apps import run as cli
    from mpc_rs_tpu_torch.controllers.mppi import MppiConfig, MppiStatus
    from mpc_rs_tpu_torch.io import cobs
    from mpc_rs_tpu_torch.models.params import CartPoleParams
    from mpc_rs_tpu_torch.ops import mppi_cuda
    from mpc_rs_tpu_torch.ops.mppi_cuda import CartPoleShaped4

    native_before = native_digests()
    # H1. the native codec, loaded (never rebuilt in place), against the
    # Python codec on seeded payloads of 0-600 bytes, some with runs of 254+
    # non-zero bytes (the 0xFF code)
    t0 = time.perf_counter()
    native = cobs.native_library()
    check(native is not None, "the native mpcio library did not load")
    rng = np.random.default_rng(2024)
    total = 0
    for i in range(1000):
        payload = rng.integers(0, 256, int(rng.integers(0, 601)), dtype=np.uint8)
        if i % 3 == 0 and payload.size:  # a run of non-zero bytes
            a = int(rng.integers(0, payload.size))
            payload[a:a + int(rng.integers(200, 400))] |= 1
        payload = payload.tobytes()
        enc = cobs.cobs_encode(payload, use_native=True)
        check(enc == cobs._py_cobs_encode(payload), f"COBS encode: native and Python differ on payload {i}")
        check(cobs.cobs_decode(enc, use_native=True) == payload == cobs._py_cobs_decode(enc),
              f"COBS decode of payload {i}")
        total += len(payload)
    emit({"phase": "hil_io", "library": str(native.path), "built": native.built, "payloads": 1000,
          "payload_bytes": total, "seconds": time.perf_counter() - t0})

    # H2. the cart-pole at serve's plan-streaming horizons on its one kernel
    # (mppi_horizons_kernel, horizons.cu), box-muller alone: K2 on one
    # problem and the batch of serve's 8 robots at K = 8192 against the
    # float64 plain version fed the kernel's noise, at λ = 20, where the f32
    # solve is well conditioned; the kernel's noise against ops/philox.py's
    # words; the statuses the plain version's; the merge tickets back at
    # zero; its registers and local bytes, one count at every N
    # (HORIZONS_REGISTERS), and its blocks an SM (mppi_cuda.horizons_occupancy). N = 40
    # at R = 1 and 4, then N = 9-39 at R = 1: odd N half uses its last
    # box-muller pair. At N = 40 also serve's λ = 0.5, against twice the
    # plain f32 version's own distance from float64.
    k, b = 8192, 8
    occupancy = {n: mppi_cuda.horizons_occupancy(n, dev) for n in range(9, 41)}
    counts = {(o["registers"], o["local_bytes"]) for o in occupancy.values()}
    check(len(counts) == 1 and occupancy[9]["registers"] == HORIZONS_REGISTERS,
          f"mppi_horizons_kernel: (registers, local bytes) {counts} over N = 9-40, want one, "
          f"{HORIZONS_REGISTERS} registers")

    def serve_model(n):
        return CartPoleShaped4(CartPoleParams.single_wheel(), 0.01 if n == 40 else 0.8 / n)

    def serve_cfg(n, lam, kk=k):
        return MppiConfig(n_horizon=n, n_rollouts=kk, lambda_=lam, std_dev=3.0, limit=(-20.0, 20.0))

    def batch_plain(cfg, m, xs, u_ns, noise, dtype, rpt=None):
        parts = mppi_cuda.mppi_batch_partials_plain(cfg, m, xs.to(dtype), u_ns.to(dtype), noise.to(dtype),
                                                    rollouts_per_thread=rpt)
        return mppi_cuda.finalize_batch_plain(cfg, parts)

    gen = torch.Generator(device=dev).manual_seed(940)
    xs = torch.zeros((b, 4), device=dev)
    xs[:, 2] = 0.2 * torch.rand(b, generator=gen, device=dev) - 0.1
    xs[:, 3] = 0.4 * torch.rand(b, generator=gen, device=dev) - 0.2
    seeds = torch.arange(b, dtype=torch.int32, device=dev) * 31 + 5
    horizon_err, rows = {}, []
    for n in (40, *range(9, 40)):
        m, cfg = serve_model(n), serve_cfg(n, 20.0)
        sources, rpts = mppi_cuda.built_for(m, n)
        check(sources == ("box-muller",) and rpts == ((1, 4) if n == 40 else (1,)), f"N={n} built for {sources} {rpts}")
        u_ns = 0.3 * torch.randn((b, n), generator=gen, device=dev)
        for rpt in rpts:
            noise = torch.empty((b, k, n), device=dev)
            got_u, got_st = mppi_cuda.mppi_solve_batch_fused(cfg, m, xs, u_ns, seeds=seeds, sampler="box-muller",
                                                             noise_out=noise, rollouts_per_thread=rpt)
            words = mppi_cuda.batch_noise(cfg, m, seeds, "box-muller")
            noise_err = max_err(noise, words)
            check(noise_err < 1e-4, f"N={n} R={rpt}: kernel noise vs ops/philox.py words {noise_err}")
            one_u, one_st = mppi_cuda.mppi_solve_fused(cfg, m, xs[0], u_ns[0], seed=int(seeds[0]),
                                                       rollouts_per_thread=rpt)
            check(torch.equal(mppi_cuda.solve_noise(cfg, m, int(seeds[0]), 0, device=dev), words[0]),
                  f"N={n}: a single solve's words are not robot 0's")
            want_u, want_st = batch_plain(cfg, m, xs, u_ns, noise, torch.float64, rpt)
            check(torch.equal(got_st, want_st) and bool((got_st == 0).all()) and int(one_st) == int(want_st[0]),
                  f"N={n} R={rpt} statuses {got_st.tolist()} / {want_st.tolist()} / {int(one_st)}")
            e = max(check_band(got_u, want_u, f"N={n} batch R={rpt} vs plain"),
                    check_band(one_u, want_u[0], f"N={n} K2 R={rpt} vs plain"))
            horizon_err[n] = max(horizon_err.get(n, 0.0), e)
            rows.append({"n": n, "rollouts_per_thread": rpt, "max_abs_err": e, "noise_max_abs_err": noise_err,
                         "registers": occupancy[n]["registers"], "blocks_per_sm": occupancy[n]["blocks_per_sm"]})
        tickets_zero = bool((mppi_cuda.merge_tickets(dev, 1) == 0).all()) and bool(
            (mppi_cuda.merge_tickets(dev, b) == 0).all())
        check(tickets_zero, f"N={n}: merge tickets not zero after the calls")
    m40, cfg_app = serve_model(40), serve_cfg(40, 0.5)
    u40 = 0.3 * torch.randn((b, 40), generator=gen, device=dev)
    got_u, got_st = mppi_cuda.mppi_solve_batch_fused(cfg_app, m40, xs, u40, seeds=seeds, sampler="box-muller")
    words = mppi_cuda.batch_noise(cfg_app, m40, seeds, "box-muller")
    want_u, want_st = batch_plain(cfg_app, m40, xs, u40, words, torch.float64)
    own = max_err(batch_plain(cfg_app, m40, xs, u40, words, torch.float32)[0], want_u)
    app_err = max_err(got_u, want_u)
    check(bool((got_st == 0).all()) and app_err <= 2 * own + F32_BAND["atol"],
          f"N=40 at serve's λ=0.5: {app_err} against twice the plain f32 distance {own}")
    emit({"phase": "family_serve_horizons", "k": k, "b": b, "lambda": 20.0, "rows": rows,
          "max_abs_err": horizon_err, "n40_app_lambda_max_abs_err": app_err, "n40_app_lambda_plain_f32_vs_f64": own,
          "occupancy": occupancy})

    # H3-H5. the HIL apps through the CLI entry against a fake MCU
    log_dir = ["--log-dir", "logs/chip_smoke_hil"]
    t0 = time.perf_counter()
    n_reads = cli.main(["uart", "--sim-mcu", "--t-end", "1.5"])
    check(n_reads > 10, f"uart read {n_reads} State packets in 1.5 s")
    emit({"phase": "hil_uart", "state_packets": n_reads, "wall_s": time.perf_counter() - t0})

    def drive_commu(argv, model_key, all_ok=True):
        mppi_cuda.reset_launches()
        t_start = time.perf_counter()
        res = cli.main(argv)
        torch.cuda.synchronize()
        counts = dict(mppi_cuda.launches)
        check(res.solves > 0, f"{argv[0]}: no solve")
        # every solve of the run, and the one before traffic, is one launch
        check(counts["mppi_solve_fused"] == counts[model_key] == res.solves + 1,
              f"{argv[0]}: launches {counts['mppi_solve_fused']} ({model_key} {counts[model_key]}), "
              f"{res.solves} solves + 1 before traffic")
        check(not all_ok or all(st == MppiStatus.OK for st in res.statuses),
              f"{argv[0]}: statuses {sorted(set(res.statuses))}")
        return res, counts, time.perf_counter() - t_start

    res, counts, secs = drive_commu(["mppi4-commu", "--sim-mcu", "--t-end", "3"], "model:CartPoleShaped4")
    check(res.max_abs_theta < math.radians(60.0) and res.upright and res.plant_max_abs_theta < math.radians(60.0),
          f"mppi4-commu tipped: max |theta| {res.max_abs_theta}, the plant's {res.plant_max_abs_theta}")
    emit({"phase": "hil_mppi4_commu", "k": 800_000, "sim_s": 3.0, "time_scale": 1.0, "solves": res.solves,
          "packets": res.packets, "max_abs_theta": res.max_abs_theta,
          "plant_max_abs_theta": res.plant_max_abs_theta, "solve": ms_quantiles(res.solve_seconds),
          "launches": {key: v for key, v in counts.items() if v}, "wall_s": secs, **card})
    # the HW flagship: its UKF in the JAX app's float32, whose α=1e-3 filter
    # goes non-finite a few packets after a control acts, in the JAX package
    # too (tests/test_torch_commu.py; the solves then fail to a zero
    # control), and in the reference's float64, which must stay finite with
    # every solve OK. In both, every solve made on a finite estimate is OK.
    # The float64 run prints its console streams (captured): an Rcv line for
    # each packet of the traffic loop, none for the first frame's filter step.
    for ukf_dtype in ("float32", "float64"):
        held = ukf_dtype == "float64"
        console = io.StringIO()
        with contextlib.redirect_stdout(console) if held else contextlib.nullcontext():
            res, counts, secs = drive_commu(["mppi4-ukf-commu", "--sim-mcu", "--t-end", "3", "--ukf-dtype",
                                             ukf_dtype, *log_dir, *(["--console"] if held else [])],
                                            "model:Commu4Cost4", all_ok=held)
        rcv = console.getvalue().count("\x1b[36mRcv:") if held else None
        check(not held or rcv == res.packets - 1, f"mppi4-ukf-commu --console: {rcv} Rcv lines, {res.packets} packets")
        check(res.solves >= 20, f"mppi4-ukf-commu {ukf_dtype}: {res.solves} solves")
        check(res.finite or not held, f"mppi4-ukf-commu {ukf_dtype}: the estimate went non-finite")
        check(all(st == MppiStatus.OK for st in res.statuses[:res.finite_solves]),
              f"mppi4-ukf-commu {ukf_dtype}: a solve on a finite estimate failed, "
              f"statuses {res.statuses[:res.finite_solves]}")
        emit({"phase": "hil_mppi4_ukf_commu", "ukf_dtype": ukf_dtype, "k": 800_000, "n": 20, "sim_s": 3.0,
              "time_scale": 1.0, "solves": res.solves, "packets": res.packets, "upright": res.upright,
              "finite": res.finite, "finite_solves": res.finite_solves, "statuses": dict(Counter(res.statuses)),
              "console_rcv_lines": rcv,
              "max_abs_theta_estimate": res.max_abs_theta, "plant_max_abs_theta": res.plant_max_abs_theta,
              "solve": ms_quantiles(res.solve_seconds),
              "est_step": ms_quantiles(res.est_seconds), "launches": {key: v for key, v in counts.items() if v},
              "wall_s": secs, **card})

    # H6. serve: 8 robots at K = 8192, slow-motion twins at time-scale 0.2:
    # M = 1 (N = 8) at depth 0 and 2, M = 4 at the default 0.01 s tick
    # (N = 40) at depth 1, and two plan-streaming horizons the JAX serve
    # picks from the tick period: M = 2 at 0.05 s (N = 16, the row's sums in
    # warp 0) at depth 1 and at depth 0 (at depth 1 a plan solved from
    # tick t's state is sent at ticks t + 2 and t + 3, 0.1 s late at that
    # tick), M = 4 at 0.025 s (N = 32, two warps)
    serve_runs = {}
    want_horizon = {"m1_d0": 8, "m1_d2": 8, "m4_d1": 40, "m2_p050_d1": 16, "m2_p050_d0": 16, "m4_p025": 32}
    for label, extra in (("m1_d0", []), ("m1_d2", ["--pipeline-depth", "2"]),
                         ("m4_d1", ["--ticks-per-dispatch", "4", "--pipeline-depth", "1"]),
                         ("m2_p050_d1", ["--ticks-per-dispatch", "2", "--control-period", "0.05",
                                         "--pipeline-depth", "1"]),
                         ("m2_p050_d0", ["--ticks-per-dispatch", "2", "--control-period", "0.05"]),
                         ("m4_p025", ["--ticks-per-dispatch", "4", "--control-period", "0.025"])):
        mppi_cuda.reset_launches()
        t_start = time.perf_counter()
        summary = cli.main(["serve", "--sim-mcu", "--robots", "8", "--k", "8192", "--time-scale", "0.2",
                            "--t-end", "1.0", "--seed", "3", "--report-every", "100", *extra])
        torch.cuda.synchronize()
        counts = dict(mppi_cuda.launches)
        serve_runs[label] = (summary, counts)
        # every dispatch, and the solve before traffic, is one batched launch
        check(counts["mppi_solve_batch_fused"] == counts["model:CartPoleShaped4"] == summary["dispatches"] + 1
              and summary["dispatches"] > 0,
              f"serve {label}: launches {counts['mppi_solve_batch_fused']}, dispatches {summary['dispatches']}")
        check(all(v > 0 for v in summary["rx"]) and all(v > 0 for v in summary["tx"]),
              f"serve {label}: a link without frames: rx {summary['rx']} tx {summary['tx']}")
        check(summary["bad_frames"] == 0, f"serve {label}: {summary['bad_frames']} bad frames")
        check(summary["horizon"] == want_horizon[label], f"serve {label}: N={summary['horizon']}")
        emit({"phase": "serve", "case": label, "robots": 8, "k": 8192, "time_scale": 0.2,
              "horizon": summary["horizon"], "ticks_per_s": summary["ticks_per_s"],
              "dispatches_per_s": summary["dispatches_per_s"], "solve_ms_p50": summary["solve_ms_p50"],
              "dispatch_ms_p50": summary["dispatch_ms_p50"],
              "upright": sum(th < math.radians(60.0) for th in summary["max_abs_theta"]),
              "ticks": summary["ticks"], "dispatches": summary["dispatches"],
              "launches": {key: v for key, v in counts.items() if v}, "wall_s": time.perf_counter() - t_start,
              **card})

    # timings: one batched launch of serve's shapes at N = 8 and at every
    # plan-streaming N = 9-40 (device time by torch.profiler, a call by CUDA
    # events), the plain version, the bound
    timing = {}
    for nn in range(8, 41):
        m = CartPoleShaped4(CartPoleParams.single_wheel(), 0.1) if nn == 8 else serve_model(nn)
        cfg = serve_cfg(nn, 0.5)
        x8, u8 = xs.clone(), torch.zeros((b, nn), device=dev)
        call = lambda: mppi_cuda.mppi_solve_batch_fused(cfg, m, x8, u8, seeds=seeds, sampler="box-muller")  # noqa: E731
        plain = lambda: mppi_cuda.finalize_batch_plain(cfg, mppi_cuda.mppi_batch_partials_plain(  # noqa: E731
            cfg, m, x8, u8, mppi_cuda.batch_noise(cfg, m, seeds, "box-muller")))
        dev_us = 1e3 * device_ms(call)
        kern = median_ms(call, reps=20)
        plain_t = median_ms(plain, reps=5, warmup=1)
        timing[nn] = (kern, plain_t, bound(flops_of(plain), nbytes(x8, u8, seeds, u8) + 4 * b), dev_us)
        emit({"phase": "timing_serve_batch", "n": nn, "b": b, "k": k, "rollouts_per_thread":
              mppi_cuda.rollouts_per_thread(k, b, m, nn), "device_us": dev_us, "event_us": 1e3 * kern,
              "plain_us": 1e3 * plain_t, **timing[nn][2], **card})
    check(native_digests() == native_before, "native/ changed during the run")
    kern, plain_t, bnd, _ = timing[40]
    streamed = {16: sum(serve_runs[label][1]["mppi_solve_batch_fused"] for label in ("m2_p050_d1", "m2_p050_d0")),
                32: serve_runs["m4_p025"][1]["mppi_solve_batch_fused"],
                40: serve_runs["m4_d1"][1]["mppi_solve_batch_fused"]}
    return [
        {"name": "mppi_horizons_kernel: the cart-pole at serve's N = 9-40, one kernel that takes N at run time, on B "
                 "problems (K5/K6, serve plan streaming, B=8, K=8192, box-muller; the top-level numbers at N = 40, "
                 "every N in per_n)", "route": "cuda", "source": HORIZONS_SOURCE, "replaces": f"{PALLAS}:692",
         "launches": sum(streamed.values()), "launches_by_n": streamed,
         "max_abs_err": max(horizon_err.values()), "ms": kern, "plain_ms": plain_t, "bound_ms": bnd["bound_ms"],
         "bound_by": bnd["bound_by"], "library_ms": None,
         "per_n": {n_: {"max_abs_err": horizon_err[n_], "device_us": timing[n_][3], "ms": timing[n_][0],
                        "plain_ms": timing[n_][1], "bound_ms": timing[n_][2]["bound_ms"],
                        "bound_by": timing[n_][2]["bound_by"], "registers": occupancy[n_]["registers"],
                        "blocks_per_sm": occupancy[n_]["blocks_per_sm"]} for n_ in range(9, 41)}},
    ]



# The estimator ladder's apps, held to their acceptance checks
# (mpc_rs_tpu_torch/apps/acceptance.py, the JAX package's SPECS and checks).
LADDER_APPS = ("one-liner-kf", "two-liner-kf", "ukf-one", "ukf-two", "ukf-pen", "ukf-pen2", "ukf-pen3", "pid")


# The smoke run's parity band: it fails on no survival-interval overlap or a
# KS p at or below 1e-3, the band the JAX package's small-N re-check holds
# (tests/test_parity_dist.py:40,59). The reference's pass rule (both p > 0.01)
# decides the 200-episode entries of PARITY_DIST_TORCH.json.
PARITY_KS_P_MIN = 1e-3
PARITY_EPISODES = 200


def fleet_finish_phases(dev: torch.device, card: dict) -> None:
    """The fleet slice's last paths and the estimator ladder: the oracle
    loaded read-only and one recorded episode re-derived bit for bit;
    200-episode parity of the cartpole4 and flagship fleets (torch-op
    estimator and K7) against the oracle's recorded episodes; the AoS fleet
    under each sigma root at the JAX gates; a resumed fleet against the
    uninterrupted one, bit for bit; the eight ladder apps through the CLI
    entry at their acceptance criteria. Each path runs with the launch
    counts set to 0 just before it and read just after."""
    from mpc_rs_tpu_torch.apps import acceptance
    from mpc_rs_tpu_torch.apps import run as cli
    from mpc_rs_tpu_torch.apps.fleet import build_fleet, resume_fleet, run_fleet
    from mpc_rs_tpu_torch.ops import estimator_cuda, mppi_cuda
    from mpc_rs_tpu_torch.runtime.checkpoint import carry_fields, load_fleet
    from mpc_rs_tpu_torch.scripts import oracle
    from mpc_rs_tpu_torch.scripts import parity_dist as pd

    def counted(fn):
        mppi_cuda.reset_launches()
        estimator_cuda.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        counts = {k: v for k, v in {**mppi_cuda.launches, **estimator_cuda.launches}.items() if v}
        return out, counts, time.perf_counter() - t0

    native_before = native_digests()

    # P1. the oracle, read-only, and cartpole4-est seed 5000 against the record
    t0 = time.perf_counter()
    native = oracle.oracle_library()
    stamp = native.path.with_name(native.path.name + ".src.sha256")
    fresh = pd.oracle_episode("cartpole4-est", pd.ORACLE_SEED["cartpole4-est"])
    recorded = pd.recorded_oracle("cartpole4-est")[0]
    check(fresh == recorded, f"the oracle's cartpole4-est seed 5000 {fresh} is not the record's {recorded}")
    emit({"phase": "parity_oracle_record", "library": str(native.path), "built": native.built,
          "source_sha256": native.digest, "stamp": stamp.read_text().strip() if stamp.is_file() else None,
          "episode": fresh, "equals_record": True, "seconds": time.perf_counter() - t0})

    # P2. 200 episodes a config and estimator against the 200 recorded oracle episodes
    record = json.loads(Path(pd.RECORD).read_text())
    for config in ("cartpole4-est", "flagship-est"):
        ora = pd.recorded_oracle(config)
        ticks = pd.N_TICKS[config]
        for est in ("torch", "chain"):
            eps, counts, secs = counted(lambda: pd.run_library_fleet(config, PARITY_EPISODES, dev, est))
            s = pd.summarize(eps, ora)
            check(counts.get("mppi_solve_batch_fused") == ticks
                  and counts.get("estimator_chain_fused", 0) == (ticks if est == "chain" else 0),
                  f"parity {config} {est}: launches {counts} for {ticks} ticks")
            p_rms, p_max = s["tests"]["ks_rms_theta"]["p"], s["tests"]["ks_max_theta"]["p"]
            row = {"phase": f"parity_{config.replace('-', '_')}", "estimator": est, "episodes": PARITY_EPISODES,
                   "oracle_episodes": len(ora), "ticks": ticks,
                   **{side: {"survival": s[side]["survival"], "rms_theta_mean": s[side]["rms_theta_mean"],
                             "max_theta_p99": s[side]["max_theta_p99"]} for side in ("library", "oracle")},
                   "ks_rms_theta": s["tests"]["ks_rms_theta"], "ks_max_theta": s["tests"]["ks_max_theta"],
                   "survival_ci_overlap": s["tests"]["survival_ci_overlap"], "pass_rule_p_above_0.01": s["pass"],
                   "jax_tpu_record": {"library_rms_theta_mean": record[config]["library"]["rms_theta_mean"],
                                      "oracle_rms_theta_mean": record[config]["oracle"]["rms_theta_mean"],
                                      "ks_rms_p": record[config]["tests"]["ks_rms_theta"]["p"],
                                      "ks_max_p": record[config]["tests"]["ks_max_theta"]["p"]},
                   "launches": counts, "seconds": secs, **card}
            emit(row)
            check(s["tests"]["survival_ci_overlap"], f"parity {config} {est}: the survival intervals do not overlap")
            check(min(p_rms, p_max) > PARITY_KS_P_MIN,
                  f"parity {config} {est}: KS p {p_rms} (θ-RMS), {p_max} (max|θ|) at or below {PARITY_KS_P_MIN}")

    # P3. the AoS fleet through the CLI entry at B = 1024, under each root
    for model, root, t_end, gate in (("flagship6", "eigh", 3, 0.95), ("flagship6", "jacobi", 3, 0.95),
                                     ("flagship6", "cholesky", 3, 0.95), ("cartpole4", "eigh", 10, 0.99)):
        res, counts, secs = counted(lambda: cli.main(
            ["fleet", "--model", model, "--scenarios", "1024", "--t-end", str(t_end), "--ukf-layout", "aos",
             "--sqrt-method", root, "--log-dir", "logs/chip_smoke_fleet_aos"]))
        tick_ms = sorted(1e3 * t for t in res.tick_seconds)
        emit({"phase": "fleet_aos", "model": model, "sqrt_method": root, "scenarios": res.scenarios,
              "ticks": res.ticks, "survival": res.survival, "survived": res.scenarios - res.tipped,
              "statuses_ok": res.statuses_ok, "median_max_theta": res.median_max_theta,
              "tick_ms_median": statistics.median(tick_ms), "tick_ms_p99": tick_ms[int(0.99 * len(tick_ms))],
              "scenario_ticks_per_s": res.scenario_ticks_per_s, "launches": counts, "seconds": secs, **card})
        check(res.survival >= gate and res.statuses_ok,
              f"AoS fleet {model} {root}: survival {res.survival} (gate {gate}), statuses ok {res.statuses_ok}")
        check(counts.get("mppi_solve_batch_fused") == res.ticks and "estimator_chain_fused" not in counts,
              f"AoS fleet {model} {root}: launches {counts} for {res.ticks} ticks")

    # P4. resume: two chunks straight against one chunk, --resume, one chunk
    t0 = time.perf_counter()
    d = Path("logs/chip_smoke_resume")
    base = ["fleet", "--model", "cartpole4", "--scenarios", "1024", "--report-every", "1"]
    def straight_then_resumed():
        straight = cli.main([*base, "--t-end", "2", "--log-dir", str(d / "a")])
        cli.main([*base, "--t-end", "1", "--log-dir", str(d / "b")])
        return straight, cli.main([*base, "--t-end", "1", "--log-dir", str(d / "c"),
                                   "--resume", str(d / "b" / "fleet" / "fleet.pt")])

    (straight, resumed), counts, _ = counted(straight_then_resumed)
    template = build_fleet("cartpole4", None, dev, scenarios=1024).carry
    (ca, ga), (cc, gc) = (load_fleet(str(d / x / "fleet" / "fleet.pt"), template, dev) for x in ("a", "c"))
    fa, fr, fca, fcc = carry_fields(straight.carry), carry_fields(resumed.carry), carry_fields(ca), carry_fields(cc)
    same = (all(torch.equal(fa[k], fr[k]) and torch.equal(fca[k], fcc[k]) for k in fa)
            and torch.equal(ga.get_state(), gc.get_state()))
    check(same, "the resumed cartpole4 fleet differs from the uninterrupted one")
    check(counts.get("mppi_solve_batch_fused") == straight.ticks + 2 * resumed.ticks,
          f"resume: launches {counts}")

    def chain_fleet():
        return build_fleet("flagship6", None, dev, scenarios=1024, estimator_chain=True, seed=3)

    ckpt = str(d / "chain" / "fleet.pt")
    straight_chain = run_fleet(chain_fleet(), t_end=0.4, report_every=0.2)
    run_fleet(chain_fleet(), t_end=0.2, report_every=0.2, checkpoint=ckpt)
    resumed_chain = run_fleet(resume_fleet(chain_fleet(), ckpt, seed=0), t_end=0.2, report_every=0.2)
    fa, fr = carry_fields(straight_chain.carry), carry_fields(resumed_chain.carry)
    check(all(torch.equal(fa[k], fr[k]) for k in fa), "the resumed flagship chain fleet differs")
    emit({"phase": "fleet_resume", "cartpole4_ticks": [straight.ticks, resumed.ticks],
          "flagship6_chain_ticks": [straight_chain.ticks, resumed_chain.ticks], "bit_for_bit": True,
          "generator_state_equal": True, "launches_cartpole4": counts, "seconds": time.perf_counter() - t0})

    # P5. the estimator ladder through the CLI entry, float64 on the card, at
    # its acceptance criteria (seed 0, held); seeds 1-4 reported
    for app in LADDER_APPS:
        check_fn = acceptance.SPECS[app][2]
        extra = ["--log-dir", "logs/chip_smoke_ladder"] if app == "pid" else []
        verdicts, secs = [], []
        for seed in range(5):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                (ret, counts, _) = counted(lambda: cli.main([app, "--seed", str(seed), *extra]))
            secs.append(time.perf_counter() - t0)
            verdicts.append(bool(check_fn(ret, buf.getvalue())))
        emit({"phase": "estimator_ladder", "app": app, "device": str(dev), "passes_seed_0": verdicts[0],
              "passes_seeds_0_4": verdicts, "seconds": secs, "launches": counts})
        check(verdicts[0], f"{app} at seed 0 fails its acceptance criterion")
    check(native_digests() == native_before, "native/ changed during the run")

# --------------------------------------------------------------------------
# gradient MPC: the six mpc_examples apps, the QP fleet and qp-parking, each
# app held to its acceptance check (mpc_rs_tpu_torch/apps/acceptance.py).

PANOC_BUDGET_S = 0.03  # the reference's real-time budget a PANOC solve (SURVEY §6)
OP_MPC_X_TICKS = 10  # op-mpc-x's prefix on the card (of 1 001 ticks, ~0.7 s each)
NOISE_ITERS = 30  # past this many iterations a condensed-QP PANOC solve is noise-driven
# how far from the optimum op-mpc-x-calc's tol-1e-6 stop can be: 2·√n·tol/λ_min(2H), λ_min = 0.1254
CALC_RADIUS = 2.0 * math.sqrt(8) * 1e-6 / 0.1253964616268916
MPC_APPS = ("op-en2", "op-mpc-x", "op-mpc-x-calc", "op-mpc-x-calc-nl", "mpc-ukf-x", "mpc-ukf-s")


def gradient_mpc_phases(dev: torch.device, card: dict) -> None:
    """The gradient-MPC slice (float64 solves in batched torch ops, no
    kernel of its own): the six apps through the CLI entry (op-mpc-x's
    first OP_MPC_X_TICKS ticks through its library function) at their JAX
    acceptance criteria with each app's solve times and PANOC iterations
    beside the 0.03 s budget; op-mpc-x-calc-nl on the card against the CPU;
    the QP fleet at B = 1024 on both solvers; 200 qp-parking episodes
    against a fresh oracle. Each path runs with the launch counts set to 0
    just before it and read just after: none launches a kernel of the port."""
    import types

    import numpy as np

    from mpc_rs_tpu_torch.apps import acceptance
    from mpc_rs_tpu_torch.apps import mpc_examples as me
    from mpc_rs_tpu_torch.apps import run as cli
    from mpc_rs_tpu_torch.apps.fleet import build_qp_fleet
    from mpc_rs_tpu_torch.controllers import panoc
    from mpc_rs_tpu_torch.controllers.qp import box_qp_newton, build_condensed_qp, qp_linear_term
    from mpc_rs_tpu_torch.models import dynamics, reference
    from mpc_rs_tpu_torch.models.params import CartPoleParams
    from mpc_rs_tpu_torch.ops import estimator_cuda, mppi_cuda
    from mpc_rs_tpu_torch.runtime.profile_tick import _union_us
    from mpc_rs_tpu_torch.scripts import parity_dist as pd

    def counted(fn):
        mppi_cuda.reset_launches()
        estimator_cuda.reset_launches()
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = fn()
        torch.cuda.synchronize()
        counts = {k: v for k, v in {**mppi_cuda.launches, **estimator_cuda.launches}.items() if v}
        check(not counts, f"a gradient-MPC path launched the port's kernels: {counts}")
        return out, buf.getvalue(), time.perf_counter() - t0

    def solve_stats(log) -> dict:
        it = sorted(log.iterations)
        return {**ms_quantiles(log.seconds), "solves": len(it), "iterations_median": statistics.median(it),
                "iterations_max": it[-1], "budget_ms": 1e3 * PANOC_BUDGET_S,
                "solves_within_budget": sum(s <= PANOC_BUDGET_S for s in log.seconds) / len(log.seconds)}

    # a host read-back of a device flag after one small kernel: what each of
    # PANOC's loop conditions costs on the card
    flag = torch.zeros(1, device=dev)
    readback_s = []
    for _ in range(200):
        t0 = time.perf_counter()
        flag.add_(1.0)
        bool((flag > 0).any())
        readback_s.append(time.perf_counter() - t0)
    readback_us = 1e3 * ms_quantiles(readback_s)["median_ms"]
    emit({"phase": "mpc_readback", "readback_us_median": readback_us, **card})

    logs = "logs/chip_smoke_mpc"
    # G1. the six apps on the card at their acceptance criteria
    for app in MPC_APPS:
        panoc.reset_readbacks()
        if app == "op-mpc-x":
            args = types.SimpleNamespace(device="cuda", max_iter=None, fd=False, log_dir=logs)
            ret, out, secs = counted(lambda: me.run_op_mpc_x(args, max_ticks=OP_MPC_X_TICKS))
            ok = acceptance._finite(ret.x) and "Error:" not in out and ret.ticks == OP_MPC_X_TICKS
            verdict = f"{OP_MPC_X_TICKS} of 1001 ticks finite, no bail (chk_parks needs all 1001)"
        else:
            argv = [app] + ([] if app == "op-en2" else ["--log-dir", logs])
            ret, out, secs = counted(lambda: cli.main(argv))
            chk = acceptance.SPECS[app][2]
            ok, verdict = bool(chk(ret, out)), chk.__name__
        row = {"phase": "mpc_app", "app": app, "device": str(dev), "passes": bool(ok), "criterion": verdict,
               "seconds": secs, **card}
        if app == "op-en2":
            row.update(iterations=int(ret.iterations), u=ret.u.cpu().tolist())
        else:
            stats = solve_stats(ret.log)
            per_solve = panoc.readbacks / stats["solves"]
            row.update(ticks=getattr(ret, "ticks", getattr(ret, "n_solves", None)), final_x=list(map(float, ret.x)),
                       solve=stats, readbacks_per_solve=per_solve, graph_replays_per_solve=panoc.replays / stats["solves"],
                       readback_share_of_median_solve=per_solve * readback_us / (1e3 * stats["median_ms"]))
        emit(row)
        check(ok, f"{app} on the card fails its acceptance criterion {verdict}")

    # G2. op-mpc-x-calc-nl on the card against the CPU: both apps, then the
    # card's solve at every CPU tick's state and warm start
    runs = {}
    for d in ("cuda", "cpu"):
        ret, out, _ = counted(lambda: cli.main(["op-mpc-x-calc-nl", "--device", d, "--log-dir", f"{logs}/{d}"]))
        runs[d] = (ret, bool(acceptance.SPECS["op-mpc-x-calc-nl"][2](ret, out)))
    solve_cpu, _ = me.op_mpc_x_calc_controller("cpu")
    solve_dev, _ = me.op_mpc_x_calc_controller(dev)
    p = CartPoleParams.single_wheel()
    plant = dynamics.as_vector_fn(dynamics.make_cartpole_nonlinear(p, 0.1), 4)
    a, bm = dynamics.linear_ab(p, 0.1)
    qp = build_condensed_qp(a, bm, np.diag([5.0, 5.0, 1.0, 1.0]), 8)
    gen_ref = reference.make_gen_ref_raised_cosine(8)
    x, u = torch.tensor([0.5, 0.0, 0.1, 0.0], dtype=torch.float64), torch.zeros(8, dtype=torch.float64)
    clean_err, noisy_err, noisy, iters_equal = 0.0, 0.0, 0, 0
    for _ in range(51):
        rc = solve_cpu(x, u)
        rd = solve_dev(x.to(dev), u.to(dev))
        ud = rd.u.cpu()
        if int(rc.iterations) <= NOISE_ITERS:
            check(int(rd.iterations) == int(rc.iterations), f"op-mpc-x-calc-nl: card {int(rd.iterations)} "
                  f"iterations against the CPU's {int(rc.iterations)}")
            clean_err = max(clean_err, float((ud - rc.u).abs().max()))
        else:  # noise-driven: both within CALC_RADIUS of the exact optimum
            noisy += 1
            u_star = box_qp_newton(qp.h, qp_linear_term(qp, x, gen_ref(x).flatten(-2)), torch.zeros(8, dtype=torch.float64),
                                   -30.0, 30.0)
            noisy_err = max(noisy_err, float((ud - u_star).abs().max()), float((rc.u - u_star).abs().max()))
        iters_equal += int(rd.iterations) == int(rc.iterations)
        u = rc.u
        x = plant(x, float(u[0]))
    traj_err = float(np.abs(runs["cuda"][0].x - runs["cpu"][0].x).max())
    emit({"phase": "mpc_calc_nl_card_vs_cpu", "ticks": 51, "clean_ticks": 51 - noisy, "noise_driven_ticks": noisy,
          "iterations_equal_ticks": iters_equal, "clean_max_abs_u_err": clean_err,
          "noise_driven_max_abs_u_from_optimum": noisy_err, "final_state_max_abs_diff": traj_err,
          "card_parks": runs["cuda"][1], "cpu_parks": runs["cpu"][1], **card})
    check(clean_err <= 1e-9, f"op-mpc-x-calc-nl: card against CPU {clean_err} on a clean tick (1e-9)")
    check(noisy_err <= CALC_RADIUS, f"op-mpc-x-calc-nl: {noisy_err} from the optimum on a noise-driven tick "
                                    f"({CALC_RADIUS})")
    check(runs["cuda"][1] and runs["cpu"][1] and traj_err <= 1e-5,
          f"op-mpc-x-calc-nl: verdicts {runs['cuda'][1]}, {runs['cpu'][1]}, final states {traj_err} apart")

    # G3. the QP fleet at B = 1024, 3 s, through the CLI entry on both solvers,
    # then its tick timed and profiled; one shared tick's Newton against PANOC
    # apps/acceptance.py's fleet-qp gate is parked >= 0.95 and upright 1.0 at
    # B = 64; at B = 1024 the tail of x0 (|θ0| up to 0.8 rad) tips a few
    # scenarios in 3 s in the JAX package's own fleets (Newton upright
    # 0.998-1.0 over seeds 0-3; float32 PANOC 0.996 at B = 512:
    # tests/gradient_mpc_properties.py --fleet), so upright is gated at 0.99
    gates = {"newton": (0.95, 0.99), "panoc": (0.95, 0.99)}
    for solver, (park_min, up_min) in gates.items():
        res, out, secs = counted(lambda: cli.main(["fleet", "--controller", "qp", "--qp-solver", solver,
                                                   "--scenarios", "1024", "--t-end", "3"]))
        fl = build_qp_fleet(1024, dev, solver=solver)
        carry = fl.tick(fl.carry)
        torch.cuda.synchronize()
        tick_s = []
        for _ in range(20 if solver == "newton" else 10):
            t0 = time.perf_counter()
            carry = fl.tick(carry)
            torch.cuda.synchronize()
            tick_s.append(time.perf_counter() - t0)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(PROFILED):
                for _ in range(5):
                    carry = fl.tick(carry)
                torch.cuda.synchronize()
        span = next(e.time_range for e in prof.events() if e.name == PROFILED)
        device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.name != PROFILED and span.start <= e.time_range.start <= span.end]
        busy = _union_us((e.time_range.start, min(e.time_range.end, span.end)) for e in device)
        emit({"phase": "qp_fleet", "solver": solver, "scenarios": res.scenarios, "ticks": res.ticks,
              "parked": res.parked, "upright": res.upright, "median_abs_x": res.median_abs_x,
              "scenario_ticks_per_s": res.scenario_ticks_per_s, "tick": ms_quantiles(tick_s),
              "device_launches_per_tick": len(device) / 5 if device else "not measured",
              "device_busy_share": busy / span.elapsed_us() if device else "not measured",
              "gate": {"parked_min": park_min, "upright_min": up_min}, "seconds": secs, **card})
        check(res.parked >= park_min and res.upright >= up_min,
              f"QP fleet {solver}: parked {res.parked} (gate {park_min}), upright {res.upright} (gate {up_min})")
    shared = build_qp_fleet(1024, dev, solver="newton").carry
    u_newton = build_qp_fleet(1024, dev, solver="newton").tick(shared)[1]
    u_panoc = build_qp_fleet(1024, dev, solver="panoc").tick(shared)[1]
    emit({"phase": "qp_fleet_newton_vs_panoc", "scenarios": 1024,
          "max_abs_du": float((u_newton - u_panoc).abs().max()),
          "median_abs_du": float((u_newton - u_panoc).abs().amax(dim=1).median()), **card})

    # G4. qp-parking, 200 episodes on the card against a fresh oracle
    entry, _, secs = counted(lambda: pd.run_qp_parking(PARITY_EPISODES, dev, jobs=8))
    entry.update({"ic_seed": pd.QP_IC_SEED, "ticks": pd.QP_TICKS, "oracle_source": "fresh", "seconds": secs,
                  "device": torch.cuda.get_device_name(dev), "nvidia_smi": nvidia_smi_line()})
    emit({"phase": "parity_qp_parking", **entry})
    check(entry["flag_agreement"] == 1.0 and entry["library_park_rate"] == 1.0 and entry["oracle_park_rate"] == 1.0
          and entry["max_final_state_diff"] < 1e-4, f"qp-parking: {entry}")
    pd.write_entry(str(pd.OUT), pd.QP_PARKING, entry)


# --------------------------------------------------------------------------
# tune's sweep, mpc-ukf-commu, and the acceptance harness

TUNE_GRID = ((0.1, 0.5, 1.4, 2.5), (1.0, 3.0, 10.0), 8)  # tune's default λ, σ and seeds: B = 96
TUNE_K = 800_000  # the main path's K (mppi4-non-liner, mppi4-commu)
PACKET_PERIOD_S = 0.01  # the HIL apps' 100 Hz sensor stream
ACCEPTANCE_SUBSET = "tune,mpc-ukf-commu,uart,mppi4-commu,serve-stream,op-en2"


SWEEP_MAIN_HORIZONS = (20, 40)  # make_sweep(n_horizon=N) driven as a main path past tune's N = 8
SWEEP_MAIN_TICKS = 50
SWEEP_MAIN_PIECE = 12  # problems a piece of the float64 plain version at K = 800 000 (3 GB a (12, K, 40) tensor)


def sweep_horizon(n: int) -> tuple[float, float]:
    """(step dt, λ scale) of the per-horizon checks: tune's 0.1 s and its λ
    up to N = 8; past it 0.8 s / N, so the horizon spans tune's 0.8 s, and
    λ times N/8, as a rollout's cost sums N stage costs over those 0.8 s
    (``tests/test_torch_tune.py::_horizon``)."""
    return (0.1, 1.0) if n <= N else (0.8 / n, n / N)


def tune_phases(dev: torch.device, card: dict, log: str) -> list[dict]:
    """tune's sweep launch (``mppi_sweep_kernel``, ``ops/csrc/sweep.cuh``:
    one kernel for every horizon and both noise sources): its ptxas
    registers and no spill, and its blocks an SM at N = 1, 8, 20, 40 and
    the largest (at least 4 up to N = 40); at tune's default grid (B = 96)
    and K = 1 024 and 800 000, each noise source at 1 and 4 tiles a block
    and the wrapper's, against its float64 plain version (in-kernel
    box-muller against ``sweep_noise``'s words), and the failure probes;
    every N of 1-40, 41, 64 and the largest at K = 4 096 against the
    float64 plain version, both noise sources, at the wrapper's tiles and at
    4; then, as main paths through the CLI entry
    (counts reset before, read after), tune at its acceptance spec and at
    the default grid at K = 800 000 over 100 ticks, one launch a tick
    (torch.profiler: one sweep kernel in a tick), and ``make_sweep(k=800 000,
    n_horizon=N)`` over the default grid at N = 20 and 40 for 50 ticks, one
    launch a tick each, and that launch at B = 96, K = 800 000 against the
    float64 plain version (held in the band or twice the plain float32
    distance at T2b's dt and λ; at the main path's own, its statuses, ESS
    and the distance beside the float64 answer's move). Returns the kernels line's entries (N = 8, 20,
    40)."""
    import numpy as np

    from mpc_rs_tpu_torch.apps import acceptance, tune
    from mpc_rs_tpu_torch.apps import run as cli
    from mpc_rs_tpu_torch.controllers.mppi import MppiConfig, MppiStatus
    from mpc_rs_tpu_torch.models.params import CartPoleParams
    from mpc_rs_tpu_torch.ops import mppi_cuda
    from mpc_rs_tpu_torch.ops.mppi_cuda import CartPoleShaped4
    from mpc_rs_tpu_torch.runtime.profile_sweep import sweep_ptxas as sweep_ptxas_rows

    # T1. the sweep's one kernel, for every horizon and both noise sources:
    # its registers, no spill, and its blocks an SM at the launch's shared
    # memory (at tune's grid's 16 tiles a block, and one at the largest N)
    model = CartPoleShaped4(CartPoleParams.single_wheel(), 0.1)
    sweep_rows = sweep_ptxas_rows(log)
    occupancy = [mppi_cuda.sweep_occupancy(n, mppi_cuda.sweep_tiles(TUNE_K, 96, dev), dev) for n in (1, 8, 20, 40)]
    occupancy.append(mppi_cuda.sweep_occupancy(mppi_cuda.SWEEP_MAX_HORIZON, 1, dev))
    emit({"phase": "ptxas_sweep", "instantiations": len(sweep_rows), "ptxas": sweep_rows, "occupancy": occupancy})
    check(len(sweep_rows) == 1 and sweep_rows[0].get("registers", 255) <= 64,
          f"the sweep kernel in the ptxas report: {sweep_rows} (one kernel, at most 64 registers)")
    check(not any(r.get("spill_bytes") for r in sweep_rows), f"ptxas spills in the sweep kernel: {sweep_rows}")
    check(all(r["blocks_per_sm"] >= 4 for r in occupancy[:-1]) and occupancy[-1]["blocks_per_sm"] >= 1,
          f"the sweep kernel's blocks an SM: {occupancy}")
    check(all(r["shared_bytes"] == mppi_cuda.sweep_shared_bytes(r["n"], r["tiles"]) for r in occupancy),
          f"the sweep launch's shared bytes (C side) against sweep_shared_bytes: {occupancy}")

    lams, sigs, n_seeds = TUNE_GRID
    grid = [(lam, sig, r) for lam in lams for sig in sigs for r in range(n_seeds)]
    lam = torch.tensor([g[0] for g in grid], dtype=torch.float32, device=dev)
    sig = torch.tensor([g[1] for g in grid], dtype=torch.float32, device=dev)
    seeds = torch.tensor([g[2] for g in grid], dtype=torch.int32, device=dev)
    b = lam.numel()

    def cfg(k):  # the sweep reads N, K and the box; λ and σ are the problems' own
        return MppiConfig(n_horizon=N, n_rollouts=k, lambda_=1.0, std_dev=1.0, limit=(-20.0, 20.0))

    # T2. the launch against its float64 plain version: in the f32 band, or,
    # in the grid's cells where the float32 problem is ill-conditioned (λ =
    # 0.1 at σ = 10 weighs one or two rollouts), within twice the plain
    # float32 version's own distance
    gen = torch.Generator(device=dev).manual_seed(1313)
    err = 0.0
    for k in (1024, TUNE_K):
        xs = torch.randn((b, 4), generator=gen, device=dev) * torch.tensor([0.3, 0.1, 0.1, 0.1], device=dev)
        u_ns = torch.randn((b, N), generator=gen, device=dev)
        for source in ("external", "box-muller"):
            if source == "external":
                noise = torch.randn((b, k, N), generator=gen, device=dev) * sig[:, None, None]
                kw = dict(noise=noise)
            else:
                noise, kw = mppi_cuda.sweep_noise(cfg(k), seeds, 9, sig), dict(seeds=seeds, solve=9)
            row = {"phase": "sweep_vs_plain", "b": b, "k": k, "noise": source,
                   "wrapper_tiles": mppi_cuda.sweep_tiles(k, b, dev)}
            for tiles in (1, 4, None):
                u, st, ess = mppi_cuda.mppi_sweep_batch_fused(cfg(k), model, xs, u_ns, lam, sig,
                                                              tiles_per_block=tiles, **kw)
                want_u, want_st, want_ess = mppi_cuda.mppi_sweep_batch_plain(
                    cfg(k), model, xs.double(), u_ns.double(), lam, sig, noise=noise, tiles_per_block=tiles)
                u32, _, ess32 = mppi_cuda.mppi_sweep_batch_plain(cfg(k), model, xs, u_ns, lam, sig, noise=noise,
                                                                 tiles_per_block=tiles)
                what = f"sweep K={k} {source} tiles={tiles or 'wrapper'}"
                check(torch.equal(st, want_st) and bool((st == MppiStatus.OK).all()),
                      f"{what}: statuses {sorted(set(st.tolist()))}, plain {sorted(set(want_st.tolist()))}")
                e = max(check_band_or_own(u, want_u, u32, f"{what} u_n'"),
                        check_band_or_own(ess, want_ess, ess32, f"{what} ESS"))
                err = max(err, e)
                row[f"max_abs_err_tiles_{tiles or 'wrapper'}"] = e
                row[f"ess_range_tiles_{tiles or 'wrapper'}"] = [float(ess.min()), float(ess.max())]
            emit(row)
            del noise, kw
    check(bool((mppi_cuda.merge_tickets(dev, b) == 0).all()), "sweep tickets not zero")
    xs = torch.tensor(X0, device=dev).repeat(b, 1)
    xs[0, 0] = float("nan")
    lam0 = lam.clone()
    lam0[1] = 0.0
    u, st, ess = mppi_cuda.mppi_sweep_batch_fused(cfg(512), model, xs, torch.zeros((b, N), device=dev), lam0, sig,
                                                  seeds=seeds, solve=0)
    check(st[:3].tolist() == [MppiStatus.NO_FINITE, MppiStatus.INVALID_U, MppiStatus.OK]
          and bool((u[:2] == 0).all()) and float(ess[0]) == 0.0 and bool(torch.isnan(ess[1])),
          f"sweep probes: statuses {st[:3].tolist()}, ESS {ess[:3].tolist()}")
    emit({"phase": "sweep_failure_probes", "statuses": st[:3].tolist(), "ess": [float(v) for v in ess[:3]]})

    # T2b. every horizon of the sweep of N = 1-40, 41, 64 and the largest at K
    # = 4 096, at the wrapper's tiles (1) and, up to N = 21, at 4 (R = 4 up to
    # N = 10, 2 up to 20), both noise sources, against the float64 plain
    # version; box-muller's last pair is half used at odd N. The grid's σ
    # and seeds with λ ∈ {5, 20, 50, 200}: at tune's λ = 0.1-0.5 the softmax
    # weighs one or two rollouts, where float32 rounding alone moves u_n'
    # past the band and twice the plain float32 version's distance (held at
    # N = 8 above, as the serve horizons are held at λ = 20)
    k = 4096
    err_n = {}
    lam_wc = torch.tensor([(5.0, 20.0, 50.0, 200.0)[lams.index(g[0])] for g in grid], dtype=torch.float32,
                          device=dev)
    for n in (*range(1, 41), 41, 64, mppi_cuda.SWEEP_MAX_HORIZON):
        dt, scale = sweep_horizon(n)
        m_n = CartPoleShaped4(CartPoleParams.single_wheel(), dt)
        lam_n = lam_wc * scale
        cfg_n = MppiConfig(n_horizon=n, n_rollouts=k, lambda_=1.0, std_dev=1.0, limit=(-20.0, 20.0))
        xs = torch.randn((b, 4), generator=gen, device=dev) * torch.tensor([0.3, 0.1, 0.1, 0.1], device=dev)
        u_ns = torch.randn((b, n), generator=gen, device=dev)
        row = {"phase": "sweep_horizon_vs_plain", "n": n, "b": b, "k": k, "dt": dt, "lambdas": [5.0, 20.0, 50.0, 200.0],
               "lambda_scale": scale}
        for source in ("external", "box-muller"):
            if source == "external":
                noise = torch.randn((b, k, n), generator=gen, device=dev) * sig[:, None, None]
                kw = dict(noise=noise)
            else:
                noise, kw = mppi_cuda.sweep_noise(cfg_n, seeds, 11, sig), dict(seeds=seeds, solve=11)
            for tiles in (None, 4) if n <= 21 else (None,):  # past N = 20 a thread runs one rollout a tile
                u, st, ess = mppi_cuda.mppi_sweep_batch_fused(cfg_n, m_n, xs, u_ns, lam_n, sig,
                                                              tiles_per_block=tiles, **kw)
                want_u, want_st, want_ess = mppi_cuda.mppi_sweep_batch_plain(
                    cfg_n, m_n, xs.double(), u_ns.double(), lam_n, sig, noise=noise, tiles_per_block=tiles)
                u32, _, ess32 = mppi_cuda.mppi_sweep_batch_plain(cfg_n, m_n, xs, u_ns, lam_n, sig, noise=noise,
                                                                 tiles_per_block=tiles)
                what = f"sweep N={n} K={k} {source} tiles={tiles or 'wrapper'}"
                check(u.shape == (b, n) and torch.equal(st, want_st) and bool((st == MppiStatus.OK).all()),
                      f"{what}: statuses {sorted(set(st.tolist()))}, plain {sorted(set(want_st.tolist()))}")
                e = max(check_band_or_own(u, want_u, u32, f"{what} u_n'"),
                        check_band_or_own(ess, want_ess, ess32, f"{what} ESS"))
                err_n[n] = max(err_n.get(n, 0.0), e)
                row[f"max_abs_err_{source}_tiles_{tiles or 'wrapper'}"] = e
        emit(row)
    check(bool((mppi_cuda.merge_tickets(dev, b) == 0).all()), "sweep tickets not zero after the horizons")

    # T3. tune through the CLI entry: the acceptance spec, then the default grid at K = 800 000
    spec_argv = acceptance.SPECS["tune"][1]
    mppi_cuda.reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cells = cli.main(["tune", *spec_argv, "--log-dir", "logs/chip_smoke_tune"])
    spec_launches = mppi_cuda.launches["mppi_sweep_batch_fused"]
    check(acceptance.SPECS["tune"][2](cells, buf.getvalue()) and spec_launches == 20,
          f"tune at its acceptance spec: {cells}, {spec_launches} launches for 20 ticks")
    mppi_cuda.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cells = cli.main(["tune", "--k", str(TUNE_K), "--log-dir", "logs/chip_smoke_tune"])
    torch.cuda.synchronize()
    tune_s = time.perf_counter() - t0
    counts = {key: v for key, v in mppi_cuda.launches.items() if v}
    ticks = 100
    ref = next(c for c in cells if c["lambda"] == 0.5 and c["sigma"] == 3.0)
    check(counts == {"mppi_sweep_batch_fused": ticks, f"sweep:N={N}": ticks},
          f"tune: launches {counts} for {ticks} ticks")
    check(ref["survival"] == 1.0, f"tune: the (0.5, 3) cell survived {ref['survival']}")
    check(all(1.0 <= c["mean_ess"] <= TUNE_K for c in cells if c["mean_ess"] is not None),
          f"tune: a mean ESS outside [1, K]: {[c['mean_ess'] for c in cells]}")
    # one tick under torch.profiler: one sweep kernel, the plant step's torch ops
    one = tune.make_sweep(k=TUNE_K, n_ticks=1, device=dev)
    events = device_events(lambda: one(lam, sig, seeds))
    sweeps = [t for name, t in events if "mppi_sweep_kernel" in name]
    others = [t for name, t in events if "mppi_sweep_kernel" not in name and not name.startswith(("Memcpy", "Memset"))]
    check(len(sweeps) <= 1 and not any("mppi_partials_kernel" in name for name, _ in events),
          f"a tune tick launched {[name for name, _ in events]}")
    emit({"phase": "tune_main_path", "b": b, "k": TUNE_K, "ticks": ticks, "seconds": tune_s,
          "tick_ms_mean": 1e3 * tune_s / ticks, "cells": cells, "spec_launches": spec_launches, "launches": counts,
          "tick_sweep_kernels_caught": len(sweeps), "tick_sweep_device_us": sweeps,
          "tick_other_device_us": sum(others), "tick_other_kernels": len(others), **card})

    # T4. times at the main path's shape: the launch (device, events), its plain version, its bound
    cfg_k = cfg(TUNE_K)
    xs = torch.tensor(X0, device=dev).repeat(b, 1)
    u0 = torch.zeros((b, N), device=dev)
    call = lambda: mppi_cuda.mppi_sweep_batch_fused(cfg_k, model, xs, u0, lam, sig, seeds=seeds, solve=3)  # noqa: E731
    plain = lambda: mppi_cuda.mppi_sweep_batch_plain(cfg_k, model, xs, u0, lam, sig, seeds=seeds, solve=3)  # noqa: E731
    call()
    dev_us = [t for _, t in device_events(call, reps=5, keep=lambda name: "mppi_sweep_kernel" in name)]
    check(bool(dev_us), "torch.profiler caught no sweep kernel")
    kern_ms = statistics.median(dev_us) / 1e3
    event_ms = median_ms(call, reps=20)
    plain_ms = median_ms(plain, reps=3, warmup=1)
    n_bytes = nbytes(xs, u0, lam, sig, seeds) + nbytes(u0) + 4 * b + 4 * b  # in: x, u_n, λ, σ, seeds; out: u_n', status, ESS
    bnd = bound(flops_of(plain), n_bytes)
    tiles_main = mppi_cuda.sweep_tiles(TUNE_K, b, dev)
    emit({"phase": "timing_sweep", "n": N, "b": b, "k": TUNE_K, "kernel_device_ms": kern_ms,
          "kernel_event_ms": event_ms, "plain_ms": plain_ms, "tiles": tiles_main,
          "rollouts_a_thread": mppi_cuda.sweep_rollouts_a_thread(N, tiles_main), **bnd, **card})
    entries = [{"name": "mppi_sweep_kernel: tune's sweep, one kernel for every horizon, per-problem lambda and "
                        "sigma, ESS in the merge (mppi_sweep_batch_fused, N=8, B=96, K=800000)",
                "route": "cuda", "source": SWEEP_SOURCE, "replaces": f"{PALLAS}:692",
                "launches": counts["mppi_sweep_batch_fused"], "max_abs_err": max(err, err_n[N]), "ms": kern_ms,
                "plain_ms": plain_ms, "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"], "library_ms": None}]

    # T3b/T4b. past tune's N = 8: make_sweep(k=800 000, n_horizon=N) over the
    # default grid, a main path each (counts reset before, read after), then
    # one launch's device time, a call's CUDA-event time, the plain version
    # (in four pieces of 24 problems, so that its (B, K, N) tensors fit), the
    # bound of its operations, and the launch against its float64 plain
    # version at that shape (the kernels line's max_abs_err)
    for n in SWEEP_MAIN_HORIZONS:
        run = tune.make_sweep(k=TUNE_K, n_horizon=n, n_ticks=SWEEP_MAIN_TICKS, device=dev)
        mppi_cuda.reset_launches()
        t0 = time.perf_counter()
        survived, total_cost, mean_ess = run(lam, sig, seeds)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts_n = {key: v for key, v in mppi_cuda.launches.items() if v}
        check(counts_n == {"mppi_sweep_batch_fused": SWEEP_MAIN_TICKS, f"sweep:N={n}": SWEEP_MAIN_TICKS},
              f"make_sweep(n_horizon={n}): launches {counts_n} for {SWEEP_MAIN_TICKS} ticks")
        check(survived.shape == total_cost.shape == mean_ess.shape == (b,)
              and bool(torch.isfinite(total_cost).all()) and bool(torch.isfinite(mean_ess).all())
              and bool(((mean_ess >= 0.0) & (mean_ess <= TUNE_K)).all()),
              f"make_sweep(n_horizon={n}): cost {total_cost.tolist()}, ESS {mean_ess.tolist()}")
        cfg_n = MppiConfig(n_horizon=n, n_rollouts=TUNE_K, lambda_=1.0, std_dev=1.0, limit=(-20.0, 20.0))
        xs = torch.tensor(X0, device=dev).repeat(b, 1)
        u0 = torch.zeros((b, n), device=dev)
        call = lambda: mppi_cuda.mppi_sweep_batch_fused(cfg_n, model, xs, u0, lam, sig, seeds=seeds,  # noqa: E731
                                                        solve=3)
        pieces = [slice(i, i + b // 4) for i in range(0, b, b // 4)]
        plain = lambda: [mppi_cuda.mppi_sweep_batch_plain(cfg_n, model, xs[p], u0[p], lam[p], sig[p],  # noqa: E731
                                                          seeds=seeds[p], solve=3) for p in pieces]
        call()
        dev_us = [t for _, t in device_events(call, reps=3, keep=lambda name: "mppi_sweep_kernel" in name)]
        check(bool(dev_us), f"torch.profiler caught no sweep kernel at N={n}")
        kern_n = statistics.median(dev_us) / 1e3
        event_n = median_ms(call, reps=5, warmup=1)
        plain_n = median_ms(plain, reps=2, warmup=1)
        n_bytes = nbytes(xs, u0, lam, sig, seeds) + nbytes(u0) + 4 * b + 4 * b
        bnd_n = bound(flops_of(plain), n_bytes)
        # the same launch against its float64 plain version fed the kernel's
        # words (sweep_noise), in pieces of 12 problems, at the main path's
        # shape (B = 96, K = 800 000, R = 1: 3125 rows a problem, which the
        # block merges, in partials_end_wide with Σw² at N = 40), σ, seeds
        # and first tick (X0, u_n = 0, tick 3). (a) At the per-horizon
        # checks' dt = 0.8 s / N and λ ∈ {5, 20, 50, 200}·N/8 (T2b): in the
        # band or twice the plain float32 distance (the kernels line's
        # max_abs_err). (b) At the main path's dt = 0.1 and the grid's λ: the
        # statuses, ESS in [1, K] and u_n' in the box; the distance is
        # emitted beside the float64 answer's own move when every noise word
        # moves by 2^-24 (relative, seeded), not held: 2-4 s rollouts of the
        # cart-pole at σ = 1-10 are chaotic at float32's resolution, and
        # that move reaches the kernel's distance (PERF.md §6)
        dt_h, scale = sweep_horizon(n)
        gen_moved = torch.Generator(device=dev).manual_seed(17)
        err_main, err_free, moved_free = 0.0, 0.0, 0.0
        for m_p, lam_p, held in ((CartPoleShaped4(CartPoleParams.single_wheel(), dt_h), lam_wc * scale, True),
                                 (model, lam, False)):
            u, st, ess = mppi_cuda.mppi_sweep_batch_fused(cfg_n, m_p, xs, u0, lam_p, sig, seeds=seeds, solve=3)
            for p in (slice(i, i + SWEEP_MAIN_PIECE) for i in range(0, b, SWEEP_MAIN_PIECE)):
                noise = mppi_cuda.sweep_noise(cfg_n, seeds[p], 3, sig[p])
                plain64 = lambda nz: mppi_cuda.mppi_sweep_batch_plain(  # noqa: E731
                    cfg_n, m_p, xs[p].double(), u0[p].double(), lam_p[p], sig[p], noise=nz, tiles_per_block=tiles_main)
                want_u, want_st, want_ess = plain64(noise)
                what = (f"make_sweep(n_horizon={n}) launch, B={b} K={TUNE_K} dt={m_p.dt:.4g} problems "
                        f"{p.start}-{p.stop - 1}")
                check(torch.equal(st[p], want_st) and bool((st[p] == MppiStatus.OK).all()),
                      f"{what}: statuses {sorted(set(st[p].tolist()))}, plain {sorted(set(want_st.tolist()))}")
                if held:
                    u32, _, ess32 = mppi_cuda.mppi_sweep_batch_plain(cfg_n, m_p, xs[p], u0[p], lam_p[p], sig[p],
                                                                     noise=noise, tiles_per_block=tiles_main)
                    err_main = max(err_main, check_band_or_own(u[p], want_u, u32, f"{what} u_n'"),
                                   check_band_or_own(ess[p], want_ess, ess32, f"{what} ESS"))
                    del u32, ess32
                else:
                    check(bool(torch.isfinite(u[p]).all()) and bool(((u[p] >= -20.0) & (u[p] <= 20.0)).all())
                          and bool(((ess[p] >= 1.0) & (ess[p] <= TUNE_K)).all()),
                          f"{what}: u_n' outside the box or ESS {ess[p].tolist()} outside [1, K]")
                    moved = noise.double() * (1.0 + 2.0**-24 * torch.randn(
                        noise.shape, generator=gen_moved, device=dev, dtype=torch.float64))
                    err_free = max(err_free, max_err(u[p], want_u))
                    moved_free = max(moved_free, max_err(plain64(moved)[0], want_u))
                    del moved
                del noise, want_u, want_ess
            torch.cuda.empty_cache()
        surv = float(survived.float().mean())
        emit({"phase": "tune_main_path_horizon", "n": n, "b": b, "k": TUNE_K, "ticks": SWEEP_MAIN_TICKS,
              "seconds": run_s, "tick_ms_mean": 1e3 * run_s / SWEEP_MAIN_TICKS, "launches": counts_n,
              "survival": surv, "max_abs_err_vs_f64_plain": err_main, "held_at_dt": dt_h,
              "main_dt_max_abs_err_u": err_free, "main_dt_f64_moved_by_2^-24": moved_free, "kernel_device_ms": kern_n, "kernel_event_ms": event_n, "plain_ms": plain_n,
              "tiles": tiles_main, "rollouts_a_thread": mppi_cuda.sweep_rollouts_a_thread(n, tiles_main), **bnd_n,
              **card})
        entries.append({"name": f"mppi_sweep_kernel at N={n} (tune's make_sweep(n_horizon={n}), B=96, K=800000)",
                        "route": "cuda", "source": SWEEP_SOURCE, "replaces": f"{PALLAS}:692",
                        "launches": counts_n[f"sweep:N={n}"], "max_abs_err": err_main, "ms": kern_n,
                        "plain_ms": plain_n, "bound_ms": bnd_n["bound_ms"], "bound_by": bnd_n["bound_by"],
                        "library_ms": None})
        del run, survived, total_cost, mean_ess
        torch.cuda.empty_cache()
    return entries


def mpc_commu_phase(dev: torch.device, card: dict) -> None:
    """mpc-ukf-commu through the CLI entry at its acceptance spec's argv
    (``--sim-mcu --t-end 3 --time-scale 0.5``): at least 100 solves in the
    6 s window, its solve median and p99 against the 10 ms packet period,
    PANOC's iterations, read-backs and graph replays a solve."""
    from mpc_rs_tpu_torch.apps import acceptance
    from mpc_rs_tpu_torch.apps import run as cli
    from mpc_rs_tpu_torch.controllers import panoc
    from mpc_rs_tpu_torch.ops import estimator_cuda, mppi_cuda

    argv = acceptance.SPECS["mpc-ukf-commu"][1]
    mppi_cuda.reset_launches()
    estimator_cuda.reset_launches()
    panoc.reset_readbacks()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = cli.main(["mpc-ukf-commu", *argv])
    secs = time.perf_counter() - t0
    counts = {k: v for k, v in {**mppi_cuda.launches, **estimator_cuda.launches}.items() if v}
    passes = bool(acceptance.SPECS["mpc-ukf-commu"][2](res, buf.getvalue()))
    solves = res.solves + 1  # and the one before traffic
    it = sorted(res.iterations)
    emit({"phase": "hil_mpc_ukf_commu", "argv": argv, "solves": res.solves, "packets": res.packets,
          "passes_chk_packets_100": passes, "upright": res.upright, "finite": res.finite,
          "max_abs_theta": res.max_abs_theta, "plant_max_abs_theta": res.plant_max_abs_theta,
          "solve": ms_quantiles(res.solve_seconds), "est_step": ms_quantiles(res.est_seconds),
          "packet_period_ms": 1e3 * PACKET_PERIOD_S,
          "solves_within_packet_period": sum(t <= PACKET_PERIOD_S for t in res.solve_seconds) / len(res.solve_seconds),
          "iterations_median": statistics.median(it), "iterations_max": it[-1],
          "readbacks_per_solve": panoc.readbacks / solves, "graph_replays_per_solve": panoc.replays / solves,
          "launches": counts, "wall_s": secs, **card})
    check(passes, f"mpc-ukf-commu: {res.solves} solves, the spec's chk_packets(100) fails (upright {res.upright})")
    check(not counts, f"mpc-ukf-commu launched the port's MPPI kernels: {counts}")


def panoc_graph_phase(dev: torch.device, card: dict) -> None:
    """PANOC replayed from CUDA graphs against the eager solve, on the card:
    op-mpc-x-calc's and mpc-ukf-commu's condensed QPs, 12 warm-started
    solves from seeded states, the graph solve (the QP's closure) and the
    eager one (the same closure behind a lambda): iterations and read-backs
    equal, u within 1e-12; each one's ms, device kernels (torch.profiler)
    and graph replays an iteration."""
    import numpy as np

    from mpc_rs_tpu_torch.controllers import panoc
    from mpc_rs_tpu_torch.controllers.qp import build_condensed_qp, make_qp_value_and_grad
    from mpc_rs_tpu_torch.models import dynamics, reference
    from mpc_rs_tpu_torch.models.params import CartPoleParams

    rng = np.random.default_rng(13)
    a, b = dynamics.linear_ab(CartPoleParams.single_wheel(), 0.1)
    a40, b40 = dynamics.linear_ab(CartPoleParams.two_wheel(), 1.2 / 40, two_wheel=True)
    setups = {
        "op-mpc-x-calc": (build_condensed_qp(a, b, np.diag([5.0, 5.0, 1.0, 1.0]), 8, device=dev),
                          reference.make_gen_ref_raised_cosine(8), panoc.PanocConfig(tol=1e-6, max_iter=80, lbfgs_mem=20),
                          panoc.box_projection(-30.0, 30.0), 8, [0.5, 0.2, 0.1, 0.2]),
        "mpc-ukf-commu": (build_condensed_qp(a40, b40, np.diag([0.0, 0.0, 10.0, 3.0]), 40, device=dev),
                          reference.make_gen_ref_raised_cosine(40, velocity_gain=-0.75),
                          panoc.PanocConfig(tol=1e-6, max_iter=60, lbfgs_mem=20), panoc.box_projection(-10.0, 10.0),
                          40, [0.3, 0.2, 0.05, 0.2]),
    }
    for app, (qp, gen_ref, cfg, proj, n, scale) in setups.items():
        vg_factory = make_qp_value_and_grad(qp, gen_ref)
        u = torch.zeros(n, dtype=torch.float64, device=dev)
        worst, t_graph, t_eager, iters, per_it = 0.0, [], [], [], {}
        for i, x in enumerate(rng.normal(size=(12, 4)) * scale):
            vg = vg_factory(torch.tensor(x, dtype=torch.float64, device=dev))
            runs = {}
            for mode, oracle in (("graph", vg), ("eager", lambda v, vg=vg: vg(v))):
                panoc.reset_readbacks()
                t0 = time.perf_counter()
                res = panoc.panoc_solve(cfg, None, proj, u, value_and_grad=oracle)
                res.u.cpu()
                (t_graph if mode == "graph" else t_eager).append(time.perf_counter() - t0)
                runs[mode] = (res, panoc.readbacks, panoc.replays)
            (g, rb_g, rp_g), (e, rb_e, _) = runs["graph"], runs["eager"]
            check(int(g.iterations) == int(e.iterations) and rb_g == rb_e,
                  f"{app} solve {i}: graph {int(g.iterations)} iterations, {rb_g} read-backs; eager "
                  f"{int(e.iterations)}, {rb_e}")
            worst = max(worst, float((g.u - e.u).abs().max()))
            iters.append(int(g.iterations))
            if i == 11:  # the last solve's device kernels an iteration, each way
                for mode, oracle in (("graph", vg), ("eager", lambda v, vg=vg: vg(v))):
                    events = device_events(lambda: panoc.panoc_solve(cfg, None, proj, u, value_and_grad=oracle).u.cpu())
                    per_it[f"{mode}_device_kernels_per_iteration"] = (
                        len(events) / max(1, int(g.iterations)) if events else "not measured")
                per_it["readbacks_per_iteration"] = rb_g / max(1, int(g.iterations))
                per_it["graph_replays_per_iteration"] = rp_g / max(1, int(g.iterations))
            u = g.u
        check(worst <= 1e-12, f"{app}: graph and eager solves {worst} apart (1e-12)")
        emit({"phase": "panoc_graph_vs_eager", "app": app, "solves": 12, "max_abs_u_diff": worst,
              "iterations_equal": True, "readbacks_equal": True, "iterations_median": statistics.median(iters),
              "graph_solve": ms_quantiles(t_graph[1:]), "eager_solve": ms_quantiles(t_eager[1:]),
              "first_graph_solve_ms_with_capture": 1e3 * t_graph[0], **per_it, **card})


def acceptance_phase(dev: torch.device, card: dict) -> None:
    """The acceptance harness on the card (``apps/acceptance.py``), seed 0,
    the specs of this slice's paths and the HIL ones: every one passes."""
    from mpc_rs_tpu_torch.apps import acceptance
    from mpc_rs_tpu_torch.ops import estimator_cuda, mppi_cuda

    Path("logs").mkdir(exist_ok=True)
    out = Path("logs/chip_smoke_acceptance.json")
    out.unlink(missing_ok=True)
    mppi_cuda.reset_launches()
    estimator_cuda.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        payload = acceptance.main(["--only", ACCEPTANCE_SUBSET, "--seeds", "1", "--out", str(out)])
    counts = {k: v for k, v in {**mppi_cuda.launches, **estimator_cuda.launches}.items() if v}
    rates = {name: r["rate"] for name, r in payload["results"].items()}
    emit({"phase": "acceptance", "specs": ACCEPTANCE_SUBSET.split(","), "seed": 0, "rates": rates,
          "fails": {name: r["fails"] for name, r in payload["results"].items() if r["fails"]},
          "device": payload["device"], "launches": counts, "seconds": time.perf_counter() - t0, **card})
    check(all(r == 1.0 for r in rates.values()), f"acceptance on the card: {rates}")


MULTIGPU_JOIN_S = 240  # each rank process's join timeout


# serve's plan-streaming horizons the K-sharded solve and the finalize are
# held at: each end of the row's sums (31 in warp 0, 32 over two), odd N
SHARDED_SERVE_HORIZONS = (9, 16, 31, 32, 39, 40)


def sharded_family() -> list[tuple]:
    """The K-sharded solve past N = 8, one case a (model, N) pair of the
    family: (label, model, MppiConfig, x0). The HW flagship at N = 20 at its
    K = 800 000 (bench.py:230-288), mppi2's double integrator at N = 40 at
    its app's K = 8 000, and serve's cart-pole (``serve_n<N>``, built for
    box-muller alone) at ``SHARDED_SERVE_HORIZONS`` at serve's default
    K = 8 192, each at its app's σ and limits and the family's at their
    apps' λ; serve's at λ = 20, where its f32 solve is well conditioned, as
    its sampled sharded solve on two ranks is held in the band of the
    float64 plain solve on the ranks' draws."""
    from mpc_rs_tpu_torch.controllers.mppi import MppiConfig
    from mpc_rs_tpu_torch.models.params import CartPoleParams
    from mpc_rs_tpu_torch.ops.mppi_cuda import CartPoleShaped4, Commu4Cost4, DoubleIntegratorQuad2

    return [
        ("hw_flagship", Commu4Cost4(CartPoleParams.two_wheel(), 0.05),
         MppiConfig(n_horizon=20, n_rollouts=800_000, lambda_=2.0, std_dev=2.0, limit=(-10.0, 10.0)),
         (0.0, 0.0, 0.1, 0.0)),
        ("mppi2", DoubleIntegratorQuad2(0.05),
         MppiConfig(n_horizon=40, n_rollouts=8000, lambda_=2.5, std_dev=1.0, limit=(-3.0, 3.0), control_inv=2.5),
         (1.0, 0.0)),
        *((f"serve_n{n}", CartPoleShaped4(CartPoleParams.single_wheel(), 0.8 / n),
           MppiConfig(n_horizon=n, n_rollouts=8192, lambda_=20.0, std_dev=3.0, limit=(-20.0, 20.0)), X0)
          for n in SHARDED_SERVE_HORIZONS),
    ]


def finalize_phase(dev: torch.device, card: dict) -> dict:
    """``fleet_finalize_kernel`` at N = 8, 20, 40 and serve's N = 9, 16, 31,
    32 and 39 (``sharded_family``'s cases past N = 8, the cart-pole's K2 at
    K = 800 000 for 8), each with box-muller and external noise at R = 1
    and 4 where the pair is built for them (serve's cart-pole: box-muller,
    R = 1, and R = 4 at N = 40): the merged rows of B problems (the rank's row; B = 1, and B = 8
    where K is small) finished by ``finalize_batch_fused`` are the
    merged-in-launch solve bit for bit; the rows-only launch's (B, nb, N+2)
    rows finished by it match ``finalize_batch_plain`` in float64 on the
    same rows (the f32 band, the same statuses), and are the merged solve's
    bits where that solve merges with one warp too (nb ≤ 128, the same
    merge_rows_warp); a problem with no finite rollout is NO_FINITE with
    zeros. Returns the timings a horizon at the K-sharded solve's shape
    (one problem, one row)."""
    from mpc_rs_tpu_torch.controllers.mppi import MppiConfig, MppiStatus
    from mpc_rs_tpu_torch.models.params import CartPoleParams
    from mpc_rs_tpu_torch.ops import mppi_cuda
    from mpc_rs_tpu_torch.ops.mppi_cuda import CartPoleShaped4

    gen = torch.Generator(device=dev).manual_seed(2020)
    cases = [("cartpole_n8", CartPoleShaped4(CartPoleParams.single_wheel(), 0.1),
              MppiConfig(n_horizon=N, n_rollouts=800_000, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0)), X0),
             *sharded_family()]
    rows_out, worst, timing = [], {}, {}
    for label, m, cfg, x0 in cases:
        n, k = cfg.n_horizon, cfg.n_rollouts
        b = 1 if k > 100_000 else 8
        xs = torch.tensor(x0, device=dev) + 0.05 * torch.randn((b, len(x0)), generator=gen, device=dev)
        u_ns = 0.3 * torch.randn((b, n), generator=gen, device=dev)
        seeds = torch.arange(b, dtype=torch.int32, device=dev) * 31 + 7
        built_sources, built_rpts = mppi_cuda.built_for(m, n)
        for source in (s_ for s_ in ("external", "box-muller") if s_ in built_sources):
            for rpt in built_rpts:
                kw = (dict(noise=cfg.std_dev * torch.randn((b, k, n), generator=gen, device=dev))
                      if source == "external" else dict(seeds=seeds, sampler=source))
                merged = mppi_cuda.mppi_batch_partials_merged_fused(cfg, m, xs, u_ns, rollouts_per_thread=rpt, **kw)
                solve_u, solve_st = mppi_cuda.mppi_solve_batch_fused(cfg, m, xs, u_ns, rollouts_per_thread=rpt, **kw)
                fin_u, fin_st = mppi_cuda.finalize_batch_fused(cfg, merged[:, None].contiguous())
                check(torch.equal(fin_u, solve_u) and torch.equal(fin_st, solve_st),
                      f"finalize N={n} {label} {source} R={rpt}: the merged rows finished are not the solve's bits")
                parts = mppi_cuda.mppi_batch_partials_fused(cfg, m, xs, u_ns, rollouts_per_thread=rpt, **kw)
                got_u, got_st = mppi_cuda.finalize_batch_fused(cfg, parts)
                want_u, want_st = mppi_cuda.finalize_batch_plain(cfg, parts.double())
                check(torch.equal(got_st, want_st) and bool((got_st == MppiStatus.OK).all()),
                      f"finalize N={n} {label} {source} R={rpt}: statuses {got_st.tolist()} / {want_st.tolist()}")
                err = check_band(got_u, want_u, f"finalize N={n} {label} {source} R={rpt} vs plain")
                nb = int(parts.shape[1])
                if nb <= 128:
                    check(torch.equal(got_u, solve_u), f"finalize N={n} {label} {source} R={rpt}: nb = {nb}, "
                                                       "not the warp-merged solve's bits")
                worst[n] = max(worst.get(n, 0.0), err)
                rows_out.append({"case": label, "n": n, "b": b, "k": k, "source": source, "rollouts_per_thread": rpt,
                                 "blocks": nb, "max_abs_err": err, "bits_of_the_merged_solve": nb <= 128})
        bad = torch.full((1, 1, n + 2), 0.0, device=dev)
        bad[0, 0, 0] = mppi_cuda.NEG_BIG
        u_bad, st_bad = mppi_cuda.finalize_batch_fused(cfg, bad)
        check(int(st_bad[0]) == MppiStatus.NO_FINITE and bool((u_bad == 0).all()),
              f"finalize N={n}: a row with no finite rollout gave {int(st_bad[0])}")
        # the K-sharded solve's shape: one problem, one (all-reduced) row
        row = mppi_cuda.mppi_partials_merged_fused(cfg, m, xs[0], u_ns[0], seed=5)[None, None].contiguous()
        fin = lambda: mppi_cuda.finalize_batch_fused(cfg, row)  # noqa: E731
        plain = lambda: mppi_cuda.finalize_batch_plain(cfg, row)  # noqa: E731
        timing[n] = dict(ms=device_ms(fin), event_ms=median_ms(fin, reps=50), plain_ms=median_ms(plain, reps=20),
                         max_abs_err=worst[n], **bound(flops_of(plain), nbytes(row) + 4 * (n + 1)))
        emit({"phase": "timing_finalize", "n": n, "case": label, **timing[n], **card})
    emit({"phase": "finalize", "rows": rows_out, "max_abs_err": worst, **card})
    return timing


def merged_row_phase(dev: torch.device, card: dict) -> list[dict]:
    """The partials launch's merged-row output (the rank's share of a
    multi-GPU solve): at P = 1 on the cart-pole with ``shaped4`` at
    K = 800 000, and the batch on cartpole4 (B = 1024, K = 1024) and
    flagship6 (B = 1024, K = 8192), each noise source at R = 1 and 4. Each
    merged row is held against its float64 plain version on the kernel's
    own noise (the f32 band, or twice the plain f32 version's distance where
    the f32 problem is ill-conditioned), against the rows-only launch's row
    bit for bit where a problem is one block (the same sums), and finished
    by ``finalize_batch_fused`` it must give the merged-in-launch solve bit
    for bit (the same merge order). A problem with no finite rollout writes
    NEG_BIG and zeros. Returns the timings of both wrappers."""
    from mpc_rs_tpu_torch.controllers.mppi import MppiConfig
    from mpc_rs_tpu_torch.models.params import CartPoleParams
    from mpc_rs_tpu_torch.ops import mppi_cuda, philox
    from mpc_rs_tpu_torch.ops.mppi_cuda import CartPoleShaped4, Flagship4Diag4

    gen = torch.Generator(device=dev).manual_seed(1414)
    worst, rows = 0.0, []
    cases = (("cartpole-shaped4", 1, 800_000, CartPoleShaped4(CartPoleParams.single_wheel(), 0.1), 3.0, 20.0,
              (-20.0, 20.0)),
             ("cartpole4", 1024, 1024, CartPoleShaped4(CartPoleParams.single_wheel(), 0.1, fast=True), 10.0, 20.0,
              (-10.0, 10.0)),
             ("flagship6", 1024, 8192, Flagship4Diag4(CartPoleParams.two_wheel(), 0.15, fast=True), 4.0, 50.0,
              (-10.0, 10.0)))
    for label, b, k, m, sd, lam, limit in cases:
        cfg = MppiConfig(n_horizon=N, n_rollouts=k, lambda_=lam, std_dev=sd, limit=limit)
        xs = 0.2 * torch.randn((b, 4), generator=gen, device=dev)
        if label != "flagship6":
            xs = xs + torch.tensor(X0, device=dev)
        u_ns = 0.5 * torch.randn((b, N), generator=gen, device=dev)
        seeds = torch.randint(-2**31, 2**31 - 1, (b,), generator=gen, device=dev, dtype=torch.int32)
        for source in ("external", *philox.SAMPLERS):
            for rpt in (1, 4):
                noise = (sd * torch.randn((b, k, N), generator=gen, device=dev) if source == "external"
                         else torch.empty((b, k, N), device=dev))
                kw = (dict(noise=noise) if source == "external" else
                      dict(seeds=seeds, sampler=source, noise_out=noise))
                if b == 1:
                    one = (dict(noise=noise[0]) if source == "external" else
                           dict(seed=int(seeds[0]), sampler=source, noise_out=noise[0]))
                    got = mppi_cuda.mppi_partials_merged_fused(cfg, m, xs[0], u_ns[0], rollouts_per_thread=rpt,
                                                               **one)[None]
                    solve_u, solve_st = mppi_cuda.mppi_solve_fused(
                        cfg, m, xs[0], u_ns[0], rollouts_per_thread=rpt,
                        **{a: v for a, v in one.items() if a != "noise_out"})
                    solve_u, solve_st = solve_u[None], solve_st[None]
                    rows_only = mppi_cuda.mppi_batch_partials_fused(
                        cfg, m, xs[:1], u_ns[:1], rollouts_per_thread=rpt,
                        **(dict(noise=noise) if source == "external" else
                           dict(seeds=seeds[:1], sampler=source)))
                else:
                    got = mppi_cuda.mppi_batch_partials_merged_fused(cfg, m, xs, u_ns, rollouts_per_thread=rpt, **kw)
                    solve_u, solve_st = mppi_cuda.mppi_solve_batch_fused(
                        cfg, m, xs, u_ns, rollouts_per_thread=rpt, **{a: v for a, v in kw.items() if a != "noise_out"})
                    rows_only = mppi_cuda.mppi_batch_partials_fused(
                        cfg, m, xs, u_ns, rollouts_per_thread=rpt, **{a: v for a, v in kw.items() if a != "noise_out"})
                fin_u, fin_st = mppi_cuda.finalize_batch_fused(cfg, got[:, None].contiguous())
                check(torch.equal(fin_u, solve_u) and torch.equal(fin_st, solve_st),
                      f"merged row {label} {source} R={rpt}: finished, it is not the merged-in-launch solve")
                if rows_only.shape[1] == 1:
                    check(torch.equal(got, rows_only[:, 0]),
                          f"merged row {label} {source} R={rpt}: one block, yet not the rows-only row")
                want = mppi_cuda.mppi_batch_partials_merged_plain(cfg, m, xs.double(), u_ns.double(), noise.double(),
                                                                  rollouts_per_thread=rpt)
                want32 = mppi_cuda.mppi_batch_partials_merged_plain(cfg, m, xs, u_ns, noise, rollouts_per_thread=rpt)
                err = check_band_or_own(got, want, want32, f"merged row {label} {source} R={rpt}")
                worst = max(worst, err)
                rows.append({"case": label, "source": source, "rollouts_per_thread": rpt, "max_abs_err": err,
                             "blocks": int(rows_only.shape[1])})
                del noise
        # a problem with no finite rollout: NEG_BIG and zeros
        bad = xs.clone()
        bad[0, 0] = float("nan")
        got = (mppi_cuda.mppi_partials_merged_fused(cfg, m, bad[0], u_ns[0], seed=3)[None] if b == 1 else
               mppi_cuda.mppi_batch_partials_merged_fused(cfg, m, bad, u_ns, seeds=seeds, sampler="box-muller"))
        check(float(got[0, 0]) == float(torch.tensor(mppi_cuda.NEG_BIG, dtype=torch.float32))
              and bool((got[0, 1:] == 0).all()), f"merged row {label}: a problem with no finite rollout {got[0]}")
    check(bool((mppi_cuda.merge_tickets(dev, 1) == 0).all()) and bool((mppi_cuda.merge_tickets(dev, 1024) == 0).all()),
          "merged row: merge tickets not zero after the calls")
    emit({"phase": "merged_row", "rows": rows, "max_abs_err": worst, **card})

    # timings at the sharded paths' shapes: the K-sharded solve's rank at
    # K = 800 000 and the fleet tick's rank at cartpole4's B = 1024, K = 1024
    out = {}
    m = CartPoleShaped4(CartPoleParams.single_wheel(), 0.1)
    cfg = MppiConfig(n_horizon=N, n_rollouts=800_000, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
    x, u0 = torch.tensor(X0, device=dev), torch.zeros(N, device=dev)
    one = lambda: mppi_cuda.mppi_partials_merged_fused(cfg, m, x, u0, seed=3)  # noqa: E731
    plain = lambda: mppi_cuda.mppi_partials_merged_plain(  # noqa: E731
        cfg, m, x, u0, mppi_cuda.solve_noise(cfg, m, 3, 0, device=dev))
    out["mppi_partials_merged_fused"] = dict(
        ms=device_ms(one), event_ms=median_ms(one, reps=20), plain_ms=median_ms(plain, reps=5, warmup=1),
        max_abs_err=worst, **bound(flops_of(plain), nbytes(x, u0) + 4 * (N + 2)))
    mf = CartPoleShaped4(CartPoleParams.single_wheel(), 0.1, fast=True)
    cfgf = MppiConfig(n_horizon=N, n_rollouts=1024, lambda_=0.5, std_dev=10.0, limit=(-10.0, 10.0))
    xs = torch.tensor(X0, device=dev) + 0.2 * torch.randn((1024, 4), generator=gen, device=dev)
    u_ns = 0.5 * torch.randn((1024, N), generator=gen, device=dev)
    seeds = torch.arange(1024, dtype=torch.int32, device=dev)
    batch = lambda: mppi_cuda.mppi_batch_partials_merged_fused(cfgf, mf, xs, u_ns, seeds=seeds,  # noqa: E731
                                                               sampler="clt4")
    bplain = lambda: mppi_cuda.mppi_batch_partials_merged_plain(  # noqa: E731
        cfgf, mf, xs, u_ns, mppi_cuda.batch_noise(cfgf, mf, seeds, "clt4"))
    out["mppi_batch_partials_merged_fused"] = dict(
        ms=device_ms(batch), event_ms=median_ms(batch, reps=20), plain_ms=median_ms(bplain, reps=5, warmup=1),
        max_abs_err=worst, **bound(flops_of(bplain), nbytes(xs, u_ns, seeds) + 4 * 1024 * (N + 2)))
    for name, t in out.items():
        emit({"phase": "timing_merged_row", "wrapper": name, **t, **card})
    return out


def spawn_ranks(world: int, backend: str, tag: str, root: Path) -> list[dict]:
    """``world`` rank processes of this script (``--rank``), one store file,
    each joined within ``MULTIGPU_JOIN_S``; a rank that fails or times out
    fails the smoke. Returns each rank's result."""
    root = root.resolve()  # the file:// store takes an absolute path
    root.mkdir(parents=True, exist_ok=True)
    store = root / f"{tag}.store"
    store.unlink(missing_ok=True)
    logs = [root / f"{tag}.rank{r}.log" for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--rank", str(r),
                                           str(world), str(store), backend, str(root / f"{tag}.rank{r}.json")],
                                          stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + MULTIGPU_JOIN_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        check(p.returncode == 0, f"{tag}: rank {r} of {world} failed ({p.returncode}):\n"
                                 f"{logs[r].read_text()[-4000:]}")
    return [json.loads((root / f"{tag}.rank{r}.json").read_text()) for r in range(world)]


def multigpu_phases(dev: torch.device, card: dict) -> list[dict]:
    """The multi-GPU slice on the card (``parallel/``): the merged-row
    output against its plain version (``merged_row_phase``); NCCL at world
    size 1 on cuda:0 (a real process group): the K-sharded mppi4-non-liner
    solve at K = 800 000 against ``mppi_solve_fused`` bit for bit, a
    50-tick closed loop on it, and the cartpole4 fleet at B = 1024 through
    ``python -m torch.distributed.run ... -m mpc_rs_tpu_torch.apps.run
    fleet`` over 10 s at its survival gate; gloo with two ranks on the one
    card (CUDA tensors): the K-sharded solve with external noise against the
    one-rank solve in the f32 band, with in-kernel sampling every status 0
    and u0 of the one-rank solve's sign, the cartpole4 fleet at B = 1024 as
    1×2 (rollouts: the two ranks' carries the same bits, by digest) and 2×1
    (scenarios: the one-rank fleet's bits, R pinned) over 1 s, its tick
    median and the two all-reduces' share of it; and, with two cards or
    more, the same at NCCL world min(count, 4). Every sharded call on the
    card is one merged-row launch and one finalize launch. Returns the
    kernels line's entries."""
    from mpc_rs_tpu_torch.ops.mppi_cuda import FINALIZE_HORIZONS

    t_phase = time.perf_counter()
    timing = merged_row_phase(dev, card)
    fin_timing = finalize_phase(dev, card)
    root = Path("logs") / "chip_smoke_multigpu"
    runs = {"nccl1": spawn_ranks(1, "nccl", "nccl1", root), "gloo2": spawn_ranks(2, "gloo", "gloo2", root)}
    count = torch.cuda.device_count()
    if count >= 2:
        runs["nccl_multi"] = spawn_ranks(min(count, 4), "nccl", "nccl_multi", root)
    else:
        emit({"phase": "multigpu_nccl_multi", "skipped": f"torch.cuda.device_count() = {count}: NCCL takes one "
                                                          "card a rank, so a multi-card world needs two cards"})
    for tag, ranks in runs.items():
        check(all(r["ok"] for r in ranks), f"{tag}: {ranks}")
        emit({"phase": f"multigpu_{tag}", "ranks": ranks, **card})
    nccl1 = runs["nccl1"][0]
    check(nccl1["solve_bit_equal"], f"NCCL world 1: the sharded solve is not mppi_solve_fused's: {nccl1}")
    for label, _, fcfg, _ in sharded_family():
        check(nccl1[f"{label}_bit_equal"],
              f"NCCL world 1: the sharded {label} solve (N={fcfg.n_horizon}) is not mppi_solve_fused's: {nccl1}")
    # the HW flagship's K-sharded solves/s beside its 0.06 s budget: NCCL at
    # world 1, and the two gloo ranks sharing the card at W = 1 and 2
    hw = {tag: runs[tag][0]["hw_flagship_scaling"] for tag in runs}
    emit({"phase": "multigpu_hw_flagship", "n": 20, "k": 800_000, "budget_s": HW_BUDGET_S,
          "scaling": {tag: [dict(r, s_per_solve=1.0 / r["solves_per_s"],
                                 within_budget=1.0 / r["solves_per_s"] <= HW_BUDGET_S) for r in rows]
                      for tag, rows in hw.items()},
          "n8_scaling_same_ranks": {tag: runs[tag][0]["n8_scaling"] for tag in runs},
          "max_abs_err_vs_one_rank": {tag: max(r[f"{label}_max_abs_err_vs_one_rank"] for r in ranks
                                               for label, *_ in sharded_family()) for tag, ranks in runs.items()},
          **card})
    gloo = runs["gloo2"]
    check(gloo[0]["fleet_1x2_digest"] == gloo[1]["fleet_1x2_digest"], "gloo 1x2: the rollouts replicas differ")
    check(gloo[0]["fleet_2x1_equals_one_rank"], "gloo 2x1: the fleet is not the one-rank fleet's bits")

    # the fleet through torch.distributed.run at NCCL world 1, at its gate
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1", "-m",
           "mpc_rs_tpu_torch.apps.run", "fleet", "--model", "cartpole4", "--t-end", "10",
           "--log-dir", "logs/chip_smoke_dist"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=MULTIGPU_JOIN_S)
    check(proc.returncode == 0, f"fleet under torch.distributed.run: {proc.returncode}\n{proc.stdout[-2000:]}"
                                f"\n{proc.stderr[-3000:]}")
    got = re.search(r"survived (\d+)/(\d+) over (\d+) ticks; median tick ([\d.]+) ms; all statuses 0: (\w+)",
                    proc.stdout)
    check(got is not None and "ranks=1 backend=nccl" in proc.stdout, f"fleet under torchrun: {proc.stdout[-2000:]}")
    survived, b_fleet = int(got.group(1)), int(got.group(2))
    check(survived / b_fleet >= 0.99 and got.group(5) == "True", f"fleet under torchrun: {got.group(0)}")
    emit({"phase": "multigpu_torchrun_fleet", "backend": "nccl", "world": 1, "scenarios": b_fleet,
          "survival": survived / b_fleet, "ticks": int(got.group(3)), "tick_ms_median": float(got.group(4)),
          "wall_s": time.perf_counter() - t0, **card})
    emit({"phase": "multigpu_total", "seconds": time.perf_counter() - t_phase,
          "finalize_horizons": sorted(FINALIZE_HORIZONS)})

    launches = {name: sum(r["launches"].get(name, 0) for rs in runs.values() for r in rs)
                for name in ("mppi_partials_merged_fused", "mppi_batch_partials_merged_fused", "finalize_batch_fused",
                             *(f"finalize:N={n}" for n in sorted(fin_timing)))}
    check(all(launches.values()), f"the multi-GPU main paths launched {launches}")
    return [
        {"name": f"fleet_finalize_kernel at N={n}, one kernel that takes N at run time (the K-sharded solve's "
                 f"finalize, finalize_batch_fused)",
         "route": "cuda", "source": HORIZONS_SOURCE, "replaces": f"{PALLAS}:1019",
         "launches": launches[f"finalize:N={n}"],
         "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
         "bound_by": t["bound_by"], "library_ms": None}
        for n, t in sorted(fin_timing.items())
    ] + [
        {"name": f"mppi_partials_kernel, merged-row output (K2 rank of the K-sharded solve, {name})",
         "route": "cuda", "source": COMMON_SOURCE, "replaces": f"{PALLAS}:{line}",
         "launches": launches[name], "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
         "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None}
        for (name, line), t in ((("mppi_partials_merged_fused", 438), timing["mppi_partials_merged_fused"]),
                                (("mppi_batch_partials_merged_fused", 739),
                                 timing["mppi_batch_partials_merged_fused"]))
    ]


def rank_main(argv: list[str]) -> None:
    """One rank of ``multigpu_phases`` (``chip_smoke.py --rank R W STORE
    BACKEND OUT``): joins the world on cuda:LOCAL (R wrapped onto the
    cards), runs the K-sharded solve and the sharded fleet, and writes its
    result to OUT. Every check that fails raises, and the rank exits
    non-zero."""
    import dataclasses
    import hashlib

    from mpc_rs_tpu_torch.apps.fleet import build_fleet, run_fleet
    from mpc_rs_tpu_torch.controllers.mppi import MppiConfig
    from mpc_rs_tpu_torch.models.params import CartPoleParams
    from mpc_rs_tpu_torch.ops import mppi_cuda
    from mpc_rs_tpu_torch.ops.mppi_cuda import CartPoleShaped4, mppi_solve_fused
    from mpc_rs_tpu_torch.parallel.distributed import init_distributed
    from mpc_rs_tpu_torch.parallel.mesh import make_mesh
    from mpc_rs_tpu_torch.parallel.scaling import measure_scaling
    from mpc_rs_tpu_torch.parallel.scenario import gather_carry
    from mpc_rs_tpu_torch.parallel.sharded_mppi import make_sharded_mppi, merge_rows, rank_seed
    from mpc_rs_tpu_torch.runtime.checkpoint import carry_fields

    rank, world, store, backend, out = int(argv[0]), int(argv[1]), argv[2], argv[3], argv[4]
    faulthandler.dump_traceback_later(MULTIGPU_JOIN_S - 20, exit=True)  # a hang shows where, in the log
    dev = init_distributed(f"file://{store}", world, rank, backend=backend, device="cuda",
                           timeout_s=MULTIGPU_JOIN_S / 2)
    torch.cuda.set_device(dev)
    res = {"rank": rank, "world": world, "backend": backend, "device": str(dev), "ok": False}
    mesh = make_mesh({"rollouts": world})
    model = CartPoleShaped4(CartPoleParams.single_wheel(), 0.1)
    cfg = MppiConfig(n_horizon=N, n_rollouts=800_000, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
    x, u0 = torch.tensor(X0, device=dev), torch.zeros(N, device=dev)
    gen = torch.Generator(device=dev).manual_seed(77)  # the same noise on every rank
    noise = 3.0 * torch.randn((cfg.n_rollouts, N), generator=gen, device=dev)

    # the K-sharded solve: external noise against the one-rank solve
    mppi_cuda.reset_launches()
    solve = make_sharded_mppi(cfg, model, mesh, external_noise=True)
    u, st = solve(noise, x, u0)
    torch.cuda.synchronize(dev)
    per_solve = dict(mppi_cuda.launches)
    check(per_solve["mppi_partials_merged_fused"] == 1 and per_solve["finalize_batch_fused"] == 1
          and per_solve["mppi_solve_fused"] == 0, f"a sharded solve's launches {per_solve}")
    one_u, one_st = mppi_solve_fused(cfg, model, x, u0, noise=noise)
    check(int(st) == int(one_st) == 0, f"sharded solve status {int(st)} / one-rank {int(one_st)}")
    res["solve_bit_equal"] = bool(torch.equal(u, one_u))
    res["solve_max_abs_err_vs_one_rank"] = check_band(u, one_u, "sharded solve vs the one-rank solve")
    # in-kernel sampling: rank r keys seed + r·7919
    u_s, st_s = make_sharded_mppi(cfg, model, mesh)(3, x, u0)
    one_s, _ = mppi_solve_fused(cfg, model, x, u0, seed=3)
    check(int(st_s) == 0 and math.copysign(1, float(u_s[0])) == math.copysign(1, float(one_s[0])),
          f"sampled sharded solve: status {int(st_s)}, u0 {float(u_s[0])} against the one-rank {float(one_s[0])}")
    res["sampled_u0"], res["one_rank_sampled_u0"] = float(u_s[0]), float(one_s[0])

    # the K-sharded solve past N = 8 (sharded_family): the HW flagship at
    # N = 20, K = 800 000, mppi2 at N = 40, external noise against the
    # one-rank solve; serve's cart-pole, built for box-muller alone,
    # sampling (rank r keys seed + r·7919) against the one-rank solve fed
    # the ranks' noise (the same key at world 1). Bit for bit at world 1,
    # checked by the caller; the band at any world; each one merged-row and
    # one finalize launch. Then the HW flagship's solves/s at 1 → W ranks
    # (parallel/scaling.py), in sampling mode
    family = Counter()
    for label, m, fcfg, fx0 in sharded_family():
        n_f, k_f = fcfg.n_horizon, fcfg.n_rollouts
        xf, uf = torch.tensor(fx0, device=dev), torch.zeros(n_f, device=dev)
        sampled = "external" not in mppi_cuda.built_for(m, n_f)[0]
        mppi_cuda.reset_launches()
        if sampled:
            u_f, st_f = make_sharded_mppi(fcfg, m, mesh)(21, xf, uf)
        else:
            fgen = torch.Generator(device=dev).manual_seed(78)
            fnoise = fcfg.std_dev * torch.randn((k_f, n_f), generator=fgen, device=dev)
            u_f, st_f = make_sharded_mppi(fcfg, m, mesh, external_noise=True)(fnoise, xf, uf)
        torch.cuda.synchronize(dev)
        counts = dict(mppi_cuda.launches)
        check(counts["mppi_partials_merged_fused"] == 1 and counts[f"finalize:N={n_f}"] == 1
              and counts["mppi_solve_fused"] == 0, f"a sharded {label} solve's launches {counts}")
        family.update(counts)
        if sampled and world == 1:
            one_u, one_st = mppi_solve_fused(fcfg, m, xf, uf, seed=21)
        elif sampled:  # the plain solve on the ranks' draws, each K/W rollouts keyed rank_seed(21, r)
            local = dataclasses.replace(fcfg, n_rollouts=k_f // world)
            fnoise = torch.cat([mppi_cuda.solve_noise(local, m, rank_seed(21, r), 0, device=dev)
                                for r in range(world)])
            one_u, one_st = mppi_cuda.mppi_solve_plain(fcfg, m, xf.double(), uf.double(), noise=fnoise.double())
            one_u = one_u.float()
        else:
            one_u, one_st = mppi_solve_fused(fcfg, m, xf, uf, noise=fnoise)
        check(int(st_f) == int(one_st) == 0, f"sharded {label} status {int(st_f)} / one-rank {int(one_st)}")
        res[f"{label}_bit_equal"] = bool(torch.equal(u_f, one_u))
        res[f"{label}_max_abs_err_vs_one_rank"] = check_band(u_f, one_u, f"sharded {label} vs the one-rank solve")
        if label == "hw_flagship":  # beside the N = 8 solve at the same K, in this process
            mppi_cuda.reset_launches()
            res["hw_flagship_scaling"] = measure_scaling(fcfg, m, iters=50, device=dev)
            res["n8_scaling"] = measure_scaling(cfg, model, iters=50, device=dev)
            family.update(dict(mppi_cuda.launches))

    # the main path: the mppi4-non-liner closed loop on the K-sharded solve,
    # 50 ticks with the plant stepped, counts reset before and read after
    solve = make_sharded_mppi(cfg, model, mesh)
    mppi_cuda.reset_launches()
    xs, u_n, statuses, tick_s = x.clone(), u0, [], []
    for i in range(50):
        t0 = time.perf_counter()
        u_n, st = solve(1000 + i, xs, u_n)
        xs = torch.stack(model.step(*xs.unbind(), u_n[0]))
        torch.cuda.synchronize(dev)
        tick_s.append(time.perf_counter() - t0)
        statuses.append(int(st))
    res["loop_launches"] = dict(mppi_cuda.launches)
    check(statuses == [0] * 50 and abs(float(xs[2])) < 0.2,
          f"sharded closed loop: statuses {sorted(set(statuses))}, final x {xs.tolist()}")
    check(res["loop_launches"]["mppi_partials_merged_fused"] == 50
          and res["loop_launches"]["finalize_batch_fused"] == 50, f"closed loop launches {res['loop_launches']}")
    res["loop_tick_ms_median"] = 1e3 * statistics.median(tick_s)
    launches = Counter(res["loop_launches"]) + family

    # the sharded fleet: 1×world (rollouts) and, with more than one rank,
    # world×1 (scenarios) against the one-rank fleet, R pinned to its choice
    b = 1024
    rpt = mppi_cuda.rollouts_per_thread(1024, b)
    shapes = [(1, world)] + ([(world, 1)] if world > 1 else [])
    for s, r in shapes:
        fmesh = make_mesh({"scenario": s, "rollouts": r})
        fl = build_fleet("cartpole4", None, dev, scenarios=b, mesh=fmesh, seed=5,
                         rollouts_per_thread=rpt if r == 1 else None)
        mppi_cuda.reset_launches()
        fres = run_fleet(fl, t_end=1.0, report_every=1.0)
        counts = dict(mppi_cuda.launches)
        ticks = fres.ticks
        check(counts["mppi_batch_partials_merged_fused"] == ticks and counts["finalize_batch_fused"] == ticks
              and counts["mppi_solve_batch_fused"] == 0, f"fleet {s}x{r}: launches {counts} over {ticks} ticks")
        check(fres.survival == 1.0 and fres.statuses_ok, f"fleet {s}x{r}: survival {fres.survival}")
        launches.update(counts)
        local = carry_fields(fres.carry)
        digest = hashlib.sha256(b"".join(v.cpu().numpy().tobytes() for v in local.values())).hexdigest()
        res[f"fleet_{s}x{r}_digest"] = digest
        res[f"fleet_{s}x{r}_tick_ms_median"] = 1e3 * statistics.median(fres.tick_seconds)
        whole = gather_carry(fres.carry, fmesh)
        if s > 1 and rank == 0:
            one = run_fleet(build_fleet("cartpole4", None, dev, scenarios=b, seed=5), t_end=1.0, report_every=1.0)
            a, c = carry_fields(whole), carry_fields(one.carry)
            res["fleet_2x1_equals_one_rank"] = all(torch.equal(a[f], c[f].cpu()) for f in c)
            res["one_rank_fleet_tick_ms_median"] = 1e3 * statistics.median(one.tick_seconds)
        if r > 1:
            # the same mesh with the estimator on K7 (the tick whose host
            # time the merge competes with), then the two all-reduces of a
            # tick alone: their share of each tick
            chain = run_fleet(build_fleet("cartpole4", None, dev, scenarios=b, mesh=fmesh, seed=5,
                                          estimator_chain=True), t_end=1.0, report_every=1.0)
            check(chain.survival == 1.0 and chain.statuses_ok, f"chain fleet {s}x{r}: survival {chain.survival}")
            res[f"fleet_{s}x{r}_chain_tick_ms_median"] = 1e3 * statistics.median(chain.tick_seconds)
            rows = torch.randn((b, N + 2), generator=gen, device=dev)
            mcfg = fl.cfg

            def merge():
                merge_rows(mcfg, rows, fmesh, "rollouts")
                torch.cuda.synchronize(dev)

            for _ in range(3):
                merge()
            times = []
            for _ in range(50):
                t0 = time.perf_counter()
                merge()
                times.append(time.perf_counter() - t0)
            res["allreduce_ms_median"] = 1e3 * statistics.median(times)
            res["allreduce_share_of_tick"] = res["allreduce_ms_median"] / res[f"fleet_{s}x{r}_tick_ms_median"]
            res["allreduce_share_of_chain_tick"] = (res["allreduce_ms_median"]
                                                    / res[f"fleet_{s}x{r}_chain_tick_ms_median"])
    res["launches"] = dict(launches)
    res["ok"] = True
    Path(out).write_text(json.dumps(res))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this run needs a CUDA GPU")

    from mpc_rs_tpu_torch.apps import run as cli
    from mpc_rs_tpu_torch.controllers.mppi import MppiConfig, MppiStatus
    from mpc_rs_tpu_torch.models.params import CartPoleParams
    from mpc_rs_tpu_torch.ops import build, mppi_cuda
    from mpc_rs_tpu_torch.ops.mppi_cuda import CartPoleShaped4, mppi_chain_fused, mppi_solve_fused
    from mpc_rs_tpu_torch.ops.philox import philox_normal
    from mpc_rs_tpu_torch.runtime.profile_fleet import ptxas_kernel
    from mpc_rs_tpu_torch.runtime.profile_partials import ptxas_partials, sass_counts

    dev = torch.device("cuda", 0)
    model = CartPoleShaped4(CartPoleParams.single_wheel(), 0.1)

    def cfg(k, lam=0.5):
        return MppiConfig(n_horizon=N, n_rollouts=k, lambda_=lam, std_dev=3.0, limit=(-20.0, 20.0))

    def x0(values=X0):
        return torch.tensor(values, dtype=torch.float32, device=dev)

    # 1. the device
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi_line()
    power_limit = smi.rsplit(",", 1)[-1].strip()
    card = {"card": name, "power_limit": power_limit}
    emit({"phase": "device", "name": name, "capability": list(cap), "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__, "cuda": torch.version.cuda})
    check(cap == (9, 0), f"compute capability {cap}, the kernels are built for sm_90a")

    # 2. build: one nvcc a source, all at once, one library
    t0 = time.perf_counter()
    so, build_s = build.build()
    build.load_library()
    build_wall = time.perf_counter() - t0
    log = so.with_suffix(".log").read_text() if so.with_suffix(".log").is_file() else ""
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "library": so.name, "build_s": build_s, "build_wall_s": build_wall,
          "built_model_horizons": sorted(mppi_cuda.BUILT), "ptxas": ptxas})
    # the production partials instantiations' ptxas report (their static
    # SASS is read after the fleet and estimator phases)
    partials_ptxas = ptxas_partials(log)
    spills = [ln for ln in partials_ptxas if "spill stores" in ln and " 0 bytes spill stores" not in ln]
    emit({"phase": "ptxas_partials", "build_s": build_s, "ptxas_partials": partials_ptxas})
    check(not spills, f"ptxas spills in partials instantiations: {spills}")
    registers = {}
    for ln in partials_ptxas:
        tag, used = ln.split(": ", 1)[0], re.search(r"Used (\d+) registers", ln)
        if used:
            n_steps, model_name, _, _, fast, source, rpt = tag.split("/")
            registers[(model_name, int(n_steps), int(fast), int(rpt), int(source))] = int(used.group(1))
    want = {(m, n_, f, r, src): n for (m, n_, f, r), row in PARTIALS_PTXAS.items()
            for src, n in (row.items() if isinstance(row, dict) else enumerate(row))}
    moved = {f"{k}": (want.get(k), registers.get(k)) for k in want.keys() | registers.keys()
             if want.get(k) != registers.get(k)}
    check(not moved, f"partials instantiations' ptxas registers moved (want, got): {moved}")
    # D1's instantiations (partials_body with D1's policy): registers, no spill
    d1_ptxas = ptxas_kernel(log, "kernel_mix_partials_kernel")
    d1_spills = [ln for ln in d1_ptxas if "spill stores" in ln and " 0 bytes spill stores" not in ln]
    emit({"phase": "ptxas_d1", "ptxas": d1_ptxas})
    check(sum("registers" in ln for ln in d1_ptxas) == 16, f"D1 instantiations in the ptxas report: {d1_ptxas}")
    check(not d1_spills, f"ptxas spills in the D1 kernel: {d1_spills}")
    # the estimator chain's three instantiations (K7: cartpole4, flagship6 and
    # flagship6 on the scaled sensor): registers, no spill
    k7_ptxas = ptxas_kernel(log, "estimator_chain_kernel")
    k7_spills = [ln for ln in k7_ptxas if "spill stores" in ln and " 0 bytes spill stores" not in ln]
    emit({"phase": "ptxas_estimator_chain", "ptxas": k7_ptxas})
    check(sum("registers" in ln for ln in k7_ptxas) == 3, f"K7 instantiations in the ptxas report: {k7_ptxas}")
    check(not k7_spills, f"ptxas spills in the estimator chain: {k7_spills}")
    # the rows' finalize and the cart-pole's solves past N = 8, one kernel
    # each for every horizon: registers (the solves' HORIZONS_REGISTERS), no spill
    for kernel, want in (("fleet_finalize_kernel", None), ("mppi_horizons_kernel", HORIZONS_REGISTERS)):
        lines = ptxas_kernel(log, kernel)
        spilled = [ln for ln in lines if "spill stores" in ln and " 0 bytes spill stores" not in ln]
        used = [int(u.group(1)) for ln in lines if (u := re.search(r"Used (\d+) registers", ln))]
        emit({"phase": f"ptxas_{kernel}", "ptxas": lines})
        check(len(used) == 1 and not spilled and want in (None, used[0]),
              f"{kernel}: one kernel with no spill{f' and {want} registers' if want else ''}: {lines}")

    # 2b. the HIL apps of this slice at their acceptance specs, on the host's
    # clock, before any torch.profiler session of the run
    mpc_commu_phase(dev, card)
    acceptance_phase(dev, card)
    # the library's SASS dump, beside the phases that follow (none of them
    # gated on the host's clock)
    library_sass_job(so)

    # 3. K2 with external noise against the plain version in float64
    gen = torch.Generator(device=dev).manual_seed(1234)
    k2_err = 0.0
    for k in (819_200, 10_240, 1000, 1):
        noise = 3.0 * torch.randn((k, N), generator=gen, device=dev)
        u_n = 0.5 * torch.randn(N, generator=gen, device=dev)
        got_u, got_st = mppi_solve_fused(cfg(k), model, x0(), u_n, noise=noise)
        want_u, want_st = mppi_cuda.mppi_solve_plain(cfg(k), model, x0().double(),
                                                     u_n.double(), noise=noise.double())
        check(int(got_st) == int(want_st) == MppiStatus.OK, f"K2 K={k} statuses {int(got_st)}/{int(want_st)}")
        err = check_band(got_u, want_u, f"K2 K={k}")
        k2_err = max(k2_err, err)
        emit({"phase": "k2_external_noise", "n": N, "k": k, "status": int(got_st), "max_abs_err": err})

    # 4. K2 with in-kernel Philox against the plain version fed ops/philox.py noise
    k = 819_200
    for seed, solve in ((7, 0), (-3, 5)):
        got_u, got_st = mppi_solve_fused(cfg(k), model, x0(), torch.zeros(N, device=dev), seed=seed, solve=solve)
        eps = philox_normal(seed, solve, k, N, 3.0, device=dev)
        want_u, want_st = mppi_cuda.mppi_solve_plain(cfg(k), model, x0().double(),
                                                     torch.zeros(N, dtype=torch.float64, device=dev),
                                                     noise=eps.double())
        check(int(got_st) == int(want_st) == MppiStatus.OK, f"K2 philox statuses {int(got_st)}/{int(want_st)}")
        err = check_band(got_u, want_u, f"K2 philox seed={seed} solve={solve}")
        k2_err = max(k2_err, err)
        emit({"phase": "k2_philox", "k": k, "seed": seed, "solve": solve, "max_abs_err": err})
    probes = {
        "nan_x0": (dict(x=x0((float("nan"), 0.0, 0.1, 0.0))), MppiStatus.NO_FINITE),
        "lambda_0": (dict(lam=0.0), MppiStatus.INVALID_U),
        "k_1": (dict(k=1), MppiStatus.OK),
        "k_1000": (dict(k=1000), MppiStatus.OK),
    }
    for label, (kw, want) in probes.items():
        u, st = mppi_solve_fused(cfg(kw.get("k", 512), kw.get("lam", 0.5)), model, kw.get("x", x0()),
                                 torch.zeros(N, device=dev), seed=5)
        u_plain, st_plain = mppi_cuda.mppi_solve_plain(
            cfg(kw.get("k", 512), kw.get("lam", 0.5)), model, kw.get("x", x0()), torch.zeros(N, device=dev), seed=5)
        check(int(st) == int(st_plain) == want, f"probe {label}: status {int(st)}/{int(st_plain)}, want {int(want)}")
        if want != MppiStatus.OK:
            check(bool((u == 0).all()), f"probe {label}: zero fallback")
        else:
            check(bool(torch.isfinite(u).all()), f"probe {label}: finite u")
        emit({"phase": "failure_probe", "probe": label, "status": int(st)})

    # 4b. what a solve and a chain launch, by torch.profiler: a K2 solve is
    # one kernel, a K1 chain of J solves J; the tickets are zero after them
    zeros = torch.zeros(N, device=dev)
    xt = x0()
    per_call = {}
    for label, fn, want in (
        ("k2_solve", lambda: mppi_solve_fused(cfg(819_200), model, xt, zeros, seed=1), 1),
        ("k2_solve_k10240", lambda: mppi_solve_fused(cfg(10_240), model, xt, zeros, seed=1), 1),
        ("k1_chain_j8", lambda: mppi_chain_fused(cfg(819_200), model, xt, zeros, n_solves=8, base_seed=1), 8),
        ("k1_chain_j8_plant", lambda: mppi_chain_fused(cfg(10_240), model, xt, zeros, n_solves=8, plant=True), 8),
    ):
        per_call[label] = check_kernels_per_call(fn, want, label)
    check(bool((mppi_cuda.merge_tickets(dev, 1) == 0).all()), "K1/K2 tickets not zero")
    emit({"phase": "kernels_per_call", **per_call})

    # 5. K1 with the plant on, against its plain version in float64 and
    # against sequential K2 solves with the plant stepped between them. At the
    # app's λ=0.5 the softmax's effective sample size is near 1 and a closed
    # loop turns a last-bit difference in the plant step into another winning
    # rollout within a few solves, so the plant-on chains run at λ=20, where
    # they are well conditioned (as tests/test_torch_kernels.py holds the JAX
    # chain); the app's λ is held with the state held.
    lam = 20.0
    zeros = torch.zeros(N, device=dev)
    k1_err, k1 = 0.0, {}
    k, j = 10_240, 16
    seeds = torch.arange(j, dtype=torch.int32, device=dev) * 7919 - 40
    for mode, kw, seq_seed in (
        ("seeds", dict(seeds=seeds), lambda i: (int(seeds[i]), 0)),
        ("base_seed", dict(n_solves=j, base_seed=77), lambda i: (77, i)),
    ):
        chain = mppi_chain_fused(cfg(k, lam), model, x0(), zeros, plant=True, **kw)
        plain = mppi_cuda.mppi_chain_plain(cfg(k, lam), model, x0().double(), zeros.double(), plant=True, **kw)
        x, u_n, u0s, sts = x0(), zeros, [], []
        for i in range(j):
            seed, solve = seq_seed(i)
            u_n, st = mppi_solve_fused(cfg(k, lam), model, x, u_n, seed=seed, solve=solve)
            x = torch.stack(model.step(*x.unbind(), u_n[0]))
            u0s.append(u_n[0])
            sts.append(int(st))
        check(chain.statuses.tolist() == plain.statuses.tolist() == sts == [0] * j,
              f"K1 {mode} statuses {chain.statuses.tolist()} / plain {plain.statuses.tolist()} / K2 {sts}")
        err = max(check_band(chain.u0s, plain.u0s, f"K1 {mode} u0s vs plain chain"),
                  check_band(chain.u_n, plain.u_n, f"K1 {mode} final u_n vs plain chain"),
                  check_band(chain.x, plain.x, f"K1 {mode} final x vs plain chain"))
        k1_err = max(k1_err, err)
        k1[f"max_abs_err_{mode}_vs_plain"] = err
        k1[f"max_abs_err_{mode}_vs_sequential_k2"] = max(
            check_band(chain.u0s, torch.stack(u0s), f"K1 {mode} vs sequential K2"),
            check_band(chain.x, x, f"K1 {mode} final x vs sequential K2"))
    # the kernel's plant step against the plain model step in float64, on
    # the kernel's own u0
    one = mppi_chain_fused(cfg(k), model, x0(), zeros, n_solves=1, base_seed=3, plant=True)
    want_x = torch.stack(model.step(*x0().double().unbind(), one.u0s[0].double()))
    check(int(one.statuses[0]) == 0 and float(one.u0s[0]) != 0.0, "K1 one-step chain")
    k1["max_abs_err_plant_step"] = check_band(one.x, want_x, "K1 plant step vs plain model step")
    k1_err = max(k1_err, k1["max_abs_err_plant_step"])
    # the app's λ with the state held
    held = mppi_chain_fused(cfg(k), model, x0(), zeros, seeds=seeds)
    plain = mppi_cuda.mppi_chain_plain(cfg(k), model, x0().double(), zeros.double(), seeds=seeds)
    check(plain.statuses.tolist() == held.statuses.tolist() == [0] * j, "K1 held vs plain chain statuses")
    k1["max_abs_err_held_lambda_0.5_vs_plain"] = check_band(held.u0s, plain.u0s, "K1 held vs plain chain")
    k1_err = max(k1_err, k1["max_abs_err_held_lambda_0.5_vs_plain"])
    emit({"phase": "k1_chain", "k": k, "j": j, "lambda": lam, **k1})
    # at the headline K
    k, j = 819_200, 8
    chain = mppi_chain_fused(cfg(k, lam), model, x0(), zeros, n_solves=j, base_seed=5, plant=True)
    plain = mppi_cuda.mppi_chain_plain(cfg(k, lam), model, x0().double(), zeros.double(),
                                       n_solves=j, base_seed=5, plant=True)
    check(chain.statuses.tolist() == plain.statuses.tolist() == [0] * j, "K1 K=819 200 statuses")
    err = max(check_band(chain.u0s, plain.u0s, "K1 K=819 200 u0s vs plain chain"),
              check_band(chain.x, plain.x, "K1 K=819 200 final x vs plain chain"))
    k1_err = max(k1_err, err)
    emit({"phase": "k1_chain", "k": k, "j": j, "lambda": lam, "max_abs_err_base_seed_vs_plain": err})

    # 6. the main path: the CLI app at its default K, then the device-resident chain of the same loop
    mppi_cuda.reset_launches()
    t0 = time.perf_counter()
    res = cli.main(["mppi4-non-liner", "--t-end", "10", "--log-dir", "logs/chip_smoke"])
    app_s = time.perf_counter() - t0
    k_app, ticks = 800_000, len(res.statuses)
    torch.cuda.synchronize()
    chain_main = mppi_chain_fused(cfg(k_app), model, x0(), torch.zeros(N, device=dev), n_solves=ticks,
                                  base_seed=0, plant=True)
    chain_x = chain_main.x.cpu()
    counts = dict(mppi_cuda.launches)
    check(ticks >= 100, f"the 10 s episode ran {ticks} ticks")
    check(all(s == 0 for s in res.statuses), f"app statuses {sorted(set(res.statuses))}")
    check(not res.tipped, "the app tipped past 60 degrees")
    check(abs(res.x[2]) < 0.2, f"app final |theta| = {abs(res.x[2])}")
    check(bool((chain_main.statuses == 0).all()), "chain statuses")
    check(bool(torch.isfinite(chain_x).all()) and abs(float(chain_x[2])) < 0.2, f"chain final x {chain_x.tolist()}")
    check(counts["mppi_solve_fused"] >= ticks, f"K2 launches {counts['mppi_solve_fused']} < ticks {ticks}")
    check(counts["mppi_chain_fused"] >= 1, "K1 was not launched on the main path")
    tick_ms = [1e3 * s for s in res.tick_seconds]
    emit({"phase": "main_path", "k": k_app, "ticks": ticks, "final_x": res.x.tolist(),
          "chain_final_x": chain_x.tolist(), "launches": counts, "app_s": app_s,
          "tick_ms_median": statistics.median(tick_ms), "tick_ms_max": max(tick_ms), **card})

    # timings: kernel and plain, kernel-then-plain in one process on one card
    timing = {}
    xt, u0 = x0(), torch.zeros(N, device=dev)
    solve_bytes = 2 * nbytes(xt, u0) - nbytes(xt) + 4  # in: x, u_n; out: u_n', the status
    for k in (10_240, 800_000, 819_200):
        kern = median_ms(lambda: mppi_solve_fused(cfg(k), model, xt, u0, seed=3), reps=50)
        plain_t = median_ms(lambda: mppi_cuda.mppi_solve_plain(cfg(k), model, xt, u0, seed=3), reps=10)
        timing[k] = (kern, plain_t,
                     bound(flops_of(lambda: mppi_cuda.mppi_solve_plain(cfg(k), model, xt, u0, seed=3)), solve_bytes))
        emit({"phase": "timing_k2", "k": k, "n": N, "kernel_us_per_solve": 1e3 * kern,
              "plain_us_per_solve": 1e3 * plain_t, **timing[k][2], **card})
    chain_timing = {}
    for k in (10_240, 800_000, 819_200):
        jj = 64
        kern = median_ms(lambda: mppi_chain_fused(cfg(k), model, xt, u0, n_solves=jj, base_seed=1),
                         reps=5, warmup=1) / jj
        plain_t = median_ms(lambda: mppi_cuda.mppi_chain_plain(cfg(k), model, xt, u0, n_solves=jj, base_seed=1),
                            reps=2, warmup=1) / jj
        chain_timing[k] = (kern, plain_t)
        emit({"phase": "timing_k1", "k": k, "n": N, "j": jj, "kernel_us_per_solve": 1e3 * kern,
              "plain_us_per_solve": 1e3 * plain_t, "rollouts_per_thread": mppi_cuda.rollouts_per_thread(k),
              **card})
    # the wrapper's R against R = 1 at the K1/K2 shapes, in turns; at K = 10 240
    # the wrapper takes R = 1, so R = 4 is set against it
    for k, forced in ((10_240, 4), (800_000, 1), (819_200, 1)):
        chain = lambda **kw: mppi_chain_fused(cfg(k), model, xt, u0, n_solves=64, base_seed=1, **kw)  # noqa: E731
        solve = lambda **kw: mppi_solve_fused(cfg(k), model, xt, u0, seed=3, **kw)  # noqa: E731
        turns = {}
        for path, fn, per in (("k1_per_solve", chain, 64), ("k2_per_call", solve, 1)):
            turns[path] = {"wrapper": [], str(forced): []}
            for label in ("wrapper", str(forced), str(forced), "wrapper"):
                kw = {} if label == "wrapper" else {"rollouts_per_thread": forced}
                turns[path][label].append({"device_us": 1e3 * device_ms(lambda: fn(**kw), reps=3, kernels=per) / per,
                                           "event_us": 1e3 * median_ms(lambda: fn(**kw), reps=5, warmup=1) / per})
        emit({"phase": "timing_r_turns", "k": k, "wrapper_r": mppi_cuda.rollouts_per_thread(k), "turns": turns,
              **card})

    # 7. K2 and K1 in bench.py's two configurations (bench.py:97-101): clt4a
    # in the fast tier and wallace in the exact tier, the state held. The
    # kernel's noise comes from the same partials kernel on a grid of one
    # problem (solve word 0) through the batched entry, which can write it.
    zeros = torch.zeros(N, device=dev)
    for sampler, fast in (("clt4a", True), ("wallace", False)):
        m = CartPoleShaped4(CartPoleParams.single_wheel(), 0.1, fast=fast)
        for k in (10_240, 819_200):
            out = torch.empty((1, k, N), device=dev)
            mppi_cuda.mppi_batch_partials_fused(cfg(k), m, x0()[None], zeros[None], sampler=sampler, noise_out=out,
                                                seeds=torch.tensor([11], dtype=torch.int32, device=dev))
            words = mppi_cuda.solve_noise(cfg(k), m, 11, 0, sampler, device=dev)
            noise_err = max_err(out[0], words)
            check(torch.equal(out[0], words) if sampler == "clt4a" else noise_err < 1e-4,
                  f"K2 {sampler} fast={fast} K={k}: kernel noise vs plain words {noise_err}")
            got_u, got_st = mppi_solve_fused(cfg(k), m, x0(), zeros, seed=11, sampler=sampler)
            want_u, want_st = mppi_cuda.mppi_solve_plain(cfg(k), m, x0().double(), zeros.double(),
                                                         noise=words.double())
            check(int(got_st) == int(want_st) == MppiStatus.OK, f"K2 {sampler} K={k} statuses")
            err = check_band(got_u, want_u, f"K2 {sampler} fast={fast} K={k} vs plain")
            seeds = torch.arange(8, dtype=torch.int32, device=dev) * 13 + 1
            chain = mppi_chain_fused(cfg(k), m, x0(), zeros, seeds=seeds, sampler=sampler)
            u, u0s = zeros, []
            for j in range(8):
                u, _ = mppi_solve_fused(cfg(k), m, x0(), u, seed=int(seeds[j]), sampler=sampler)
                u0s.append(u[0])
            check(chain.statuses.tolist() == [0] * 8 and torch.equal(chain.u0s, torch.stack(u0s)),
                  f"K1 {sampler} K={k}: the seeded chain differs from sequential K2 solves")
            jj = 64
            kern = median_ms(lambda: mppi_chain_fused(cfg(k), m, xt, u0, n_solves=jj, base_seed=1, sampler=sampler),
                             reps=5, warmup=1) / jj
            k2_kern = median_ms(lambda: mppi_solve_fused(cfg(k), m, xt, u0, seed=3, sampler=sampler), reps=20)
            plain = lambda: mppi_cuda.mppi_solve_plain(cfg(k), m, xt, u0, seed=3, sampler=sampler)  # noqa: E731
            plain_t = median_ms(plain, reps=5, warmup=1)
            k2_err = max(k2_err, err)
            emit({"phase": "k2_k1_bench_config", "sampler": sampler, "fast": fast, "k": k,
                  "noise_max_abs_err": noise_err, "max_abs_err": err, "chain_equals_sequential_k2": True,
                  "k1_kernel_us_per_solve": 1e3 * kern, "k2_kernel_us_per_call": 1e3 * k2_kern,
                  "plain_us_per_solve": 1e3 * plain_t, **bound(flops_of(plain), solve_bytes), **card})

    fleet = fleet_phases(dev, card)
    estimator = estimator_phases(dev, card)
    # the production partials instantiations' static SASS: each merges its rows by a ticket
    sass = sass_counts(so, Path(build.find_nvcc()).parent / "cuobjdump", library_sass(so))
    emit({"phase": "sass", "build_s": build_s, "kernels": sass})
    check(not any("mppi_finalize_kernel" in r["kernel"] for r in sass), "mppi_finalize_kernel is still built")
    production = [r for r in sass if "finalize_kernel" not in r["kernel"]]
    check(len(production) == 6 + 1 and all(r["ATOM"] >= 1 for r in production),
          f"the production partials instantiations (3 solves x R = 1, 4), the sweep's one kernel and their "
          f"tickets: {sass}")
    diag = diag_phases(dev, card)
    ukf_fidelity_phase(dev, card)
    family = family_phases(dev, card)
    hil = hil_phases(dev, card)
    multigpu = multigpu_phases(dev, card)
    sweep = tune_phases(dev, card, log)
    fleet_finish_phases(dev, card)
    gradient_mpc_phases(dev, card)
    panoc_graph_phase(dev, card)

    emit({"kernels": [
        {"name": "mppi_partials_kernel, merged in the launch (K2, mppi_solve_fused)", "route": "cuda",
         "source": COMMON_SOURCE, "replaces": f"{PALLAS}:438",
         "launches": counts["mppi_solve_fused"], "max_abs_err": k2_err,
         "ms": timing[k_app][0], "plain_ms": timing[k_app][1], "bound_ms": timing[k_app][2]["bound_ms"],
         "bound_by": timing[k_app][2]["bound_by"], "library_ms": None},
        {"name": "mpc_mppi_chain: one merged mppi_partials_kernel launch a solve (K1, mppi_chain_fused, per solve)",
         "route": "cuda",
         "source": SOURCE, "replaces": f"{PALLAS}:1004",
         "launches": counts["mppi_chain_fused"], "max_abs_err": k1_err,
         "ms": chain_timing[k_app][0], "plain_ms": chain_timing[k_app][1],
         "bound_ms": timing[k_app][2]["bound_ms"], "bound_by": timing[k_app][2]["bound_by"],
         "library_ms": None},
        *fleet,
        *estimator,
        *diag,
        *family,
        *hil,
        *sweep,
        *multigpu,
    ]})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[2:]))
    sys.exit(main())
