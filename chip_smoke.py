#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each
against its plain PyTorch version on the card, drives the main path (the
``mppi4-non-liner`` closed loop through the CLI entry function, and the
device-resident chain of the same loop), and times kernels against plain
versions with CUDA events. It prints one JSON line per phase, then the
kernels line, the ``nvidia-smi`` name and power limit, and last the line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero; so
does a machine without CUDA, or a directory without the ``mpc_rs_tpu_torch``
package. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

N = 8
X0 = (0.5, 0.0, 0.1, 0.0)
F32_BAND = dict(rtol=1e-3, atol=2e-4)  # the JAX package's band (tests/test_pallas.py:59)
SOURCE = "mpc_rs_tpu_torch/ops/csrc/mppi_kernels.cu"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).abs().max())


def check_band(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """|got − want| ≤ atol + rtol·|want| elementwise; returns the max abs error."""
    g, w = got.double().cpu(), want.double().cpu()
    ok = bool(((g - w).abs() <= F32_BAND["atol"] + F32_BAND["rtol"] * w.abs()).all())
    check(ok, f"{what}: outside rtol 1e-3 / atol 2e-4 (got {g.tolist()}, want {w.tolist()})")
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


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this run needs a CUDA GPU")

    from mpc_rs_tpu_torch.apps import run as cli
    from mpc_rs_tpu_torch.controllers.mppi import MppiConfig, MppiStatus
    from mpc_rs_tpu_torch.models.params import CartPoleParams
    from mpc_rs_tpu_torch.ops import build, mppi_cuda
    from mpc_rs_tpu_torch.ops.mppi_cuda import CartPoleShaped4, mppi_chain_fused, mppi_solve_fused
    from mpc_rs_tpu_torch.ops.philox import philox_normal

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

    # 2. build
    so, build_s = build.build()
    build.load_library()
    log = so.with_suffix(".log").read_text() if so.with_suffix(".log").is_file() else ""
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "library": so.name, "build_s": build_s,
          "horizon": mppi_cuda.HORIZON, "ptxas": ptxas})

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
    for k in (10_240, 800_000, 819_200):
        kern = median_ms(lambda: mppi_solve_fused(cfg(k), model, xt, u0, seed=3), reps=50)
        plain_t = median_ms(lambda: mppi_cuda.mppi_solve_plain(cfg(k), model, xt, u0, seed=3), reps=10)
        timing[k] = (kern, plain_t)
        emit({"phase": "timing_k2", "k": k, "n": N, "kernel_us_per_solve": 1e3 * kern,
              "plain_us_per_solve": 1e3 * plain_t, **card})
    chain_timing = {}
    for k in (10_240, 800_000, 819_200):
        jj = 64
        kern = median_ms(lambda: mppi_chain_fused(cfg(k), model, xt, u0, n_solves=jj, base_seed=1),
                         reps=5, warmup=1) / jj
        plain_t = median_ms(lambda: mppi_cuda.mppi_chain_plain(cfg(k), model, xt, u0, n_solves=jj, base_seed=1),
                            reps=2, warmup=1) / jj
        chain_timing[k] = (kern, plain_t)
        emit({"phase": "timing_k1", "k": k, "n": N, "j": jj, "kernel_us_per_solve": 1e3 * kern,
              "plain_us_per_solve": 1e3 * plain_t, **card})

    emit({"kernels": [
        {"name": "mppi_partials_kernel+mppi_finalize_kernel (K2, mppi_solve_fused)", "route": "cuda",
         "source": SOURCE, "replaces": "mpc_rs_tpu/ops/mppi_pallas.py:438",
         "launches": counts["mppi_solve_fused"], "max_abs_err": k2_err,
         "ms": timing[k_app][0], "plain_ms": timing[k_app][1]},
        {"name": "mpc_mppi_chain (K1, mppi_chain_fused)", "route": "cuda",
         "source": SOURCE, "replaces": "mpc_rs_tpu/ops/mppi_pallas.py:1004",
         "launches": counts["mppi_chain_fused"], "max_abs_err": k1_err,
         "ms": chain_timing[k_app][0], "plain_ms": chain_timing[k_app][1]},
    ]})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    sys.exit(main())
