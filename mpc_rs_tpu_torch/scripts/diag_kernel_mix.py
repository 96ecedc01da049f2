"""Kernel op-mix probe (D1): where the time of a partials launch goes.

    python -m mpc_rs_tpu_torch.scripts.diag_kernel_mix [MODE ...] [--device cuda|cpu]

Port of ``scripts/diag_kernel_mix.py``. Each mode runs the chain of
``ops/diag_cuda.kernel_mix_chain_fused`` (K = 819 200, N = 8, the fast-tier
cart-pole with ``shaped4``, λ = 0.5, σ = 3, ±20, the state held) with parts
of the partials kernel switched off or swapped (``diag_cuda.MODES``; the
JAX script's default four when none is named): ``full`` − ``nosample`` is
the sampling's share of a solve, ``full`` − ``noroll`` the rollout's.

Timing is the JAX script's ``time_mode``: chains of J_short = 200 and
J_long = 1 600 solves, each call ending in a synchronising read of its u0s,
3 repetitions on the host clock, and the marginal (min long − min short) /
(J_long − J_short) per solve, accepted when positive and over a tenth of
the long call (else repeated, up to 3 attempts, then min long / J_long).

Per mode it prints µs per solve, G rollout-steps per second and lane-cycles
per rollout-step: seconds × SM clock × SMs × 128 FP32 lanes / (K·N), with
the SM count and the SM clock (``nvidia-smi`` right after the mode's timed
calls) read on the card in the same run. Then the sampling and rollout
shares. Runs on the CUDA card unless ``--device cpu`` is given (the plain
version; no lane-cycles there), and raises without a card.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

from mpc_rs_tpu_torch.apps.common import resolve_device
from mpc_rs_tpu_torch.controllers.mppi import MppiConfig
from mpc_rs_tpu_torch.models.params import CartPoleParams
from mpc_rs_tpu_torch.ops.diag_cuda import MODES, kernel_mix_chain_fused
from mpc_rs_tpu_torch.ops.mppi_cuda import CartPoleShaped4

N, K, X0 = 8, 819_200, (0.5, 0.0, 0.1, 0.0)
J_SHORT, J_LONG = 200, 1600  # diag_kernel_mix.py:297
DEFAULT_MODES = ("full", "clt", "nosample", "noroll")  # diag_kernel_mix.py:328
FP32_LANES = 128  # FP32 lanes of an SM, Hopper


def query_gpu(fields: str) -> list[str]:
    """``nvidia-smi --query-gpu=<fields>`` of card 0, one string per field."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    return [f.strip() for f in out.stdout.strip().splitlines()[0].split(",")]


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_mode(run, j_short: int = J_SHORT, j_long: int = J_LONG, reps: int = 3) -> float:
    """Seconds per solve by marginal chain length (diag_kernel_mix.py:297-316);
    ``run(j, seed)`` runs a chain of j solves and returns once it is done."""
    run(j_short, 0)
    run(j_long, 0)
    for attempt in range(3):
        ts, tl = [], []
        for r in range(reps):
            t0 = time.perf_counter()
            run(j_short, attempt * 100 + 7 * r + 1)
            ts.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            run(j_long, attempt * 100 + 13 * r + 2)
            tl.append(time.perf_counter() - t0)
        sec = (min(tl) - min(ts)) / (j_long - j_short)
        if sec > 0 and (min(tl) - min(ts)) > 0.1 * min(tl):
            return sec
    return min(tl) / j_long


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="mpc_rs_tpu_torch.scripts.diag_kernel_mix",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("modes", nargs="*", metavar="MODE",
                    help=f"modes to time, of {', '.join(MODES)} (default: {' '.join(DEFAULT_MODES)})")
    ap.add_argument("--device", default="cuda", help="cuda (the kernel, default) or cpu (the plain version)")
    return ap


def main(argv=None) -> dict:
    """Time each mode; returns {"device", "card", "sms", "modes": {mode:
    {us_per_solve, g_steps_per_s, lane_cycles_per_step, sm_clock_mhz}},
    and the two shares when their modes ran}."""
    ap = build_parser()
    args = ap.parse_args(argv)
    bad = [m for m in args.modes if m not in MODES]
    if bad:
        ap.error(f"unknown mode(s) {bad}; choose from {', '.join(MODES)}")
    dev = resolve_device(args.device)
    modes = args.modes or list(DEFAULT_MODES)
    model = CartPoleShaped4(CartPoleParams.single_wheel(), 0.1, fast=True)
    cfg = MppiConfig(n_horizon=N, n_rollouts=K, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
    x0 = torch.tensor(X0, dtype=torch.float32, device=dev)
    u0 = torch.zeros(N, dtype=torch.float32, device=dev)
    cuda = dev.type == "cuda"
    out = {"device": torch.cuda.get_device_name(dev) if cuda else "cpu", "k": K, "n": N,
           "card": card_line() if cuda else None,
           "sms": torch.cuda.get_device_properties(dev).multi_processor_count if cuda else None,
           "modes": {}}
    print(f"device: {out['card'] or 'cpu (plain version)'}; K={K} N={N}", flush=True)

    for mode in modes:
        def run(j, seed, mode=mode):
            u0s, _ = kernel_mix_chain_fused(cfg, model, x0, u0, mode=mode, n_solves=j, base_seed=seed)
            float(u0s.sum())  # waits for the chain, as the JAX script's float(run(...))

        sec = time_mode(run, J_SHORT, J_LONG)
        steps = K * N
        row = {"us_per_solve": sec * 1e6, "g_steps_per_s": steps / sec / 1e9,
               "lane_cycles_per_step": None, "sm_clock_mhz": None}
        if cuda:
            row["sm_clock_mhz"] = float(query_gpu("clocks.sm")[0])
            row["lane_cycles_per_step"] = sec * row["sm_clock_mhz"] * 1e6 * out["sms"] * FP32_LANES / steps
        out["modes"][mode] = row
        print(mode, {k2: (float(f"{v:.4g}") if isinstance(v, float) else v) for k2, v in row.items()}, flush=True)

    us = {m: r["us_per_solve"] for m, r in out["modes"].items()}
    for share, other in (("sampling", "nosample"), ("rollout", "noroll")):
        if "full" in us and other in us:
            d = us["full"] - us[other]
            out[f"{share}_us_per_solve"], out[f"{share}_share"] = d, d / us["full"]
            print(f"{share} share: {d:.1f} µs/solve ({100 * d / us['full']:.0f}%)", flush=True)
    return out


if __name__ == "__main__":
    main()
