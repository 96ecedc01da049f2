"""Mul-add probe (D2): does a bf16 dependent mul-add chain run faster than
the float32 one on the card?

    python -m mpc_rs_tpu_torch.scripts.diag_bf16_fma [--device cuda|cpu]

Port of ``scripts/diag_bf16_vpu.py``. It asks whether a packed-bf16
rollout state could pay: ``ops/diag_cuda.fma_chain_fused`` runs ``inner`` =
256 dependent updates x ← x·a + x₀/2 on one (rows, 128) tile of 1.5s in
each of ``steps`` CTAs, float32 on 64 rows and bf16 on 64 and 128 rows,
timed as the JAX script's ``marginal``: ``steps`` 2 000 and 16 000, 3
repetitions on the host clock around a call that ends in a synchronising
read, and (min long − min short) / 14 000 per step.

It prints µs per step (one tile's chain), G updates per second (one fused
mul-add, or one bf16 mul and add, is one update) and the share of the
card's peak:

- float32: 67 TFLOP/s (NVIDIA's H100 SXM data sheet, outside the tensor
  cores), 33.5 T fused mul-adds per second;
- bf16: the CUDA C++ Programming Guide's table "Throughput of Native
  Arithmetic Instructions (Operations per Clock Cycle per Multiprocessor)"
  gives compute capability 9.0 256 results of 16-bit floating-point add,
  multiply or multiply-add a clock an SM, twice its 128 for float32, so
  67 T bf16 mul-adds per second at the clock behind the float32 figure
  (the Hopper white paper's 133.8 TFLOP/s non-tensor BF16). An update
  rounded after each op is two instructions (a product, then a sum), so
  its ceiling is half that, 33.5 T updates per second.

Runs on the CUDA card unless ``--device cpu`` is given, and raises without
a card. On the CPU the plain version computes the tile once whatever
``steps`` is, so its marginal times nothing: that run checks the path only.
"""

from __future__ import annotations

import argparse
import time

import torch

from mpc_rs_tpu_torch.apps.common import resolve_device
from mpc_rs_tpu_torch.ops.diag_cuda import fma_chain_fused
from mpc_rs_tpu_torch.scripts.diag_kernel_mix import card_line

CONFIGS = ((torch.float32, 64), (torch.bfloat16, 64), (torch.bfloat16, 128))  # diag_bf16_vpu.py:66
INNER, STEPS_SHORT, STEPS_LONG = 256, 2000, 16000  # diag_bf16_vpu.py:64,72
PEAK_F32_FMA = 67e12 / 2  # fused mul-adds per second (data sheet)
PEAK_BF16_FMA = 2 * PEAK_F32_FMA  # bf16 mul-add results per second (Programming Guide, cc 9.0)
CEILING = {torch.float32: PEAK_F32_FMA, torch.bfloat16: PEAK_BF16_FMA / 2}  # updates per second


def marginal(run, s_short: int, s_long: int, reps: int = 3) -> float:
    """Seconds per step by marginal grid length (diag_bf16_vpu.py:49-60)."""
    run(s_short)
    run(s_long)
    ts, tl = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        run(s_short)
        ts.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        run(s_long)
        tl.append(time.perf_counter() - t0)
    return (min(tl) - min(ts)) / (s_long - s_short)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="mpc_rs_tpu_torch.scripts.diag_bf16_fma",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the kernel, default) or cpu (the plain version)")
    return ap


def main(argv=None) -> dict:
    """Time each configuration; returns {"device", "card", "configs": [{dtype,
    rows, inner, us_per_step, g_fma_per_s, peak_share, ceiling_share}]}."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    out = {"device": torch.cuda.get_device_name(dev) if cuda else "cpu",
           "card": card_line() if cuda else None, "configs": []}
    print(f"device: {out['card'] or 'cpu (plain version)'}", flush=True)
    for dtype, rows in CONFIGS:
        x = torch.full((rows, 128), 1.5, dtype=dtype, device=dev)

        def run(steps, x=x):
            float(fma_chain_fused(x, INNER, steps).float().sum())

        sec = marginal(run, STEPS_SHORT, STEPS_LONG)
        rate = rows * 128 * INNER / sec
        name = str(dtype).removeprefix("torch.")
        row = {"dtype": name, "rows": rows, "inner": INNER, "us_per_step": sec * 1e6,
               "g_fma_per_s": rate / 1e9,
               "peak_share": rate / (PEAK_BF16_FMA if dtype == torch.bfloat16 else PEAK_F32_FMA) if cuda else None,
               "ceiling_share": rate / CEILING[dtype] if cuda else None}
        out["configs"].append(row)
        share = f", {100 * row['peak_share']:.1f}% of peak, {100 * row['ceiling_share']:.1f}% of the ceiling" if cuda else ""
        print(f"dtype={name:9s} rows={rows:4d} inner={INNER} -> {sec * 1e6:8.3f} us/step, "
              f"{rate / 1e9:8.1f} G fma/s{share}", flush=True)
    return out


if __name__ == "__main__":
    main()
