"""tune's sweep launch at any horizon, on a CUDA card: what ptxas made of
``mppi_sweep_kernel`` (one kernel for every N: registers, spill stores,
stack), and, at tune's default grid (λ ∈ {0.1, 0.5, 1.4, 2.5} × σ ∈ {1, 3,
10} × 8 seeds: B = 96) and ``--k`` rollouts (default 800 000, the main
path's), for each N of ``--horizons`` (default 1-40):

- the blocks an SM holds at the launch's shared memory
  (``mppi_cuda.sweep_occupancy``) and the tiles of 256 rollouts a block the
  wrapper picks (``sweep_tiles``), or each count of ``--tiles``;
- the device µs of one launch (``torch.profiler``, the median over a few
  launches) and the CUDA-event µs of a wrapper call, box-muller;
- the bound: the larger of the plain version's float operations
  (``chip_smoke.flops_of``, counted on 8 of the 96 problems and multiplied
  by 12: each operation's element count is the batch's times a per-problem
  count) over the FP32 peak and the bytes the launch must move over the
  HBM rate (``chip_smoke.bound``).

    python mpc_rs_tpu_torch/runtime/profile_sweep.py [--k 800000] [--horizons 1,8,20-23,224] \\
        [--tiles 4,8,16] [--out FILE]

One JSON line a horizon and tile count, each with the card's ``nvidia-smi`` name and power
limit; ``--out`` also gets them. Needs a CUDA card and the checkout's
``chip_smoke.py`` (its timing and bound helpers).
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
# mppi_sweep_kernel(CartPoleNonlinearT<false>, SweepArgs): one kernel, not a template
SWEEP_RE = re.compile(r"mpc17mppi_sweep_kernelE")
GRID = ((0.1, 0.5, 1.4, 2.5), (1.0, 3.0, 10.0), 8)  # tune's default λ, σ and seeds
CHUNK = 8  # problems a flop count runs on (of the grid's 96)


def parse_horizons(spec: str) -> list[int]:
    """'1,8,20-23' -> [1, 8, 20, 21, 22, 23]."""
    out = []
    for part in spec.split(","):
        first, _, last = part.partition("-")
        out += range(int(first), int(last or first) + 1)
    return out


def sweep_ptxas(log: str) -> list[dict]:
    """{registers, spill_bytes, stack_bytes} of the sweep kernel in a build
    log (ptxas -v): one row a kernel whose name is the sweep's."""
    rows, func = [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            func = line.split("'")[1] if "'" in line else line.split()[-1]
            if "Compiling entry function" in line and SWEEP_RE.search(func):
                rows.append({"kernel": func})
            continue
        if not SWEEP_RE.search(func) or not rows:
            continue
        if (used := re.search(r"Used (\d+) registers", line)):
            rows[-1]["registers"] = int(used.group(1))
        if (spill := re.search(r"(\d+) bytes spill stores", line)):
            rows[-1]["spill_bytes"] = int(spill.group(1))
        if (stack := re.search(r"(\d+) bytes stack frame", line)):
            rows[-1]["stack_bytes"] = int(stack.group(1))
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k", type=int, default=800_000)
    ap.add_argument("--horizons", default="1-40", help="comma-separated N or first-last spans")
    ap.add_argument("--tiles", help="comma-separated tiles of 256 rollouts a block to time (default: the wrapper's)")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from mpc_rs_tpu_torch.controllers.mppi import MppiConfig
    from mpc_rs_tpu_torch.models.params import CartPoleParams
    from mpc_rs_tpu_torch.ops import build, mppi_cuda

    if not torch.cuda.is_available():
        raise SystemExit("profile_sweep: needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    so, build_s = build.build()
    build.load_library()
    lines = []

    def emit(row):
        lines.append({**row, "nvidia_smi": smi})
        print(json.dumps(lines[-1]), flush=True)

    log = so.with_suffix(".log").read_text() if so.with_suffix(".log").is_file() else ""
    ptxas = sweep_ptxas(log)
    emit({"kind": "ptxas", "build_s": build_s, "instantiations": len(ptxas),
          "spills": [r for r in ptxas if r.get("spill_bytes")], "sweep": ptxas})

    lams, sigs, n_seeds = GRID
    cells = [(lam, sig, s) for lam in lams for sig in sigs for s in range(n_seeds)]
    lam = torch.tensor([c[0] for c in cells], dtype=torch.float32, device=dev)
    sig = torch.tensor([c[1] for c in cells], dtype=torch.float32, device=dev)
    seeds = torch.tensor([c[2] for c in cells], dtype=torch.int32, device=dev)
    b, k = lam.numel(), args.k
    model = mppi_cuda.CartPoleShaped4(CartPoleParams.single_wheel(), 0.1)
    xs = torch.tensor(cs.X0, device=dev).repeat(b, 1)
    tile_counts = parse_horizons(args.tiles) if args.tiles else [mppi_cuda.sweep_tiles(k, b, dev)]
    for n in parse_horizons(args.horizons):
        cfg = MppiConfig(n_horizon=n, n_rollouts=k, lambda_=1.0, std_dev=1.0, limit=(-20.0, 20.0))
        u0 = torch.zeros((b, n), device=dev)
        plain = lambda: mppi_cuda.mppi_sweep_batch_plain(  # noqa: E731
            cfg, model, xs[:CHUNK], u0[:CHUNK], lam[:CHUNK], sig[:CHUNK], seeds=seeds[:CHUNK], solve=3)
        flops = cs.flops_of(plain) * (b // CHUNK)
        n_bytes = cs.nbytes(xs, u0, lam, sig, seeds) + cs.nbytes(u0) + 4 * b + 4 * b
        torch.cuda.empty_cache()

        for tiles in tile_counts:
            def call():
                return mppi_cuda.mppi_sweep_batch_fused(cfg, model, xs, u0, lam, sig, seeds=seeds, solve=3,
                                                        tiles_per_block=tiles)

            call()
            dev_us = [t for _, t in cs.device_events(call, reps=3, keep=lambda name: "mppi_sweep_kernel" in name)]
            emit({"kind": "sweep", "n": n, "b": b, "k": k, "wrapper_tiles": mppi_cuda.sweep_tiles(k, b, dev),
                  **mppi_cuda.sweep_occupancy(n, tiles, dev),
                  "device_us": statistics.median(dev_us) if dev_us else None, "device_us_all": dev_us,
                  "event_us": 1e3 * cs.median_ms(call, reps=5, warmup=1), **cs.bound(flops, n_bytes)})
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(ln) + "\n" for ln in lines))


if __name__ == "__main__":
    main()
