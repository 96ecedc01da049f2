"""tune's sweep launch at N = 8 from two checkouts, bit for bit: each
checkout's library is built and run in a process of its own on tune's
default grid (B = 96) with both noise sources at R = 1 and 4 and at K =
1 024 and 800 000, from one seeded input set; the outputs (u_n', status,
ESS) are saved, then compared, beside each build's N = 8 ptxas lines.

    python mpc_rs_tpu_torch/runtime/sweep_bits.py --root _cmp/parent --out logs/bits_parent.pt
    python mpc_rs_tpu_torch/runtime/sweep_bits.py --root . --out logs/bits_change.pt
    python mpc_rs_tpu_torch/runtime/sweep_bits.py --compare logs/bits_parent.pt logs/bits_change.pt

Needs a CUDA card for the runs; prints one JSON line a run or comparison.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from pathlib import Path

# mppi_sweep_kernel at N = 8: <R, 8> then enable_if's 0, or a checkout's
# <S, R> from before the sweep took any N
N8_RE = re.compile(r"mppi_sweep_kernelI(?:Li\d+ELi8ELi0EE|Li\d+ELi\d+EEEv)")


def run(root: Path, out: Path) -> None:
    os.chdir(root)
    sys.path.insert(0, str(root))
    import torch

    from mpc_rs_tpu_torch.controllers.mppi import MppiConfig
    from mpc_rs_tpu_torch.models.params import CartPoleParams
    from mpc_rs_tpu_torch.ops import build, mppi_cuda

    so, build_s = build.build()
    build.load_library()
    ptxas, func = [], ""
    for line in so.with_suffix(".log").read_text().splitlines():
        if "Function properties for" in line or "Compiling entry function" in line:
            func = line
        elif N8_RE.search(func) and ("registers" in line or "spill" in line):
            ptxas.append(f"{func.split()[-1]}: {line.strip()}")
    dev = torch.device("cuda", 0)
    grid = [(lam, sig, r) for lam in (0.1, 0.5, 1.4, 2.5) for sig in (1.0, 3.0, 10.0) for r in range(8)]
    lam = torch.tensor([g[0] for g in grid], dtype=torch.float32, device=dev)
    sig = torch.tensor([g[1] for g in grid], dtype=torch.float32, device=dev)
    seeds = torch.tensor([g[2] for g in grid], dtype=torch.int32, device=dev)
    b = lam.numel()
    model = mppi_cuda.CartPoleShaped4(CartPoleParams.single_wheel(), 0.1)
    outs = {}
    for k in (1024, 800_000):
        cfg = MppiConfig(n_horizon=8, n_rollouts=k, lambda_=1.0, std_dev=1.0, limit=(-20.0, 20.0))
        gen = torch.Generator(device=dev).manual_seed(88)
        xs = torch.randn((b, 4), generator=gen, device=dev) * torch.tensor([0.3, 0.1, 0.1, 0.1], device=dev)
        u_ns = torch.randn((b, 8), generator=gen, device=dev)
        noise = torch.randn((b, k, 8), generator=gen, device=dev) * sig[:, None, None]
        for source in ("external", "box-muller"):
            kw = dict(noise=noise) if source == "external" else dict(seeds=seeds, solve=7)
            for rpt in (1, 4):
                res = mppi_cuda.mppi_sweep_batch_fused(cfg, model, xs, u_ns, lam, sig, rollouts_per_thread=rpt, **kw)
                outs[f"K{k}/{source}/R{rpt}"] = [t.cpu() for t in res]
        del noise
    torch.save({"out": outs, "ptxas": ptxas, "build_s": build_s}, out)
    print(json.dumps({"root": str(root), "build_s": build_s, "ptxas": ptxas}))


def compare(a_path: Path, b_path: Path) -> None:
    import torch

    a, b = torch.load(a_path), torch.load(b_path)
    cases = {key: all(torch.equal(x, y) for x, y in zip(a["out"][key], b["out"][key])) for key in a["out"]}
    print(json.dumps({"cases": cases, "all_equal": all(cases.values()), "ptxas": [a["ptxas"], b["ptxas"]],
                      "build_s": [a["build_s"], b["build_s"]]}))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--compare", nargs=2, type=Path)
    args = ap.parse_args(argv)
    if args.compare:
        compare(*args.compare)
    else:
        run(args.root.resolve(), args.out.resolve())


if __name__ == "__main__":
    main()
