"""tune's sweep launch and three solves from two checkouts: each checkout's
library is built and run in a process of its own on one seeded input set,
its outputs saved, then the two compared.

- The sweep at N = 8 on tune's default grid (B = 96), both noise sources,
  at K = 1 024 and 800 000, at the wrapper's own blocking (the parent's R or
  the change's tiles a block), beside the float64 plain version on the same
  noise: the comparison reports each checkout's distance from the float64
  answer and the two checkouts' distance from each other, each beside the
  f32 band (atol 2e-4 + rtol 1e-3 of the float64 answer) and twice the plain
  float32 version's own distance, whichever is larger.
- The solves, bit for bit: K2 at N = 8 (the cart-pole, exact box-muller, K =
  800 000), K5 flagship6 (B = 1 024, K = 8 192, fast clt4a) and serve's
  batch at N = 40 (the cart-pole, B = 8, K = 8 192, box-muller).

    python mpc_rs_tpu_torch/runtime/sweep_bits.py --root _cmp/parent --out logs/bits_parent.pt
    python mpc_rs_tpu_torch/runtime/sweep_bits.py --root . --out logs/bits_change.pt
    python mpc_rs_tpu_torch/runtime/sweep_bits.py --compare logs/bits_parent.pt logs/bits_change.pt

Needs a CUDA card for the runs; prints one JSON line a run or comparison,
with each build's ptxas lines of the sweep kernel.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from pathlib import Path

# the sweep kernel's name in a ptxas log: the change's one kernel, or a
# checkout's mppi_sweep_kernel<R, 8> from before the sweep took N at run time
SWEEP_RE = re.compile(r"mpc17mppi_sweep_kernelE|mppi_sweep_kernelILi\d+ELi8ELi0EE")
BAND = (2e-4, 1e-3)  # atol, rtol: the JAX package's f32 band (tests/test_pallas.py:59)


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
        elif SWEEP_RE.search(func) and ("registers" in line or "spill" in line):
            ptxas.append(f"{func.split()[-1]}: {line.strip()}")
    dev = torch.device("cuda", 0)
    grid = [(lam, sig, r) for lam in (0.1, 0.5, 1.4, 2.5) for sig in (1.0, 3.0, 10.0) for r in range(8)]
    lam = torch.tensor([g[0] for g in grid], dtype=torch.float32, device=dev)
    sig = torch.tensor([g[1] for g in grid], dtype=torch.float32, device=dev)
    seeds = torch.tensor([g[2] for g in grid], dtype=torch.int32, device=dev)
    b = lam.numel()
    model = mppi_cuda.CartPoleShaped4(CartPoleParams.single_wheel(), 0.1)
    outs, plain = {}, {}
    for k in (1024, 800_000):
        cfg = MppiConfig(n_horizon=8, n_rollouts=k, lambda_=1.0, std_dev=1.0, limit=(-20.0, 20.0))
        gen = torch.Generator(device=dev).manual_seed(88)
        xs = torch.randn((b, 4), generator=gen, device=dev) * torch.tensor([0.3, 0.1, 0.1, 0.1], device=dev)
        u_ns = torch.randn((b, 8), generator=gen, device=dev)
        ext = torch.randn((b, k, 8), generator=gen, device=dev) * sig[:, None, None]
        for source in ("external", "box-muller"):
            kw = dict(noise=ext) if source == "external" else dict(seeds=seeds, solve=7)
            noise = ext if source == "external" else mppi_cuda.sweep_noise(cfg, seeds, 7, sig)
            key = f"K{k}/{source}"
            outs[key] = [t.cpu() for t in mppi_cuda.mppi_sweep_batch_fused(cfg, model, xs, u_ns, lam, sig, **kw)]
            # the plain version's rows of 256 rollouts (its answer does not
            # depend on the rows but in the last bits)
            plain[key] = {str(dt): [t.cpu() for t in mppi_cuda.mppi_sweep_batch_plain(
                cfg, model, xs.to(dt), u_ns.to(dt), lam, sig, noise=noise)] for dt in (torch.float64, torch.float32)}
            del noise
        del ext
        torch.cuda.empty_cache()
    solves = {}
    gen = torch.Generator(device=dev).manual_seed(89)
    cfg = MppiConfig(n_horizon=8, n_rollouts=800_000, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
    x = torch.tensor([0.5, 0.0, 0.1, 0.0], device=dev)
    u_n = torch.randn(8, generator=gen, device=dev)
    solves["K2 cartpole N=8 exact box-muller K=800000"] = [
        t.cpu() for t in mppi_cuda.mppi_solve_fused(cfg, model, x, u_n, seed=5, solve=3)]
    flag = mppi_cuda.Flagship4Diag4(CartPoleParams.two_wheel(), 0.05, fast=True)
    cfg = MppiConfig(n_horizon=8, n_rollouts=8192, lambda_=1.4, std_dev=3.0, limit=(-20.0, 20.0))
    xs = torch.randn((1024, 4), generator=gen, device=dev) * 0.1
    u_ns = torch.randn((1024, 8), generator=gen, device=dev)
    fseeds = torch.arange(1024, dtype=torch.int32, device=dev)
    solves["K5 flagship6 B=1024 K=8192 fast clt4a"] = [
        t.cpu() for t in mppi_cuda.mppi_solve_batch_fused(cfg, flag, xs, u_ns, seeds=fseeds, sampler="clt4a")]
    serve = mppi_cuda.CartPoleShaped4(CartPoleParams.single_wheel(), 0.02)
    cfg = MppiConfig(n_horizon=40, n_rollouts=8192, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
    xs = torch.randn((8, 4), generator=gen, device=dev) * torch.tensor([0.3, 0.1, 0.1, 0.1], device=dev)
    u_ns = torch.randn((8, 40), generator=gen, device=dev)
    solves["serve cartpole N=40 B=8 K=8192 box-muller"] = [
        t.cpu() for t in mppi_cuda.mppi_solve_batch_fused(cfg, serve, xs, u_ns, seeds=fseeds[:8], sampler="box-muller")]
    torch.save({"out": outs, "plain": plain, "solves": solves, "ptxas": ptxas, "build_s": build_s}, out)
    print(json.dumps({"root": str(root), "build_s": build_s, "ptxas": ptxas}))


def compare(a_path: Path, b_path: Path) -> None:
    """The sweep's distances (each checkout from the float64 plain version,
    and from each other), each as the largest ratio to the tolerance (the
    band, or twice the plain float32 distance), and the solves' bit
    equality."""
    import torch

    a, b = torch.load(a_path), torch.load(b_path)
    sweep = {}
    for key in a["out"]:
        row = {}
        for what, i in (("u_n", 0), ("ess", 2)):
            want = a["plain"][key][str(torch.float64)][i].double()
            f32 = a["plain"][key][str(torch.float32)][i].double()
            tol = torch.maximum(BAND[0] + BAND[1] * want.abs(), 2.0 * (f32 - want).abs())
            got_a, got_b = a["out"][key][i].double(), b["out"][key][i].double()
            row[what] = {"a_vs_f64_over_tol": float(((got_a - want).abs() / tol).max()),
                         "b_vs_f64_over_tol": float(((got_b - want).abs() / tol).max()),
                         "a_vs_b_max_abs": float((got_a - got_b).abs().max()),
                         "a_vs_b_over_tol": float(((got_a - got_b).abs() / tol).max()),
                         "a_vs_b_equal": bool(torch.equal(a["out"][key][i], b["out"][key][i]))}
        row["status_equal"] = bool(torch.equal(a["out"][key][1], b["out"][key][1]))
        sweep[key] = row
    solves = {key: all(torch.equal(x, y) for x, y in zip(a["solves"][key], b["solves"][key])) for key in a["solves"]}
    print(json.dumps({"sweep": sweep, "solves": solves, "solves_equal": all(solves.values()),
                      "sweep_within_tol": all(r[w]["b_vs_f64_over_tol"] <= 1.0 for r in sweep.values()
                                              for w in ("u_n", "ess")),
                      "ptxas": [a["ptxas"], b["ptxas"]], "build_s": [a["build_s"], b["build_s"]]}))


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
