"""The cart-pole's solves past N = 8 and the rows' finalize from two
checkouts: each checkout's library is built and run in a process of its own
on one seeded input set, its outputs saved, then the two compared (the
manner of ``runtime/sweep_bits.py``).

- serve's batch (B = 8, K = 8 192, box-muller, the wrapper's R) at N = 9,
  16, 20, 31, 32, 37, 38, 39 and 40, at λ = 20, where the float32 solve is
  well conditioned, with the noise the kernel drew (``noise_out``) and the
  float64 plain version's answer on the change's noise;
- the K-sharded solve's merged rows (``mppi_batch_partials_merged_fused``,
  the same batch) at N = 9, 16, 31, 32, 39 and 40, and the float64 plain
  version's rows;
- the finalize (``finalize_batch_fused``) at N = 8, 20 and 40 on seeded rows
  (B = 64 scenarios of 32 rows, some rows and one scenario with no finite
  rollout, one scenario whose weights sum to 0), and its float64 plain
  version.

The comparison holds the noise bit for bit, the statuses equal, and each
checkout's u_n' and rows within the f32 band of the float64 answer (atol
2e-4 + rtol 1e-3, or twice the plain float32 version's own distance where
that is larger), reporting every distance over that tolerance.

    python mpc_rs_tpu_torch/runtime/serve_bits.py --root _cmp/parent --out logs/serve_bits_parent.pt
    python mpc_rs_tpu_torch/runtime/serve_bits.py --root . --out logs/serve_bits_change.pt
    python mpc_rs_tpu_torch/runtime/serve_bits.py --compare logs/serve_bits_parent.pt logs/serve_bits_change.pt

Needs a CUDA card for the runs; prints one JSON line a run or comparison.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

BAND = (2e-4, 1e-3)  # atol, rtol: the JAX package's f32 band (tests/test_pallas.py:59)
BATCH_N = (9, 16, 20, 31, 32, 37, 38, 39, 40)
ROWS_N = (9, 16, 31, 32, 39, 40)
FINALIZE_N = (8, 20, 40)
B, K, LAMBDA = 8, 8192, 20.0


def run(root: Path, out: Path) -> None:
    os.chdir(root)
    sys.path.insert(0, str(root))
    import torch

    from mpc_rs_tpu_torch.controllers.mppi import MppiConfig
    from mpc_rs_tpu_torch.models.params import CartPoleParams
    from mpc_rs_tpu_torch.ops import build, mppi_cuda

    _, build_s = build.build()
    build.load_library()
    dev = torch.device("cuda", 0)
    seeds = torch.arange(B, dtype=torch.int32, device=dev) * 31 + 5
    res = {"batch": {}, "rows": {}, "finalize": {}, "build_s": build_s}
    for n in sorted(set(BATCH_N) | set(ROWS_N)):
        model = mppi_cuda.CartPoleShaped4(CartPoleParams.single_wheel(), 0.8 / n)
        cfg = MppiConfig(n_horizon=n, n_rollouts=K, lambda_=LAMBDA, std_dev=3.0, limit=(-20.0, 20.0))
        gen = torch.Generator(device=dev).manual_seed(900 + n)
        xs = torch.randn((B, 4), generator=gen, device=dev) * torch.tensor([0.3, 0.1, 0.1, 0.1], device=dev)
        u_ns = 0.3 * torch.randn((B, n), generator=gen, device=dev)
        noise = torch.empty((B, K, n), device=dev)
        if n in BATCH_N:
            u, st = mppi_cuda.mppi_solve_batch_fused(cfg, model, xs, u_ns, seeds=seeds, sampler="box-muller",
                                                     noise_out=noise)
            parts = {str(dt): mppi_cuda.finalize_batch_plain(cfg, mppi_cuda.mppi_batch_partials_plain(
                cfg, model, xs.to(dt), u_ns.to(dt), noise.to(dt))) for dt in (torch.float64, torch.float32)}
            res["batch"][n] = {"u": u.cpu(), "status": st.cpu(), "noise": noise.cpu(),
                               "plain": {k: [t.cpu() for t in v] for k, v in parts.items()}}
        if n in ROWS_N:
            rows = mppi_cuda.mppi_batch_partials_merged_fused(cfg, model, xs, u_ns, seeds=seeds, sampler="box-muller",
                                                              noise_out=noise)
            plain = {str(dt): mppi_cuda.mppi_batch_partials_merged_plain(
                cfg, model, xs.to(dt), u_ns.to(dt), noise.to(dt)).cpu() for dt in (torch.float64, torch.float32)}
            res["rows"][n] = {"rows": rows.cpu(), "noise": noise.cpu(), "plain": plain}
        del noise
        torch.cuda.empty_cache()
    for n in FINALIZE_N:
        cfg = MppiConfig(n_horizon=n, n_rollouts=K, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
        gen = torch.Generator(device=dev).manual_seed(700 + n)
        parts = torch.empty((64, 32, n + 2), device=dev)
        parts[..., 0] = -50.0 * torch.rand((64, 32), generator=gen, device=dev)
        parts[..., 1] = 1.0 + 255.0 * torch.rand((64, 32), generator=gen, device=dev)
        parts[..., 2:] = parts[..., 1:2] * (3.0 * torch.randn((64, 32, n), generator=gen, device=dev))
        parts[::5, ::3] = torch.tensor([mppi_cuda.NEG_BIG] + [0.0] * (n + 1), device=dev)  # rows with no finite rollout
        parts[7] = torch.tensor([mppi_cuda.NEG_BIG] + [0.0] * (n + 1), device=dev)  # NO_FINITE
        parts[9, :, 1:] = 0.0  # SUM_ZERO
        u, st = mppi_cuda.finalize_batch_fused(cfg, parts)
        plain = {str(dt): [t.cpu() for t in mppi_cuda.finalize_batch_plain(cfg, parts.to(dt))]
                 for dt in (torch.float64, torch.float32)}
        res["finalize"][n] = {"u": u.cpu(), "status": st.cpu(), "plain": plain}
    torch.save(res, out)
    print(json.dumps({"root": str(root), "build_s": build_s}))


def _over_tol(got, want, f32):
    """The largest |got - want| over the tolerance: the band of the float64
    answer ``want``, or twice the plain float32 distance where larger."""
    import torch

    want = want.double()
    tol = torch.maximum(BAND[0] + BAND[1] * want.abs(), 2.0 * (f32.double() - want).abs())
    return float(((got.double() - want).abs() / tol).max())


def compare(a_path: Path, b_path: Path) -> dict:
    import torch

    a, b = torch.load(a_path), torch.load(b_path)
    f64, f32 = str(torch.float64), str(torch.float32)
    out = {"batch": {}, "rows": {}, "finalize": {}}
    for n, ra in a["batch"].items():
        rb = b["batch"][n]
        want, plain32 = rb["plain"][f64][0], rb["plain"][f32][0]
        out["batch"][n] = {"noise_equal": bool(torch.equal(ra["noise"], rb["noise"])),
                           "status_equal": bool(torch.equal(ra["status"], rb["status"])),
                           "statuses_ok": bool((rb["status"] == 0).all()),
                           "a_vs_f64_over_tol": _over_tol(ra["u"], want, plain32),
                           "b_vs_f64_over_tol": _over_tol(rb["u"], want, plain32),
                           "a_vs_b_max_abs": float((ra["u"] - rb["u"]).abs().max()),
                           "a_vs_b_equal": bool(torch.equal(ra["u"], rb["u"]))}
    for n, ra in a["rows"].items():
        rb = b["rows"][n]
        want, plain32 = rb["plain"][f64], rb["plain"][f32]
        out["rows"][n] = {"noise_equal": bool(torch.equal(ra["noise"], rb["noise"])),
                          "a_vs_f64_over_tol": _over_tol(ra["rows"], want, plain32),
                          "b_vs_f64_over_tol": _over_tol(rb["rows"], want, plain32),
                          "a_vs_b_max_abs": float((ra["rows"] - rb["rows"]).abs().max()),
                          "a_vs_b_equal": bool(torch.equal(ra["rows"], rb["rows"]))}
    for n, ra in a["finalize"].items():
        rb = b["finalize"][n]
        want, plain32 = rb["plain"][f64][0], rb["plain"][f32][0]
        out["finalize"][n] = {"status_equal": bool(torch.equal(ra["status"], rb["status"])),
                              "status_plain_equal": bool(torch.equal(rb["status"], rb["plain"][f64][1])),
                              "a_vs_f64_over_tol": _over_tol(ra["u"], want, plain32),
                              "b_vs_f64_over_tol": _over_tol(rb["u"], want, plain32),
                              "a_vs_b_max_abs": float((ra["u"] - rb["u"]).abs().max()),
                              "a_vs_b_equal": bool(torch.equal(ra["u"], rb["u"]))}
    cases = [r for part in out.values() for r in part.values()]
    out["held"] = (all(r.get("noise_equal", True) and r.get("status_equal", True) for r in cases)
                   and all(r["b_vs_f64_over_tol"] <= 1.0 for r in cases))
    out["build_s"] = [a["build_s"], b["build_s"]]
    print(json.dumps(out))
    return out


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
