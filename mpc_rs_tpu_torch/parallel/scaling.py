"""Scaling harness: K-sharded MPPI solves/s against the number of ranks.

Port of ``mpc_rs_tpu/parallel/scaling.py``: the K-sharded solve
(``parallel/sharded_mppi.py``) at 1 → W ranks of the world, K fixed (strong
scaling), its throughput, speedup and parallel efficiency. The ranks of a
measurement form a group of their own (``dist.new_group(ranks[:w])``); the
others wait at a barrier. The inputs are built before the timed window.

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m mpc_rs_tpu_torch.parallel.scaling [--k 800000] [--dist-backend nccl]

prints one JSON line on rank 0, with the card's name and power limit. NCCL
takes one card a rank, so one card measures W = 1 only; gloo ranks that
share a card (``--dist-backend gloo``) measure what the merge costs, not
scaling, and the line says so (``"kind": "merge-cost"``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
import torch.distributed as dist

from mpc_rs_tpu_torch.controllers.mppi import MppiConfig
from mpc_rs_tpu_torch.parallel.mesh import Mesh, world
from mpc_rs_tpu_torch.parallel.sharded_mppi import make_sharded_mppi


def measure_scaling(cfg: MppiConfig, model, world_sizes=None, *, iters: int = 20,
                    device: str | torch.device = "cuda") -> list[dict]:
    """[{ranks, solves_per_s, speedup, efficiency}, ...] for each W of
    ``world_sizes`` (default 1, 2, 4, 8 up to the world), as rank 0 timed
    them; every rank of the world calls it. K = cfg.n_rollouts is the
    whole solve's, split over W ranks."""
    rank, n_world = world()
    if world_sizes is None:
        world_sizes = [w for w in (1, 2, 4, 8) if w <= n_world]
    if any(w > n_world for w in world_sizes):
        raise ValueError(f"world sizes {list(world_sizes)} exceed the world's {n_world} ranks")
    dev = torch.device(device)
    x = torch.tensor([0.5, 0.0, 0.1, 0.0], dtype=torch.float32, device=dev)
    u_n = torch.zeros(cfg.n_horizon, dtype=torch.float32, device=dev)
    grouped = dist.is_available() and dist.is_initialized()

    def sync(u):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return float(u[0])

    results, base = [], None
    for w in world_sizes:
        group = dist.new_group(list(range(w))) if grouped else None  # every rank of the world creates it
        sps = None
        if rank < w:
            mesh = Mesh({"rollouts": w}, {"rollouts": rank}, {"rollouts": group}, rank, n_world)
            solve = make_sharded_mppi(cfg, model, mesh)
            seeds = list(range(iters + 1))  # a new draw each solve, built before the clock
            sync(solve(seeds[0], x, u_n)[0])
            t0 = time.perf_counter()
            for i in range(iters):
                u, _ = solve(seeds[i + 1], x, u_n)
            sync(u)
            sps = iters / (time.perf_counter() - t0)
        if grouped:
            dist.barrier()
        if rank == 0:
            base = base or sps
            results.append({"ranks": w, "solves_per_s": sps, "speedup": sps / base,
                            "efficiency": sps / base / (w / world_sizes[0])})
    return results


def _nvidia_smi() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not available"


def main(argv=None) -> list[dict]:
    from mpc_rs_tpu_torch.models.params import CartPoleParams
    from mpc_rs_tpu_torch.ops.mppi_cuda import CartPoleShaped4
    from mpc_rs_tpu_torch.parallel.distributed import init_distributed, launched

    ap = argparse.ArgumentParser(prog="mpc_rs_tpu_torch.parallel.scaling")
    ap.add_argument("--k", type=int, default=800_000, help="rollouts of the whole solve")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if launched():
        device = init_distributed(backend=args.dist_backend, device=args.device)
    rank, n_world = world()
    backend = dist.get_backend() if dist.is_initialized() else None
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    shared = device.type == "cuda" and n_world > cards
    cfg = MppiConfig(n_horizon=8, n_rollouts=args.k, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
    model = CartPoleShaped4(CartPoleParams.single_wheel(), 0.1)
    results = measure_scaling(cfg, model, iters=args.iters, device=device)
    if rank == 0:
        print(json.dumps({"kind": "merge-cost" if shared else "scaling", "k": args.k, "world": n_world,
                          "backend": backend, "device": str(device), "cards": cards,
                          "nvidia_smi": _nvidia_smi() if device.type == "cuda" else None,
                          "results": results}), flush=True)
    return results


if __name__ == "__main__":
    main()
