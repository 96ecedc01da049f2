"""serve's plain path on the CPU at ``serve-stream``'s spec, for timing a
checkout against another on a loaded host, and the spec's robots' swing
on either device.

    python mpc_rs_tpu_torch/runtime/profile_serve_cpu.py [--root DIR] [--label NAME] [--seeds 5] [--load 0]
        [--device cpu|cuda]

Imports ``mpc_rs_tpu_torch`` from ``--root`` (default: the checkout this
file is in; run it as a file for that), so that one host can time a parent
unpacked with ``git archive`` beside the change, in turns. It measures:

- the plain batched solve alone at ``serve-stream``'s shape (8 robots,
  K = 128, N = 40, box-muller), 30 solves in the main thread of a fresh
  process at 1 and at 8 intra-op threads: median and worst ms;
- ``serve-stream``'s acceptance spec (``apps/acceptance.py``) over seeds
  0 .. ``--seeds`` − 1 in a fresh process, with ``--load`` CPU-bound
  processes running beside it (each a loop of torch matrix products and
  elementwise ops on its default threads, as the workers of a parallel
  test run are): whether each seed passes, and each dispatch's time from
  the dispatch's return to its solve's end (the queue behind the solve
  before it included; the pre-solve before traffic left out), taken from
  the ``Dispatch``'s future on the caller's side: median and worst; and
  each seed's largest |θ| over its 8 robots, in degrees, as their links
  read it (the spec fails a seed at 60).

``--device cuda`` runs only the last part, on the card (no dispatch times:
a card dispatch has no future). Each part runs in its own spawned process, because the threads a process
has run torch's parallel ops on change what the next one pays. Prints one
JSON line with ``--label``. Host clock only.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import statistics
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path


def _load(seconds: float) -> None:
    import torch

    x, y = torch.randn(1500, 1500), torch.randn(4_000_000)
    end = time.time() + seconds
    while time.time() < end:
        x @ x
        torch.sin(y)
        y.sum()


def _quantiles(ms: list[float]) -> dict:
    return {"n": len(ms), "median_ms": statistics.median(ms), "worst_ms": max(ms)} if ms else {"n": 0}


def solve_alone(root: str, threads: int, solves: int = 30) -> dict:
    """The plain batched solve at serve-stream's shape."""
    sys.path.insert(0, root)
    import torch

    from mpc_rs_tpu_torch.controllers.mppi import MppiConfig
    from mpc_rs_tpu_torch.models.params import CartPoleParams
    from mpc_rs_tpu_torch.ops.mppi_cuda import CartPoleShaped4, mppi_solve_batch_fused

    torch.set_num_threads(threads)
    cfg = MppiConfig(n_horizon=40, n_rollouts=128, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
    model = CartPoleShaped4(CartPoleParams.single_wheel(), 0.02)
    xs, u_ns, ms = torch.zeros(8, 4), torch.zeros(8, 40), []
    for i in range(solves):
        t0 = time.perf_counter()
        mppi_solve_batch_fused(cfg, model, xs, u_ns, seeds=torch.arange(8, dtype=torch.int32) + i,
                               sampler="box-muller")
        ms.append(1e3 * (time.perf_counter() - t0))
    return _quantiles(ms)


def serve_stream(root: str, seeds: int, device: str = "cpu") -> dict:
    """``serve-stream`` over seeds, each dispatch but the pre-solve timed to
    its solve's end on the CPU, and each seed's largest |θ|."""
    sys.path.insert(0, root)
    import math

    from mpc_rs_tpu_torch.apps import serve as serve_mod
    from mpc_rs_tpu_torch.apps.acceptance import run_one

    real, ms, thetas = serve_mod.make_batch_solver, [], []
    stop = serve_mod.RobotLink.stop

    def stop_and_record(link):
        thetas.append(link.max_abs_theta)
        stop(link)

    def timed_solver(*args, **kwargs):
        solve, dispatched = real(*args, **kwargs), []

        def timed(*a):
            d = solve(*a)
            t0 = time.perf_counter()
            if dispatched and d.future is not None:
                d.future.add_done_callback(lambda _: ms.append(1e3 * (time.perf_counter() - t0)))
            dispatched.append(d)
            return d

        return timed

    serve_mod.make_batch_solver = timed_solver
    serve_mod.RobotLink.stop = stop_and_record
    passed, worst_deg = [], []
    for seed in range(seeds):
        thetas.clear()
        passed.append(bool(run_one("serve-stream", seed, device)[0]))
        worst_deg.append(math.degrees(max(thetas)))
    return {"passed": sum(passed), "seeds": seeds, "device": device, "dispatch_to_solved": _quantiles(ms),
            "worst_abs_theta_deg": worst_deg}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="")
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--load", type=int, default=0, help="CPU-bound processes running beside serve-stream")
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    args = ap.parse_args(argv)
    root = str(Path(args.root).resolve())
    context = multiprocessing.get_context("spawn")
    row = {"label": args.label, "root": args.root, "load": args.load}
    if args.device == "cpu":
        with ProcessPoolExecutor(1, mp_context=context) as pool:
            row["solve_alone_1_thread"] = pool.submit(solve_alone, root, 1).result()
        with ProcessPoolExecutor(1, mp_context=context) as pool:
            row["solve_alone_8_threads"] = pool.submit(solve_alone, root, 8).result()
    loads = [context.Process(target=_load, args=(600.0,), daemon=True) for _ in range(args.load)]
    for p in loads:
        p.start()
    try:
        with ProcessPoolExecutor(1, mp_context=context) as pool:
            row.update(pool.submit(serve_stream, root, args.seeds, args.device).result())
    finally:
        for p in loads:
            p.terminate()
            p.join()
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
