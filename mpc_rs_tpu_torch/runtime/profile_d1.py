"""D1, the kernel op-mix probe, on a CUDA card: device time a solve by
kernel, launches a solve, CUDA-event and host-clock times, in every mode,
beside the K1 chain it splits.

    python mpc_rs_tpu_torch/runtime/profile_d1.py [--root DIR] [--label NAME] [--out FILE] [--modes M ...]

Imports ``mpc_rs_tpu_torch`` from ``--root`` (default: the checkout this
file is in), so that one command on the card measures two checkouts in
turns (parent, change, change, parent) with this one script; it uses only
the wrappers every checkout of the port since its fourth slice has. For
that checkout, at the probe's K = 819 200 (``scripts/diag_kernel_mix.py``'s
configuration):

- the build: ptxas's registers and spill stores of each D1 instantiation;
- per mode (default all of ``diag_cuda.MODES``): the device µs a solve by
  kernel over a chain of 8 (``torch.profiler``) and the kernels a solve;
  the CUDA-event µs a solve over a chain of 64 (median of 5); and the
  host-clock marginal µs a solve of the probe's own timing
  (``diag_kernel_mix.time_mode``, chains of 200 and 1 600);
- ``full`` and ``clt`` beside K1's fast-tier box-muller and clt4 chains at
  the same K (chains of 64, six rounds in alternating order): the
  CUDA-event µs a solve, and the device µs a solve by kernel;
- where the wrapper takes ``rollouts_per_thread``: ``full``, ``nosample``,
  ``noroll`` and ``clt`` at R forced to 1 and 4, device µs a solve, in
  turns (the split of R = 4 against R = 1);
- the same solve through the partials kernel of every MPPI solve (fast
  box-muller, one problem), merged in the launch and rows only, at R = 1
  and 4, at K = 819 200 (at R = 4, 800 blocks: 1.5 waves of an H100's 528
  four-a-SM slots) and at K = 1 081 344 (two whole waves), device µs a
  solve: what the merge costs at each R, and whether the tail does;
- where the wrapper issues its launches from the C loop on every call (no
  ``diag_cuda._GRAPHS``): ``full``'s chain captured once into a CUDA graph
  at J = 64, 200 and 1 600 (``torch.cuda.CUDAGraph``, the wrapper's
  launches recorded as they are) and replayed: the CUDA-event µs a solve
  of the J = 64 replay and the host-clock marginal of the 200 and 1 600
  replays, against the C loop's, in turns.

Prints one JSON line per measurement, each with ``--label`` and the card's
``nvidia-smi`` name and power limit, and writes them to ``--out``. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch
from torch.autograd import DeviceType

N, K = 8, 819_200
X0 = (0.5, 0.0, 0.1, 0.0)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_lines(log: str, kernel: str) -> list[str]:
    """ptxas's register and spill lines of each instantiation of ``kernel``."""
    out, func = [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            func = line.split("'")[1] if "'" in line else line.split()[-1]
        elif ("registers" in line or "spill" in line) and kernel in func:
            out.append(f"{func}: {line.strip()}")
    return out


def device_us(fn, reps: int = 1) -> tuple[dict, int]:
    """(device µs by kernel name, kernels launched) of ``reps`` calls under
    torch.profiler; retried when no event was caught."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                  and not e.name.startswith(("Memcpy", "Memset"))]
        if events:
            break
    per: dict[str, float] = {}
    for e in events:
        name = e.name.replace("(anonymous namespace)::", "").removeprefix("void ")
        label = name.split("<")[0].split("(")[0].split("::")[-1].strip()
        per[label] = per.get(label, 0.0) + e.time_range.elapsed_us()
    return per, len(events)


def event_us(fn, reps: int = 5) -> float:
    """Median CUDA-event µs of one call."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(1e3 * e0.elapsed_time(e1))
    return statistics.median(times)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default="logs/profile_d1/profile_d1.jsonl")
    ap.add_argument("--modes", nargs="*", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_d1: torch.cuda.is_available() is false; this needs a CUDA card")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from mpc_rs_tpu_torch.controllers.mppi import MppiConfig
    from mpc_rs_tpu_torch.models.params import CartPoleParams
    from mpc_rs_tpu_torch.ops import build, diag_cuda, mppi_cuda
    from mpc_rs_tpu_torch.ops.mppi_cuda import CartPoleShaped4
    from mpc_rs_tpu_torch.scripts import diag_kernel_mix

    head = {"label": args.label, "root": args.root, "nvidia_smi": nvidia_smi_line()}
    lines = []

    def emit(row):
        row = {**head, **row}
        print(json.dumps(row), flush=True)
        lines.append(row)

    so, build_s = build.build()
    build.load_library()
    log = so.with_suffix(".log").read_text() if so.with_suffix(".log").is_file() else ""
    emit({"phase": "build", "build_s": build_s, "package": str(Path(diag_cuda.__file__).resolve()),
          "ptxas_d1": ptxas_lines(log, "kernel_mix")})

    dev = torch.device("cuda", 0)
    model = CartPoleShaped4(CartPoleParams.single_wheel(), 0.1, fast=True)
    cfg = MppiConfig(n_horizon=N, n_rollouts=K, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
    x, u = torch.tensor(X0, device=dev), torch.zeros(N, device=dev)

    def d1(mode, j, seed=1):
        return lambda: diag_cuda.kernel_mix_chain_fused(cfg, model, x, u, mode=mode, n_solves=j, base_seed=seed)

    def k1(sampler, j):
        return lambda: mppi_cuda.mppi_chain_fused(cfg, model, x, u, n_solves=j, base_seed=1, sampler=sampler)

    def marginal(run) -> float:
        return 1e6 * diag_kernel_mix.time_mode(run, diag_kernel_mix.J_SHORT, diag_kernel_mix.J_LONG)

    for mode in args.modes or diag_cuda.MODES:
        per, kernels = device_us(d1(mode, 8))

        def run(j, seed, mode=mode):
            u0s, _ = diag_cuda.kernel_mix_chain_fused(cfg, model, x, u, mode=mode, n_solves=j, base_seed=seed)
            float(u0s.sum())

        emit({"phase": "mode", "mode": mode, "k": K, "device_us_per_solve": {n: t / 8 for n, t in per.items()},
              "device_us_per_solve_total": sum(per.values()) / 8, "kernels_per_solve": kernels / 8,
              "event_us_per_solve": event_us(d1(mode, 64)) / 64, "marginal_us_per_solve": marginal(run)})

    pairs = {"k1_box_muller": k1("box-muller", 64), "d1_full": d1("full", 64),
             "k1_clt4": k1("clt4", 64), "d1_clt": d1("clt", 64)}
    turns = {name: [] for name in pairs}
    for rnd in range(6):
        for name in list(pairs) if rnd % 2 == 0 else list(reversed(pairs)):
            turns[name].append(event_us(pairs[name], reps=3) / 64)
    by_kernel = {name: {n: t / 64 for n, t in device_us(fn)[0].items()} for name, fn in pairs.items()}
    med = {n: statistics.median(t) for n, t in turns.items()}
    emit({"phase": "d1_vs_k1", "k": K, "j": 64, "event_us_per_solve": turns, "event_us_per_solve_median": med,
          "d1_full_over_k1_box_muller": med["d1_full"] / med["k1_box_muller"],
          "d1_clt_over_k1_clt4": med["d1_clt"] / med["k1_clt4"], "device_us_per_solve": by_kernel})

    if "rollouts_per_thread" in inspect.signature(diag_cuda.kernel_mix_chain_fused).parameters:
        split = {m: {"1": [], "4": []} for m in ("full", "nosample", "noroll", "clt")}
        for r in ("1", "4", "4", "1"):
            for m in split:
                per, _ = device_us(lambda m=m: diag_cuda.kernel_mix_chain_fused(
                    cfg, model, x, u, mode=m, n_solves=8, base_seed=1, rollouts_per_thread=int(r)))
                split[m][r].append(sum(per.values()) / 8)
        emit({"phase": "r_split", "k": K, "device_us_per_solve": split})

    split = {}
    for k in (K, 1_081_344):
        kcfg = MppiConfig(n_horizon=N, n_rollouts=k, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
        seeds = torch.tensor([7], dtype=torch.int32, device=dev)
        for rows_only in (False, True):
            fn = mppi_cuda.mppi_batch_partials_fused if rows_only else mppi_cuda.mppi_solve_batch_fused
            for r in (1, 4, 4, 1):
                per, _ = device_us(lambda: fn(kcfg, model, x[None], u[None], seeds=seeds, sampler="box-muller",
                                              rollouts_per_thread=r), reps=8)
                split.setdefault(f"k{k} {'rows_only' if rows_only else 'merged'} R={r}", []).append(
                    sum(per.values()) / 8)
    emit({"phase": "partials_split", "sampler": "box-muller", "fast": True, "device_us_per_solve": split})

    if hasattr(diag_cuda, "_GRAPHS"):  # the wrapper already replays a captured chain
        torch.cuda.synchronize()
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in lines))
        return lines

    # full's chain captured into CUDA graphs, against the C loop, in turns
    graphs = {}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for j in (64, diag_kernel_mix.J_SHORT, diag_kernel_mix.J_LONG):
            d1("full", j)()
    torch.cuda.current_stream().wait_stream(side)
    for j in (64, diag_kernel_mix.J_SHORT, diag_kernel_mix.J_LONG):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = d1("full", j)()
        graphs[j] = (g, out)
    torch.cuda.synchronize()
    want = d1("full", 64)()[0]
    graphs[64][0].replay()
    torch.cuda.synchronize()
    same = torch.equal(graphs[64][1][0], want)

    def run_graph(j, seed):
        graphs[j][0].replay()
        float(graphs[j][1][0].sum())

    def run_loop(j, seed):
        u0s, _ = diag_cuda.kernel_mix_chain_fused(cfg, model, x, u, mode="full", n_solves=j, base_seed=1)
        float(u0s.sum())

    rows = {"loop": [], "graph": []}
    for label in ("loop", "graph", "graph", "loop"):
        if label == "graph":
            ev = event_us(lambda: graphs[64][0].replay()) / 64
            rows[label].append({"event_us_per_solve": ev, "marginal_us_per_solve": marginal(run_graph)})
        else:
            rows[label].append({"event_us_per_solve": event_us(d1("full", 64)) / 64,
                                "marginal_us_per_solve": marginal(run_loop)})
    emit({"phase": "cuda_graph", "mode": "full", "k": K, "graph_u0s_equal_loop": same, "turns": rows})

    torch.cuda.synchronize()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in lines))
    return lines


if __name__ == "__main__":
    main()
