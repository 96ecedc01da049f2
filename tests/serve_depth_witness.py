"""``serve``'s plan streaming at N = 16 (``--ticks-per-dispatch 2
--control-period 0.05``) at pipeline depth 1 and 0, in the JAX package and
in the port, on the CPU: how many of the 8 simulated robots stay upright
(|θ| < 60°) in each run (run manually; prints JSON lines).

    python tests/serve_depth_witness.py --seeds 0,1,2,3 --k 8192 --time-scale 0.2
    python tests/serve_depth_witness.py --control-period 0.01 --k 128 --depths 1 --torch-root DIR

``--control-period 0.01 --k 128`` is the acceptance's ``serve-stream``
(N = 40); ``--torch-root`` runs the port of another checkout (the JAX
package always from this one).

Each run is one ``serve --sim-mcu --robots 8`` process of its own, at the
same flags and ``--seed`` in both packages (the JAX app on its CPU backend,
``--cpu``; the port with ``--device cpu``), two at a time. The JAX app's CPU
solve draws ``jax.random`` noise and the port's Philox noise, so the two
packages are compared by their counts, not robot by robot. A line reports
the upright robots, the ticks, the dispatches and the median solve (and, in the port,
dispatch) milliseconds, so that a run whose solve did not keep up with the
tick can be told apart.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONE_THREAD = {"OMP_NUM_THREADS": "1", "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"}
CHILD = """
import json, sys
sys.path.insert(0, {root!r} if {package!r} == "jax" else {torch_root!r})
if {package!r} == "jax":
    from mpc_rs_tpu.apps import run
    argv = [*{argv!r}, "--cpu"]
else:
    from mpc_rs_tpu_torch.apps import run
    argv = [*{argv!r}, "--device", "cpu"]
if __name__ == "__main__":
    s = run.main(argv)
    print("RESULT " + json.dumps({{k: s.get(k) for k in ("horizon", "ticks", "dispatches", "max_abs_theta", "rx", "tx",
                                                       "solve_ms_p50", "dispatch_ms_p50")}}))
"""


def one_run(package: str, depth: int, seed: int, args) -> dict:
    argv = ["serve", "--sim-mcu", "--robots", "8", "--k", str(args.k), "--time-scale", str(args.time_scale),
            "--t-end", str(args.t_end), "--ticks-per-dispatch", "2", "--control-period", str(args.control_period),
            "--pipeline-depth", str(depth), "--seed", str(seed)]
    code = CHILD.format(root=ROOT, torch_root=os.path.abspath(args.torch_root), package=package, argv=argv)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                          env={**os.environ, **ONE_THREAD, "JAX_PLATFORMS": "cpu"}, timeout=600)
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    if proc.returncode != 0 or not line:
        return {"package": package, "depth": depth, "seed": seed, "error": proc.stderr[-2000:]}
    s = json.loads(line[-1][len("RESULT "):])
    upright = sum(th < math.radians(60.0) for th in s["max_abs_theta"])
    return {"package": package, "root": ROOT if package == "jax" else os.path.abspath(args.torch_root),
            "depth": depth, "seed": seed, "k": args.k, "control_period": args.control_period,
            "time_scale": args.time_scale, "t_end": args.t_end, "upright": upright, **s}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--k", type=int, default=8192)
    ap.add_argument("--time-scale", type=float, default=0.2)
    ap.add_argument("--t-end", type=float, default=1.0)
    ap.add_argument("--control-period", type=float, default=0.05)
    ap.add_argument("--torch-root", default=ROOT)
    ap.add_argument("--packages", default="jax,torch")
    ap.add_argument("--depths", default="1,0")
    ap.add_argument("--workers", type=int, default=2)
    args = ap.parse_args()
    jobs = [(p, int(d), int(s)) for p in args.packages.split(",") for d in args.depths.split(",")
            for s in args.seeds.split(",")]
    with ThreadPoolExecutor(args.workers) as pool:
        for row in pool.map(lambda j: one_run(*j, args), jobs):
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
