"""CLI entry: ``python -m mpc_rs_tpu_torch.apps.run <example> [options]``.

Runs on the CUDA device by default and raises when there is none; the plain
PyTorch path runs only with ``--device cpu``.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    from mpc_rs_tpu_torch.apps.registry import EXAMPLES

    ap = argparse.ArgumentParser(
        prog="mpc_rs_tpu_torch.apps.run",
        description="Run a reference-example workload on the PyTorch/CUDA port.",
    )
    ap.add_argument("example", choices=sorted(EXAMPLES), help="workload name")
    ap.add_argument("--k", type=int, default=None, help="MPPI rollouts (default: reference K)")
    ap.add_argument("--t-end", type=float, default=10.0, help="sim duration [s]")
    ap.add_argument("--seed", type=int, default=0, help="PRNG seed")
    ap.add_argument("--log-dir", default="logs", help="CSV log directory")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (fused kernels, default) or cpu (plain path)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    from mpc_rs_tpu_torch.apps.registry import get_example

    return get_example(args.example)(args)


if __name__ == "__main__":
    main()
