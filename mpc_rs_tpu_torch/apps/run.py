"""CLI entry: ``python -m mpc_rs_tpu_torch.apps.run <example> [options]``.

Runs on the CUDA device by default and raises when there is none; the plain
PyTorch path runs only with ``--device cpu``.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    """One subcommand per example, each taking only the options it uses."""
    from mpc_rs_tpu_torch.ops.philox import SAMPLERS

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--k", type=int, default=None, help="MPPI rollouts (default: reference K)")
    common.add_argument("--t-end", type=float, default=10.0, help="sim duration [s]")
    common.add_argument("--seed", type=int, default=0, help="PRNG seed")
    common.add_argument("--device", default="cuda",
                        help="torch device: cuda (fused kernels, default) or cpu (plain path)")
    ap = argparse.ArgumentParser(
        prog="mpc_rs_tpu_torch.apps.run",
        description="Run a reference-example workload on the PyTorch/CUDA port.",
    )
    sub = ap.add_subparsers(dest="example", required=True, metavar="example")

    mppi = sub.add_parser("mppi4-non-liner", parents=[common], help="single-robot MPPI closed loop")
    mppi.add_argument("--log-dir", default="logs", help="CSV log directory")

    fleet = sub.add_parser("fleet", parents=[common], help="scenario fleet: B closed loops per tick")
    fleet.add_argument("--model", choices=["cartpole4", "flagship6"], default="cartpole4",
                       help="fleet plant/estimator stack")
    fleet.add_argument("--scenarios", type=int, default=1024, help="fleet batch size B")
    fleet.add_argument("--report-every", type=float, default=1.0, help="fleet report period [s]")
    fleet.add_argument("--sampler", choices=list(SAMPLERS), default=None,
                       help="in-kernel noise generator (default: clt4 below K=2048, clt4a from "
                            "K=2048 with fast math; wallace with --no-fast-math)")
    fleet.add_argument("--fast-math", action=argparse.BooleanOptionalAction, default=None,
                       help="fast-tier dynamics and sampling (default: on)")
    fleet.add_argument("--ukf-alpha", type=float, default=None,
                       help="UKF sigma-point spread α (default 1, the f32 fleets' spread)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    from mpc_rs_tpu_torch.apps.registry import get_example

    return get_example(args.example)(args)


if __name__ == "__main__":
    main()
