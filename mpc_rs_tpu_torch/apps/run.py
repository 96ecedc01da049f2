"""CLI entry: ``python -m mpc_rs_tpu_torch.apps.run <example> [options]``.

Runs on the CUDA device by default and raises when there is none; the plain
PyTorch path runs only with ``--device cpu``. ``--device`` is the torch
device here; the serial link of the hardware apps, which the JAX CLI calls
``--device``, is ``--serial`` (a comma-separated list, one path a robot, for
``serve``).
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    """One subcommand per example, each taking only the options it uses."""
    from mpc_rs_tpu_torch.ops.philox import SAMPLERS

    def common_options(t_end: float) -> argparse.ArgumentParser:
        common = argparse.ArgumentParser(add_help=False)
        common.add_argument("--k", type=int, default=None, help="MPPI rollouts (default: reference K)")
        common.add_argument("--t-end", type=float, default=t_end, help=f"sim duration [s] (default {t_end:g})")
        common.add_argument("--seed", type=int, default=0, help="PRNG seed")
        common.add_argument("--device", default="cuda",
                            help="torch device: cuda (fused kernels, default) or cpu (plain path)")
        return common

    common = common_options(10.0)
    ap = argparse.ArgumentParser(
        prog="mpc_rs_tpu_torch.apps.run",
        description="Run a reference-example workload on the PyTorch/CUDA port.",
    )
    sub = ap.add_subparsers(dest="example", required=True, metavar="example")

    sampler = argparse.ArgumentParser(add_help=False)
    sampler.add_argument("--sampler", choices=list(SAMPLERS), default="box-muller",
                         help="in-kernel noise generator (default box-muller)")
    log_dir = argparse.ArgumentParser(add_help=False)
    log_dir.add_argument("--log-dir", default="logs", help="CSV log directory")

    # examples/mppi2.rs runs 5 s
    sub.add_parser("mppi2", parents=[common_options(5.0), sampler], help="MPPI on a double integrator (N=40)")
    sub.add_parser("mppi4", parents=[common, log_dir, sampler], help="MPPI on the linear cart-pole")
    sub.add_parser("mppi4-non-liner", parents=[common, log_dir], help="single-robot MPPI closed loop")
    mppi_s = sub.add_parser("mppi4-non-liner-s", parents=[common, log_dir, sampler],
                            help="multi-rate loop: MPPI at 10 Hz, UKF(4,3) on a delayed sensor")
    mppi_s.add_argument("--ref-qr", action="store_true",
                        help="the reference's hand-tuned UKF Q/R (tips within 1-2 s at 333 Hz)")
    ukf = sub.add_parser("mppi4-non-liner-ukf", parents=[common, log_dir, sampler],
                         help="flagship multi-rate loop: 6-state plant, UKF2(6,5), the 2 N pulse")
    ukf.add_argument("--use-ukf-estimate", action="store_true",
                     help="feed the controller the UKF estimate (default: the true state, DEBUG_UKF)")
    ukf.add_argument("--ukf-alpha", type=float, default=None,
                     help="UKF sigma-point spread α (default 1 with --use-ukf-estimate, else 1e-3)")
    ukf.add_argument("--control-period", type=float, default=None,
                     help="controller period [s] (default 3e-3; 0: a solve every physics tick)")

    ukf.add_argument("--console", action="store_true",
                     help="ANSI Con:/Rcv: console streams (mppi4-non-liner-ukf.rs:291-349)")

    def hil_options(serial_help: str) -> argparse.ArgumentParser:
        hil = argparse.ArgumentParser(add_help=False)
        hil.add_argument("--serial", default="/dev/ttyUSB0", help=serial_help)
        hil.add_argument("--sim-mcu", action="store_true",
                         help="replace the robot with a fake MCU behind a PTY")
        hil.add_argument("--time-scale", type=float, default=1.0,
                         help="sim seconds per wall second for --sim-mcu (slow-motion twin, <1 for slow hosts)")
        return hil

    hil = hil_options("serial device of the robot (115200 baud, COBS frames)")
    sub.add_parser("uart", parents=[common, hil], help="serial echo smoke test: Control out, State in")
    sub.add_parser("mppi4-commu", parents=[common, hil, sampler],
                   help="HW-in-loop MPPI on the nonlinear cart-pole (State in, Control out)")
    commu = sub.add_parser("mppi4-ukf-commu", parents=[common, hil, log_dir, sampler],
                           help="HW flagship: Sensor3 with dropout, UKF2(6,5), MPPI N=20 K=8e5")
    commu.add_argument("--console", action="store_true",
                       help="ANSI Con:/Rcv: console streams (mppi4-non-liner-ukf.rs:291-349)")
    commu.add_argument("--ukf-dtype", choices=["float32", "float64"], default="float32",
                       help="the UKF's precision on the host (default float32, the JAX app's; float64 is "
                            "the reference's, in which its alpha=1e-3 filter stays finite)")
    serve = sub.add_parser("serve", parents=[common, hil_options(
        "comma-separated serial devices, one per robot")], help="B robot links, one batched solve a tick")
    serve.add_argument("--robots", type=int, default=8, help="number of robot links B")
    serve.add_argument("--stale-timeout", type=float, default=0.5,
                       help="seconds without a frame before a robot gets zero control")
    serve.add_argument("--pipeline-depth", type=int, default=0,
                       help="batched solves kept in flight beyond the one consumed (0: synchronous); each "
                            "level adds one period of control latency")
    serve.add_argument("--ticks-per-dispatch", type=int, default=1,
                       help="stream the first M entries of each plan at successive ticks, dispatching every "
                            "M ticks (M=1: the reference's freshest-state-wins posture)")
    serve.add_argument("--control-period", type=float, default=None,
                       help="control tick period [s] of simulated time (default 0.01)")
    serve.add_argument("--report-every", type=float, default=1.0, help="report period [s] of wall time")

    panoc = argparse.ArgumentParser(add_help=False)
    panoc.add_argument("--max-iter", type=int, default=None, help="PANOC iteration budget (default: the app's)")

    mpc_commu = sub.add_parser("mpc-ukf-commu", parents=[common, hil, panoc],
                               help="HW gradient MPC: Sensor3, UKF2(6,5), condensed-QP PANOC at N=40 (float64)")
    mpc_commu.add_argument("--console", action="store_true",
                           help="ANSI Con:/Rcv: console streams (mppi4-non-liner-ukf.rs:291-349)")
    mpc_commu.add_argument("--ukf-dtype", choices=["float32", "float64"], default="float32",
                           help="the UKF's precision on the host (default float32, the JAX app's)")

    fleet = sub.add_parser("fleet", parents=[common, log_dir, panoc], help="scenario fleet: B closed loops per tick")
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
    fleet.add_argument("--ukf-layout", choices=["soa", "aos"], default=None,
                       help="fleet estimator layout: batch-minor SoA (default) or the batched AoS filter")
    fleet.add_argument("--sqrt-method", choices=["eigh", "jacobi", "cholesky"], default=None,
                       help="the AoS filter's sigma root (default: eigh for cartpole4, jacobi for flagship6; "
                            "the SoA layout always takes jacobi)")
    fleet.add_argument("--resume", default=None,
                       help="fleet checkpoint to resume from: the port's fleet.pt, or a JAX fleet.npz "
                            "(its PRNG keys are dropped and the generator is seeded from --seed)")
    fleet.add_argument("--controller", choices=["mppi", "qp"], default="mppi",
                       help="fleet controller: sampling MPPI or batched gradient MPC (condensed QP)")
    fleet.add_argument("--qp-solver", choices=["newton", "panoc"], default="newton",
                       help="the QP fleet's solver: batched projected Newton (default) or batched PANOC")
    fleet.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                       help="under torch.distributed.run: the collectives' backend (default NCCL on the "
                            "card, gloo on the CPU; gloo runs two ranks on one card)")

    tune = sub.add_parser("tune", parents=[common, log_dir],
                          help="batched (lambda, sigma) sweep of the mppi4-non-liner loop, one launch a tick")
    tune.add_argument("--lambdas", default="0.1,0.5,1.4,2.5", help="comma-separated MPPI lambda grid")
    tune.add_argument("--sigmas", default="1,3,10", help="comma-separated MPPI sigma grid")
    tune.add_argument("--tune-seeds", type=int, default=8, help="episodes (seeds) per grid cell")

    # gradient MPC (float64 solves on --device)
    sub.add_parser("op-en2", parents=[common], help="PANOC smoke test: min |u|^2 on a unit ball")
    op_x = sub.add_parser("op-mpc-x", parents=[common, log_dir, panoc],
                          help="nonlinear-cost gradient MPC, N=50 rollout with a cosh barrier")
    op_x.add_argument("--fd", action="store_true",
                      help="the reference's finite-difference gradients (parity mode, its quirk kept)")
    sub.add_parser("op-mpc-x-calc", parents=[common, log_dir, panoc], help="condensed-QP PANOC, linear plant")
    sub.add_parser("op-mpc-x-calc-nl", parents=[common, log_dir, panoc],
                   help="condensed-QP PANOC, nonlinear plant (model mismatch)")
    sub.add_parser("mpc-ukf-x", parents=[common, log_dir, panoc],
                   help="PANOC on a UKF(4,2) estimate with a rate-limited planner and a control low-pass")
    ukf_s = sub.add_parser("mpc-ukf-s", parents=[common, log_dir, panoc],
                           help="multi-rate loop: two-wheel condensed-QP PANOC, UKF(6,5), the 2 N pulse")
    ukf_s.add_argument("--use-ukf-estimate", action="store_true",
                       help="feed the controller the UKF estimate (default: the true state, DEBUG_UKF)")

    # the estimator ladder (float64 on --device): the seed drives the noise
    ladder = argparse.ArgumentParser(add_help=False)
    ladder.add_argument("--seed", type=int, default=0, help="numpy seed of the noise")
    ladder.add_argument("--device", default="cuda",
                        help="torch device: cuda (default) or cpu")
    for name, what in (("one-liner-kf", "1-D KF with Gaussian algebra"),
                       ("two-liner-kf", "2-state linear KF, Joseph form"),
                       ("ukf-one", "scalar UKF"), ("ukf-two", "2-state UKF with an x1^4 drift"),
                       ("ukf-pen", "4-state pendulum UKF, [dx, dtheta] observed"),
                       ("ukf-pen2", "4-state pendulum UKF, rpm/gyro observed"),
                       ("ukf-pen3", "6-state pendulum UKF, force IMU observed")):
        sub.add_parser(name, parents=[ladder], help=what)
    pid = sub.add_parser("pid", parents=[ladder, log_dir], help="velocity-form PID baseline (tips by design)")
    pid.add_argument("--t-end", type=float, default=10.0, help="sim duration [s] (default 10)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    from mpc_rs_tpu_torch.apps.registry import get_example

    return get_example(args.example)(args)


if __name__ == "__main__":
    main()
