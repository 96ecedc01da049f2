"""Example registry of the port: reference binary name → runner.

All 26 of the JAX package's apps: the MPPI application family (``mppi2``,
``mppi4``, ``mppi4-non-liner``, ``mppi4-non-liner-s``,
``mppi4-non-liner-ukf``), the scenario ``fleet`` (MPPI, or the QP fleet with
``--controller qp``), the hardware-in-the-loop apps (``uart``,
``mppi4-commu``, ``mppi4-ukf-commu``, ``mpc-ukf-commu``), the fleet serving
bridge ``serve``, the (λ, σ) sweep ``tune``, the estimator ladder with the
PID baseline (``one-liner-kf`` … ``ukf-pen3``, ``pid``), and the
gradient-MPC apps (``op-en2``, ``op-mpc-x``, ``op-mpc-x-calc``,
``op-mpc-x-calc-nl``, ``mpc-ukf-x``, ``mpc-ukf-s``).
"""

from __future__ import annotations

from mpc_rs_tpu_torch.apps import commu_examples, estimator_examples, mpc_examples, mppi_examples
from mpc_rs_tpu_torch.apps import fleet as fleet_mod
from mpc_rs_tpu_torch.apps import serve as serve_mod
from mpc_rs_tpu_torch.apps import tune as tune_mod

EXAMPLES = {
    "mppi2": mppi_examples.mppi2,
    "mppi4": mppi_examples.mppi4,
    "mppi4-non-liner": mppi_examples.mppi4_non_liner,
    "mppi4-non-liner-s": mppi_examples.mppi4_non_liner_s,
    "mppi4-non-liner-ukf": mppi_examples.mppi4_non_liner_ukf,
    "uart": commu_examples.uart,
    "mppi4-commu": commu_examples.mppi4_commu,
    "mppi4-ukf-commu": commu_examples.mppi4_ukf_commu,
    "mpc-ukf-commu": commu_examples.mpc_ukf_commu,
    "fleet": fleet_mod.fleet,  # scenario-fleet north star (BASELINE.json)
    "serve": serve_mod.serve,  # one batched solve a tick for B robot links
    "tune": tune_mod.tune,  # the (λ, σ) grid, one sweep launch a tick
    "one-liner-kf": estimator_examples.one_liner_kf,
    "two-liner-kf": estimator_examples.two_liner_kf,
    "ukf-one": estimator_examples.ukf_one,
    "ukf-two": estimator_examples.ukf_two,
    "ukf-pen": estimator_examples.ukf_pen,
    "ukf-pen2": estimator_examples.ukf_pen2,
    "ukf-pen3": estimator_examples.ukf_pen3,
    "pid": estimator_examples.pid,
    "op-en2": mpc_examples.op_en2,
    "op-mpc-x": mpc_examples.op_mpc_x,
    "op-mpc-x-calc": mpc_examples.op_mpc_x_calc,
    "op-mpc-x-calc-nl": mpc_examples.op_mpc_x_calc_nl,
    "mpc-ukf-x": mpc_examples.mpc_ukf_x,
    "mpc-ukf-s": mpc_examples.mpc_ukf_s,
}


def get_example(name: str):
    if name not in EXAMPLES:
        raise KeyError(f"unknown example {name!r}; choose from {sorted(EXAMPLES)}")
    return EXAMPLES[name]
