"""Example registry of the port: reference binary name → runner.

Ported so far: the MPPI application family (``mppi2``, ``mppi4``,
``mppi4-non-liner``, ``mppi4-non-liner-s``, ``mppi4-non-liner-ukf``), the
scenario ``fleet``, the hardware-in-the-loop apps (``uart``,
``mppi4-commu``, ``mppi4-ukf-commu``) and the fleet serving bridge
``serve``; ROADMAP.md lists the rest.
"""

from __future__ import annotations

from mpc_rs_tpu_torch.apps import commu_examples, mppi_examples
from mpc_rs_tpu_torch.apps import fleet as fleet_mod
from mpc_rs_tpu_torch.apps import serve as serve_mod

EXAMPLES = {
    "mppi2": mppi_examples.mppi2,
    "mppi4": mppi_examples.mppi4,
    "mppi4-non-liner": mppi_examples.mppi4_non_liner,
    "mppi4-non-liner-s": mppi_examples.mppi4_non_liner_s,
    "mppi4-non-liner-ukf": mppi_examples.mppi4_non_liner_ukf,
    "uart": commu_examples.uart,
    "mppi4-commu": commu_examples.mppi4_commu,
    "mppi4-ukf-commu": commu_examples.mppi4_ukf_commu,
    "fleet": fleet_mod.fleet,  # scenario-fleet north star (BASELINE.json)
    "serve": serve_mod.serve,  # one batched solve a tick for B robot links
}


def get_example(name: str):
    if name not in EXAMPLES:
        raise KeyError(f"unknown example {name!r}; choose from {sorted(EXAMPLES)}")
    return EXAMPLES[name]
