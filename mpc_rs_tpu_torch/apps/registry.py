"""Example registry of the port: reference binary name → runner.

Ported so far: the MPPI application family (``mppi2``, ``mppi4``,
``mppi4-non-liner``, ``mppi4-non-liner-s``, ``mppi4-non-liner-ukf``) and the
scenario ``fleet``; ROADMAP.md lists the rest.
"""

from __future__ import annotations

from mpc_rs_tpu_torch.apps import fleet as fleet_mod
from mpc_rs_tpu_torch.apps import mppi_examples

EXAMPLES = {
    "mppi2": mppi_examples.mppi2,
    "mppi4": mppi_examples.mppi4,
    "mppi4-non-liner": mppi_examples.mppi4_non_liner,
    "mppi4-non-liner-s": mppi_examples.mppi4_non_liner_s,
    "mppi4-non-liner-ukf": mppi_examples.mppi4_non_liner_ukf,
    "fleet": fleet_mod.fleet,  # scenario-fleet north star (BASELINE.json)
}


def get_example(name: str):
    if name not in EXAMPLES:
        raise KeyError(f"unknown example {name!r}; choose from {sorted(EXAMPLES)}")
    return EXAMPLES[name]
