"""Example registry of the port: reference binary name → runner.

Only ``mppi4-non-liner`` is ported so far; ROADMAP.md lists the rest.
"""

from __future__ import annotations

from mpc_rs_tpu_torch.apps import mppi_examples

EXAMPLES = {
    "mppi4-non-liner": mppi_examples.mppi4_non_liner,
}


def get_example(name: str):
    if name not in EXAMPLES:
        raise KeyError(f"unknown example {name!r}; choose from {sorted(EXAMPLES)}")
    return EXAMPLES[name]
