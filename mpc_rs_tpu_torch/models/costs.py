"""Stage costs of the port, component-wise on tensors.

Port of ``mpc_rs_tpu/models/costs.py``; the kernels carry the same costs as
the ``Shaped4``, ``Diag4``, ``Quad2`` and ``Commu4Cost`` device functors
(``ops/csrc/mppi_common.cuh``).
"""

from __future__ import annotations

import torch


def quad2(x0, x1):
    """x0² + x1² — examples/mppi2.rs:53."""
    return x0 * x0 + x1 * x1


def shaped4(x0, x1, x2, x3):
    """Shaped cart-pole cost with clamps — examples/mppi4.rs:20-27.

    2·clamp(x0,±2)² + 3·clamp(x1+2·clamp(x0,±2),±5)² +
    5·(x2+0.35·clamp(x0,±0.75))² + 1.2·x3².
    ``torch.clamp`` propagates NaN, as ``jnp.clip`` does, so a NaN state
    gives a NaN cost.
    """
    xc = torch.clamp(x0, -2.0, 2.0)
    t1 = 2.0 * xc * xc
    a = torch.clamp(x1 + 2.0 * xc, -5.0, 5.0)
    t2 = 3.0 * (a * a)
    b = x2 + 0.35 * torch.clamp(x0, -0.75, 0.75)
    t3 = 5.0 * (b * b)
    t4 = 1.2 * x3 * x3
    return t1 + t2 + t3 + t4


def make_diag4(c0: float, c1: float, c2: float, c3: float):
    """Diagonal quadratic Σ cᵢ xᵢ² — examples/mppi4-non-liner-ukf.rs:21,33-35
    (C = [0.1, 0.1, 1.0, 0.5]). The kernels carry it as the ``Diag4``
    device functor."""

    def cost(x0, x1, x2, x3):
        return c0 * x0 * x0 + c1 * x1 * x1 + c2 * x2 * x2 + c3 * x3 * x3

    return cost


def commu4(x0, x1, x2, x3):
    """HW flagship cost — examples/mppi4-ukf-commu.rs:171-177.

    0 + 1.2 + 3θ² + 3θ̇² (the 1.2 constant is in the reference verbatim).
    x0 and x1 do not enter; the result takes x2's shape."""
    return 1.2 + 3.0 * x2 * x2 + 3.0 * x3 * x3
