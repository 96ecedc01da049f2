"""Stage costs of the port, component-wise on tensors.

Port of ``mpc_rs_tpu/models/costs.py``; the kernels carry the same cost as
the ``Shaped4`` device functor (``ops/csrc/mppi_kernels.cu``).
"""

from __future__ import annotations

import torch


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
