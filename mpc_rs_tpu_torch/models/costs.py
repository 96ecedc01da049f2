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


def rollout_states(dynamics_step, x0, u_seq):
    """The states x₁ … x_N (..., N, n) of the vector-form ``dynamics_step``
    from x0 (..., n) under the controls u_seq (..., N), one step at a time."""
    x, xs = x0, []
    for k in range(u_seq.shape[-1]):
        x = dynamics_step(x, u_seq[..., k])
        xs.append(x)
    return torch.stack(xs, dim=-2)


def tracking_stage_costs(e, u, x2, gain, barrier):
    """GAIN[0]·e0² + GAIN[1]·e1⁴ + GAIN[2]·e2⁴ + GAIN[3]·e3⁴ + GAIN[4]·u² +
    barrier·max(cosh θ − 1.2, 0) of errors e (..., 4), controls u and
    angles x2, elementwise (op-mpc-x.rs:113-123, mpc-ukf-x.rs:232-238)."""
    sq = e * e  # integer powers as products, as XLA's integer_pow takes them
    c = (gain[0] * sq[..., 0] + gain[1] * (sq[..., 1] * sq[..., 1]) + gain[2] * (sq[..., 2] * sq[..., 2])
         + gain[3] * (sq[..., 3] * sq[..., 3]) + gain[4] * (u * u))
    if barrier:
        c = c + barrier * torch.clamp(torch.cosh(x2) - 1.2, min=0.0)
    return c


def make_tracking_rollout_cost(dynamics_step, planning_err, gain, barrier=1.0, n_state=4, rollout=None):
    """Horizon-rollout tracking cost — examples/op-mpc-x.rs:106-125
    (``mpc_rs_tpu/models/costs.py:47-80``).

    Rolls the vector-form ``dynamics_step(x, u) -> x`` on (..., n_state)
    over a control sequence u (..., N) and sums ``tracking_stage_costs`` of
    e = ``planning_err(x)`` at each step (barrier weight 1.0:
    op-mpc-x.rs:123). The states are stepped one at a time and the stage
    costs of all N steps taken at once on the stacked states: the same
    arithmetic a step as the JAX scan, in a third of the operations that
    autograd records. ``rollout(x0, u_seq) -> (..., N, n_state)`` replaces
    the stepping (e.g. a linear model's two matmuls). Returns
    ``cost(x0, u_seq) -> (...)``.
    """

    def cost(x0, u_seq):
        xs = rollout_states(dynamics_step, x0, u_seq) if rollout is None else rollout(x0, u_seq)
        return tracking_stage_costs(planning_err(xs), u_seq, xs[..., 2], gain, barrier).sum(dim=-1)

    return cost
