"""Plant models of the port, component-wise on tensors.

Port of ``mpc_rs_tpu/models/dynamics.py``. A step takes the state as
unpacked tensors (any common shape, any float dtype) plus the control and
returns the next-state components, so one definition serves the (K,)-wide
rollouts of the plain MPPI tier and the float64 host step of the apps.

Only the exact tier of the nonlinear cart-pole is ported so far. The
CUDA kernels carry the same model as a device functor
(``ops/csrc/mppi_kernels.cu``, ``CartPoleNonlinear``).
"""

from __future__ import annotations

import torch

from mpc_rs_tpu_torch.models.params import CartPoleParams


def make_cartpole_nonlinear(p: CartPoleParams, dt: float | None = None, *, fast: bool = False):
    """Nonlinear 4-state cart-pole — examples/mppi4-non-liner.rs:81-94.

    Fully explicit: every component reads the *old* state. State-dependent
    denominator d = D0 − M2²L²cos²θ. State: [x, dx, theta, dtheta].
    If ``dt`` is None the returned step takes dt as a trailing argument
    (examples/mppi4-non-liner-s.rs:195-209).

    The operation order and the grouping of Python-float constants are those
    of the JAX package (``mpc_rs_tpu/models/dynamics.py:74-99``): a leading
    product of floats is folded in double and meets the tensor once.
    """
    if fast:
        raise NotImplementedError(
            "fast=True (polynomial sin/cos and the approximate reciprocal of "
            "ops/fastmath.py) is not ported yet; see ROADMAP.md, queue 1, "
            "'the fast=True tier'"
        )
    d0 = p.d0
    ml = p.m2 * p.l

    def step_dt(x0, x1, x2, x3, u, dt):
        s, c = torch.sin(x2), torch.cos(x2)
        d = d0 - ml * ml * c * c
        thrust = p.kt * u / p.r_w + ml * x3 * x3 * s
        term1 = p.mass_line * p.m2 * p.g * p.l * s
        term2 = thrust * ml * c
        term3 = (p.j2 + p.m2 * p.l * p.l) * thrust
        term4 = p.m2 * p.g * p.l * p.l * s * c
        n3 = x3 + (term1 - term2) / d * dt
        n1 = x1 + (term3 + term4) / d * dt
        n2 = x2 + x3 * dt
        n0 = x0 + x1 * dt
        return n0, n1, n2, n3

    if dt is None:
        return step_dt
    return lambda x0, x1, x2, x3, u: step_dt(x0, x1, x2, x3, u, dt)
