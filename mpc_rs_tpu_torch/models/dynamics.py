"""Plant models of the port, component-wise on tensors.

Port of ``mpc_rs_tpu/models/dynamics.py``. A step takes the state as
unpacked tensors (any common shape, any float dtype) plus the control and
returns the next-state components, so one definition serves the (K,)-wide
rollouts of the plain MPPI tier, the (B,)-wide fleet plant and estimator,
and the float64 host step of the apps.

The operation order and the grouping of Python-float constants are those of
the JAX package: a leading product of floats is folded in double and meets
the tensor once. The CUDA kernels carry the controller models as device
functors with the same constants folded on the host
(``ops/csrc/mppi_common.cuh``: ``CartPoleNonlinearT``, ``Flagship4``,
``DoubleIntegrator``, ``CartPoleLinear``, ``Commu4``).

The exact nonlinear cart-pole and ``make_accel6`` also step Python floats
(``math``'s sin/cos), as the fake MCU of the hardware apps does on the host;
the other makers take tensors only.

``fast=True`` swaps sin/cos for the polynomials of ``ops/fastmath.py`` and
divides once, by ``fdiv``/``freciprocal``: exact division here, the hardware
approximate reciprocal inside the kernel.

A tensor divided by a Python float goes through ``_div``: one IEEE division
on every device, as in the kernels and the JAX reference.
"""

from __future__ import annotations

import math

import torch


def _div(a, b: float):
    """a / b, rounded once, for a tensor or a Python float ``a`` and a
    Python float ``b``. On a CUDA tensor PyTorch would multiply by the
    float32 reciprocal of a Python-float divisor, which is an ulp off for
    many quotients (about one in five for the wheel radius); a 0-d tensor on
    the same device makes it divide."""
    if isinstance(a, torch.Tensor) and a.is_cuda:
        return a / a.new_full((), b)
    return a / b

from mpc_rs_tpu_torch.models.params import CartPoleParams
from mpc_rs_tpu_torch.ops import fastmath


def _sin(x):
    """sin of a tensor, or of a Python float (the fake MCU's host step)."""
    return torch.sin(x) if isinstance(x, torch.Tensor) else math.sin(x)


def _cos(x):
    return torch.cos(x) if isinstance(x, torch.Tensor) else math.cos(x)


def _sincos(fast: bool):
    if fast:
        return fastmath.fsincos
    return lambda th: (_sin(th), _cos(th))


def as_vector_fn(step, n: int):
    """A component-wise ``step(*xs, u)`` as ``f(x, u)`` on (..., n) tensors
    (``mpc_rs_tpu/utils/structs.py:28-41``): the components broadcast and
    stack on the last axis, so one step maps a state, a batch or a sigma set."""

    def f(x, u):
        out = step(*(x[..., i] for i in range(n)), u)
        return torch.stack(torch.broadcast_tensors(*out), dim=-1)

    return f


def make_double_integrator(dt: float):
    """2-state double integrator — examples/mppi2.rs:22-27
    (``dynamics.py:22-31``). x0 += x1*dt (old x1); x1 += u*dt."""

    def step(x0, x1, u):
        return x0 + x1 * dt, x1 + u * dt

    return step


def make_cartpole_linear(p: CartPoleParams, dt: float):
    """Linear 4-state wheeled pendulum — examples/mppi4.rs:82-89
    (``dynamics.py:34-54``). Sequential (semi-implicit) update: x3 from old
    x2; x2 from *new* x3; x1 from *new* x2; x0 from *new* x1 (Rust mutates
    in place). State: [x, dx, theta, dtheta]. The kernels carry it as the
    ``CartPoleLinear`` functor with the same four constants."""
    d = p.d_lin
    a32 = p.mass_line / d * p.m2 * p.g * p.l
    b3 = -p.m2 * p.l / d / p.r_w * p.kt
    a12 = -p.m2 * p.m2 * p.g * p.l * p.l / d
    b1 = (p.m2 * p.l * p.l + p.j2) / d / p.r_w * p.kt

    def step(x0, x1, x2, x3, u):
        x3 = x3 + (a32 * x2 + b3 * u) * dt
        x2 = x2 + x3 * dt
        x1 = x1 + (a12 * x2 + b1 * u) * dt
        x0 = x0 + x1 * dt
        return x0, x1, x2, x3

    return step



def make_cartpole_linear_pid(p: CartPoleParams, dt: float):
    """The PID example's linear cart-pole — examples/pid.rs:62-78
    (``dynamics.py:329-351``). ``make_cartpole_linear`` but for the
    reference's D constant, which takes ``J1 / R_W * R_W`` (== J1, * and /
    associate left) for ``J1 / (R_W * R_W)``; kept, so trajectories match."""
    mass_line = p.m1 + p.m2 + p.j1 / p.r_w * p.r_w  # quirk: == m1 + m2 + j1
    d = mass_line * (p.m2 * p.l * p.l + p.j2) - p.m2 * p.m2 * p.l * p.l
    a32 = mass_line / d * p.m2 * p.g * p.l
    b3 = -p.m2 * p.l / d / p.r_w * p.kt
    a12 = -p.m2 * p.m2 * p.g * p.l * p.l / d
    b1 = (p.m2 * p.l * p.l + p.j2) / d / p.r_w * p.kt

    def step(x0, x1, x2, x3, u):
        x3 = x3 + (a32 * x2 + b3 * u) * dt
        x2 = x2 + x3 * dt
        x1 = x1 + (a12 * x2 + b1 * u) * dt
        x0 = x0 + x1 * dt
        return x0, x1, x2, x3

    return step

def make_cartpole_nonlinear(p: CartPoleParams, dt: float | None = None, *, fast: bool = False):
    """Nonlinear 4-state cart-pole — examples/mppi4-non-liner.rs:81-94.

    Fully explicit: every component reads the *old* state. State-dependent
    denominator d = D0 − M2²L²cos²θ. State: [x, dx, theta, dtheta].
    If ``dt`` is None the returned step takes dt as a trailing argument
    (examples/mppi4-non-liner-s.rs:195-209).
    """
    sincos = _sincos(fast)
    d0 = p.d0
    ml = p.m2 * p.l

    def step_dt(x0, x1, x2, x3, u, dt):
        s, c = sincos(x2)
        d = d0 - ml * ml * c * c
        thrust = _div(p.kt * u, p.r_w) + ml * x3 * x3 * s
        term1 = p.mass_line * p.m2 * p.g * p.l * s
        term2 = thrust * ml * c
        term3 = (p.j2 + p.m2 * p.l * p.l) * thrust
        term4 = p.m2 * p.g * p.l * p.l * s * c
        if fast:
            # one reciprocal feeds both accelerations (dynamics.py:85-93)
            inv_d_dt = fastmath.fdiv(dt, d)
            n3 = x3 + (term1 - term2) * inv_d_dt
            n1 = x1 + (term3 + term4) * inv_d_dt
        else:
            n3 = x3 + (term1 - term2) / d * dt
            n1 = x1 + (term3 + term4) / d * dt
        n2 = x2 + x3 * dt
        n0 = x0 + x1 * dt
        return n0, n1, n2, n3

    if dt is None:
        return step_dt
    return lambda x0, x1, x2, x3, u: step_dt(x0, x1, x2, x3, u, dt)


def make_ddot(p: CartPoleParams, *, fast: bool = False):
    """Second-order core (ddot_x, ddot_theta) — mppi4-non-liner-ukf.rs:126-139.

    Takes (dx, theta, dtheta, u, f) with f the disturbance force; two driven
    wheels. A literal Python ``0.0`` for f specialises the model as the JAX
    package does at trace time (``dynamics.py:126-157``): the controller
    rollout never evaluates cos(dtheta) or the force terms.
    """
    sincos = _sincos(fast)
    fcos = fastmath.fcos if fast else torch.cos
    d1 = p.d1_two
    ml = p.m2 * p.l
    mll_j2 = p.m2 * p.l * p.l + p.j2

    def ddot_fn(dx, theta, dtheta, u, f):
        f_zero = isinstance(f, (int, float)) and f == 0.0
        s, c = sincos(theta)
        d = d1 - (ml * c) ** 2
        if fast:
            # one reciprocal feeds both quotients (same denominator)
            inv_d = fastmath.freciprocal(d)
            num_x = (
                mll_j2 * ml * dtheta * dtheta * s
                - (ml**2) * p.g * s * c
                + (2.0 * mll_j2 / p.r_w) * p.kt * u
            )
            fs = p.m2 * p.g * s if f_zero else p.m2 * p.g * s - 2.0 * f
            num_th = (
                -(ml**2) * dtheta * dtheta * s * c
                + fs * (p.l * p.mass_line_two)
                - (2.0 * ml / p.r_w) * p.kt * u * c
            )
            if not f_zero:
                cdt = fcos(dtheta)
                num_x = num_x + mll_j2 * f * cdt
                num_th = num_th - ml * f * cdt * cdt
            return inv_d * num_x, inv_d * num_th
        # ddot_x — mppi4-non-liner-ukf.rs:128-133
        term1 = mll_j2 * ml / d * dtheta * dtheta * s
        term2 = -(ml**2) * p.g / d * s * c
        term3 = 2.0 * mll_j2 / (d * p.r_w) * p.kt * u
        ddot_x = term1 + term2 + term3
        if not f_zero:
            ddot_x = ddot_x + mll_j2 / d * f * fcos(dtheta)
        # ddot_theta — mppi4-non-liner-ukf.rs:134-138
        t1 = -(ml**2) / d * dtheta * dtheta * s * c
        fs = p.m2 * p.g * s if f_zero else p.m2 * p.g * s - 2.0 * f
        t2 = fs * p.l * p.mass_line_two / d
        t3 = -2.0 * ml / (d * p.r_w) * p.kt * u * c
        ddot_theta = t1 + t2 + t3
        if not f_zero:
            ddot_theta = ddot_theta - ml * f * fcos(dtheta) ** 2 / d
        return ddot_x, ddot_theta

    return ddot_fn


def make_flagship4(p: CartPoleParams, dt: float, *, fast: bool = False):
    """4-state controller model of the flagship — mppi4-non-liner-ukf.rs:141-148.

    State [x, dx, theta, dtheta]; semi-implicit: theta from new dtheta,
    x from new dx.
    """
    ddot = make_ddot(p, fast=fast)

    def step(x0, x1, x2, x3, u):
        ddx, ddth = ddot(x1, x2, x3, u, 0.0)
        n3 = x3 + ddth * dt
        n2 = x2 + n3 * dt
        n1 = x1 + ddx * dt
        n0 = x0 + n1 * dt
        return n0, n1, n2, n3

    return step


def make_flagship6(p: CartPoleParams):
    """6-state plant/UKF model — mppi4-non-liner-ukf.rs:150-159.

    State [x, dx, ddx, theta, dtheta, ddtheta]; accelerations are states.
    Sequential cascade using *new* values; takes (u, dt, f) at call time.
    """
    ddot = make_ddot(p)

    def step(x0, x1, x2, x3, x4, x5, u, dt, f=0.0):
        ddx, ddth = ddot(x1, x3, x4, u, f)
        n5 = ddth
        n4 = x4 + n5 * dt
        n3 = x3 + n4 * dt
        n2 = ddx
        n1 = x1 + n2 * dt
        n0 = x0 + n1 * dt
        return n0, n1, n2, n3, n4, n5

    return step


def make_accel6(p: CartPoleParams, with_force: bool = True, quirk_denominator: bool = False):
    """6-state explicit model with the accelerations as states — three
    reference variants share it (``dynamics.py:222-267``). State [x, dx,
    ddx, theta, dtheta, ddtheta]; every read is of the old state, and
    (u, dt, f) come at call time.

    - mpc-ukf-s.rs:135-155: ``with_force=True`` (denominator cos θ);
    - mpc-ukf-commu.rs:151-166: ``with_force=False`` (denominator cos θ),
      the fake MCU's plant;
    - mppi4-ukf-commu.rs:137-153: ``with_force=False,
      quirk_denominator=True``, that app's UKF model.

    ``quirk_denominator`` keeps mppi4-ukf-commu.rs:139 as it is: its
    denominator takes ``cos(x[2])``, the ẍ slot, d = D1 − (M2 L cos ẍ)²."""
    d1 = p.d1_two
    ml = p.m2 * p.l
    mll_j2 = p.m2 * p.l * p.l + p.j2

    def step(x0, x1, x2, x3, x4, x5, u, dt, f=0.0):
        c, s = _cos(x3), _sin(x3)
        d_cos = _cos(x2) if quirk_denominator else c
        d = d1 - (ml * d_cos) ** 2
        n0 = x0 + x1 * dt
        n1 = x1 + x2 * dt
        term1 = mll_j2 * ml / d * x4 * x4 * s
        term2 = -(ml**2) * p.g / d * s * c
        term3 = 2.0 * mll_j2 / (d * p.r_w) * p.kt * u
        n2 = term1 + term2 + term3
        if with_force:
            n2 = n2 + mll_j2 / d * f * c
        n3 = x3 + x4 * dt
        n4 = x4 + x5 * dt
        t1 = -(ml**2) / d * x4 * x4 * s * c
        t3 = -2.0 * ml / (d * p.r_w) * p.kt * u * c
        if with_force:
            t2 = (p.m2 * p.g * s - 2.0 * f) * p.l * p.mass_line_two / d
            t4 = -ml * f * c * c / d
            n5 = t1 + t2 + t3 + t4
        else:
            t2 = p.m2 * p.g * p.l * p.mass_line_two / d * s
            n5 = t1 + t2 + t3
        return n0, n1, n2, n3, n4, n5

    return step


def make_commu4(p: CartPoleParams, dt: float):
    """4-state controller model of the HW flagship — mppi4-ukf-commu.rs:154-169
    (``dynamics.py:270-294``). State [x, dx, theta, dtheta]; fully explicit
    (all reads old state). The kernels carry it as the ``Commu4`` functor."""
    d1 = p.d1_two
    ml = p.m2 * p.l
    mll_j2 = p.m2 * p.l * p.l + p.j2

    def step(x0, x1, x2, x3, u):
        c, s = torch.cos(x2), torch.sin(x2)
        d = d1 - (ml * c) ** 2
        n0 = x0 + x1 * dt
        term1 = mll_j2 * ml / d * x3 * x3 * s
        term2 = -(ml**2) * p.g / d * s * c
        term3 = 2.0 * mll_j2 / (d * p.r_w) * p.kt * u
        n1 = x1 + (term1 + term2 + term3) * dt
        n2 = x2 + x3 * dt
        t1 = -(ml**2) / d * x3 * x3 * s * c
        t2 = p.m2 * p.g * p.l * p.mass_line_two / d * s
        t3 = -2.0 * ml / (d * p.r_w) * p.kt * u * c
        n3 = x3 + (t1 + t2 + t3) * dt
        return n0, n1, n2, n3

    return step


def make_pen6(p: CartPoleParams, dt: float):
    """6-state single-wheel UKF model — examples/ukf-pen3.rs:34-51
    (``dynamics.py:297-326``). State [x, dx, ddx, theta, dtheta, ddtheta];
    explicit. The reference's quirk is kept: the denominator takes
    ``cos(x[2])``, the ẍ slot (ukf-pen3.rs:37)."""
    d0 = p.d0
    ml = p.m2 * p.l

    def step(x0, x1, x2, x3, x4, x5, u):
        c, s = torch.cos(x3), torch.sin(x3)
        d = d0 - (ml * torch.cos(x2)) ** 2
        n0 = x0 + x1 * dt
        n1 = x1 + x2 * dt
        thrust = _div(p.kt * u, p.r_w) + ml * x4 * x4 * s
        term3 = (p.j2 + p.m2 * p.l * p.l) * thrust
        term4 = p.m2 * p.g * p.l * p.l * s * c
        n2 = (term3 + term4) / d
        n3 = x3 + x4 * dt
        n4 = x4 + x5 * dt
        term1 = p.mass_line * p.m2 * p.g * p.l * s
        term2 = thrust * ml * c
        n5 = (term1 - term2) / d
        return n0, n1, n2, n3, n4, n5

    return step


def linear_ab(p: CartPoleParams, dt: float, two_wheel: bool = False):
    """Discrete-time (A, B) of the linearized cart-pole as nested Python
    floats, the same numbers as ``mpc_rs_tpu/models/dynamics.py:354-380``.

    Single-wheel: examples/op-mpc-x-calc.rs:10-21.
    Two-wheel:    examples/mpc-ukf-s.rs:101-111.
    """
    if two_wheel:
        d = p.d_lin_two
        a_th = p.mass_line_two * p.m2 * p.g * p.l / d * dt
        b_dx = 2.0 * (p.m2 * p.l * p.l + p.j2) / (d * p.r_w) * p.kt * dt
        b_dth = -2.0 * p.m2 * p.l / (d * p.r_w) * p.kt * dt
    else:
        d = p.d_lin
        a_th = p.mass_line / d * p.m2 * p.g * p.l * dt
        b_dx = (p.m2 * p.l * p.l + p.j2) / d / p.r_w * p.kt * dt
        b_dth = -p.m2 * p.l / d / p.r_w * p.kt * dt
    a = [
        [1.0, dt, 0.0, 0.0],
        [0.0, 1.0, -p.m2 * p.m2 * p.g * p.l * p.l / d * dt, 0.0],
        [0.0, 0.0, 1.0, dt],
        [0.0, 0.0, a_th, 1.0],
    ]
    b = [[0.0], [b_dx], [0.0], [b_dth]]
    return a, b
