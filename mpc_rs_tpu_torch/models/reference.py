"""Reference-trajectory generators of the gradient-MPC apps (gen_ref,
next_plan, planning_err).

Port of ``mpc_rs_tpu/models/reference.py:15-119``. Vector form on (..., 4)
states; a horizon's references are (..., N, 4), time-major (the reference
stores them 4×N, column-major, which flattens to the same order).
"""

from __future__ import annotations

import math

import torch


def make_gen_ref_raised_cosine(n_horizon: int, velocity_gain: float = -0.4):
    """Raised-cosine parking reference — examples/op-mpc-x-calc.rs:29-39.

    ``gen_ref(x) -> (..., N, 4)`` with rows [x0(1+cosφ)/2,
    clamp(g·x0,±2)sinφ, clamp(−0.5x0,±0.35)cosφ/2, clamp(−0.5x0,±1.5)sinφ],
    φ = πi/N, the velocity gain g = −0.4 (mpc-ukf-commu.rs:192-202: −0.75).
    The phases' cos and sin are taken in float64 once and meet x in its
    dtype."""
    phases = torch.arange(n_horizon, dtype=torch.float64) * (math.pi / n_horizon)
    cos64, sin64 = torch.cos(phases), torch.sin(phases)

    def gen_ref(x):
        cosp, sinp = (v.to(dtype=x.dtype, device=x.device) for v in (cos64, sin64))
        x0 = x[..., 0]
        r0 = x0[..., None] * (1.0 + cosp) / 2.0
        r1 = torch.clamp(velocity_gain * x0, -2.0, 2.0)[..., None] * sinp
        r2 = torch.clamp(-0.5 * x0, -0.35, 0.35)[..., None] * (1.0 * cosp) / 2.0
        r3 = torch.clamp(-0.5 * x0, -1.5, 1.5)[..., None] * sinp
        return torch.stack([r0, r1, r2, r3], dim=-1)

    return gen_ref


def make_gen_ref_zero(n_horizon: int):
    """Regulator reference ≡ 0 — examples/mpc-ukf-s.rs:179-181."""

    def gen_ref(x):
        return torch.zeros(x.shape[:-1] + (n_horizon, 4), dtype=x.dtype, device=x.device)

    return gen_ref


def make_planning_err(l: float):
    """Center-of-gravity tracking error — examples/op-mpc-x.rs:86-102:
    e = [x_g_err, x_g_dot_err, θ_err, θ̇_err] with the cascaded clamped
    references (x_g target 0, v_ref = clamp(1.5·e_x,±1.5), θ_ref =
    clamp(0.5·e_v,±0.3))."""

    def planning_err(x):
        x_g = x[..., 0] + x[..., 2] * l
        x_g_ref = torch.clamp(0.0 - x_g, -1.5, 1.5)
        x_g_err = x_g_ref - x_g
        x_g_dot = x[..., 1] + x[..., 3] * l
        x_g_dot_ref = torch.clamp(1.5 * x_g_err, -1.5, 1.5)
        x_g_dot_err = x_g_dot_ref - x_g_dot
        theta_ref = torch.clamp(0.5 * x_g_dot_err, -0.3, 0.3)
        theta_err = theta_ref - x[..., 2]
        theta_dot_err = 0.0 - x[..., 3]
        return torch.stack(torch.broadcast_tensors(x_g_err, x_g_dot_err, theta_err, theta_dot_err), dim=-1)

    return planning_err


def make_next_plan(dt: float):
    """Incremental rate-limited planner — examples/mpc-ukf-x.rs:182-203:
    per-state rate limits [0.5, 1.2, 1.5, 5.0]·dt, cascaded x → ẋ → θ → θ̇."""
    m0, m1, m2, m3 = 0.5 * dt, 1.2 * dt, 1.5 * dt, 5.0 * dt

    def next_plan(plan):
        d_x = torch.clamp(0.0 - plan[..., 0], -m0, m0)
        p0 = plan[..., 0] + d_x
        dd_x = d_x - plan[..., 1]
        p1 = plan[..., 1] + torch.clamp(dd_x, -m1, m1)
        d_theta = d_x * 0.5 - plan[..., 2]
        p2 = plan[..., 2] + torch.clamp(d_theta, -m2, m2)
        dd_theta = d_theta * 3.0 - plan[..., 3]
        p3 = plan[..., 3] + torch.clamp(dd_theta, -m3, m3)
        return torch.stack([p0, p1, p2, p3], dim=-1)

    return next_plan


def make_plan_err(l: float):
    """Tracking error against an explicit plan — examples/mpc-ukf-x.rs:207-216."""

    def plan_err(x, plan):
        x_g = x[..., 0] + x[..., 2] * l
        x_g_dot = x[..., 1] + x[..., 3] * l
        return torch.stack([plan[..., 0] - x_g, plan[..., 1] - x_g_dot,
                            plan[..., 2] - x[..., 2], plan[..., 3] - x[..., 3]], dim=-1)

    return plan_err


def rollout_plan(next_plan, plan0, n: int):
    """The planner unrolled n steps → (..., n, 4) (mpc-ukf-x.rs:228-231)."""
    plans, p = [], plan0
    for _ in range(n):
        p = next_plan(p)
        plans.append(p)
    return torch.stack(plans, dim=-2)
