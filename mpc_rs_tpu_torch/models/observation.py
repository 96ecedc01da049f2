"""Observation models (hx) of the fleets and of the UKF examples, the
sensor-dropout mask of the hardware apps, and a simulated Gaussian sensor.

Port of ``mpc_rs_tpu/models/observation.py:19-113``. Vector form: ``hx(x)``
takes x of shape (..., n_state) and returns z of shape (..., n_obs), so the
same function maps a (B, n) batch or an (m, B, n) sigma-point stack.
"""

from __future__ import annotations

import math

import torch

from mpc_rs_tpu_torch.models.params import CartPoleParams

_RAD2DEG = 180.0 / math.pi


def make_hx_rpm_gyro4(p: CartPoleParams):
    """4-state → [rpm, rpm, deg/s] — examples/ukf-pen2.rs:47-53,
    mppi4-non-liner-s.rs:242-248. Wheel odometry 60/(2π R_W)·dx on both
    encoders, gyro θ̇ in deg/s."""
    k = 60.0 / (2.0 * math.pi * p.r_w)

    def hx(x):
        rpm = k * x[..., 1]
        return torch.stack([rpm, rpm, x[..., 3] * _RAD2DEG], dim=-1)

    return hx



def make_hx_vel2():
    """4-state → [dx, dθ] — examples/ukf-pen.rs:86-91, mpc-ukf-x.rs:108-113."""

    def hx(x):
        return torch.stack(torch.broadcast_tensors(x[..., 1], x[..., 3]), dim=-1)

    return hx

def make_hx_imu6(p: CartPoleParams, gear: float = 36.0):
    """6-state → [rpm, −rpm, deg/s, az/G, ax/G] — mppi4-non-liner-ukf.rs:169-179.

    State [x, dx, ddx, theta, dtheta, ddtheta]; encoders geared (×36, one
    negated); ax = G sinθ + ẍ cosθ + L θ̈ ;  az = G cosθ − ẍ sinθ + L θ̇².
    """
    k = gear * 60.0 / (2.0 * math.pi * p.r_w)

    def hx(x):
        dx, ddx = x[..., 1], x[..., 2]
        th, dth, ddth = x[..., 3], x[..., 4], x[..., 5]
        ax = p.g * torch.sin(th) + ddx * torch.cos(th) + p.l * ddth
        az = p.g * torch.cos(th) - ddx * torch.sin(th) + p.l * dth * dth
        return torch.stack([k * dx, -k * dx, dth * _RAD2DEG, az / p.g, ax / p.g], dim=-1)

    return hx


def make_hx_force6(p: CartPoleParams):
    """6-state → force-based IMU variant — examples/ukf-pen3.rs:53-63
    (``observation.py:67-84``): v = M2 G cosθ + M2 ẍ sinθ − M2 L θ̇²,
    h = −M2 G sinθ + M2 ẍ cosθ + M2 L θ̈; encoders ungeared, both positive."""
    k = 60.0 / (2.0 * math.pi * p.r_w)

    def hx(x):
        dx, ddx = x[..., 1], x[..., 2]
        th, dth, ddth = x[..., 3], x[..., 4], x[..., 5]
        v = p.m2 * p.g * torch.cos(th) + p.m2 * ddx * torch.sin(th) - p.m2 * p.l * dth * dth
        h = -p.m2 * p.g * torch.sin(th) + p.m2 * ddx * torch.cos(th) + p.m2 * p.l * ddth
        return torch.stack(torch.broadcast_tensors(k * dx, k * dx, dth * _RAD2DEG, v / p.g, h / p.g), dim=-1)

    return hx


def make_masked_hx(hx, enable_mask):
    """Zero disabled observation channels — mppi4-ukf-commu.rs:282-292
    (``observation.py:87-97``): ``hx(x) * enable_mask``, paired with the
    inflated R of ``noise.gen_r_mask``."""

    def masked(x):
        return hx(x) * enable_mask

    return masked


def make_gaussian_sensor(hx, stddevs):
    """Simulated sensor hx(x) + diag(σ)·N(0, 1) — e.g.
    mppi4-non-liner-ukf.rs:181-191 (``observation.py:100-113``). The
    standard normals come from the ``torch.Generator`` the caller passes,
    as the JAX package's come from an explicit key."""
    sig = torch.as_tensor(stddevs)

    def sensor(generator: torch.Generator, x):
        s = sig.to(dtype=x.dtype, device=x.device)
        eps = torch.randn(x.shape[:-1] + s.shape, generator=generator, dtype=x.dtype, device=x.device)
        return hx(x) + s * eps

    return sensor
