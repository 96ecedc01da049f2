"""Process-noise builders (gen_q) of the fleets, and the sensor-dropout
measurement noise of the hardware apps.

Port of ``mpc_rs_tpu/models/noise.py:12-99``: the same piecewise-white-noise
matrices in the same operation order. ``dt`` may be a Python float or a 0-d
tensor; the result has ``dtype`` (default: that of a tensor ``dt``, else
float64).
"""

from __future__ import annotations

import torch


def _dt(dt, dtype):
    if dtype is None:
        dtype = dt.dtype if isinstance(dt, torch.Tensor) else torch.float64
    return torch.as_tensor(dt, dtype=dtype)


def gen_q6(dt, phy=(100.0, 70.0, 20.0), dtype=None) -> torch.Tensor:
    """Piecewise-white-noise 6×6 process noise — mppi4-non-liner-ukf.rs:192-221.

    Three overlapping 3×3 white-noise blocks weighted by PHY = [100, 70, 20]
    (flagship) or [50, 50, 10] (mppi4-ukf-commu.rs:28).
    """
    dt = _dt(dt, dtype)
    z = torch.zeros_like(dt)
    dt2 = dt * dt
    dt3 = dt2 * dt
    dt4 = dt2 * dt2
    a, b, c = dt4 / 8.0, dt3 / 6.0, dt3 / 3.0
    d, e = dt2 / 2.0, dt

    def mat(rows):
        return torch.stack([torch.stack(r) for r in rows])

    q1 = mat([
        [z, z, z, z, z, z],
        [z, z, z, z, z, z],
        [z, z, z, z, z, z],
        [z, z, z, z, a, b],
        [z, z, z, a, c, d],
        [z, z, z, b, d, e],
    ])
    q2 = mat([
        [z, z, z, z, z, z],
        [z, z, z, a, b, z],
        [z, z, z, z, z, z],
        [z, a, z, c, d, z],
        [z, b, z, d, e, z],
        [z, z, z, z, z, z],
    ])
    q3 = mat([
        [z, a, b, z, z, z],
        [a, c, d, z, z, z],
        [b, d, e, z, z, z],
        [z, z, z, z, z, z],
        [z, z, z, z, z, z],
        [z, z, z, z, z, z],
    ])
    return phy[0] * q1 + phy[1] * q2 + phy[2] * q3


def gen_q4(dt, accel_var=(25.0, 400.0), dtype=None) -> torch.Tensor:
    """Piecewise-white-noise 4×4 process noise for the (x, ẋ, θ, θ̇) state:
    white linear acceleration of variance ``accel_var[0]`` drives (x, ẋ),
    white angular acceleration ``accel_var[1]`` drives (θ, θ̇)."""
    dt = _dt(dt, dtype)
    z = torch.zeros_like(dt)
    d4, d3, d2 = dt**4 / 4.0, dt**3 / 2.0, dt * dt
    sa, sw = accel_var

    def blk(s):
        return [s * d4, s * d3, s * d3, s * d2]

    a = blk(sa)
    w = blk(sw)
    return torch.stack([
        torch.stack([a[0], a[1], z, z]),
        torch.stack([a[2], a[3], z, z]),
        torch.stack([z, z, w[0], w[1]]),
        torch.stack([z, z, w[2], w[3]]),
    ])


def gen_r_mask(r_diag, enable_mask, dropped: float = 1e6) -> torch.Tensor:
    """Sensor-dropout R — mppi4-ukf-commu.rs:228-236 (``noise.py:85-92``):
    channels whose enable bit is 0 get the variance ``dropped``. ``r_diag``
    (..., n_obs) and ``enable_mask`` (..., n_obs) of {0, 1}; returns the
    (..., n_obs, n_obs) diagonal in the dtype of ``r_diag``."""
    r_diag = torch.as_tensor(r_diag)
    mask = torch.as_tensor(enable_mask, device=r_diag.device)
    return torch.diag_embed(torch.where(mask.bool(), r_diag, dropped))


def enable_bits_to_mask(enable, n: int = 5) -> torch.Tensor:
    """u8 enable bitmask → (..., n) float32 mask of {0, 1}, bit i for
    channel i — src/packet.rs:112-118 (``noise.py:95-99``)."""
    enable = torch.as_tensor(enable, dtype=torch.int32)
    bits = (enable[..., None] >> torch.arange(n, dtype=torch.int32, device=enable.device)) & 1
    return bits.to(torch.float32)
