"""Velocity-form PID, the baseline controller (advanced-pid's ``VelPid``,
examples/pid.rs:15,27).

Port of ``mpc_rs_tpu/controllers/pid.py:18-48``. Incremental form with the
derivative on the error:
  Δu = Kp·(e − e₁) + Ki·e·dt + Kd·(e − 2e₁ + e₂)/dt
  u  = clamp(u + Δu, lo, hi)
The state (u, e₁, e₂) is a tuple of tensors of any shape.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class PidConfig:
    kp: float
    ki: float
    kd: float
    lo: float = -float("inf")
    hi: float = float("inf")


class PidState(NamedTuple):
    u: torch.Tensor
    e1: torch.Tensor  # previous error
    e2: torch.Tensor  # error two ticks ago


def pid_init(dtype=torch.float32, shape=(), device=None) -> PidState:
    z = torch.zeros(shape, dtype=dtype, device=device)
    return PidState(u=z, e1=z, e2=z)


def pid_update(cfg: PidConfig, state: PidState, set_point, actual, dt):
    """One tick: returns (u, new state) — pid.rs:27 ``pid.update(ref, act, DT)``."""
    e = set_point - actual
    du = cfg.kp * (e - state.e1) + cfg.ki * e * dt + cfg.kd * (e - 2.0 * state.e1 + state.e2) / dt
    u = torch.clamp(state.u + du, cfg.lo, cfg.hi)
    return u, PidState(u=u, e1=e, e2=state.e1)
