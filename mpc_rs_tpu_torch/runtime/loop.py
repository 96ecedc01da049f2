"""Closed-loop helpers of the runtime.

Port of ``mpc_rs_tpu/runtime/loop.py:54`` (``pulse_disturbance``); the
multi-rate loops come with the apps that run them.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Pulse:
    """A force of ``f`` N during t∈(t0, t1) s, else 0. Called with a Python
    float (→ float) or a tensor of sim times, e.g. a fleet's (B,) clock (→ a
    tensor of its dtype). The fused estimator chain reads its fields."""

    t0: float
    t1: float
    f: float

    def __call__(self, t):
        if isinstance(t, torch.Tensor):
            return ((t > self.t0) & (t < self.t1)).to(t.dtype) * self.f
        return self.f if self.t0 < t < self.t1 else 0.0


def pulse_disturbance(t0: float = 1.0, t1: float = 1.5, f: float = 2.0) -> Pulse:
    """The reference's push: f N during t∈(t0,t1) s — mppi4-non-liner-ukf.rs:237-244."""
    return Pulse(t0, t1, f)
