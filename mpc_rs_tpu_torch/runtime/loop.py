"""Closed-loop helpers of the runtime.

Port of ``mpc_rs_tpu/runtime/loop.py:54`` (``pulse_disturbance``); the
multi-rate loops come with the apps that run them.
"""

from __future__ import annotations

import torch


def pulse_disturbance(t0: float = 1.0, t1: float = 1.5, f: float = 2.0):
    """The reference's push: f N during t∈(t0,t1) s — mppi4-non-liner-ukf.rs:237-244.

    The returned force takes a Python float (→ float) or a tensor of sim
    times, e.g. a fleet's (B,) clock (→ a tensor of its dtype)."""

    def force(t):
        if isinstance(t, torch.Tensor):
            return ((t > t0) & (t < t1)).to(t.dtype) * f
        return f if t0 < t < t1 else 0.0

    return force
