"""Shared runner plumbing: the MPPI solver of the apps and the host plant step.

Port of ``mpc_rs_tpu/apps/common.py:25-120``. The JAX apps pick the Pallas
kernel on a TPU and the vmap tier elsewhere; the port takes the device from
the caller and never picks one itself: a CUDA device runs the fused kernel,
``device="cpu"`` (asked for explicitly) runs its plain version.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from mpc_rs_tpu_torch.controllers.mppi import MppiConfig
from mpc_rs_tpu_torch.ops.mppi_cuda import CartPoleShaped4, mppi_solve_fused

DEG60 = math.radians(60.0)


def resolve_device(device: str | torch.device) -> torch.device:
    """The requested device; a CUDA device without a usable card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is false; "
            "pass --device cpu to run the plain PyTorch path"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def make_mppi_solver(cfg: MppiConfig, model: CartPoleShaped4, device: str | torch.device):
    """solve(seed: int, x: np (S,), u_n: tensor (N,)) -> (u_n', status).

    Float32 on ``device``. Each solve samples Philox noise keyed by ``seed``
    (``ops/philox.py``), so the CPU and CUDA paths draw the same samples."""
    device = resolve_device(device)

    def solve(seed, x, u_n):
        xt = torch.as_tensor(np.asarray(x, np.float32), device=device)
        return mppi_solve_fused(cfg, model, xt, u_n, seed=int(seed))

    return solve


def np_step(step, x, u, *extra):
    """Apply a component-wise dynamics step to a numpy state vector, in
    float64 on the host (``mpc_rs_tpu/apps/common.py:107-120``)."""
    xs = (torch.tensor(float(c), dtype=torch.float64) for c in x)
    uu = torch.tensor(float(u), dtype=torch.float64)
    out = step(*xs, uu, *extra)
    return np.array([float(v) for v in out], dtype=np.float64)


class Elapsed:
    def __init__(self):
        self.t0 = time.time()

    def print(self):
        print(f"elapsed: {time.time() - self.t0:.2f} sec")
