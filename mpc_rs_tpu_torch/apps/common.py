"""Shared runner plumbing: the MPPI solver of the apps and the host plant step.

Port of ``mpc_rs_tpu/apps/common.py:25-120``. The JAX apps pick the Pallas
kernel on a TPU and the vmap tier elsewhere; the port takes the device from
the caller and never picks one itself: a CUDA device runs the fused kernel,
``device="cpu"`` (asked for explicitly) runs its plain version.
"""

from __future__ import annotations

import functools
import math
import time

import numpy as np
import torch

from mpc_rs_tpu_torch.controllers.mppi import MppiConfig
from mpc_rs_tpu_torch.ops.mppi_cuda import mppi_solve_fused

DEG60 = math.radians(60.0)
PI_2 = math.pi / 2.0


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


def solves_on_one_cpu_thread(app):
    """Run ``app(args)`` with torch's intra-op threads set to one on a CPU
    ``args.device``, and the count restored after it (it is the process's:
    a caller's process, as the tests calling ``cli.main``, gets its own
    back); on a card, as it is. For the HIL apps whose solve count follows
    the host's speed (a solve every pass of the loop, or one a packet): a
    plain solve is a few thousand small torch ops, and an OpenMP team of a
    thread a core shares those cores with the fake MCU's threads and with
    every other process, so under host load a solve takes a hundred times
    as long."""

    @functools.wraps(app)
    def run(args):
        if resolve_device(args.device).type != "cpu":
            return app(args)
        before = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return app(args)
        finally:
            torch.set_num_threads(before)

    return run


def make_mppi_solver(cfg: MppiConfig, model, device: str | torch.device, sampler: str | None = None):
    """solve(seed: int, x: np (S,), u_n: tensor (N,)) -> (u_n', status).

    ``model`` is any model the kernels are built for (``ops/mppi_cuda.py``:
    ``MODELS`` at a horizon of ``BUILT``). Float32 on ``device``; u_n may
    lie on the host and is moved there. Each solve samples ``sampler``'s
    Philox noise (default box-muller, as ``mpc_rs_tpu/apps/common.py:25-61``)
    keyed by ``seed`` (``ops/philox.py``), so the CPU and CUDA paths draw
    the same samples. A HIL app runs it on one intra-op thread on the CPU
    (``solves_on_one_cpu_thread``)."""
    device = resolve_device(device)
    sampler = sampler or "box-muller"

    def solve(seed, x, u_n):
        xt = torch.as_tensor(np.asarray(x, np.float32), device=device)
        un = torch.as_tensor(u_n, dtype=torch.float32, device=device)
        return mppi_solve_fused(cfg, model, xt, un, seed=int(seed), sampler=sampler)

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
