"""Per-solve timing and the torch.profiler trace.

Port of ``mpc_rs_tpu/runtime/profiler.py``: ``SolveTimer`` collects
per-call wall times (the reference prints only an elapsed wall clock,
examples/mppi4.rs:39,69), and ``torch_trace`` stands for ``xla_trace``: a
``torch.profiler`` session over a block of code, written as a Chrome trace
(chrome://tracing, Perfetto).
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


def _cuda_devices(out, found: set) -> set:
    """The CUDA devices of the tensors in ``out`` (a tensor, or tuples,
    lists and dicts of them)."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, (tuple, list)):
        for v in out:
            _cuda_devices(v, found)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    return found


class SolveTimer:
    """Collects per-call wall times; waiting for the device's results included."""

    def __init__(self, name: str = "solve"):
        self.name = name
        self.samples_ms: list[float] = []

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        yield
        self.samples_ms.append((time.perf_counter() - t0) * 1e3)

    def wrap(self, fn):
        """``fn`` timed a call, up to the end of its result's device work:
        every CUDA device the result's tensors lie on is synchronised, where
        the JAX timer blocks until the result is ready."""

        def timed(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            for device in _cuda_devices(out, set()):
                torch.cuda.synchronize(device)
            self.samples_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        return timed

    def summary(self) -> dict:
        if not self.samples_ms:
            return {"name": self.name, "count": 0}
        a = np.asarray(self.samples_ms)
        return {
            "name": self.name,
            "count": int(a.size),
            "mean_ms": float(a.mean()),
            "p50_ms": float(np.percentile(a, 50)),
            "p95_ms": float(np.percentile(a, 95)),
            "p99_ms": float(np.percentile(a, 99)),
            "max_ms": float(a.max()),
        }

    def print_summary(self):
        s = self.summary()
        if s["count"]:
            print(
                f"[{s['name']}] n={s['count']} mean={s['mean_ms']:.3f}ms "
                f"p50={s['p50_ms']:.3f} p95={s['p95_ms']:.3f} p99={s['p99_ms']:.3f} "
                f"max={s['max_ms']:.3f}"
            )


@contextlib.contextmanager
def torch_trace(log_dir: str = "logs/torch_trace"):
    """A ``torch.profiler`` session over the block (host activity, and the
    card's kernels and copies where there is a card), written on exit as a
    Chrome trace ``<log_dir>/trace.json``; yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
