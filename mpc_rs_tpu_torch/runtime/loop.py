"""Deterministic closed-loop harnesses of the runtime.

Port of ``mpc_rs_tpu/runtime/loop.py:30-182``. The reference's wall-clock
thread topology (examples/mppi4-non-liner-ukf.rs:224-288) becomes a
deterministic multi-rate tick loop: physics at ``dt_phys``, the sensor at
its own period and latency, the controller and the logger at theirs, the
disturbance in sim time. Two harnesses:

- ``run_simple_loop``: the single-rate examples (mppi4.rs:41-67: solve →
  step → log → tip-over guard);
- ``run_multirate_loop``: the threaded sim examples (mppi4-non-liner-s,
  mppi4-non-liner-ukf) with pluggable plant, sensor, estimator and
  controller closures.

The JAX loops split a ``jax.random`` key a solve; here each solve draws an
integer seed in [0, 2³¹ − 1) from ``seeds``, an explicit
``numpy.random.Generator``, and passes it to the controller, which keys its
Philox noise with it (``ops/philox.py``). The schedule is the reference's
rule for rule.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
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


@dataclasses.dataclass(frozen=True)
class MultiRateConfig:
    dt_phys: float = 1e-3  # physics tick
    sensor_period: float = 9e-3  # UKF thread cadence (sleep 9 ms — :268)
    sensor_latency: float = 0.0  # observation age (modeled, not slept)
    # controller cadence; None = FREE-RUNNING: re-solve every physics tick,
    # like the reference's unthrottled control threads (no sleep in the loop,
    # mppi4-non-liner-ukf.rs:54-99) on an infinitely fast solver
    control_period: Optional[float] = 1e-2
    log_period: float = 30e-3  # logging thread cadence (:403)
    t_end: float = 10.0
    skip_publish_eps: float = 1e-2  # |Δu|<ε ⇒ skip publish (:88-90)
    disturbance: Optional[Callable[[float], float]] = None  # f(t) [N] (:237-244)
    tip_over: Optional[Callable[[np.ndarray], bool]] = None  # episode guard


class LoopResult(NamedTuple):
    t: float
    x: np.ndarray
    tipped: bool
    n_solves: int
    history: list
    # host wall seconds of each controller call, its first control read back
    # (which waits for a solve on the card); not in the JAX result
    solve_seconds: list


def _draw_seed(seeds: np.random.Generator) -> int:
    return int(seeds.integers(0, 2**31 - 1))


def _timed_solve(controller, seed, x, u_n):
    t0 = time.perf_counter()
    u_new, status = controller(seed, x, u_n)
    u0 = float(u_new[0])
    return u_new, status, u0, time.perf_counter() - t0


def run_simple_loop(
    *,
    solve: Callable,  # (seed, x, u_n) -> (u_n', status)
    plant_step: Callable,  # (x, u) -> x  (np arrays)
    dt: float,
    t_end: float,
    x0: np.ndarray,
    u0,
    seeds: np.random.Generator,
    tip_over: Optional[Callable] = None,
    logger=None,
    on_step: Optional[Callable] = None,
) -> LoopResult:
    """Single-rate loop of the open-loop examples (mppi4.rs:41-67)."""
    x = np.asarray(x0, dtype=np.float64)
    u_n = u0
    t = 0.0
    n = 0
    hist, secs = [], []
    tipped = False
    while t < t_end:
        u_n, _, u0_now, s = _timed_solve(solve, _draw_seed(seeds), x, u_n)  # zero fallback inside solve
        secs.append(s)
        x = np.asarray(plant_step(x, u0_now), dtype=np.float64)
        n += 1
        hist.append((t, u0_now, x.copy()))
        if logger is not None:
            logger.write_row(t, u0_now, x)
        if on_step is not None:
            on_step(t, u0_now, x)
        if tip_over is not None and tip_over(x):
            tipped = True
            break
        t += dt
    return LoopResult(t=t, x=x, tipped=tipped, n_solves=n, history=hist, solve_seconds=secs)


def run_multirate_loop(
    cfg: MultiRateConfig,
    *,
    plant_step: Callable,  # (x, u, dt, f) -> x           (np arrays)
    sensor: Callable,  # (rng, x) -> z                 (np arrays)
    est_predict_update: Callable,  # (est, u, z, dt) -> est
    est_state: Callable,  # (est) -> np x_hat
    controller: Callable,  # (seed, x_hat, u_n) -> (u_n', status)
    predictor: Optional[Callable],  # (x_hat, u_n) -> x_pred  (N-step, logging)
    x0: np.ndarray,
    u0,
    est0,
    seeds: np.random.Generator,
    rng: np.random.Generator,
    logger=None,
    debug_ukf_bypass: bool = False,  # DEBUG_UKF: controller sees true state (:30-31)
) -> LoopResult:
    """Deterministic multi-rate closed loop (flagship sim topology §3.4).

    The controller runs every ``control_period`` (every physics tick when
    it is None) on the latest estimate, after the tip check, and its
    sequence is published unless its first control moved less than
    ``skip_publish_eps`` (the first solve is always published); the
    estimator runs every ``sensor_period`` on an observation that is
    ``sensor_latency`` old, with the time since its last run (the sensor
    period on its first); physics every ``dt_phys``; the CSV row (t, u, x,
    x̂, x_pred) every ``log_period``, x_pred the N-step forward prediction
    (mppi4-non-liner-ukf.rs:419-422).
    """
    x = np.asarray(x0, dtype=np.float64)
    u_n = u0
    est = est0
    t = 0.0
    n_solves = 0
    hist, secs = [], []
    tipped = False

    lat_steps = max(0, int(round(cfg.sensor_latency / cfg.dt_phys)))
    x_hist = [x.copy()] * (lat_steps + 1)

    next_sensor = cfg.sensor_period
    next_control = 0.0
    next_log = 0.0
    last_est_t = 0.0

    free_run = cfg.control_period is None
    while t < cfg.t_end:
        # --- controller tick
        if free_run or t >= next_control:
            x_hat = x.copy() if debug_ukf_bypass else est_state(est)
            if cfg.tip_over is not None and cfg.tip_over(x_hat):
                tipped = True
                break
            u_new, _, u0_new, s = _timed_solve(controller, _draw_seed(seeds), x_hat, u_n)
            secs.append(s)
            n_solves += 1
            if abs(u0_new - float(u_n[0])) >= cfg.skip_publish_eps or n_solves == 1:
                u_n = u_new  # publish (skip-if-close: :88-90,351-354)
            if not free_run:
                next_control += cfg.control_period

        # --- physics tick
        f = cfg.disturbance(t) if cfg.disturbance is not None else 0.0
        x = np.asarray(plant_step(x, float(u_n[0]), cfg.dt_phys, f), dtype=np.float64)
        x_hist.append(x.copy())
        if len(x_hist) > lat_steps + 1:
            x_hist.pop(0)

        # --- sensor/estimator tick
        if t >= next_sensor:
            z = sensor(rng, x_hist[0])  # delayed observation
            dt_est = t - last_est_t if last_est_t > 0 else cfg.sensor_period
            est = est_predict_update(est, float(u_n[0]), z, dt_est)
            last_est_t = t
            next_sensor += cfg.sensor_period

        # --- logging tick
        if logger is not None and t >= next_log:
            x_hat = est_state(est)
            x_pred = predictor(x_hat, u_n) if predictor is not None else x_hat
            logger.write_row(t, float(u_n[0]), x, x_hat, x_pred)
            next_log += cfg.log_period

        hist.append((t, float(u_n[0])))
        t += cfg.dt_phys

    return LoopResult(t=t, x=x, tipped=tipped, n_solves=n_solves, history=hist, solve_seconds=secs)
