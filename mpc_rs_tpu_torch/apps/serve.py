"""Fleet serving bridge: many robot links, one device, one batched solve a
tick — port of ``mpc_rs_tpu/apps/serve.py:53-338``.

    robot i ──COBS State──▶ reader thread ──▶ latest-state table ─┐
    robot j ──COBS State──▶ reader thread ──▶ latest-state table ─┤
                                                                  ▼
                                     mppi_solve_batch_fused (B robots)
                                                                  │
    robot i ◀──COBS Control(u0_i)──── control tick ◀──────────────┘

Per robot the semantics are mppi4-commu.rs's: the freshest State wins
(examples/mppi4-commu.rs:42-59), a warm-started u_n per robot, zero control
when its solve fails (examples/mppi4-ukf-commu.rs:76-81), and
Control::from_current out (src/packet.rs:69-76). A link quiet for
``--stale-timeout`` seconds gets zero control until it resumes; the batched
solve keeps serving the rest of the fleet.

Robot links are serial devices (``--serial /dev/ttyUSB0,/dev/ttyUSB1,…``,
one a robot) or ``--sim-mcu`` PTY fake MCUs (one simulated robot a link).
On the card a tick's B solves are one launch of the scenario-batched
partials kernel (K5/K6), merged in the launch; B is the robot count (the
JAX package's padding of B to a multiple of 8 is the TPU's layout and is
not ported).
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import threading
import time
import weakref
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from mpc_rs_tpu_torch.apps.commu_examples import SimMcu
from mpc_rs_tpu_torch.apps.common import DEG60, resolve_device
from mpc_rs_tpu_torch.controllers.mppi import MppiConfig
from mpc_rs_tpu_torch.io.packets import Control, State
from mpc_rs_tpu_torch.io.serial import SerialPort
from mpc_rs_tpu_torch.models.params import CartPoleParams
from mpc_rs_tpu_torch.ops.mppi_cuda import CartPoleShaped4, check_built, mppi_solve_batch_fused


class Dispatch:
    """One batched solve in flight: the next warm start (B, N) on the
    device, and the host copy of what the tick reads (u0 (B,), or the
    (B, N) plan) with the event that says when it has landed. On the CPU
    the solve runs in the solver's own process, through its worker thread,
    and ``future`` yields (the warm start, the host copy) once it has."""

    def __init__(self, u_n: torch.Tensor | None, host: torch.Tensor | None, done: torch.cuda.Event | None,
                 future: Future | None = None):
        self._u_n, self.host, self.done, self.future = u_n, host, done, future

    @property
    def u_n(self) -> torch.Tensor:
        """The next warm start (on the CPU, once this solve has run)."""
        return self.future.result()[0] if self.future is not None else self._u_n

    def result(self) -> np.ndarray:
        """The host copy, once the solve and its copy have landed (this
        dispatch's event or solve only: solves queued after it are not
        waited for)."""
        if self.future is not None:
            return self.future.result()[1].numpy()
        if self.done is not None:
            self.done.synchronize()
        return self.host.numpy()


def _solve(cfg: MppiConfig, model, sampler: str, plan: bool, seeds: torch.Tensor, xs: torch.Tensor,
           u_ns: torch.Tensor, advance: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """One batched solve with the zero fallback (examples/mppi4-ukf-commu.rs:
    76-81) applied per robot, with ``torch.where`` on status != 0, before the
    sequence becomes the next warm start: (that warm start (B, N), what the
    tick reads: the (B,) u0 column, or the (B, N) plan with ``plan``). The
    warm start ``u_ns`` is first advanced by ``advance`` steps (its last
    entry repeated at the end): the steps of the plan that have gone by
    since the state it was solved from."""
    if advance > 0:
        k = min(advance, u_ns.shape[1] - 1)
        u_ns = torch.cat([u_ns[:, k:], u_ns[:, -1:].expand(-1, k)], dim=1)
    u, st = mppi_solve_batch_fused(cfg, model, xs, u_ns, seeds=seeds, sampler=sampler)
    u = torch.where((st != 0)[:, None], 0.0, u)
    return u, u if plan else u[:, 0]


def _solver_process(conn, cfg: MppiConfig, model, sampler: str, plan: bool) -> None:
    """The CPU solver's own process: announces its intra-op thread count,
    then answers each (seeds, xs, u_ns, advance) request with ``_solve``'s pair as
    numpy arrays (or the exception it raised), until a None. Its torch ops
    run on one intra-op thread, which ``torch.set_num_threads`` sets for
    this process alone."""
    torch.set_num_threads(1)
    conn.send(torch.get_num_threads())
    while (request := conn.recv()) is not None:
        try:
            *arrays, advance = request
            u, out = _solve(cfg, model, sampler, plan, *(torch.from_numpy(a) for a in arrays), advance)
            reply = (u.numpy(), out.numpy())
        except Exception as err:  # raised again by the caller's Dispatch
            reply = err
        conn.send(reply)


def _stop_solver_process(worker: ThreadPoolExecutor, conn, process) -> None:
    """Let the queued solves finish, then end the solver's process."""
    worker.shutdown(wait=True)
    if process.is_alive():
        conn.send(None)
        process.join()
    conn.close()


def make_batch_solver(cfg: MppiConfig, model, device: str | torch.device, sampler: str = "box-muller",
                      plan: bool = False):
    """``solve(seeds (B,) int32, xs (B, S), u_ns, advance=0) -> Dispatch``,
    which returns without waiting for the solve, so the caller can pipeline
    dispatches (``serve.py:53-99``). ``u_ns`` is the (B, N) warm start, or
    the ``Dispatch`` whose sequence is the warm start; ``advance`` steps of
    it are dropped first (``_solve``).

    On a CUDA device one launch of ``mppi_solve_batch_fused`` (K5/K6), robot
    b keyed by Philox seed ``seeds[b]`` with ``sampler``, and the zero
    fallback on the device (``_solve``), so the warm-start chain never
    leaves it: the host reads back only what the tick reads, into a pinned
    buffer of its own with an event recorded after it. The states and seeds
    are copied out of the caller's arrays before the call returns (the
    caller rewrites its state table every tick while a solve may still be
    queued), through pinned buffers of their own.

    On the CPU the plain version runs in a process of the solver's own
    (``_solver_process``, started with ``spawn``), on one intra-op thread,
    fed by one worker thread of the caller's, so that the caller's tick
    goes on while it runs; solves run in dispatch order, each taking the
    warm start of the one before. In the caller's process the solve would
    share the interpreter lock with the robot links' and fake MCUs' threads
    (``serve --sim-mcu``: 17 of them), and its thousands of torch calls
    would each wait for it: there the plain solve at serve-stream's shape
    (8 robots, K = 128, N = 40) took two to three times its 20 ms alone,
    and its intra-op pool's OpenMP team stalled it again on a host whose
    cores other processes held. ``solve.close()`` waits for the queued
    solves and ends the process; dropping the solver does too. Raises unless
    the kernel is built for ``model`` at ``cfg.n_horizon``, on every device.
    A script that makes a CPU solver guards its own body with
    ``if __name__ == "__main__":``, as ``spawn`` imports it again."""
    device = resolve_device(device)
    check_built(model, cfg.n_horizon)
    if device.type == "cuda":
        return _cuda_batch_solver(cfg, model, device, sampler, plan)
    context = multiprocessing.get_context("spawn")
    conn, child = context.Pipe()
    # a fresh copy of the model: its cached closures are not sent to the process
    process = context.Process(target=_solver_process, args=(child, cfg, dataclasses.replace(model), sampler, plan),
                              name="serve-solve", daemon=True)
    process.start()
    child.close()
    intraop_threads = []
    worker = ThreadPoolExecutor(max_workers=1, thread_name_prefix="serve-solve",
                                initializer=lambda: intraop_threads.append(conn.recv()))

    def run(seeds: np.ndarray, xs: np.ndarray, u_ns: torch.Tensor | Dispatch, advance: int):
        if isinstance(u_ns, Dispatch):
            u_ns = u_ns.u_n  # the worker has run that solve: it was queued first
        conn.send((seeds, xs, np.asarray(u_ns), int(advance)))
        reply = conn.recv()
        if isinstance(reply, Exception):
            raise reply
        return tuple(torch.from_numpy(a) for a in reply)

    def solve(seeds, xs, u_ns: torch.Tensor | Dispatch, advance: int = 0) -> Dispatch:
        return Dispatch(None, None, None, worker.submit(run, np.array(seeds, np.int32), np.array(xs, np.float32),
                                                        u_ns, advance))

    solve.close = weakref.finalize(solve, _stop_solver_process, worker, conn, process)
    solve.process, solve.intraop_threads = process, intraop_threads
    return solve


def _cuda_batch_solver(cfg: MppiConfig, model, device: torch.device, sampler: str, plan: bool):
    """``make_batch_solver`` on a CUDA device."""

    def to_device(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).pin_memory().to(device, non_blocking=True)  # a copy, never the caller's

    def solve(seeds, xs, u_ns: torch.Tensor | Dispatch, advance: int = 0) -> Dispatch:
        if isinstance(u_ns, Dispatch):
            u_ns = u_ns.u_n
        u, out = _solve(cfg, model, sampler, plan, to_device(np.array(seeds, np.int32)),
                        to_device(np.array(xs, np.float32)), u_ns, advance)
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return Dispatch(u, host, done)

    solve.close = lambda: None
    return solve


class RobotLink:
    """One robot's serial link and a reader thread keeping its freshest
    State (the reference's reader thread → mpsc channel, batched:
    examples/mppi4-commu.rs:42-50)."""

    def __init__(self, index: int, port: SerialPort, mcu: SimMcu | None = None):
        self.index = index
        self.port = port
        self.mcu = mcu
        self.x = np.zeros(4, np.float64)
        self.last_rx = -1.0  # wall time of the last good frame (-1: never)
        self.n_rx = 0
        self.n_tx = 0
        self.max_abs_theta = 0.0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._reader, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def _reader(self):
        while not self._stop.is_set():
            s = self.port.read_latest_packet(State)
            if s is None:
                continue
            x = s.to_vector()
            with self._lock:
                self.x = x
                self.last_rx = time.time()
                self.n_rx += 1
                self.max_abs_theta = max(self.max_abs_theta, abs(float(x[2])))

    def snapshot(self):
        with self._lock:
            return self.x, self.last_rx

    def send(self, current: float):
        try:
            self.port.write_packet(Control.from_current(current))
            self.n_tx += 1
        except OSError:
            pass  # the link is gone; staleness zeroes it

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
        self.port.close()
        if self.mcu:
            self.mcu.stop()


def _open_links(args, b: int) -> list[RobotLink]:
    """B links: fake MCUs (robot i seeded ``seed + i``) with ``--sim-mcu``,
    else one ``--serial`` path a robot (``serve.py:155-173``)."""
    links = []
    try:
        if args.sim_mcu:
            scale = args.time_scale or 1.0
            for i in range(b):
                mcu = SimMcu(mode="state", rate_hz=100.0, seed=args.seed + i, duration=args.t_end + 30,
                             time_scale=scale).start()
                try:
                    port = SerialPort(mcu.device, 115200, timeout_ms=20)
                except BaseException:
                    mcu.stop()
                    raise
                links.append(RobotLink(i, port, mcu).start())
        else:
            devices = [d for d in args.serial.split(",") if d]
            if len(devices) != b:
                raise ValueError(f"--robots {b} but --serial lists {len(devices)} links; "
                                 "pass a comma-separated serial path per robot")
            for i, dev in enumerate(devices):
                links.append(RobotLink(i, SerialPort(dev, 115200, timeout_ms=20)).start())
    except BaseException:
        for ln in links:
            ln.stop()
        raise
    return links


def plan_horizon(period: float, ticks_per_dispatch: int) -> tuple[int, float]:
    """(N, plan step dt) of serve's controller, whose horizon is T = 0.8 s
    (``mpc_rs_tpu/apps/serve.py:185-204``): N = 8 steps of 0.1 s at one tick
    a dispatch; with plan streaming (``ticks_per_dispatch`` M > 1, entries
    1..M-1 open-loop, computed from a state j ticks stale) steps of one tick
    ``period``, N = clip(round(0.8 / period), max(8, M), 40): any N of 8-40."""
    t_hor = 0.8
    if ticks_per_dispatch > 1:
        return int(np.clip(round(t_hor / period), max(8, ticks_per_dispatch), 40)), period
    return 8, t_hor / 8


def plan_steps_gone_by(snap_t: float, last_snap: float, step_s: float) -> int:
    """The plan steps between two state snapshots taken at wall times
    ``last_snap`` and ``snap_t``, at ``step_s`` wall seconds a step, to the
    nearest (a half rounds to even): how far ``serve`` advances the warm
    start of the dispatch solved from the later snapshot."""
    return int(round((snap_t - last_snap) / step_s))


def serve(args) -> dict:
    """Serve a robot fleet from one device: B links, one batched solve a
    dispatch.

    The controller of each robot is mppi4-commu's (nonlinear cart-pole,
    T=0.8 N=8, σ=3, λ=0.5, ±20: examples/mppi4-commu.rs:8-19) at a fleet
    K (default 8192). ``--pipeline-depth D`` keeps D more solves in flight
    than the one the tick consumes: the controls sent at tick t come from
    tick t−D's states. ``--ticks-per-dispatch M`` > 1 streams the first M
    entries of each returned plan at successive ticks, its steps
    re-discretised to the tick period (``plan_horizon``): N =
    clip(round(0.8 / period), max(8, M), 40), 40 at the default 0.01 s; the
    kernel is built at every such N. Each dispatch's warm start is the previous dispatch's
    sequence advanced by the plan steps that went by between their state
    snapshots (``plan_steps_gone_by``: 0 while they are under half a step
    apart, as at N = 8 with its 0.1 s steps): with plan streaming a dispatch comes M
    steps after the one before, and a sequence left M steps behind the
    state makes the fake MCUs' robots swing, and now and then fall, at
    K = 128. Returns the JAX runner's summary."""
    b = args.robots
    p = CartPoleParams.single_wheel()
    scale = args.time_scale or 1.0
    period_sim = args.control_period if args.control_period else 0.01
    m_stream = max(1, int(args.ticks_per_dispatch or 1))
    n, dt = plan_horizon(period_sim, m_stream)
    k = args.k or 8192
    cfg = MppiConfig(n_horizon=n, n_rollouts=k, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
    device = resolve_device(args.device)
    solve = make_batch_solver(cfg, CartPoleShaped4(p, dt), device, plan=m_stream > 1)

    xs = np.zeros((b, 4), np.float32)
    u_dev = torch.zeros((b, n), dtype=torch.float32, device=device)
    seeds0 = np.arange(b, dtype=np.int32)
    solve(seeds0, xs, u_dev).result()  # before real-time traffic starts

    period = period_sim / scale
    stale = args.stale_timeout / scale
    depth = max(0, int(args.pipeline_depth or 0))
    pending: deque = deque()
    links = _open_links(args, b)

    ticks = 0
    solve_s, dispatch_s = [], []  # from the dispatch's return, and from before it, to the u0 read back
    t0 = time.time()
    next_report = t0 + args.report_every
    deadline = t0 + args.t_end / scale
    dispatched = 0
    last_fresh = np.zeros(b, bool)
    step_s = dt / scale  # a plan step on the wall clock
    last_snap = None  # the wall time of the state snapshot u_dev was solved from

    def dispatch() -> bool:
        """Snapshot the freshest states and queue one batched solve."""
        nonlocal u_dev, dispatched, last_snap
        snap_t = time.time()
        fresh = np.zeros(b, bool)
        for ln in links:
            x, last_rx = ln.snapshot()
            xs[ln.index] = x
            fresh[ln.index] = last_rx > 0 and (snap_t - last_rx) < stale
        last_fresh[:] = fresh
        if not fresh.any():
            return False
        seeds = np.int32(args.seed) + np.int32(dispatched) * np.int32(b) + seeds0
        advance = 0 if last_snap is None else plan_steps_gone_by(snap_t, last_snap, step_s)
        last_snap = snap_t
        d0 = time.time()
        d = solve(seeds, xs, u_dev, advance)
        s0 = time.time()  # the JAX runner's clock starts after its async dispatch returns (serve.py:255-258)
        u_dev = d  # the next solve's warm start: this one's sequence
        dispatched += 1
        pending.append((d0, s0, d, fresh.copy()))
        return True

    def pop_plan():
        d0, s0, d, fr = pending.popleft()
        u_plan = d.result()  # waits for this solve only
        now = time.time()
        solve_s.append(now - s0)
        dispatch_s.append(now - d0)
        if u_plan.ndim == 1:
            u_plan = u_plan[:, None]
        return u_plan, fr

    plan, plan_fresh, plan_j = None, None, m_stream
    try:
        while time.time() < deadline:
            tick_t0 = time.time()
            if plan_j >= m_stream or plan is None:
                # the plan is spent: keep `depth` more dispatches in flight
                # than the one about to be consumed, then take the oldest
                if not pending:
                    dispatch()
                while pending and len(pending) <= depth:
                    if not dispatch():
                        break
                if pending:
                    plan, plan_fresh = pop_plan()
                    plan_j = 0
            if plan is not None and plan_j < plan.shape[1]:
                for ln in links:
                    i = ln.index
                    ln.send(float(plan[i, plan_j]) if plan_fresh[i] else 0.0)
                ticks += 1
                plan_j += 1
            now = time.time()
            if now >= next_report:
                next_report += args.report_every
                el = now - t0
                med = 1e3 * float(np.median(solve_s[-200:])) if solve_s else 0.0
                print(
                    f"[serve] t={el * scale:6.2f}s ticks/s={ticks / el:7.1f} "
                    f"solves/s={dispatched / el:6.1f} "
                    f"active={int(last_fresh.sum())}/{b} depth={len(pending)} "
                    f"solve_ms={med:6.2f} "
                    f"rx={sum(ln.n_rx for ln in links)} "
                    f"bad={sum(ln.port.n_bad_frames for ln in links)}"
                )
            ahead = (tick_t0 + period) - time.time()
            if ahead > 0:
                time.sleep(ahead)
        while pending:
            pending.popleft()[2].result()  # drain without sending past the deadline
    finally:
        for ln in links:
            ln.stop()

    el = time.time() - t0
    summary = {
        "robots": b,
        "ticks": ticks,
        "ticks_per_s": ticks / el,
        "dispatches": dispatched,
        "dispatches_per_s": dispatched / el,
        "ticks_per_dispatch": m_stream,
        "plan_dt": dt,
        "horizon": n,
        "robot_solves_per_s": ticks * b / el,
        "rx": [ln.n_rx for ln in links],
        "tx": [ln.n_tx for ln in links],
        "max_abs_theta": [ln.max_abs_theta for ln in links],
        "solve_ms_p50": 1e3 * float(np.median(solve_s)) if solve_s else 0.0,
        "dispatch_ms_p50": 1e3 * float(np.median(dispatch_s)) if dispatch_s else 0.0,
        "bad_frames": sum(ln.port.n_bad_frames for ln in links),
    }
    survived = sum(1 for th in summary["max_abs_theta"] if th < DEG60)
    print(
        f"[serve] done: {ticks} ticks, {summary['robot_solves_per_s']:.0f} "
        f"robot-solves/s, {survived}/{b} robots upright "
        f"(solve p50 {summary['solve_ms_p50']:.2f} ms)"
    )
    return summary
