"""Hardware-in-the-loop example runners — port of
``mpc_rs_tpu/apps/commu_examples.py`` (examples/uart.rs, mppi4-commu.rs,
mppi4-ukf-commu.rs, mpc-ukf-commu.rs).

The robot is a serial link (``--serial``, default /dev/ttyUSB0 at 115200
baud, COBS frames). ``--sim-mcu`` replaces it with a fake MCU thread behind
a PTY that integrates the plant at 1 kHz and streams sensor packets: the
reference's sim↔HW twin (SURVEY §4.3) without hardware. Every MPPI solve
runs on the device the caller names (``--device``, default cuda): the fused
kernel on the card, raising when there is none, or its plain version with
``--device cpu``; mpc-ukf-commu's PANOC solve runs in float64 on it
(``controllers/panoc.py``, its segments replayed from CUDA graphs on a card).
On the CPU the apps that solve run on one intra-op thread for the run
(``common.solves_on_one_cpu_thread``): a solve every pass of the loop, or
one a packet, then keeps its rate while other processes hold the cores.

The HW apps' 6-state UKF runs on the host CPU in float32, as the port's
``mppi4-non-liner-ukf`` runs its filter: the JAX app jits its estimator
step onto its default device (``commu_examples.py:226-237``), no Pallas
kernel is involved, and a 6-state filter is a few hundred scalar operations
(µs on a host core), which a card would spend in launches. It is a
placement of the estimator, not a fallback of the solve, which stays on the
device.
"""

from __future__ import annotations

import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from mpc_rs_tpu_torch.apps.common import (DEG60, PI_2, Elapsed, make_mppi_solver, resolve_device,
                                          solves_on_one_cpu_thread)
from mpc_rs_tpu_torch.controllers.mppi import MppiConfig
from mpc_rs_tpu_torch.controllers.panoc import PanocConfig, box_projection, panoc_solve
from mpc_rs_tpu_torch.controllers.qp import build_condensed_qp, make_qp_value_and_grad
from mpc_rs_tpu_torch.estimators import ukf
from mpc_rs_tpu_torch.io.packets import Control, Sensor3, State
from mpc_rs_tpu_torch.io.serial import PtyPair, SerialPort
from mpc_rs_tpu_torch.models import dynamics, noise, observation, reference
from mpc_rs_tpu_torch.models.params import CartPoleParams
from mpc_rs_tpu_torch.ops.mppi_cuda import CartPoleShaped4, Commu4Cost4
from mpc_rs_tpu_torch.runtime.console import print_con, print_rcv
from mpc_rs_tpu_torch.runtime.logger import CsvLogger

SENSOR3_NOISE = (20.0, 20.0, 2.0, 0.05, 0.05)  # the fake MCU's sensor σ (commu_examples.py:105)


def float_step(step, x, u, *extra) -> np.ndarray:
    """One step of a port model on Python floats, in float64 on the host:
    the values of ``np_step``'s 0-d tensors up to sin/cos's last bit
    (``math``'s), with no torch call. Eight fake-MCU threads stepping 0-d
    tensors hand the GIL over some forty times a step, which slowed the
    dispatching thread's torch calls twelvefold on a loaded host."""
    return np.array([float(v) for v in step(*(float(c) for c in x), float(u), *extra)])


class SimMcu:
    """Fake MCU behind a PTY: integrates the plant at ~1 kHz, replies to
    Control packets, streams State or Sensor3 packets at ``rate_hz``.

    ``mode="state"``: the single-wheel nonlinear cart-pole from [0, 0,
    0.05, 0], State packets. ``mode="sensor3"``: the two-wheel
    ``make_accel6`` plant (cos θ denominator, no force) from rest, Sensor3
    packets of the float32 ``make_hx_imu6`` plus noise drawn from
    ``np.random.default_rng(seed)``: the JAX package's fake MCU draws the
    same sensor noise for a seed. The plant steps in float64 on the host
    (``float_step``). ``time_scale`` < 1 runs the robot in slow motion (sim
    seconds a wall second), for hosts that cannot hold 100 Hz; the runner
    scales its measured packet intervals by the same factor.
    ``max_abs_theta`` is the plant's largest |θ| so far: whether the robot
    stayed upright, whatever the controller believed."""

    def __init__(self, mode: str = "state", rate_hz: float = 100.0, seed: int = 0,
                 enable: int = 0b11111, duration: float = 30.0, time_scale: float = 1.0):
        self.pair = PtyPair()
        self.mode = mode
        self.rate = rate_hz
        self.enable = enable
        self.duration = duration
        self.rng = np.random.default_rng(seed)
        self.time_scale = time_scale
        p = CartPoleParams.two_wheel() if mode == "sensor3" else CartPoleParams.single_wheel()
        self.params = p
        if mode == "sensor3":
            # the truth plant: the cos(θ) denominator (mpc-ukf-commu.rs:151-166
            # form); the estimator under test carries each app's own variant
            self.plant = dynamics.make_accel6(p, with_force=False)
            self.hx = observation.make_hx_imu6(p)
            self.x = np.zeros(6)
        else:
            self.plant = dynamics.make_cartpole_nonlinear(p, None)
            self.x = np.array([0.0, 0.0, 0.05, 0.0])
        self.u = 0.0
        self.max_abs_theta = 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    @property
    def device(self) -> str:
        return self.pair.slave_path

    def start(self):
        self._thread.start()
        return self

    def sensor3_packet(self) -> Sensor3:
        """The Sensor3 of the current state: float32 hx plus the seeded noise
        (added in place into the float32 vector, as the JAX fake MCU does)."""
        z = self.hx(torch.tensor(self.x, dtype=torch.float32)).numpy()
        z += self.rng.normal(size=5) * list(SENSOR3_NOISE)
        return Sensor3(
            enable=self.enable,
            encoder0=int(np.clip(z[0], -32768, 32767)),
            encoder1=int(np.clip(z[1], -32768, 32767)),
            gyro=float(z[2]),
            accel0=float(z[3]),
            accel1=float(z[4]),
        )

    def _run(self):
        dt = 1e-3
        next_send = 0.0
        t = 0.0
        buf = b""
        t0 = time.time()
        while not self._stop.is_set() and time.time() - t0 < self.duration / self.time_scale:
            # pace the physics to the wall clock (scaled for slow-motion twins)
            ahead = t / self.time_scale - (time.time() - t0)
            if ahead > 0:
                time.sleep(ahead)
            data = self.pair.mcu_recv()
            if data:
                buf += data
                while b"\x00" in buf:
                    frame, buf = buf.split(b"\x00", 1)
                    frame += b"\x00"
                    if len(frame) >= Control.buf_size():
                        c = Control.from_cobs(frame[-Control.buf_size():])
                        if c is not None:
                            self.u = c.u / (Control.MAX / 10.0)
            self.x = float_step(self.plant, self.x, self.u, dt, *((0.0,) if self.mode == "sensor3" else ()))
            self.max_abs_theta = max(self.max_abs_theta, abs(self.x[3 if self.mode == "sensor3" else 2]))
            t += dt
            if t >= next_send:
                next_send += 1.0 / self.rate
                pkt = self.sensor3_packet() if self.mode == "sensor3" else State(*(float(v) for v in self.x[:4]))
                try:
                    self.pair.mcu_send(pkt.as_cobs())
                except OSError:
                    break

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
        self.pair.close()


def _open_port(args, mode: str, rate=100.0):
    """(SerialPort, SimMcu or None): the fake MCU with ``--sim-mcu``, else
    the serial link ``--serial`` (``commu_examples.py:131-138``)."""
    scale = getattr(args, "time_scale", 1.0) or 1.0
    if args.sim_mcu:
        mcu = SimMcu(mode=mode, rate_hz=rate, seed=args.seed, duration=args.t_end + 30,
                     time_scale=scale).start()
        try:
            port = SerialPort(mcu.device, 115200, timeout_ms=50)
        except BaseException:
            mcu.stop()
            raise
        return port, mcu
    return SerialPort(args.serial, 115200, timeout_ms=10), None


def _close(port, mcu):
    port.close()
    if mcu:
        mcu.stop()


def uart(args) -> int:
    """Serial echo smoke test — examples/uart.rs: send Control{1234}, read
    an 18-byte framed State; returns the States read. It solves nothing,
    but takes ``--device`` as the other apps do (and raises as they do when
    no card is there)."""
    resolve_device(args.device)
    port, mcu = _open_port(args, "state")
    n_reads = 0
    try:
        deadline = time.time() + min(args.t_end, 5.0)
        while time.time() < deadline:
            port.write_packet(Control(u=1234))
            s = port.read_packet(State)
            if s is not None:
                print(s)
                n_reads += 1
    finally:
        _close(port, mcu)
    print(f"received {n_reads} State packets")
    return n_reads


class CommuResult(NamedTuple):
    solves: int  # solves in the traffic loop (the pre-solve before traffic not counted)
    packets: int  # sensor packets read
    statuses: list[int]  # MppiStatus of every solve
    solve_seconds: list[float]  # host clock of each solve, its u0 read back
    est_seconds: list[float]  # host clock of each estimator step (mppi4-ukf-commu)
    max_abs_theta: float  # largest |θ| seen (State's θ, or the estimate's)
    upright: bool  # no tip-over guard fired
    finite: bool  # every estimate finite (mppi4-ukf-commu; True for mppi4-commu)
    finite_solves: int  # the solves made before the estimate went non-finite (all, if it never did)
    plant_max_abs_theta: float | None  # the fake MCU's plant's largest |θ| (None on a serial link)

    def __int__(self) -> int:  # the solve count, what the JAX apps return (chk_packets reads it)
        return self.solves


@solves_on_one_cpu_thread
def mppi4_commu(args) -> CommuResult:
    """HW-in-loop MPPI — examples/mppi4-commu.rs: the MCU streams State, the
    host replies Control::from_current(u0). K2 on the nonlinear cart-pole
    with shaped4 (``CartPoleShaped4``), T=0.8 N=8 K=800 000 λ=0.5 σ=3 ±20;
    one solve before traffic starts, as the JAX app compiles."""
    p = CartPoleParams.single_wheel()
    t_hor, n = 0.8, 8
    dt = t_hor / n
    k = args.k or 800_000
    cfg = MppiConfig(n_horizon=n, n_rollouts=k, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
    device = resolve_device(args.device)
    solve = make_mppi_solver(cfg, CartPoleShaped4(p, dt), device, args.sampler)
    zeros = torch.zeros(n, dtype=torch.float32, device=device)
    u_n = zeros
    int(solve(0, np.zeros(4), u_n)[1])  # before real-time traffic starts
    port, mcu = _open_port(args, "state")
    statuses, solve_s = [], []
    packets, max_th, upright = 0, 0.0, True
    try:
        deadline = time.time() + args.t_end / (args.time_scale or 1.0)
        while time.time() < deadline:
            s = port.read_latest_packet(State)
            if s is None:
                continue
            packets += 1
            x = s.to_vector()
            max_th = max(max_th, abs(float(x[2])))
            print(f"{x[0]:6.3f} {x[1]:6.3f} {x[2]:6.3f} {x[3]:6.3f} ", end="")
            if x[2] > DEG60:
                print("x[2] is over 60 degrees")
                upright = False
                break
            t0 = time.perf_counter()
            u_n, status = solve(args.seed + len(statuses), x, u_n)
            u0, status = float(u_n[0]), int(status)  # waits for the solve
            solve_s.append(time.perf_counter() - t0)
            statuses.append(status)
            if status != 0:
                print("Failed to compute ", end="")
                u_n, u0 = zeros, 0.0
            print(f"{u0:6.3f}")
            port.write_packet(Control.from_current(u0))
    finally:
        _close(port, mcu)
    return CommuResult(len(statuses), packets, statuses, solve_s, [], max_th, upright, True, len(statuses),
                       mcu.max_abs_theta if mcu else None)


R_DIAG_COMMU = (200.0, 200.0, 20.0, 0.5, 0.5)  # mppi4-ukf-commu.rs's sensor R
PHY_COMMU = (50.0, 50.0, 10.0)  # mppi4-ukf-commu.rs:28


def commu_estimator(p: CartPoleParams, dt: float, dtype=torch.float32, *, alpha: float = 1e-3,
                    sqrt_method: str = "eigh", quirk_denominator: bool = True, phy=PHY_COMMU):
    """(params, state0, est_step) of the HW apps' UKF2(6,5) on Sensor3
    (``commu_examples.py:213-237``, ``:355-377``): ``make_accel6`` without
    the force, the IMU sensor, Merwe α=1e-3 and the eigh root (the JAX
    package's ``ukf_init`` defaults; ``alpha`` and ``sqrt_method`` override
    them), P0 = 10·I. mppi4-ukf-commu's plant has its own cos(ẍ) denominator
    quirk and Q's PHY = (50, 50, 10) (the defaults here); mpc-ukf-commu's
    the cos θ denominator (``quirk_denominator=False``) and gen_q6's default
    PHY (``phy=(100, 70, 20)``). ``est_step(state, u, z, dt_est,
    enable_mask)`` rebuilds Q = gen_q6(dt_est, PHY) and the dropout R =
    gen_r_mask(R_DIAG, mask) for each packet, predicts with dt_est, and
    updates with the masked hx; dt_est and the mask are taken in the
    filter's dtype (the JAX app's float32 on the card's host). A step whose
    linear algebra fails, or that starts from a non-finite estimate, gives
    a NaN estimate, the value the JAX package's LAPACK calls give.

    At the app's α=1e-3 this filter is ill-conditioned in both precisions.
    In float32 it goes non-finite a few packets after a control starts to
    act, and so does the JAX package's: on one closed-loop packet stream
    both do so within the first 10 packets, and with no control both do so
    as the pendulum falls. In float64 both stay finite on that stream
    (``tests/test_torch_commu.py``), though two evaluations of one step in
    another operation order (the JAX package jitted and eager) differ past
    the float64 band."""
    plant6 = dynamics.make_accel6(p, with_force=False, quirk_denominator=quirk_denominator)
    hx = observation.make_hx_imu6(p)
    r_diag = torch.tensor(R_DIAG_COMMU, dtype=torch.float32)
    params, state0 = ukf.ukf_init(
        torch.zeros(6, dtype=dtype),
        10.0 * torch.eye(6, dtype=dtype),
        noise.gen_q6(torch.tensor(dt, dtype=torch.float32), phy=phy).to(dtype),
        torch.diag(r_diag).to(dtype),
        alpha=alpha,
        sqrt_method=sqrt_method,
    )

    def est_step(state, u, z, dt_est, enable_mask):
        dt_e = torch.as_tensor(dt_est, dtype=dtype)
        mask = torch.as_tensor(enable_mask, dtype=dtype)

        def fxd(xv, uu):
            out = plant6(*(xv[..., i] for i in range(6)), uu, dt_e, 0.0)
            return torch.stack(torch.broadcast_tensors(*out), dim=-1)

        state = state._replace(q=noise.gen_q6(dt_e, phy=phy).to(state.q.dtype),
                               r=noise.gen_r_mask(r_diag, mask).to(state.r.dtype))
        if torch.isfinite(state.x).all() and torch.isfinite(state.p).all():
            try:
                state = ukf.ukf_predict(params, state, u, fxd)
                return ukf.ukf_update(params, state, torch.as_tensor(z, dtype=dtype),
                                      observation.make_masked_hx(hx, mask))
            except torch.linalg.LinAlgError:
                pass
        # where LAPACK returns NaN (a singular Pz, a non-finite P) torch
        # raises: the filter's value is then NaN, as in the JAX app, which
        # goes on with NaN estimates (their solves fail to a zero control)
        return state._replace(x=torch.full_like(state.x, float("nan")), p=torch.full_like(state.p, float("nan")))

    return params, state0, est_step


@solves_on_one_cpu_thread
def mppi4_ukf_commu(args) -> CommuResult:
    """HW flagship — examples/mppi4-ukf-commu.rs: Sensor3 with its enable
    bitmask, UKF2(6,5) with a per-packet gen_q and the sensor-dropout R
    (``commu_estimator``, host CPU), and K2 on ``make_commu4`` with
    ``costs.commu4`` (``Commu4Cost4``), T=1.2 N=20 K=800 000 λ=2 σ=2 ±10.
    As the JAX app: the first frame is awaited before control starts, the
    tip-over guard is armed after 10 solves, a control that moved less than
    1e-2 is not published (nor taken as the warm start), and each published
    control is logged to ``mppi-ukf-com/mppi-ukf-com-<time>.csv``.
    ``--ukf-dtype float64`` runs the filter in the reference's precision
    (the Rust reference is float64): the JAX app's float32 filter goes
    non-finite a few packets after the first control acts, and every solve
    after that fails to a zero control (``commu_estimator``)."""
    p = CartPoleParams.two_wheel()
    t_hor, n = 1.2, 20
    dt = t_hor / n
    k = args.k or 800_000
    cfg = MppiConfig(n_horizon=n, n_rollouts=k, lambda_=2.0, std_dev=2.0, limit=(-10.0, 10.0))
    device = resolve_device(args.device)
    solve = make_mppi_solver(cfg, Commu4Cost4(p, dt), device, args.sampler)
    _, est, est_step = commu_estimator(p, dt, getattr(torch, args.ukf_dtype))
    zeros = torch.zeros(n, dtype=torch.float32, device=device)
    # before real-time traffic starts, as the JAX app compiles both hot paths
    int(solve(0, np.zeros(4), zeros)[1])
    est_step(est, 0.0, torch.zeros(5), dt, torch.ones(5))
    scale = args.time_scale or 1.0
    port, mcu = _open_port(args, "sensor3")
    logger = CsvLogger(f"{args.log_dir}/mppi-ukf-com/mppi-ukf-com.csv", timestamped=True)
    u_n, pre_u = zeros, 0.0
    statuses, solve_s, est_s = [], [], []
    packets, max_th, upright, finite, finite_solves = 0, 0.0, True, True, 0
    el = Elapsed()

    def estimate(est, u, pkt, dt_est):
        nonlocal packets, finite
        enable, z = pkt.parse()
        t0 = time.perf_counter()
        est = est_step(est, u, z, dt_est, noise.enable_bits_to_mask(enable))
        est_s.append(time.perf_counter() - t0)
        packets += 1
        finite = finite and bool(torch.isfinite(est.x).all())
        return est, z

    try:
        # the reference starts its reader/UKF thread before the control
        # thread (mppi4-ukf-commu.rs:243): wait for the first frame, so the
        # controller never acts on the blind initial estimate
        first_deadline = time.time() + 5.0
        last_rx = time.time()
        while time.time() < first_deadline:
            s0 = port.read_latest_packet(Sensor3)
            if s0 is not None:
                est, _ = estimate(est, 0.0, s0, 1.0 / 100.0)  # prints no Rcv line, as the JAX app
                last_rx = time.time()
                break
        deadline = time.time() + args.t_end / scale
        while time.time() < deadline:
            s = port.read_latest_packet(Sensor3)
            if s is not None:
                dt_est = min(max((time.time() - last_rx) * scale, 1e-4), 0.1)
                last_rx = time.time()
                est, z = estimate(est, pre_u, s, dt_est)
                if args.console:
                    print_rcv(time.time() - el.t0, pre_u, est.x.numpy(), z, p_diag=torch.diagonal(est.p).numpy())
            xh = est.x.double().numpy()
            max_th = max(max_th, abs(float(xh[3])))
            # the guard is armed once the filter has digested a few packets:
            # from P0 = 10 I one noisy first measurement can throw the raw
            # estimate past π/2 before the covariance contracts
            if len(statuses) > 10 and abs(xh[3]) > PI_2:
                print("x[2] is over pi/2")
                upright = False
                break
            x4 = np.array([xh[0], xh[1], xh[3], xh[4]])
            t0 = time.perf_counter()
            u_new, status = solve(args.seed + len(statuses), x4, u_n)
            u0, status = float(u_new[0]), int(status)  # waits for the solve
            solve_s.append(time.perf_counter() - t0)
            statuses.append(status)
            finite_solves += finite
            if status != 0:
                u_new, u0 = zeros, 0.0
            u0 = float(np.clip(u0, -10.0, 10.0))
            if abs(u0 - pre_u) < 1e-2:
                continue  # skip-publish (mppi4-ukf-commu.rs:85-88)
            pre_u = u0
            u_n = u_new
            port.write_packet(Control.from_current(u0))
            if args.console:
                print_con(time.time() - el.t0, u0, [xh[0], xh[1], xh[3], xh[4]])
            logger.write_row(time.time() - el.t0, u0, xh, torch.diagonal(est.p).double().numpy())
    finally:
        _close(port, mcu)
        logger.close()
    el.print()
    print(f"{len(statuses)} solves")
    return CommuResult(len(statuses), packets, statuses, solve_s, est_s, max_th, upright, finite, finite_solves,
                       mcu.max_abs_theta if mcu else None)


class MpcCommuResult(NamedTuple):
    """mpc-ukf-commu's run: ``int()`` of it is the solve count the JAX app
    returns."""

    solves: int  # PANOC solves in the traffic loop (the pre-solve not counted)
    packets: int  # sensor packets read
    iterations: list[int]  # PANOC iterations of every solve
    solve_seconds: list[float]  # host clock of each solve, its u0 read back
    est_seconds: list[float]  # host clock of each estimator step
    max_abs_theta: float  # the estimate's largest |θ|
    upright: bool  # the π/2 guard did not fire
    finite: bool  # every estimate finite
    plant_max_abs_theta: float | None  # the fake MCU's plant's largest |θ| (None on a serial link)

    def __int__(self) -> int:
        return self.solves


MPC_COMMU_N = 40  # mpc-ukf-commu.rs: T = 1.2 s over N = 40 steps


def mpc_ukf_commu_parts(device, *, max_iter: int | None = None, est_dtype=torch.float32):
    """(solve(x4, u) -> PanocResult, est0, est_step) of mpc-ukf-commu
    (``commu_examples.py:312-364``): the two-wheel condensed QP at N=40,
    dt = 1.2/40, C = diag(0, 0, 10, 3), the raised-cosine reference with the
    −0.75 velocity gain, PANOC (tol 1e-6, memory 20, budget 60) in float64
    on ``device``, bounds ±10; the Sensor3 UKF2(6,5) of ``commu_estimator``
    with the cos θ plant and gen_q6's default PHY, in ``est_dtype`` (the
    app's float32) on the host."""
    p = CartPoleParams.two_wheel()
    n = MPC_COMMU_N
    dt = 1.2 / n
    a, b = dynamics.linear_ab(p, dt, two_wheel=True)
    qp = build_condensed_qp(a, b, np.diag([0.0, 0.0, 10.0, 3.0]), n, device=device)
    vg_factory = make_qp_value_and_grad(qp, reference.make_gen_ref_raised_cosine(n, velocity_gain=-0.75))
    cfg = PanocConfig(tol=1e-6, max_iter=max_iter or 60, lbfgs_mem=20)
    proj = box_projection(-10.0, 10.0)

    def solve(x, u):
        return panoc_solve(cfg, None, proj, u, value_and_grad=vg_factory(x))

    _, est0, est_step = commu_estimator(p, dt, est_dtype, quirk_denominator=False, phy=(100.0, 70.0, 20.0))
    return solve, est0, est_step


@solves_on_one_cpu_thread
def mpc_ukf_commu(args) -> MpcCommuResult:
    """HW gradient-MPC flagship — examples/mpc-ukf-commu.rs
    (``commu_examples.py:312-421``): the MCU streams Sensor3, the host
    filters it (``mpc_ukf_commu_parts``) and solves the N=40 condensed QP by
    PANOC on ``--device``, warm-started from the last solution. As the JAX
    app: one solve and one filter step before traffic (on a card the solve
    captures PANOC's CUDA graphs), the first frame awaited and filtered at
    dt 1/100, dt_est = clip((now − last_rx)·time_scale, 1e-4, 0.1), a solve
    every pass of the loop, the π/2 guard armed after 10 solves, and a
    control sent only when it moved by 1e-2 or more. ``--console`` prints
    the Con: lines and, in the traffic loop, the Rcv: lines."""
    device = resolve_device(args.device)
    n = MPC_COMMU_N
    solve, est, est_step = mpc_ukf_commu_parts(device, max_iter=args.max_iter, est_dtype=getattr(torch, args.ukf_dtype))
    f64 = dict(dtype=torch.float64, device=device)
    # pre-compile both hot paths before real-time traffic starts
    solve(torch.zeros(4, **f64), torch.zeros(n, **f64)).u.cpu()
    est_step(est, 0.0, torch.zeros(5), 1.2 / n, torch.ones(5))
    scale = args.time_scale or 1.0
    el0 = time.time()
    port, mcu = _open_port(args, "sensor3")
    u_n, pre_u, i = torch.zeros(n, **f64), 0.0, 0
    iterations, solve_s, est_s = [], [], []
    packets, max_th, upright, finite = 0, 0.0, True, True

    def estimate(est, u, pkt, dt_est):
        nonlocal packets, finite
        enable, z = pkt.parse()
        t0 = time.perf_counter()
        est = est_step(est, u, z, dt_est, noise.enable_bits_to_mask(enable))
        est_s.append(time.perf_counter() - t0)
        packets += 1
        finite = finite and bool(torch.isfinite(est.x).all())
        return est, z

    last_rx = time.time()
    try:
        # wait for the first frame (see mppi4_ukf_commu)
        first_deadline = time.time() + 5.0
        while time.time() < first_deadline:
            s0 = port.read_latest_packet(Sensor3)
            if s0 is not None:
                est, _ = estimate(est, 0.0, s0, 1.0 / 100.0)
                last_rx = time.time()
                break
        deadline = time.time() + args.t_end / scale
        while time.time() < deadline:
            s = port.read_latest_packet(Sensor3)
            if s is not None:
                dt_est = min(max((time.time() - last_rx) * scale, 1e-4), 0.1)
                last_rx = time.time()
                est, z = estimate(est, pre_u, s, dt_est)
                if args.console:
                    print_rcv(time.time() - el0, pre_u, est.x.numpy(), z, p_diag=torch.diagonal(est.p).numpy())
            xh = est.x.double().numpy()
            max_th = max(max_th, abs(float(xh[3])))
            if i > 10 and abs(xh[3]) > PI_2:  # the guard armed after warm-up (see mppi4_ukf_commu)
                print("θ is over pi/2")
                upright = False
                break
            x4 = torch.tensor([xh[0], xh[1], xh[3], xh[4]], **f64)
            t0 = time.perf_counter()
            res = solve(x4, u_n)
            u_n = res.u
            u0, it = torch.stack([u_n[0], res.iterations.to(torch.float64)]).tolist()  # waits for the solve
            solve_s.append(time.perf_counter() - t0)
            iterations.append(int(it))
            i += 1
            u0 = float(np.clip(u0, -10.0, 10.0))
            if abs(u0 - pre_u) < 1e-2:
                continue
            pre_u = u0
            port.write_packet(Control.from_current(u0))
            if args.console:
                print_con(time.time() - el0, u0, [xh[0], xh[1], xh[3], xh[4]])
    finally:
        _close(port, mcu)
    print(f"{i} solves")
    return MpcCommuResult(i, packets, iterations, solve_s, est_s, max_th, upright, finite,
                          mcu.max_abs_theta if mcu else None)
