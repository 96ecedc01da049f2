"""Scenario-fleet runner — B independent MPPI + UKF closed loops per tick.

Port of ``mpc_rs_tpu/apps/fleet.py:58-248,367-421`` (``build_fleet`` and
``fleet``) for one GPU, with the JAX package's per-model defaults:

- ``cartpole4``: the mppi4-non-liner-s.rs closed loop (σ=10, limit ±10,
  K=1024 per scenario), 20 Hz control with the 0.1 s model step, 100 Hz
  plant/sensor/UKF (5 substeps) at sensor noise σ=[50, 50, 0.5], gen_q4 UKF,
  tip guard 60°.
- ``flagship6``: the mppi4-non-liner-ukf.rs stack (two-wheel plant, UKF(6,5)
  on the IMU observation, MPPI λ=1.4 σ=4 limit ±10, K=8192 per scenario),
  100 Hz control and sensor at σ=[200, 200, 10, 0.05, 0.05] with σ as R,
  x0 = 0, the 2 N pulse during t∈(1, 1.5) s, tip guard π/2.

Both run the fast tier by default (polynomial sin/cos, one approximate
reciprocal in the kernel) with the clt4 sampler below K=2048 and clt4a from
K=2048; ``--no-fast-math`` runs the exact tier with wallace, and
``--sampler`` takes any of the six. The UKF uses α=1, the f32 fleets'
spread (``fleet.py:84-98``). The estimator runs in the batch-minor SoA
layout by default, always on the Jacobi sigma root; ``--ukf-layout aos``
runs the AoS filter on the root ``--sqrt-method`` names, by default the
JAX package's off a TPU (``fleet.py:81-83``): ``eigh`` for cartpole4,
``jacobi`` for flagship6. ``build_fleet(..., estimator_chain=True)`` runs
plant, sensor and UKF as the fused estimator chain (K7, SoA only); it is
off by default and has no CLI flag, as in the JAX package.
``build_fleet(..., obs_normalize=True)`` rescales the flagship's z, hx and R
by 1/σ a channel (``fleet.py:137-146``), a filter that is the same in exact
arithmetic, on the torch-op estimator or on K7 (its instantiation on the
scaled sensor); it has no CLI flag either, as there.

The CLI saves the fleet's carry and generator after every report chunk to
``<--log-dir>/fleet/fleet.pt`` (``runtime/checkpoint.py``), and
``--resume`` continues from such a file, or from a JAX ``fleet.npz``.

``--controller qp`` runs the gradient-MPC fleet (``build_qp_fleet``,
``fleet.py:251-369``): B op-mpc-x-calc-nl parking problems a tick, the
condensed QP solved by batched projected Newton (``--qp-solver newton``,
the default) or by batched PANOC (``--qp-solver panoc``), the nonlinear
plant stepped on the device.

Under ``python -m torch.distributed.run`` (one process a rank) the CLI joins
the ranks (``parallel/distributed.py``; ``--dist-backend``) and runs the
MPPI fleet on the mesh ``{"scenario": 1, "rollouts": world}``, each
scenario's K split over the ranks (``fleet.py:372-373``), and the QP fleet
split over ``{"scenario": world}``. ``build_fleet(..., mesh=)`` and
``build_qp_fleet(..., mesh=)`` take any mesh: each rank builds the whole
fleet from the seed and keeps its scenarios. The reports' survival and
medians, the QP fleet's counts and the checkpoint (the whole fleet's
carry, gathered; the file a one-rank fleet writes at the same tick) are
collective, and only rank 0 prints and writes.
"""

from __future__ import annotations

import math
import os
import statistics
import time
from typing import NamedTuple

import numpy as np
import torch

from mpc_rs_tpu_torch.apps.common import Elapsed, resolve_device
from mpc_rs_tpu_torch.controllers.mppi import MppiConfig
from mpc_rs_tpu_torch.controllers.panoc import PanocConfig, box_projection, panoc_solve
from mpc_rs_tpu_torch.controllers.qp import (
    active_set_inverse_table,
    box_qp_newton,
    build_condensed_qp,
    make_qp_value_and_grad,
    qp_linear_term,
)
from mpc_rs_tpu_torch.estimators.ukf import ukf_init
from mpc_rs_tpu_torch.models import dynamics, noise, reference
from mpc_rs_tpu_torch.models.params import CartPoleParams
from mpc_rs_tpu_torch.ops.estimator_cuda import CartPole4Rpm, Flagship6Imu
from mpc_rs_tpu_torch.ops.mppi_cuda import CartPoleShaped4, Flagship4Diag4
from mpc_rs_tpu_torch.parallel.mesh import Mesh, all_reduce, make_mesh, world
from mpc_rs_tpu_torch.parallel.scenario import (gather_carry, init_scenario_carry, make_scenario_step,
                                                shard_carry)
from mpc_rs_tpu_torch.runtime.checkpoint import load_fleet, load_jax_fleet_npz, save_fleet
from mpc_rs_tpu_torch.runtime.loop import pulse_disturbance

MODELS = ("cartpole4", "flagship6")


class Fleet(NamedTuple):
    tick: object  # step(carry, generator) -> carry
    carry: object  # ScenarioCarry
    generator: torch.Generator
    dt: float  # control tick [s]
    theta_idx: int  # plant-state index of θ
    guard: float  # tip-over guard [rad]
    cfg: MppiConfig
    sampler: str
    ukf_layout: str = "soa"  # "soa" or "aos"
    sqrt_method: str = "jacobi"  # the AoS filter's sigma root (the SoA layout takes Jacobi)
    mesh: Mesh | None = None  # the (scenario × rollouts) mesh; the carry holds this rank's scenarios


def build_fleet(model: str, k: int | None, device, *, seed: int = 0, scenarios: int = 1024,
                feed_true_state: bool = False, fast_math: bool | None = None,
                sampler: str | None = None, ukf_alpha: float | None = None,
                estimator_chain: bool = False, ukf_layout: str = "soa", sqrt_method: str | None = None,
                obs_normalize: bool | None = None, mesh: Mesh | None = None,
                rollouts_per_thread: int | None = None) -> Fleet:
    """The tick, the initial float32 carry and a seeded generator of a fleet
    model on ``device``. ``mesh``: the tick of this rank of a (scenario ×
    rollouts) mesh, its carry this rank's B/S scenarios of the whole
    fleet's; K is rounded as the JAX package rounds it, k·R when R ranks of
    the rollouts axis do not divide k (``fleet.py:158,213``).
    ``rollouts_per_thread`` pins the kernel's R. ``estimator_chain``: the
    tick runs the fused estimator chain (K7) in place of the torch-op
    estimator.
    ``ukf_layout``/``sqrt_method``: the estimator's layout and, for the AoS
    one, its sigma root (None: the model's default). ``obs_normalize``
    (flagship6; None is off): the filter on observations scaled by 1/σ, also
    on K7 (``Flagship6Imu(..., obs_sigma=σ)``, as the JAX fleet passes the
    scaled hx and R into its chain, ``fleet.py:185-191``); on cartpole4,
    which has no such option in the JAX package, it raises."""
    device = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=device)
    fast = True if fast_math is None else fast_math
    alpha = 1.0 if ukf_alpha is None else ukf_alpha
    if obs_normalize and model != "flagship6":
        raise ValueError("obs_normalize is the flagship6 fleet's option, as in the JAX package")
    n_dev = 1 if mesh is None else mesh.size("rollouts")
    if model == "flagship6":
        dt = 0.01  # 100 Hz control+sensor
        k = k or 8192
        k = k * n_dev if k % n_dev else k
        p = CartPoleParams.two_wheel()
        sigma = (200.0, 200.0, 10.0, 0.05, 0.05)
        # plant, UKF process model and sensor (hx / σ with obs_normalize)
        est = Flagship6Imu(p, dt, obs_sigma=sigma if obs_normalize else None)
        ctrl = Flagship4Diag4(p, 1.2 / 8, (0.1, 0.1, 1.0, 0.5), fast=fast)
        sens_raw = torch.tensor(sigma, **f32)
        hx = est.hx
        if obs_normalize:
            sens, r = torch.ones(5, **f32), torch.diag(1.0 / sens_raw)  # diag(σ)/σ²: σ-as-R kept
        else:
            sens, r = sens_raw, torch.diag(sens_raw)
        p0 = 0.1 * torch.eye(6, **f32)
        # ~2.15·dt in gen_q6's dt powers: absorbs the unmodeled 2 N push
        q = noise.gen_q6(torch.tensor(2.15 * dt, **f32))
        sqrt_method = sqrt_method or "jacobi"
        params, ukf0 = ukf_init(torch.zeros(6, **f32), p0, q, r, alpha=alpha, sqrt_method=sqrt_method)
        cfg = MppiConfig(n_horizon=8, n_rollouts=k, lambda_=1.4, std_dev=4.0, limit=(-10.0, 10.0))
        kw = dict(state_slice=(0, 1, 3, 4), n_substeps=1, disturbance=pulse_disturbance(1.0, 1.5, 2.0))
        x0 = torch.zeros(6, **f32)
        theta_idx, guard = 3, math.pi / 2
    elif model == "cartpole4":
        dt = 0.05  # 20 Hz control; the model step stays T/N = 0.1
        n_sub = 5  # 100 Hz plant/sensor/UKF
        k = k or 1024
        k = k * n_dev if k % n_dev else k
        p = CartPoleParams.single_wheel()
        ctrl = CartPoleShaped4(p, 0.1, fast=fast)
        est = CartPole4Rpm(p, dt / n_sub)
        sens = torch.tensor([50.0, 50.0, 0.5], **f32)
        x0 = torch.tensor([0.5, 0.0, 0.1, 0.0], **f32)
        p0 = 0.1 * torch.eye(4, **f32)
        q = noise.gen_q4(dt / n_sub, dtype=torch.float32).to(device)
        r = torch.diag(sens * sens)
        hx = est.hx
        sqrt_method = sqrt_method or "eigh"  # the JAX rule off a TPU (fleet.py:81-83)
        params, ukf0 = ukf_init(x0, p0, q, r, alpha=alpha, sqrt_method=sqrt_method)
        cfg = MppiConfig(n_horizon=8, n_rollouts=k, lambda_=0.5, std_dev=10.0, limit=(-10.0, 10.0))
        kw = dict(n_substeps=n_sub, disturbance=None)
        theta_idx, guard = 2, math.radians(60.0)
    else:
        raise ValueError(f"unknown fleet model {model!r}; choose from {MODELS}")
    sampler = sampler or (("clt4a" if k >= 2048 else "clt4") if fast else "wallace")
    plant_fx = est.plant_fx if kw["disturbance"] is not None else est.fx
    tick = make_scenario_step(cfg, ctrl, plant_fx, params, est.fx, hx, sens, dt_tick=dt,
                              ukf_p_reset=p0, feed_true_state=feed_true_state, sampler=sampler,
                              estimator_chain=estimator_chain, chain_model=est, ukf_q_const=q,
                              ukf_r_const=r, ukf_layout=ukf_layout, mesh=mesh,
                              rollouts_per_thread=rollouts_per_thread, **kw)
    carry = shard_carry(init_scenario_carry(scenarios, x0, torch.zeros(8, **f32), ukf0, ukf_layout=ukf_layout),
                        mesh)
    gen = torch.Generator(device=device).manual_seed(seed)
    return Fleet(tick, carry, gen, dt, theta_idx, guard, cfg, sampler, ukf_layout, sqrt_method, mesh)


def tipped(th_max: np.ndarray, guard: float) -> np.ndarray:
    """The scenarios whose max |θ| passed the guard, by the reference's rule
    ``th_max > guard`` (``mpc_rs_tpu/apps/fleet.py:412``): a NaN θ compares
    false, so it counts as survived."""
    return th_max > guard


class FleetResult(NamedTuple):
    carry: object  # the final ScenarioCarry
    scenarios: int
    ticks: int
    tipped: int  # scenarios whose |θ| ever passed the guard (a NaN θ did not)
    survival: float
    statuses_ok: bool  # every MPPI status of every tick was 0
    median_max_theta: float  # median over scenarios of max |θ| in the last report chunk
    tick_seconds: list  # host wall time of each tick, synchronised
    scenario_ticks_per_s: float  # over the whole run, host clock


def _whole(values: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The whole fleet's (B,) values from this rank's scenarios, by one
    ``all_reduce`` SUM over the scenario axis of a zero-padded vector (every
    rank of the axis gets every scenario's value, bit for bit)."""
    if mesh is None or mesh.group("scenario") is None:
        return values
    b, n_s = values.shape[0], mesh.size("scenario")
    full = torch.zeros((b * n_s,) + tuple(values.shape[1:]), dtype=values.dtype, device=values.device)
    full[mesh.coord("scenario") * b:(mesh.coord("scenario") + 1) * b] = values
    return all_reduce(full, torch.distributed.ReduceOp.SUM, mesh, "scenario")


def _say(mesh: Mesh | None, line: str) -> None:
    """Print on rank 0 only."""
    if mesh is None or mesh.rank == 0:
        print(line, flush=True)


def checkpoint_fleet(path: str, fl: Fleet, carry) -> None:
    """Save the whole fleet's carry and the generator to ``path``: on a
    mesh every rank gathers the carry (a collective) and rank 0 writes the
    file, the one a one-rank fleet writes at the same tick, then every rank
    waits at a barrier."""
    whole = gather_carry(carry, fl.mesh)
    if fl.mesh is None or fl.mesh.rank == 0:
        save_fleet(path, whole, fl.generator)
    if fl.mesh is not None and fl.mesh.group("scenario") is not None:
        torch.distributed.barrier()


def run_fleet(fl: Fleet, *, t_end: float, report_every: float, checkpoint: str | None = None) -> FleetResult:
    """Run whole report chunks until ``t_end`` and print one line per chunk
    (survival, median max |θ|, scenario-ticks/s), as ``fleet.py:391-418``.
    With ``checkpoint`` (a path), the carry and the generator are saved
    there after every chunk (``fleet.py:418``), outside the chunk's clock.
    A scenario is tipped once its max |θ| over a chunk passes the guard, by
    the reference's ``th_max > guard`` (``mpc_rs_tpu/apps/fleet.py:412``;
    ``tipped``): a NaN θ counts as survived, as it does there. On a mesh the
    survival, the medians and the statuses are the whole fleet's (an
    all-reduce over the scenario axis a chunk), and rank 0 prints."""
    carry, b_local = fl.carry, fl.carry.x.shape[0]
    b = b_local * (1 if fl.mesh is None else fl.mesh.size("scenario"))
    dev = carry.x.device
    chunk = max(1, min(int(round(report_every / fl.dt)), int(t_end / fl.dt)))
    n_ticks = int(t_end / fl.dt)
    done, ticks, wall_total = 0, [], 0.0
    ever_tipped = np.zeros(b, bool)
    bad_status = torch.zeros(b_local, dtype=torch.bool, device=dev)
    med = float("nan")
    while done < n_ticks:
        t0 = time.perf_counter()
        th_max = torch.zeros(b_local, dtype=carry.x.dtype, device=dev)
        for _ in range(chunk):
            t1 = time.perf_counter()
            carry = fl.tick(carry, fl.generator)
            th_max = torch.maximum(th_max, carry.x[:, fl.theta_idx].abs())
            bad_status |= carry.status != 0
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            ticks.append(time.perf_counter() - t1)
        th = _whole(th_max, fl.mesh).cpu().numpy()  # readback = sync
        wall = time.perf_counter() - t0
        wall_total += wall
        done += chunk
        ever_tipped |= tipped(th, fl.guard)
        surv = 1.0 - ever_tipped.mean()
        med = float(np.median(th))
        _say(fl.mesh, f"t={done * fl.dt:6.1f}s  survival={surv:6.3f}  median max|θ|={med:.4f}  "
                      f"{b * chunk / wall:,.0f} scenario-ticks/s")
        if checkpoint is not None:
            checkpoint_fleet(checkpoint, fl, carry)
    n_tipped = int(ever_tipped.sum())
    statuses_ok = not bool(_whole(bad_status.to(torch.int32), fl.mesh).any())
    return FleetResult(carry, b, done, n_tipped, 1.0 - n_tipped / b, statuses_ok,
                       med, ticks, b * done / wall_total)


def resume_fleet(fl: Fleet, path: str, seed: int) -> Fleet:
    """``fl`` with the carry and generator of the checkpoint at ``path``: a
    port ``fleet.pt`` (``load_fleet``), or a JAX ``fleet.npz``
    (``load_jax_fleet_npz``), whose per-scenario PRNG keys have no
    counterpart: the generator is then seeded from ``seed``. The file holds
    the whole fleet, whatever world wrote it: on a mesh every rank loads it
    and keeps its scenarios (the template's gather is a collective)."""
    dev = fl.carry.x.device
    template = gather_carry(fl.carry, fl.mesh)
    if path.endswith(".npz"):
        carry = load_jax_fleet_npz(path, fl.ukf_layout, template=template, device=dev)
        _say(fl.mesh, f"resumed fleet from {path} (a JAX fleet.npz: its PRNG keys are dropped; "
                      f"the generator is seeded from --seed {seed})")
        return fl._replace(carry=shard_carry(carry, fl.mesh),
                           generator=torch.Generator(device=dev).manual_seed(seed))
    carry, gen = load_fleet(path, template, dev)
    _say(fl.mesh, f"resumed fleet from {path}")
    return fl._replace(carry=shard_carry(carry, fl.mesh), generator=gen)


class QpFleet(NamedTuple):
    tick: object  # tick((x, u_n)) -> (x, u_n)
    carry: tuple  # (x (B, 4), u_n (B, N)): this rank's scenarios on a mesh
    dt: float  # control tick [s]
    solver: str
    mesh: Mesh | None = None  # the scenario axis splits the fleet; the tick has no collective


QP_PARK_X, QP_UPRIGHT = 0.3, math.pi / 2  # parked |x| and upright |θ| (fleet.py:345-346)


def build_qp_fleet(scenarios: int, device, *, seed: int = 0, max_iter: int = 60, solver: str = "newton",
                   x0=None, dtype=torch.float32, mesh: Mesh | None = None) -> QpFleet:
    """Batched gradient-MPC fleet (``fleet.py:251-330``): B independent
    op-mpc-x-calc-nl parking problems (the condensed QP of the linear model,
    the nonlinear plant: examples/op-mpc-x-calc.rs:73-98), float32.

    ``solver="newton"``: one batched ``box_qp_newton`` a tick (12
    iterations, no safeguard: this instance class is held to the oracle's
    enumerated optimum without it), the B linear terms from two matmuls,
    the active-set inverse table below B = 16 (``fleet.py:286-296``);
    ``solver="panoc"``: one batched ``panoc_solve`` (tol 1e-5, memory 10,
    ``max_iter``), each lane its own loop. x0: B draws of (0.5, 0, 0.1, 0) +
    0.2·N(0, 1) from a torch generator seeded ``seed``, or the (B, 4) numpy
    array given. ``dtype`` float64 builds the same fleet in float64.
    ``mesh``: this rank's B/S scenarios of the whole fleet (the ``scenario``
    axis; ``tests/test_distributed.py:113-124`` splits the JAX one so),
    each solved as on one device; the active-set table follows the whole
    fleet's B."""
    device = resolve_device(device)
    if solver not in ("newton", "panoc"):
        raise ValueError(f"unknown QP solver {solver!r}; choose newton or panoc")
    p = CartPoleParams.single_wheel()
    t_hor, n = 0.8, 8
    dt = t_hor / n
    a, bm = dynamics.linear_ab(p, dt)
    qp = build_condensed_qp(a, bm, np.diag([5.0, 5.0, 1.0, 1.0]), n, dtype=dtype, device=device)
    gen_ref = reference.make_gen_ref_raised_cosine(n)
    lim = 30.0
    plant = dynamics.as_vector_fn(dynamics.make_cartpole_nonlinear(p, dt), 4)

    if solver == "newton":
        inv_tbl = active_set_inverse_table(qp.h) if scenarios < 16 else None

        def solve_batch(x, u_n):
            b = qp_linear_term(qp, x, gen_ref(x).flatten(-2))
            return box_qp_newton(qp.h, b, u_n, -lim, lim, iters=12, inv_table=inv_tbl, safeguard=False)
    else:
        vg_factory = make_qp_value_and_grad(qp, gen_ref)
        cfg = PanocConfig(tol=1e-5, max_iter=max_iter, lbfgs_mem=10)
        proj = box_projection(-lim, lim)

        def solve_batch(x, u_n):
            return panoc_solve(cfg, None, proj, u_n, value_and_grad=vg_factory(x)).u

    def tick(carry):
        x, u_n = carry
        u_new = solve_batch(x, u_n)
        return plant(x, u_new[:, 0]), u_new

    if x0 is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        z = torch.randn((scenarios, 4), generator=gen, dtype=dtype, device=device)
        x = torch.tensor([0.5, 0.0, 0.1, 0.0], dtype=dtype, device=device) + 0.2 * z
    else:
        x = torch.tensor(np.asarray(x0), dtype=dtype, device=device).reshape(scenarios, 4)
    u_n = torch.zeros((scenarios, n), dtype=dtype, device=device)
    if mesh is not None:
        n_s, sc = mesh.size("scenario"), mesh.coord("scenario")
        if scenarios % n_s:
            raise ValueError(f"B={scenarios} scenarios not divisible by the scenario axis' {n_s} ranks")
        b = scenarios // n_s
        x, u_n = x[sc * b:(sc + 1) * b].contiguous(), u_n[sc * b:(sc + 1) * b].contiguous()
    return QpFleet(tick, (x, u_n), dt, solver, mesh)


class QpFleetResult(NamedTuple):
    carry: tuple  # the final (x, u_n)
    scenarios: int
    ticks: int
    parked: float  # share with |x| < 0.3 at the last report
    upright: float  # share with |θ| < π/2 at the last report
    median_abs_x: float
    scenario_ticks_per_s: float  # over the whole run, host clock


def run_qp_fleet(fl: QpFleet, *, t_end: float, report_every: float) -> QpFleetResult:
    """Whole report chunks until ``t_end``, the carry read back once a chunk
    (``fleet.py:335-356``), one line a chunk with the JAX line's fields. On a
    mesh the shares and the median are the whole fleet's (an all-reduce over
    the scenario axis a chunk), and rank 0 prints."""
    carry = fl.carry
    b = carry[0].shape[0] * (1 if fl.mesh is None else fl.mesh.size("scenario"))
    chunk = max(1, min(int(round(report_every / fl.dt)), int(t_end / fl.dt)))
    n_ticks = int(t_end / fl.dt)
    done, wall_total = 0, 0.0
    parked = upright = med = float("nan")
    while done < n_ticks:
        t0 = time.perf_counter()
        for _ in range(chunk):
            carry = fl.tick(carry)
        x = _whole(carry[0], fl.mesh).cpu().numpy()  # readback = sync
        wall = time.perf_counter() - t0
        wall_total += wall
        done += chunk
        parked = float((np.abs(x[:, 0]) < QP_PARK_X).mean())
        upright = float((np.abs(x[:, 2]) < QP_UPRIGHT).mean())
        med = float(np.median(np.abs(x[:, 0])))
        _say(fl.mesh, f"t={done * fl.dt:6.1f}s  parked={parked:6.3f}  upright={upright:6.3f}  "
                      f"median|x|={med:.3f}  {b * chunk / wall:,.0f} scenario-ticks/s")
    return QpFleetResult(carry, b, done, parked, upright, med, b * done / wall_total)


def _cli_mesh(args, axes) -> Mesh | None:
    """Under ``torch.distributed.run``: join the ranks (``--dist-backend``)
    and lay them out as ``axes(world)``; else None (one device)."""
    from mpc_rs_tpu_torch.parallel.distributed import init_distributed, launched

    if not launched():
        return None
    args.device = init_distributed(backend=args.dist_backend, device=args.device)
    return make_mesh(axes(world()[1]))


def _run_qp_fleet(args) -> QpFleetResult:
    mesh = _cli_mesh(args, lambda w: {"scenario": w})
    fl = build_qp_fleet(args.scenarios, args.device, seed=args.seed, max_iter=args.max_iter or 60,
                        solver=args.qp_solver, mesh=mesh)
    _say(mesh, f"fleet qp: B={args.scenarios} solver={fl.solver} device={fl.carry[0].device}"
               + ("" if mesh is None else f" ranks={mesh.world}"))
    el = Elapsed()
    res = run_qp_fleet(fl, t_end=args.t_end, report_every=args.report_every)
    if mesh is None or mesh.rank == 0:
        el.print()
    return res


def fleet(args):
    """The ``fleet`` CLI entry: the QP fleet with ``--controller qp``; else
    build (or resume) the MPPI fleet, run it with a checkpoint after every
    chunk, and print a summary. Under ``torch.distributed.run`` each rank
    runs its share of the mesh ``{"scenario": 1, "rollouts": world}``
    (``mpc_rs_tpu/apps/fleet.py:372-373``)."""
    if args.controller == "qp":
        return _run_qp_fleet(args)
    mesh = _cli_mesh(args, lambda w: {"scenario": 1, "rollouts": w})
    fl = build_fleet(args.model, args.k, args.device, seed=args.seed, scenarios=args.scenarios,
                     fast_math=args.fast_math, sampler=args.sampler, ukf_alpha=args.ukf_alpha,
                     ukf_layout=args.ukf_layout or "soa", sqrt_method=args.sqrt_method, mesh=mesh)
    if args.resume:
        fl = resume_fleet(fl, args.resume, args.seed)
    root = "aos, " + fl.sqrt_method if fl.ukf_layout == "aos" else "soa, jacobi"
    _say(mesh, f"fleet {args.model}: B={args.scenarios} K={fl.cfg.n_rollouts} sampler={fl.sampler} "
               f"fast_math={args.fast_math is not False} ukf=({root}) device={fl.carry.x.device}"
               + ("" if mesh is None else f" ranks={mesh.world} backend={torch.distributed.get_backend()}"))
    ckpt = os.path.join(args.log_dir, "fleet", "fleet.pt")
    el = Elapsed()
    res = run_fleet(fl, t_end=args.t_end, report_every=args.report_every, checkpoint=ckpt)
    if mesh is None or mesh.rank == 0:
        el.print()
    _say(mesh, f"checkpoint: {ckpt}")
    _say(mesh, f"survived {res.scenarios - res.tipped}/{res.scenarios} over {res.ticks} ticks; "
               f"median tick {1e3 * statistics.median(res.tick_seconds):.3f} ms; "
               f"all statuses 0: {res.statuses_ok}")
    return res
