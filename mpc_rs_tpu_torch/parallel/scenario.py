"""Scenario-batched closed loops on one GPU — the fleet's tick.

Port of ``mpc_rs_tpu/parallel/scenario.py:38-45,47-337,360-386`` for one
device. Each tick advances B independent closed loops: one
scenario-batched MPPI solve (``ops/mppi_cuda.py::mppi_solve_batch_fused``,
the K5/K6 kernel on a CUDA device), then ``n_substeps`` of plant → sensor →
UKF predict/update/guard. The estimator runs in one of three forms:
- ``ukf_layout="soa"`` (the default): the batch-minor filter in torch ops
  (the JAX package's ``rest_soa``), its covariance carried packed (n², B);
- ``ukf_layout="soa"`` with ``estimator_chain=True`` (opt-in, as there):
  one call of ``ops/estimator_cuda.py::estimator_chain_fused`` (its
  ``rest_chain``: the K7 kernel on a CUDA device);
- ``ukf_layout="aos"``: the AoS filter of ``estimators/ukf.py`` (its
  ``ukf_predict``, ``ukf_update`` and ``ukf_guard``, with the sigma root of
  ``UkfParams.sqrt_method``) on (B, n) means and (B, n, n) covariances in
  torch ops, the JAX package's vmapped ``rest`` (``scenario.py:190-220``).
  K7 runs the SoA filter only: ``estimator_chain=True`` with ``"aos"``
  raises, where the JAX step quietly runs without the chain.

With ``mesh=`` (``parallel/mesh.py``) the tick runs on one rank of a
(scenario × rollouts) mesh, the ``shard_map`` of ``scenario.py:339-357``:
the rank holds its scenario sub-batch of B/S (scenario axis), and samples
K/R of each scenario's rollouts (rollouts axis). Its MPPI is one launch
whose merging blocks write each scenario's merged row
(``mppi_batch_partials_merged_fused``), the rows of the rollouts axis are
merged by ``all_reduce`` MAX and SUM (``parallel/sharded_mppi.py::
merge_rows``, ``scenario.py:150-158``), and ``finalize_batch_fused``
finishes the solves. The plant, sensor and UKF then run on the sub-batch
alone, the same bits on every rank of a rollouts line (the all-reduces give
every rank the same bits), so those ranks' carries stay equal.

Randomness comes from an explicit ``torch.Generator`` on the carry's
device: per tick one (B,) int32 draw of kernel seeds (scenario b keys its
Philox stream with seeds[b]) and the standard normals of sensor noise:
per substep one (B, o) draw, or with the chain one (n_substeps, B, o)
draw. ``step(..., mppi_noise=, sensor_noise=)`` replaces both, so a test can
feed the JAX package and the port the same numbers. On a mesh every rank
draws the whole fleet's numbers (B = B/S · S) and keeps its sub-batch's, so
scenario b draws what it draws on one device whatever S is; a rollouts
rank r keys its streams with seeds[b] + r·7919 (int32), and the noise seams
take the whole fleet's tensors, of which a rank takes its share.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, NamedTuple

import numpy as np
import torch

from mpc_rs_tpu_torch.controllers.mppi import MppiConfig
from mpc_rs_tpu_torch.estimators import ukf_soa
from mpc_rs_tpu_torch.estimators.ukf import UkfParams, UkfState, ukf_guard, ukf_predict, ukf_update
from mpc_rs_tpu_torch.ops.estimator_cuda import EstimatorChain, estimator_chain_fused
from mpc_rs_tpu_torch.ops.mppi_cuda import (finalize_batch_fused, mppi_batch_partials_merged_fused,
                                            mppi_solve_batch_fused)
from mpc_rs_tpu_torch.parallel.mesh import Mesh, all_gather_host
from mpc_rs_tpu_torch.parallel.sharded_mppi import check_sharded, merge_rows, rank_seed


class ScenarioCarry(NamedTuple):
    x: torch.Tensor  # (B, S) true plant states
    u_n: torch.Tensor  # (B, N) nominal sequences
    # x (B, n); q (B, n, n); r (B, o, o); p (n², B) packed batch-minor and sigma_f None
    # under the SoA layout, p (B, n, n) and sigma_f (B, 2n+1, n) under the AoS one
    ukf: UkfState
    status: torch.Tensor  # (B,) int32 last MPPI status
    t: torch.Tensor  # (B,) sim time — drives disturbance windows


def make_scenario_step(
    cfg: MppiConfig,
    model,  # kernel model of ops/mppi_cuda.py (CartPoleShaped4, Flagship4Diag4)
    plant_fx: Callable,  # vector form (x (B, S), u (B,)[, f (B,)]) -> x — true plant
    ukf_params: UkfParams,
    ukf_fx: Callable,  # vector form (x (..., n), u) -> x
    ukf_hx: Callable,  # vector form x (..., n) -> z (..., o); also the sensor's map
    sensor_stddevs: torch.Tensor,  # (o,)
    *,
    state_slice=None,  # e.g. 6-state estimate -> 4-state controller input
    feed_true_state: bool = False,
    n_substeps: int = 1,
    dt_tick: float = 0.0,
    disturbance: Callable | None = None,
    control_start: float = 0.0,
    ukf_p_reset=None,  # enables per-instance NaN recovery (soa_guard)
    sampler: str = "box-muller",
    estimator_chain: bool = False,  # opt-in: the fused estimator chain (K7)
    chain_model=None,  # the chain's models (ops/estimator_cuda.py) — required for it
    ukf_q_const=None,  # (n, n) static process noise — required for the chain
    ukf_r_const=None,  # (o, o) static measurement noise — required for the chain
    ukf_layout: str = "soa",  # the estimator's layout: "soa" or "aos"
    mesh: Mesh | None = None,  # a (scenario × rollouts) mesh; None: one device
    rollouts_per_thread: int | None = None,  # the kernel's R (default its rule at the rank's K and B)
):
    """Returns ``step(carry, generator, *, mppi_noise=None, sensor_noise=None)
    -> carry`` advancing every scenario one control tick: MPPI → plant →
    sensor → UKF. ``step.chain`` is the tick's ``EstimatorChain`` (None
    without ``estimator_chain``).

    ``feed_true_state``: the controller sees the true plant state (the
    reference's DEBUG_UKF switch, mppi4-non-liner-ukf.rs:31,55-61).
    ``n_substeps``: plant and sensor→UKF run that many times per tick with
    u0 held (``plant_fx``/``ukf_fx`` built at the substep dt).
    ``disturbance``: f(t_sim) -> force; ``plant_fx`` is then called as
    ``plant_fx(x, u, f)``. ``control_start``: the plant coasts (u = 0)
    before this sim time. ``mppi_noise`` (B, K, N) replaces in-kernel
    sampling, ``sensor_noise`` (n_substeps, B, o) the standard normals of
    the sensor.

    ``estimator_chain``: plant, sensor and UKF run as one fused chain
    (``estimator_chain_fused``) on ``chain_model``'s plant, process and
    sensor models with the constant ``ukf_q_const``/``ukf_r_const``, as the
    JAX package's ``make_estimator_chain``; the mean's pair sums then add up
    in sequence (``unroll_sum=True``), so a tick agrees with the torch-op
    path to rounding, not bit for bit.

    ``ukf_layout="aos"``: the AoS filter on the carry of
    ``init_scenario_carry(..., ukf_layout="aos")``; it draws the same sensor
    noise as the SoA path.

    ``mesh``: the tick of one rank of a mesh with axes ``scenario`` (S) and
    ``rollouts`` (R); its carry holds the rank's B/S scenarios
    (``shard_carry``), R must divide K, and the noise seams take the whole
    fleet's (B, K, N) and (n_substeps, B, o). ``rollouts_per_thread`` pins
    the kernel's R, so that a tick on a mesh can repeat the bits of a tick
    on one device.
    """
    if ukf_layout not in ("soa", "aos"):
        raise ValueError(f"ukf_layout must be 'soa' or 'aos', got {ukf_layout!r}")
    if estimator_chain and ukf_layout == "aos":
        raise ValueError("estimator_chain=True runs the SoA filter (K7); there is no chain for ukf_layout='aos'")
    sig = torch.as_tensor(sensor_stddevs)
    p_reset = None if ukf_p_reset is None else torch.as_tensor(ukf_p_reset)
    dt_sub = dt_tick / n_substeps
    chain = None
    if estimator_chain:
        if chain_model is None or ukf_q_const is None or ukf_r_const is None:
            raise ValueError("estimator_chain=True needs chain_model, ukf_q_const and ukf_r_const")
        chain = EstimatorChain(chain_model, ukf_params, torch.as_tensor(ukf_q_const),
                               torch.as_tensor(ukf_r_const), sig, p_reset, n_substeps, dt_sub,
                               disturbance, control_start)

    n_scen = 1 if mesh is None else mesh.size("scenario")
    sc = 0 if mesh is None else mesh.coord("scenario")
    r = 0 if mesh is None else mesh.coord("rollouts")
    if mesh is not None:
        k_local = check_sharded(cfg, model, mesh.size("rollouts"))
        cfg_local = dataclasses.replace(cfg, n_rollouts=k_local)

    def mppi(x_hats, u_n, lo, seeds, mppi_noise):
        """The tick's solves of the scenarios [lo, lo + b) of the fleet."""
        rpt = rollouts_per_thread
        if mesh is None:
            if mppi_noise is None:
                return mppi_solve_batch_fused(cfg, model, x_hats, u_n, seeds=seeds, sampler=sampler,
                                              rollouts_per_thread=rpt)
            return mppi_solve_batch_fused(cfg, model, x_hats, u_n, noise=mppi_noise, rollouts_per_thread=rpt)
        b = x_hats.shape[0]
        if mppi_noise is None:
            rows = mppi_batch_partials_merged_fused(cfg_local, model, x_hats, u_n, seeds=rank_seed(seeds, r),
                                                    sampler=sampler, first_scenario=lo, rollouts_per_thread=rpt)
        else:
            noise = mppi_noise[lo:lo + b, r * k_local:(r + 1) * k_local].contiguous()
            rows = mppi_batch_partials_merged_fused(cfg_local, model, x_hats, u_n, noise=noise,
                                                    rollouts_per_thread=rpt)
        return finalize_batch_fused(cfg, merge_rows(cfg, rows, mesh, "rollouts")[:, None])

    def step(carry: ScenarioCarry, generator: torch.Generator, *,
             mppi_noise: torch.Tensor | None = None,
             sensor_noise: torch.Tensor | None = None) -> ScenarioCarry:
        b = carry.x.shape[0]
        b_all, lo = b * n_scen, b * sc  # the fleet, and this rank's first scenario in it
        dev, dtype = carry.x.device, carry.x.dtype
        x_ctrl = carry.x if feed_true_state else carry.ukf.x
        x_hats = x_ctrl if state_slice is None else x_ctrl[:, list(state_slice)]
        seeds = None
        if mppi_noise is None:
            seeds = torch.randint(0, 2**31 - 1, (b_all,), generator=generator, device=dev,
                                  dtype=torch.int32)[lo:lo + b]
        u_new, status = mppi(x_hats.contiguous(), carry.u_n, lo, seeds, mppi_noise)
        if sensor_noise is not None:
            sensor_noise = sensor_noise[:, lo:lo + b]

        if chain is not None:
            o = sig.shape[0]
            eps = (sensor_noise if sensor_noise is not None else
                   torch.randn((n_substeps, b_all, o), generator=generator, device=dev, dtype=dtype)[:, lo:lo + b])
            rows = eps.permute(0, 2, 1).reshape(n_substeps * o, b).contiguous()  # (n_sub·o, B)
            x, ukf_x, ukf_p = estimator_chain_fused(chain, carry.x, carry.ukf.x, carry.ukf.p,
                                                    u_new[:, 0], carry.t, rows)
            return ScenarioCarry(x=x, u_n=u_new, ukf=carry.ukf._replace(x=ukf_x, p=ukf_p),
                                 status=status, t=carry.t + dt_tick)
        u0 = u_new[:, 0]
        if control_start > 0.0:
            # estimator-settling window: the plant coasts while the
            # sensor->UKF chain runs (mppi4-non-liner-ukf.rs:224-288)
            u0 = torch.where(carry.t >= control_start, u0, 0.0)
        ukf = carry.ukf
        s_dev = sig.to(device=dev, dtype=dtype)

        def sense(x, i):
            eps = (sensor_noise[i] if sensor_noise is not None else
                   torch.randn((b_all, s_dev.shape[0]), generator=generator, device=dev, dtype=dtype)[lo:lo + b])
            return ukf_hx(x) + s_dev * eps

        def plant(x, i):
            if disturbance is None:
                return plant_fx(x, u0)
            return plant_fx(x, u0, disturbance(carry.t + torch.full_like(carry.t, i) * dt_sub))

        x = carry.x
        if ukf_layout == "aos":
            u_col = u0[:, None]  # broadcast over the sigma points of each scenario
            for i in range(n_substeps):
                x = plant(x, i)
                z = sense(x, i)
                ukf = ukf_update(ukf_params, ukf_predict(ukf_params, ukf, u_col, ukf_fx), z, ukf_hx)
                if p_reset is not None:
                    ukf = ukf_guard(ukf, p_reset)
            return ScenarioCarry(x=x, u_n=u_new, ukf=ukf, status=status, t=carry.t + dt_tick)
        n = ukf.x.shape[-1]
        q, r = ukf.q[0], ukf.r[0]
        soa = ukf_soa.SoaUkfState(x=ukf.x.T, p=ukf.p.reshape(n, n, b), sigma_f=None)
        for i in range(n_substeps):
            x = plant(x, i)
            z = sense(x, i)
            soa = ukf_soa.soa_predict(ukf_params, soa, u0, ukf_fx, q)
            soa = ukf_soa.soa_update(ukf_params, soa, z.T, ukf_hx, r)
            if p_reset is not None:
                soa = ukf_soa.soa_guard(soa, p_reset)
        ukf = ukf._replace(x=soa.x.T.contiguous(), p=soa.p.reshape(n * n, b))
        return ScenarioCarry(x=x, u_n=u_new, ukf=ukf, status=status, t=carry.t + dt_tick)

    step.chain = chain  # the EstimatorChain the tick runs, or None
    return step


def init_scenario_carry(batch: int, x0: torch.Tensor, u0: torch.Tensor,
                        ukf_state: UkfState, ukf_layout: str = "soa") -> ScenarioCarry:
    """Broadcast one scenario's initial condition to a (B, ...) carry. Under
    ``ukf_layout="soa"`` the covariance is packed batch-minor as one (n², B)
    tensor and sigma_f is dropped (the JAX package's ``"soa"`` carry); under
    ``"aos"`` every field is tiled batch-leading, sigma_f included."""
    tile = lambda a: a.expand((batch,) + tuple(a.shape)).contiguous()  # noqa: E731
    n = ukf_state.x.shape[-1]
    if ukf_layout == "aos":
        ukf = UkfState(*(tile(a) for a in ukf_state))
    elif ukf_layout == "soa":
        ukf = UkfState(
            x=tile(ukf_state.x),
            p=ukf_state.p.reshape(n * n, 1).expand(n * n, batch).contiguous(),
            q=tile(ukf_state.q), r=tile(ukf_state.r), sigma_f=None,
        )
    else:
        raise ValueError(f"ukf_layout must be 'soa' or 'aos', got {ukf_layout!r}")
    dev = x0.device
    return ScenarioCarry(
        x=tile(x0), u_n=tile(u0), ukf=ukf,
        status=torch.zeros(batch, dtype=torch.int32, device=dev),
        t=torch.zeros(batch, dtype=x0.dtype, device=dev),
    )


def carry_from_numpy(arrays: Mapping[str, Any], device=None) -> ScenarioCarry:
    """The port's carry from numpy arrays of a JAX ``ScenarioCarry``: keys
    ``x``, ``u_n``, ``ukf`` (a mapping with ``x``, ``p``, ``q``, ``r`` and,
    under the AoS layout, ``sigma_f``), ``status``, ``t``. ``ukf.p`` is
    (n², B) under the SoA layout and (B, n, n) under the AoS one. The JAX
    per-scenario PRNG keys (``key``) have no counterpart and are ignored;
    any other key raises."""
    unknown = set(arrays) - {"x", "u_n", "ukf", "status", "t", "key"}
    if unknown:
        raise ValueError(f"unknown ScenarioCarry fields: {sorted(unknown)}")
    t = lambda a: torch.as_tensor(np.array(a), device=device)  # noqa: E731
    u = arrays["ukf"]
    return ScenarioCarry(
        x=t(arrays["x"]), u_n=t(arrays["u_n"]),
        ukf=UkfState(x=t(u["x"]), p=t(u["p"]), q=t(u["q"]), r=t(u["r"]),
                     sigma_f=None if u.get("sigma_f") is None else t(u["sigma_f"])),
        status=t(arrays["status"]).to(torch.int32), t=t(arrays["t"]),
    )


def _map_batch(carry: ScenarioCarry, fn) -> ScenarioCarry:
    """``fn(tensor, batch_dim)`` on every tensor of the carry: the batch is
    dim 0 but for the SoA layout's packed covariance (n², B)."""
    u = carry.ukf
    soa = u.p.ndim == 2
    ukf = UkfState(x=fn(u.x, 0), p=fn(u.p, 1 if soa else 0), q=fn(u.q, 0), r=fn(u.r, 0),
                   sigma_f=None if u.sigma_f is None else fn(u.sigma_f, 0))
    return ScenarioCarry(x=fn(carry.x, 0), u_n=fn(carry.u_n, 0), ukf=ukf, status=fn(carry.status, 0),
                         t=fn(carry.t, 0))


def shard_carry(carry: ScenarioCarry, mesh: Mesh | None) -> ScenarioCarry:
    """This rank's scenarios of a whole fleet's carry: the B/S scenarios at
    its coordinate on the ``scenario`` axis (the whole carry without a
    mesh). Raises unless S divides B."""
    if mesh is None:
        return carry
    n_s, sc, b = mesh.size("scenario"), mesh.coord("scenario"), carry.x.shape[0]
    if b % n_s:
        raise ValueError(f"B={b} scenarios not divisible by the scenario axis' {n_s} ranks")
    lo, hi = sc * (b // n_s), (sc + 1) * (b // n_s)
    return _map_batch(carry, lambda a, d: a.narrow(d, lo, hi - lo).contiguous())


def gather_carry(carry: ScenarioCarry, mesh: Mesh | None) -> ScenarioCarry:
    """The whole fleet's carry on the host, gathered over the ``scenario``
    axis from every rank's sub-batch (``all_gather_host``: a collective,
    which every rank of the mesh calls at the same tick); without a mesh,
    the carry itself."""
    if mesh is None:
        return carry

    def gather(a, d):
        return all_gather_host(a.movedim(d, 0), mesh, "scenario").movedim(0, d).contiguous()

    return _map_batch(carry, gather)
