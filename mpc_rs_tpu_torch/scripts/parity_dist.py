"""Distributional parity of the port's sampled closed loops against the C++ oracle.

    python -m mpc_rs_tpu_torch.scripts.parity_dist --config flagship-est \\
        [--estimator torch|chain] [--episodes 200] [--oracle-from-record] \\
        [--device cuda] [--out PARITY_DIST_TORCH.json]

The protocol of the JAX package's ``scripts/parity_dist.py``: N free-running
episodes a side, each side drawing its own noise (the port: the fleet's
generator and the kernels' Philox samplers; the oracle, ``native/liboracle.so``
in float64: a numpy Generator seeded 2000+i, 3000+i, 4000+i or 5000+i), held
as distributions: survival rates with Wilson 95 % intervals, and two-sample
KS tests on each episode's θ-RMS and max|θ|. A config passes when the
survival intervals overlap and both KS p-values exceed 0.01
(``scripts/parity_dist.py:496-510``).

Configs (``scripts/parity_dist.py:16-43``), in the order they were ported
(the first four are sampled; ``qp-parking`` is deterministic):
- ``cartpole4-est``: the cartpole4 fleet (UKF(4,3) in the loop, 20 Hz
  control, 5 substeps at 100 Hz, K=1024), 200 ticks;
- ``flagship-est``: the flagship6 fleet (UKF(6,5) in the loop, 100 Hz, K=8192,
  the 2 N pulse), 1000 ticks;
- ``flagship-dbg``: the same with the controller on the true state;
- ``cartpole4``: the mppi4-non-liner loop, B batched single solves at
  K=16 384, N=8, λ=0.5, σ=3, ±20 in the exact tier (box-muller), the plant
  stepped at DT=0.1, 100 ticks;
- ``qp-parking`` (``scripts/parity_dist.py:388-453``): op-mpc-x-calc-nl's
  parking loop from 200 shared initial states (``default_rng(777)``), 60
  ticks of 0.1 s: the port's float64 ``box_qp_newton`` with the active-set
  table, all episodes batched on the device, against the oracle's exact
  3⁸ active-set enumeration and its own nonlinear plant, episode by
  episode; parked when |x| < 0.3 and |θ| < 0.1. It passes when every
  episode's parked flag agrees; the entry also holds both park rates and
  the largest final-state difference. Its oracle always runs fresh.

The port's side runs the fleet at its defaults, one scenario an episode,
B = episodes, exactly the config's ticks, θ read after each tick;
``--estimator chain`` runs the fleets' estimator as the fused chain (K7).
The oracle side runs fresh in a ``spawn`` process pool (the parent holds a
CUDA context, so it must not fork), or with ``--oracle-from-record`` takes
the 200 episodes ``PARITY_DIST_r05.json`` recorded (``raw.oracle``).
``--out`` gets one entry, read-modify-write, under the config's name (a
fleet config's with ``:torch`` or ``:chain``); ``PARITY_DIST_r05.json`` is
only read.
"""

from __future__ import annotations

import argparse
import json
import math
import multiprocessing
import os
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
RECORD = ROOT / "PARITY_DIST_r05.json"
OUT = ROOT / "PARITY_DIST_TORCH.json"

CONFIGS = ("cartpole4-est", "flagship-est", "flagship-dbg", "cartpole4")  # the sampled ones
QP_PARKING = "qp-parking"  # the deterministic one
N_TICKS = {"cartpole4": 100, "flagship-dbg": 1000, "flagship-est": 1000, "cartpole4-est": 200}
K = {"cartpole4": 16384, "flagship-dbg": 8192, "flagship-est": 8192, "cartpole4-est": 1024}
ORACLE_SEED = {"cartpole4": 2000, "flagship-dbg": 3000, "flagship-est": 4000, "cartpole4-est": 5000}
# the JAX library side's seeds (scripts/parity_dist.py:283, build_fleet's default 0)
LIBRARY_SEED = {"cartpole4": 12345, "flagship-dbg": 0, "flagship-est": 0, "cartpole4-est": 0}
GUARD_CART, GUARD_FLAG = math.radians(60.0), math.pi / 2


def _episode(thetas) -> dict:
    th = np.asarray(thetas, np.float64)
    return {"rms_theta": float(np.sqrt(np.mean(th * th))), "max_theta": float(np.max(np.abs(th)))}


# --------------------------------------------------------------------------
# the oracle's episodes (float64 C++ through ctypes, a numpy Generator)


def ep_cartpole4_oracle(seed: int, n_ticks: int, k: int) -> dict:
    """The mppi4-non-liner loop (``scripts/parity_dist.py:84-107``)."""
    from mpc_rs_tpu_torch.scripts import oracle as ora

    lib = ora.load_oracle()
    r = np.random.default_rng(seed)
    x, u_n, thetas, survived = np.array([0.5, 0.0, 0.1, 0.0]), np.zeros(8), [], True
    for _ in range(n_ticks):
        eps = 3.0 * r.standard_normal((k, 8))
        u, st = ora.ora_mppi(lib, 0, 0, x, u_n, eps, 0.5, 3.0, (-20.0, 20.0), 0.1)
        u_n = u if st == 0 else np.zeros(8)  # the reference's zero fallback
        x = ora.ora_dynamics(lib, 0, x, u_n[0], 0.1)
        thetas.append(x[2])
        if abs(x[2]) > GUARD_CART:
            survived = False
            break
    return {"survived": survived, **_episode(thetas)}


def ep_flagship_oracle(seed: int, feed_true: bool, n_ticks: int, k: int) -> dict:
    """The flagship loop at the fleet cadence (``scripts/parity_dist.py:110-152``)."""
    from mpc_rs_tpu_torch.scripts import oracle as ora

    lib = ora.load_oracle()
    r = np.random.default_rng(seed)
    dt = 0.01
    sens = np.array([200.0, 200.0, 10.0, 0.05, 0.05])
    ukf = ora.OraUkf(lib, np.zeros(6), 0.1 * np.eye(6), ora.ora_gen_q6(lib, 2.15 * dt), np.diag(sens),
                     fx_id=1, hx_id=1)
    x, u_n, thetas, survived = np.zeros(6), np.zeros(8), [], True
    for i in range(n_ticks):
        x4 = (x if feed_true else ukf.x)[[0, 1, 3, 4]]
        if not np.all(np.isfinite(x4)):
            x4 = np.zeros(4)
        eps = 4.0 * r.standard_normal((k, 8))
        u, st = ora.ora_mppi(lib, 2, 1, x4, u_n, eps, 1.4, 4.0, (-10.0, 10.0), 1.2 / 8)
        u_n = u if st == 0 else np.zeros(8)
        t_now = i * dt
        x = ora.ora_short6(lib, x, u_n[0], dt, 2.0 if 1.0 < t_now < 1.5 else 0.0)
        z = ora.ora_hx(lib, 1, x) + sens * r.standard_normal(5)
        ukf.predict(u_n[0], dt)
        ukf.update(z)
        if not (np.all(np.isfinite(ukf.x)) and np.all(np.isfinite(ukf.p))):  # the fleet's guard
            ukf.x = np.where(np.isfinite(ukf.x), ukf.x, 0.0)
            ukf.p = 0.1 * np.eye(6)
        thetas.append(x[3])
        if abs(x[3]) > GUARD_FLAG:
            survived = False
            break
    return {"survived": survived, **_episode(thetas)}


def ep_cartpole4_est_oracle(seed: int, n_ticks: int, k: int) -> dict:
    """The cartpole4 fleet's loop: 20 Hz MPPI on the UKF(4,3) estimate, 5
    plant/sensor/filter substeps at 100 Hz (``scripts/parity_dist.py:189-231``).
    Q is ``noise.gen_q4`` evaluated in float32 and widened to float64: the
    fleet's own float32 Q, and what the JAX script's recorded episodes took
    (its ``_q4_data`` subprocess runs JAX without x64, where
    ``jnp.float64(dt)`` is a float32 value), so seed 5000 reproduces the
    record's ``raw.oracle[0]`` bit for bit; float64 Q does not."""
    from mpc_rs_tpu_torch.models import noise
    from mpc_rs_tpu_torch.scripts import oracle as ora

    lib = ora.load_oracle()
    r = np.random.default_rng(seed)
    dt_tick, n_sub = 0.05, 5
    dt_sub = dt_tick / n_sub
    q = noise.gen_q4(dt_sub, dtype=torch.float32).double().numpy()
    sens = np.array([50.0, 50.0, 0.5])
    x = np.array([0.5, 0.0, 0.1, 0.0])
    ukf = ora.OraUkf(lib, x.copy(), 0.1 * np.eye(4), q, np.diag(sens * sens), fx_id=0, hx_id=0)
    u_n, thetas, survived = np.zeros(8), [], True
    for _ in range(n_ticks):
        x_ctrl = ukf.x.copy()
        if not np.all(np.isfinite(x_ctrl)):
            x_ctrl = np.zeros(4)
        eps = 10.0 * r.standard_normal((k, 8))
        u, st = ora.ora_mppi(lib, 0, 0, x_ctrl, u_n, eps, 0.5, 10.0, (-10.0, 10.0), 0.1)
        u_n = u if st == 0 else np.zeros(8)
        for _s in range(n_sub):
            x = ora.ora_dynamics(lib, 0, x, u_n[0], dt_sub)
            z = ora.ora_hx(lib, 0, x) + sens * r.standard_normal(3)
            ukf.predict(u_n[0], dt_sub)
            ukf.update(z)
            if not (np.all(np.isfinite(ukf.x)) and np.all(np.isfinite(ukf.p))):
                ukf.x = np.where(np.isfinite(ukf.x), ukf.x, 0.0)
                ukf.p = 0.1 * np.eye(4)
        thetas.append(x[2])
        if abs(x[2]) > GUARD_CART:
            survived = False
            break
    return {"survived": survived, **_episode(thetas)}


def oracle_episode(config: str, seed: int, n_ticks: int | None = None, k: int | None = None) -> dict:
    """One oracle episode of ``config`` at its (or the given) ticks and K."""
    n_ticks, k = n_ticks or N_TICKS[config], k or K[config]
    if config == "cartpole4":
        return ep_cartpole4_oracle(seed, n_ticks, k)
    if config == "cartpole4-est":
        return ep_cartpole4_est_oracle(seed, n_ticks, k)
    if config in ("flagship-est", "flagship-dbg"):
        return ep_flagship_oracle(seed, config == "flagship-dbg", n_ticks, k)
    raise ValueError(f"unknown config {config!r}; choose from {CONFIGS}")


def run_oracle_side(config: str, episodes: int, jobs: int, n_ticks: int | None = None,
                    k: int | None = None) -> list[dict]:
    """``episodes`` fresh oracle episodes at seeds ORACLE_SEED[config] + i, in
    a pool of ``jobs`` spawned processes."""
    import concurrent.futures as cf

    seeds = [ORACLE_SEED[config] + i for i in range(episodes)]
    ctx = multiprocessing.get_context("spawn")
    with cf.ProcessPoolExecutor(max_workers=jobs, mp_context=ctx) as pool:
        futs = [pool.submit(oracle_episode, config, s, n_ticks, k) for s in seeds]
        return [f.result() for f in futs]


def recorded_oracle(config: str, path: Path = RECORD) -> list[dict]:
    """The oracle episodes the JAX package recorded for ``config``."""
    with open(path) as fh:
        return json.load(fh)[config]["raw"]["oracle"]


# --------------------------------------------------------------------------
# the port's episodes


def run_library_fleet(config: str, episodes: int, device, estimator: str = "torch",
                      n_ticks: int | None = None, seed: int | None = None) -> list[dict]:
    """Free-running fleet episodes, one scenario an episode: exactly
    ``n_ticks`` ticks, θ after each; an episode ends at the tick its |θ|
    first passes the guard (``scripts/parity_dist.py:319-385``)."""
    from mpc_rs_tpu_torch.apps.fleet import build_fleet

    if estimator not in ("torch", "chain"):
        raise ValueError(f"estimator must be 'torch' or 'chain', got {estimator!r}")
    n_ticks = n_ticks or N_TICKS[config]
    model = "cartpole4" if config == "cartpole4-est" else "flagship6"
    fl = build_fleet(model, K[config], device, seed=LIBRARY_SEED[config] if seed is None else seed,
                     scenarios=episodes, feed_true_state=config == "flagship-dbg",
                     estimator_chain=estimator == "chain")
    carry = fl.carry
    th = torch.empty((n_ticks, episodes), dtype=carry.x.dtype, device=carry.x.device)
    for i in range(n_ticks):
        carry = fl.tick(carry, fl.generator)
        th[i] = carry.x[:, fl.theta_idx]
    th = th.cpu().numpy()
    out = []
    for e in range(episodes):
        t = th[:, e]
        tipped = np.abs(t) > fl.guard
        end = int(np.argmax(tipped)) + 1 if tipped.any() else len(t)
        out.append({"survived": not tipped.any(), **_episode(t[:end])})
    return out


def run_library_cartpole4(episodes: int, device, n_ticks: int | None = None, k: int | None = None,
                          seed: int | None = None) -> list[dict]:
    """The mppi4-non-liner loop, B = episodes batched single solves a tick
    (K5/K6 on the card) in the exact tier, each episode frozen once it tips
    (``scripts/parity_dist.py:234-297``)."""
    from mpc_rs_tpu_torch.apps.common import resolve_device
    from mpc_rs_tpu_torch.controllers.mppi import MppiConfig
    from mpc_rs_tpu_torch.models.params import CartPoleParams
    from mpc_rs_tpu_torch.ops.mppi_cuda import CartPoleShaped4, mppi_solve_batch_fused

    device = resolve_device(device)
    n_ticks, k = n_ticks or N_TICKS["cartpole4"], k or K["cartpole4"]
    model = CartPoleShaped4(CartPoleParams.single_wheel(), 0.1)
    cfg = MppiConfig(n_horizon=8, n_rollouts=k, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
    gen = torch.Generator(device=device).manual_seed(LIBRARY_SEED["cartpole4"] if seed is None else seed)
    f32 = dict(dtype=torch.float32, device=device)
    x = torch.tensor([0.5, 0.0, 0.1, 0.0], **f32).expand(episodes, 4).contiguous()
    u = torch.zeros((episodes, 8), **f32)
    alive = torch.ones(episodes, dtype=torch.bool, device=device)
    th = torch.empty((n_ticks, episodes), **f32)
    al = torch.empty((n_ticks, episodes), dtype=torch.bool, device=device)
    for i in range(n_ticks):
        seeds = torch.randint(0, 2**31 - 1, (episodes,), generator=gen, device=device, dtype=torch.int32)
        u_new, _ = mppi_solve_batch_fused(cfg, model, x, u, seeds=seeds, sampler="box-muller")
        u = torch.where(alive[:, None], u_new, 0.0)
        x_new = torch.stack(model.step(*x.unbind(-1), u[:, 0]), dim=-1)
        x = torch.where(alive[:, None], x_new, x)  # a tipped episode is frozen
        alive = alive & (x[:, 2].abs() <= GUARD_CART)
        th[i], al[i] = x[:, 2], alive
    th, al = th.cpu().numpy(), al.cpu().numpy()
    out = []
    for e in range(episodes):
        n_alive = int(al[:, e].sum())
        valid = th[: n_alive + 1, e] if n_alive < n_ticks else th[:, e]
        out.append({"survived": bool(al[-1, e]), **_episode(valid)})
    return out


def run_library(config: str, episodes: int, device, estimator: str = "torch") -> list[dict]:
    if config == "cartpole4":
        if estimator != "torch":
            raise ValueError("cartpole4 runs no estimator")
        return run_library_cartpole4(episodes, device)
    return run_library_fleet(config, episodes, device, estimator)


# --------------------------------------------------------------------------
# qp-parking: deterministic, shared initial states, compared episode by episode

QP_IC_SEED, QP_TICKS, QP_DT, QP_LIMIT = 777, 60, 0.1, 30.0


def qp_parking_ics(episodes: int) -> np.ndarray:
    """(episodes, 4) initial states (``scripts/parity_dist.py:418-420``)."""
    r = np.random.default_rng(QP_IC_SEED)
    return np.array([0.5, 0.0, 0.1, 0.0]) + r.uniform(-0.15, 0.15, size=(episodes, 4))


def run_qp_parking_library(ics: np.ndarray, device) -> np.ndarray:
    """The port's side: every episode batched, 60 ticks of the float64
    Newton solve with the active-set table from u = 0 (16 iterations, the
    safeguard on) and the nonlinear plant on the device. Returns the states
    (QP_TICKS + 1, episodes, 4), a tipped episode stepped on (the caller
    stops reading it where the JAX loop breaks)."""
    from mpc_rs_tpu_torch.apps.common import resolve_device
    from mpc_rs_tpu_torch.controllers.qp import (active_set_inverse_table, box_qp_newton, build_condensed_qp,
                                                 qp_linear_term)
    from mpc_rs_tpu_torch.models import dynamics, reference
    from mpc_rs_tpu_torch.models.params import CartPoleParams

    device = resolve_device(device)
    sw = CartPoleParams.single_wheel()
    a, bm = dynamics.linear_ab(sw, QP_DT)
    qp = build_condensed_qp(a, bm, np.diag([5.0, 5.0, 1.0, 1.0]), 8, dtype=torch.float64, device=device)
    gen_ref = reference.make_gen_ref_raised_cosine(8)
    tbl = active_set_inverse_table(qp.h)
    plant = dynamics.as_vector_fn(dynamics.make_cartpole_nonlinear(sw, QP_DT), 4)
    x = torch.tensor(ics, dtype=torch.float64, device=device)
    u0 = torch.zeros((x.shape[0], 8), dtype=torch.float64, device=device)
    xs = [x]
    for _ in range(QP_TICKS):
        b = qp_linear_term(qp, x, gen_ref(x).flatten(-2))
        u = box_qp_newton(qp.h, b, u0, -QP_LIMIT, QP_LIMIT, inv_table=tbl)
        x = plant(x, u[:, 0])
        xs.append(x)
    return torch.stack(xs).cpu().numpy()


def qp_parking_oracle(ic) -> np.ndarray:
    """One oracle episode: the exact box-QP solve and the oracle's plant,
    60 ticks or until |θ| > π/2; its states (≤ QP_TICKS + 1, 4)."""
    from mpc_rs_tpu_torch.scripts import oracle as ora

    lib = ora.load_oracle()
    xo = np.array(ic, np.float64)
    xs = [xo]
    for _ in range(QP_TICKS):
        uo = ora.ora_qp_solve_box(lib, xo, -QP_LIMIT, QP_LIMIT)
        xo = ora.ora_dynamics(lib, 0, xo, uo[0], QP_DT)
        xs.append(xo)
        if abs(xo[2]) > math.pi / 2:
            break
    return np.array(xs)


def run_qp_parking(episodes: int, device, jobs: int = 1) -> dict:
    """Both sides of ``qp-parking`` and the JAX script's statistics
    (``scripts/parity_dist.py:430-453``): tick by tick the library steps,
    then the oracle; an episode stops at the first tick either side's |θ|
    passes π/2 (the library's checked first), and is parked on a side when
    that side did not tip and ends with |x| < 0.3 and |θ| < 0.1."""
    import concurrent.futures as cf

    ics = qp_parking_ics(episodes)
    lib_xs = run_qp_parking_library(ics, device)
    if jobs > 1:
        with cf.ProcessPoolExecutor(max_workers=jobs, mp_context=multiprocessing.get_context("spawn")) as pool:
            ora_xs = list(pool.map(qp_parking_oracle, ics))
    else:
        ora_xs = [qp_parking_oracle(ic) for ic in ics]
    lib_park = ora_park = agree = 0
    max_final_dx = 0.0
    for e in range(episodes):
        ok_l = ok_o = True
        for t in range(1, QP_TICKS + 1):
            xl, xo = lib_xs[t, e], ora_xs[e][t]
            if abs(xl[2]) > math.pi / 2:
                ok_l = False
                break
            if abs(xo[2]) > math.pi / 2:
                ok_o = False
                break
        parked_l = bool(ok_l and abs(xl[0]) < 0.3 and abs(xl[2]) < 0.1)
        parked_o = bool(ok_o and abs(xo[0]) < 0.3 and abs(xo[2]) < 0.1)
        lib_park += parked_l
        ora_park += parked_o
        agree += parked_l == parked_o
        max_final_dx = max(max_final_dx, float(np.max(np.abs(xl - xo))))
    return {"episodes": episodes, "library_park_rate": lib_park / episodes, "oracle_park_rate": ora_park / episodes,
            "flag_agreement": agree / episodes, "max_final_state_diff": max_final_dx,
            "pass": agree == episodes}


# --------------------------------------------------------------------------
# statistics (scripts/parity_dist.py:460-510)


def wilson(k: int, n: int, z: float = 1.96):
    if n == 0:
        return (0.0, 1.0)
    p = k / n
    d = 1 + z * z / n
    c = p + z * z / (2 * n)
    h = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n))
    return ((c - h) / d, (c + h) / d)


def summarize(lib_eps: list[dict], ora_eps: list[dict]) -> dict:
    """Each side's survival (Wilson 95 %), θ-RMS mean and spread, max|θ|
    mean and p99; KS on θ-RMS and max|θ|; ``pass`` by the reference's rule."""
    from scipy import stats

    out = {"episodes_per_side": len(lib_eps)} if len(lib_eps) == len(ora_eps) else {
        "episodes_library": len(lib_eps), "episodes_oracle": len(ora_eps)}
    for side, eps in (("library", lib_eps), ("oracle", ora_eps)):
        surv = sum(e["survived"] for e in eps)
        rms = np.array([e["rms_theta"] for e in eps])
        mx = np.array([e["max_theta"] for e in eps])
        out[side] = {
            "survival": surv / len(eps),
            "survival_wilson95": wilson(surv, len(eps)),
            "rms_theta_mean": float(rms.mean()),
            "rms_theta_std": float(rms.std()),
            "max_theta_mean": float(mx.mean()),
            "max_theta_p99": float(np.quantile(mx, 0.99)),
        }
    lo_l, hi_l = out["library"]["survival_wilson95"]
    lo_o, hi_o = out["oracle"]["survival_wilson95"]
    ks_rms = stats.ks_2samp([e["rms_theta"] for e in lib_eps], [e["rms_theta"] for e in ora_eps])
    ks_max = stats.ks_2samp([e["max_theta"] for e in lib_eps], [e["max_theta"] for e in ora_eps])
    out["tests"] = {
        "survival_ci_overlap": bool(max(lo_l, lo_o) <= min(hi_l, hi_o)),
        "ks_rms_theta": {"stat": float(ks_rms.statistic), "p": float(ks_rms.pvalue)},
        "ks_max_theta": {"stat": float(ks_max.statistic), "p": float(ks_max.pvalue)},
    }
    out["pass"] = bool(out["tests"]["survival_ci_overlap"] and ks_rms.pvalue > 0.01 and ks_max.pvalue > 0.01)
    return out


def entry_name(config: str, estimator: str) -> str:
    return config if config == "cartpole4" else f"{config}:{estimator}"


def _card(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"device": "cpu"}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    return {"device": torch.cuda.get_device_name(device), "nvidia_smi": smi[device.index or 0] if smi else None}


def main(argv=None) -> dict:
    from mpc_rs_tpu_torch.apps.common import resolve_device

    ap = argparse.ArgumentParser(prog="mpc_rs_tpu_torch.scripts.parity_dist", description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True, choices=CONFIGS + (QP_PARKING,))
    ap.add_argument("--estimator", choices=["torch", "chain"], default="torch",
                    help="the fleets' estimator: torch ops (default) or the fused chain (K7)")
    ap.add_argument("--episodes", type=int, default=200, help="the port's episodes (and fresh oracle ones)")
    ap.add_argument("--oracle-from-record", action="store_true",
                    help=f"take the oracle's recorded episodes from {RECORD.name} instead of running it")
    ap.add_argument("--jobs", type=int, default=min(8, os.cpu_count() or 1), help="oracle processes")
    ap.add_argument("--device", default="cuda", help="torch device of the port's side (cpu: the plain path)")
    ap.add_argument("--out", default=str(OUT), help="JSON file of results, one entry a config")
    args = ap.parse_args(argv)
    if Path(args.out).resolve() == RECORD.resolve():
        raise SystemExit(f"{RECORD.name} is the JAX package's record; write elsewhere")
    device = resolve_device(args.device)

    if args.config == QP_PARKING:
        if args.oracle_from_record:
            raise SystemExit(f"qp-parking has no recorded oracle episodes in {RECORD.name}; run it fresh")
        t0 = time.perf_counter()
        entry = run_qp_parking(args.episodes, device, args.jobs)
        entry.update({"ic_seed": QP_IC_SEED, "ticks": QP_TICKS, "oracle_source": "fresh",
                      "seconds": time.perf_counter() - t0, **_card(device)})
        write_entry(args.out, QP_PARKING, entry)
        print(json.dumps(entry, indent=1))
        return entry

    t0 = time.perf_counter()
    lib = run_library(args.config, args.episodes, device, args.estimator)
    lib_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    if args.oracle_from_record:
        ora, source = recorded_oracle(args.config), f"{RECORD.name} raw.oracle"
    else:
        ora, source = run_oracle_side(args.config, args.episodes, args.jobs), "fresh"
    entry = summarize(lib, ora)
    entry.update({"oracle_source": source, "oracle_seeds": f"{ORACLE_SEED[args.config]}+i",
                  "library_seed": LIBRARY_SEED[args.config], "ticks": N_TICKS[args.config], "k": K[args.config],
                  "estimator": None if args.config == "cartpole4" else args.estimator,
                  "library_seconds": lib_s, "oracle_seconds": time.perf_counter() - t1, **_card(device),
                  "raw": {"library": lib, **({} if args.oracle_from_record else {"oracle": ora})}})
    write_entry(args.out, entry_name(args.config, args.estimator), entry)
    print(json.dumps({k: v for k, v in entry.items() if k != "raw"}, indent=1))
    return entry


def write_entry(out: str, name: str, entry: dict) -> None:
    """Read-modify-write one entry of the JSON file ``out``."""
    data = json.loads(Path(out).read_text()) if Path(out).is_file() else {}
    data[name] = entry
    tmp = f"{out}.{os.getpid()}.tmp"
    Path(tmp).write_text(json.dumps(data, indent=1) + "\n")
    os.replace(tmp, out)


if __name__ == "__main__":
    main()
