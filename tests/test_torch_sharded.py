"""The port's multi-GPU layer on the CPU: gloo ranks, one process each.

A module fixture spawns a world of 2 and a world of 4 gloo ranks (CPU
tensors, a ``file://`` store in the test's own directory, a timeout on every
collective and on every process), which run the K-sharded solve
(``parallel/sharded_mppi.py``), the sharded fleet tick
(``parallel/scenario.py`` with ``mesh=``), a checkpoint of a 2×1 fleet and
the scaling harness, and write what they got. The tests hold that against:

- (a) the JAX package's ``make_sharded_mppi(..., backend="jnp",
  external_noise=True)`` on the conftest's virtual CPU devices, on the same
  numpy (K, N) noise: the f32 band (rtol 1e-3 / atol 2e-4) and 1e-9 in f64;
  at N = 8 on the cart-pole, at the HW flagship's N = 20 and mppi2's
  N = 40 (their JAX models as ``tests/test_torch_mppi_family.py`` builds
  them), and on the cart-pole at one of serve's plan-streaming horizons,
  N = 16 (0.05 s steps);
- (b) the port's one-rank solve on the same noise, in the same bands;
- (c) the JAX package's statuses where a shard has no finite rollout, where
  none has (NO_FINITE), and at λ = 0 (INVALID_U);
- (d) the unsharded port tick and the JAX tick (``tests/test_torch_fleet.py``)
  over three ticks of B = 8 on matched noise, at meshes 2×1, 1×2 and 2×2;
  the ranks of a rollouts line hold the same bits;
- (e) the one-rank fleet's checkpoint file, which the 2×1 file equals, and a
  resume at W = 1;
- (f) the mesh's and ``init_distributed``'s errors, in this process.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_rs_tpu.controllers import mppi as jmppi
from mpc_rs_tpu.models import costs as jcosts
from mpc_rs_tpu.models import dynamics as jdyn
from mpc_rs_tpu.models.params import CartPoleParams as JParams
from mpc_rs_tpu.parallel.mesh import make_mesh as jmake_mesh
from mpc_rs_tpu.parallel.sharded_mppi import make_sharded_mppi as jmake_sharded
from mpc_rs_tpu_torch.apps.fleet import build_fleet, build_qp_fleet, resume_fleet, run_fleet, run_qp_fleet
from mpc_rs_tpu_torch.controllers.mppi import MppiConfig, MppiStatus
from mpc_rs_tpu_torch.models.params import CartPoleParams
from mpc_rs_tpu_torch.ops.mppi_cuda import CartPoleShaped4, Commu4Cost4, Flagship4Diag4, mppi_solve_fused
from mpc_rs_tpu_torch.parallel import distributed
from mpc_rs_tpu_torch.parallel.mesh import Mesh, make_mesh
from mpc_rs_tpu_torch.parallel.scenario import carry_from_numpy
from mpc_rs_tpu_torch.parallel.sharded_mppi import make_sharded_mppi, rank_seed
from mpc_rs_tpu_torch.runtime.checkpoint import carry_fields
from tests.test_torch_fleet import _jax_tick, _tick_case
from tests.test_torch_mppi_family import FAMILY

ROOT = Path(__file__).resolve().parents[1]
K, N, B, K_FLEET, TICKS = 2048, 8, 8, 256, 3
X0 = (0.5, 0.0, 0.1, 0.0)
BIG = {np.float32: 1e30, np.float64: 1e200}  # noise that overflows a rollout: no finite score
BANDS = {np.float32: dict(rtol=1e-3, atol=2e-4), np.float64: dict(rtol=1e-9, atol=1e-9)}
TD = {np.float32: torch.float32, np.float64: torch.float64}
MESHES = {2: [(2, 1), (1, 2)], 4: [(2, 2)]}
MODELS = ("cartpole4", "flagship6")
# the K-sharded solve's models: the cart-pole at N = 8, the family's pairs
# past N = 8, as tests/test_torch_mppi_family.py runs them, and the cart-pole
# at serve's N = 16 (the JAX serve's horizon at a 0.05 s tick)
SOLVE_MODELS = ("cartpole", "hw_flagship", "mppi2", "serve16")
SERVE16_DT = 0.05
PROC_TIMEOUT_S = 150

_WORKER = textwrap.dedent(
    """
    import sys
    import torch

    torch.set_num_threads(1)
    rank, world, root, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    sys.path.insert(0, root)
    from mpc_rs_tpu_torch.apps.fleet import build_fleet, build_qp_fleet, run_fleet, run_qp_fleet
    from mpc_rs_tpu_torch.controllers.mppi import MppiConfig
    from mpc_rs_tpu_torch.models.params import CartPoleParams
    from mpc_rs_tpu_torch.ops.mppi_cuda import CartPoleShaped4, Commu4Cost4, DoubleIntegratorQuad2
    from mpc_rs_tpu_torch.parallel.distributed import init_distributed
    from mpc_rs_tpu_torch.parallel.mesh import make_mesh
    from mpc_rs_tpu_torch.parallel.scaling import measure_scaling
    from mpc_rs_tpu_torch.parallel.scenario import carry_from_numpy, shard_carry
    from mpc_rs_tpu_torch.parallel.sharded_mppi import make_sharded_mppi
    from mpc_rs_tpu_torch.runtime.checkpoint import carry_fields

    init_distributed(f"file://{out}/store", world, rank, device="cpu", timeout_s=60)
    data = torch.load(f"{out}/../inputs.pt", weights_only=False)
    model = CartPoleShaped4(CartPoleParams.single_wheel(), 0.1)
    solve_models = {"cartpole": model, "hw_flagship": Commu4Cost4(CartPoleParams.two_wheel(), 0.05),
                    "mppi2": DoubleIntegratorQuad2(2.0 / 40),
                    "serve16": CartPoleShaped4(CartPoleParams.single_wheel(), data["serve16_dt"])}
    res = {}
    mesh = make_mesh({"rollouts": world})
    for m_name, m in solve_models.items():
        for name in ("float32", "float64"):
            limit = data[f"limit_{name}"]
            kw = dict(data["cfg"][m_name], n_rollouts=data["k"], limit=limit)
            x, u, noise = (data[f"{v}_{m_name}_{name}"] for v in ("x", "u", "noise"))
            solve = make_sharded_mppi(MppiConfig(**kw), m, mesh, external_noise=True)
            res[f"ext_{m_name}_{name}"] = solve(noise, x, u)
            res[f"big_shard_{m_name}_{name}"] = solve(data[f"big_{m_name}_{name}"], x, u)
            res[f"no_finite_{m_name}_{name}"] = solve(noise, torch.full_like(x, float("nan")), u)
            lam0 = make_sharded_mppi(MppiConfig(**dict(kw, lambda_=0.0)), m, mesh, external_noise=True)
            res[f"lambda0_{m_name}_{name}"] = lam0(noise, x, u)
    cfg = MppiConfig(n_horizon=8, n_rollouts=data["k"], lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
    res["sampled"] = make_sharded_mppi(cfg, model, mesh)(7, data["x_cartpole_float32"], data["u_cartpole_float32"])

    for s, r in data["meshes"][world]:
        fleet_mesh = make_mesh({"scenario": s, "rollouts": r})
        for model_name in data["models"]:
            for name in ("float32", "float64"):
                case = data["fleet"][(model_name, name)]
                fl = build_fleet(model_name, data["k_fleet"], "cpu", scenarios=data["b"], mesh=fleet_mesh)
                ticks = []
                for t in range(len(case["mppi"])):
                    carry = shard_carry(carry_from_numpy(case["starts"][t]), fleet_mesh)
                    carry = fl.tick(carry, fl.generator, mppi_noise=case["mppi"][t],
                                    sensor_noise=case["sensor"][t])
                    ticks.append(carry_fields(carry))
                res[("fleet", s, r, model_name, name)] = ticks
    qp = build_qp_fleet(data["b"], "cpu", seed=4, mesh=make_mesh({"scenario": world}))
    res["qp"] = run_qp_fleet(qp, t_end=0.3, report_every=0.3)
    if world == 2:
        ck_mesh = make_mesh({"scenario": 2, "rollouts": 1})
        fl = build_fleet("cartpole4", data["k_fleet"], "cpu", scenarios=data["b"], mesh=ck_mesh, seed=3)
        run_fleet(fl, t_end=0.1, report_every=0.05, checkpoint=f"{out}/fleet_2x1.pt")
        res["scaling"] = measure_scaling(cfg, model, [1, 2], iters=2, device="cpu")
    torch.save(res, f"{out}/rank{rank}.pt")
    print(f"RANK_OK {rank}", flush=True)
    """
)


def _cfg(dtype=np.float32, lam=0.5):
    return MppiConfig(n_horizon=N, n_rollouts=K, lambda_=lam, std_dev=3.0, limit=_limit(dtype))


def _limit(dtype):
    return (-1e300, 1e300) if dtype == np.float64 else (-1e35, 1e35)


def _solve_kw(model):
    """A solve model's MppiConfig arguments but K and the limit: the
    cart-pole's (N = 8, λ = 0.5, σ = 3; serve's at N = 16), the family's at
    their apps' own."""
    if model in ("cartpole", "serve16"):
        return dict(n_horizon=N if model == "cartpole" else 16, lambda_=0.5, std_dev=3.0)
    return {a: v for a, v in FAMILY[model][4].items() if a != "limit"}


def _solve_inputs(dtype, model="cartpole"):
    """The solves' numpy inputs: x, u_n, the (K, N) noise, and the noise
    whose first shard's rows overflow every rollout of that shard."""
    n = _solve_kw(model)["n_horizon"]
    x0 = X0 if model in ("cartpole", "serve16") else FAMILY[model][5]
    rng = np.random.default_rng(21)
    noise = (_solve_kw(model)["std_dev"] * rng.standard_normal((K, n))).astype(dtype)
    big = noise.copy()
    big[: K // 2] = BIG[dtype] * np.sign(big[: K // 2])  # rank 0 of 2, ranks 0 and 1 of 4
    return np.asarray(x0, dtype), (0.3 * rng.standard_normal(n)).astype(dtype), noise, big


def _arrays(fields: dict) -> dict:
    """A carry's tensors (``carry_fields``) as ``carry_from_numpy`` takes them."""
    ukf = {k[4:]: v.numpy() for k, v in fields.items() if k.startswith("ukf.")}
    return dict(ukf=ukf, **{k: v.numpy() for k, v in fields.items() if not k.startswith("ukf.")})


@functools.cache
def _fleet_case(model, dtype):
    """A fleet model's TICKS ticks at B = 8 on matched noise: the noise, the
    carry each tick starts from (the unsharded port's trajectory from a
    perturbed carry) and what the unsharded port's tick makes of each. Each
    tick starts from the same carry in every implementation: over ticks the
    flagship's float32 loop parts from the JAX one past the band by itself
    (its f32 solve is ill-conditioned at λ = 1.4), with no mesh involved."""
    j, arrays, _, _ = _tick_case(model, dtype, B, K_FLEET)
    rng = np.random.default_rng(5)
    sigma = float(j["cfg"].std_dev)
    mppi = (sigma * rng.standard_normal((TICKS, B, K_FLEET, N))).astype(dtype)
    sensor = rng.standard_normal((TICKS, j["n_sub"], B, len(j["sens"]))).astype(dtype)
    fl = build_fleet(model, K_FLEET, "cpu", scenarios=B)
    starts, port = [arrays], []
    for t in range(TICKS):
        carry = fl.tick(carry_from_numpy(starts[t]), fl.generator, mppi_noise=torch.tensor(mppi[t]),
                        sensor_noise=torch.tensor(sensor[t]))
        port.append(carry_fields(carry))
        starts.append(_arrays(port[-1]))
    return dict(j=j, mppi=mppi, sensor=sensor, starts=starts[:TICKS], port=port)


@functools.cache
def _jax_ticks(model, dtype):
    """The JAX tick from each of ``_fleet_case``'s start carries."""
    c = _fleet_case(model, dtype)
    return [_jax_tick(c["j"], c["starts"][t], c["mppi"][t], c["sensor"][t], K_FLEET) for t in range(TICKS)]


def _spawn(world: int, root: Path) -> tuple[list, list]:
    out = root / f"w{world}"
    out.mkdir()
    worker = out / "worker.py"
    worker.write_text(_WORKER)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(name, None)
    return [subprocess.Popen([sys.executable, str(worker), str(r), str(world), str(ROOT), str(out)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
            for r in range(world)], out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The worlds of 2 and 4 gloo ranks, run at once: {world: [rank results]}
    and the directory of the 2-rank world."""
    root = tmp_path_factory.mktemp("sharded")
    fleet = {}
    for model in MODELS:
        for dtype in (np.float32, np.float64):
            case = _fleet_case(model, dtype)
            fleet[(model, np.dtype(dtype).name)] = dict(
                starts=case["starts"], mppi=[torch.tensor(m) for m in case["mppi"]],
                sensor=[torch.tensor(s) for s in case["sensor"]])
    data = dict(k=K, k_fleet=K_FLEET, b=B, meshes=MESHES, models=MODELS, fleet=fleet,
                cfg={m: _solve_kw(m) for m in SOLVE_MODELS}, serve16_dt=SERVE16_DT)
    for dtype in (np.float32, np.float64):
        name = np.dtype(dtype).name
        data[f"limit_{name}"] = _limit(dtype)
        for m in SOLVE_MODELS:
            x, u, noise, big = _solve_inputs(dtype, m)
            data.update({f"x_{m}_{name}": torch.tensor(x), f"u_{m}_{name}": torch.tensor(u),
                         f"noise_{m}_{name}": torch.tensor(noise), f"big_{m}_{name}": torch.tensor(big)})
    torch.save(data, root / "inputs.pt")
    runs = {w: _spawn(w, root) for w in MESHES}
    deadline = time.monotonic() + PROC_TIMEOUT_S
    logs = {}
    try:
        for model in MODELS:  # the JAX references while the ranks run
            for dtype in (np.float32, np.float64):
                _jax_ticks(model, dtype)
        for w, (procs, _) in runs.items():
            for r, p in enumerate(procs):
                out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                logs[(w, r)] = (p.returncode, out)
    finally:
        for procs, _ in runs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for (w, r), (rc, out) in logs.items():
        assert rc == 0 and f"RANK_OK {r}" in out, f"world {w} rank {r} failed ({rc}):\n{out[-3000:]}"
    return {w: [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(w)]
            for w, (_, out) in runs.items()}, runs[2][1]


# --------------------------------------------------------------------------
# (a)-(c): the K-sharded solve


@functools.cache
def _jax_solver(world, dtype, lam, model):
    """The JAX package's sharded jnp solve, one a (world, dtype, λ, model),
    so each is compiled once."""
    kw = dict(_solve_kw(model), n_rollouts=K, limit=_limit(dtype))
    jcfg = jmppi.MppiConfig(**dict(kw, lambda_=kw["lambda_"] if lam is None else lam))
    mesh = jmake_mesh({"rollouts": world}, devices=jax.devices()[:world])
    if model in ("cartpole", "serve16"):
        dt = 0.1 if model == "cartpole" else SERVE16_DT
        step, cost, n_state = jdyn.make_cartpole_nonlinear(JParams.single_wheel(), dt), jcosts.shaped4, 4
    else:
        _, step, cost, n_state, _, _ = FAMILY[model]
    return jmake_sharded(jcfg, step, cost, n_state, mesh, backend="jnp", external_noise=True)


def _jax_solve(world, dtype, noise, x, u, lam=None, model="cartpole"):
    u_out, st = _jax_solver(world, dtype, lam, model)(jnp.asarray(noise), jnp.asarray(x), jnp.asarray(u))
    return np.asarray(u_out), int(st)


MODEL = CartPoleShaped4(CartPoleParams.single_wheel(), 0.1)
PORT_MODELS = {"cartpole": MODEL, "serve16": CartPoleShaped4(CartPoleParams.single_wheel(), SERVE16_DT),
               **{m: FAMILY[m][0] for m in ("hw_flagship", "mppi2")}}


@pytest.mark.parametrize("model", SOLVE_MODELS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_solve_matches_jax_and_the_one_rank_solve(ranks, world, dtype, model):
    """(a) and (b): every rank's solve, against the JAX package's sharded
    jnp solve at the same world and against the port's one-rank solve: the
    cart-pole at N = 8 and 16, the HW flagship at N = 20 and mppi2 at
    N = 40."""
    key = f"ext_{model}_{np.dtype(dtype).name}"
    x, u, noise, _ = _solve_inputs(dtype, model)
    want, want_st = _jax_solve(world, dtype, noise, x, u, model=model)
    cfg = MppiConfig(**_solve_kw(model), n_rollouts=K, limit=_limit(dtype))
    one_u, one_st = mppi_solve_fused(cfg, PORT_MODELS[model], torch.tensor(x), torch.tensor(u),
                                     noise=torch.tensor(noise))
    for res in ranks[0][world]:
        got, st = res[key]
        assert got.dtype == TD[dtype] and got.shape == (cfg.n_horizon,)
        assert int(st) == want_st == int(one_st) == MppiStatus.OK
        np.testing.assert_allclose(got.numpy(), want, **BANDS[dtype])
        np.testing.assert_allclose(got.numpy(), one_u.numpy(), **BANDS[dtype])
    assert all(torch.equal(r[key][0], ranks[0][world][0][key][0]) for r in ranks[0][world])


@pytest.mark.parametrize("model", SOLVE_MODELS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_solve_failure_statuses_match_jax(ranks, world, dtype, model):
    """(c): a shard whose rollouts all overflow (its partials NEG_BIG and
    zeros) leaves the others' solve, as in the JAX package; no finite
    rollout on any shard is NO_FINITE and λ = 0 is INVALID_U, both with
    zeros, as the JAX package's statuses; at each solve model's horizon."""
    name = f"{model}_{np.dtype(dtype).name}"
    x, u, noise, big = _solve_inputs(dtype, model)
    want, want_st = _jax_solve(world, dtype, big, x, u, model=model)
    nan_x = np.full_like(x, np.nan)
    _, want_nf = _jax_solve(world, dtype, noise, nan_x, u, model=model)
    _, want_l0 = _jax_solve(world, dtype, noise, x, u, lam=0.0, model=model)
    assert (want_st, want_nf, want_l0) == (MppiStatus.OK, MppiStatus.NO_FINITE, MppiStatus.INVALID_U)
    for res in ranks[0][world]:
        got, st = res[f"big_shard_{name}"]
        assert int(st) == want_st
        np.testing.assert_allclose(got.numpy(), want, **BANDS[dtype])
        for key, want_status in (("no_finite", want_nf), ("lambda0", want_l0)):
            got, st = res[f"{key}_{name}"]
            assert int(st) == want_status and bool((got == 0).all()), key


def test_sharded_solve_samples_an_independent_stream_a_rank(ranks):
    """In-kernel sampling: rank r keys its stream with seed + r·7919, every
    rank ends with the same solve, its status 0 and its u0 of the one-rank
    solve's sign."""
    cfg = MppiConfig(n_horizon=N, n_rollouts=K, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
    x, u, _, _ = _solve_inputs(np.float32)
    one, _ = mppi_solve_fused(cfg, MODEL, torch.tensor(x), torch.tensor(u), seed=7)
    for world in (2, 4):
        first = ranks[0][world][0]["sampled"]
        for res in ranks[0][world]:
            got, st = res["sampled"]
            assert int(st) == 0 and torch.equal(got, first[0])
            assert np.sign(float(got[0])) == np.sign(float(one[0]))
    assert rank_seed(2**31 - 1, 1) == 2**31 - 1 + 7919 - 2**32
    assert rank_seed(torch.tensor([5], dtype=torch.int32), 3).tolist() == [5 + 3 * 7919]


def test_one_rank_mesh_runs_no_collective():
    """A process with no group is a 1×1 mesh: the sharded solve is the
    one-rank solve, bit for bit."""
    mesh = make_mesh()
    assert mesh.shape == {"rollouts": 1} and mesh.group("rollouts") is None
    x, u, noise, _ = _solve_inputs(np.float32)
    cfg = _cfg()
    got = make_sharded_mppi(cfg, MODEL, mesh, external_noise=True)(torch.tensor(noise), torch.tensor(x),
                                                                    torch.tensor(u))
    want = mppi_solve_fused(cfg, MODEL, torch.tensor(x), torch.tensor(u), noise=torch.tensor(noise))
    assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])


# --------------------------------------------------------------------------
# (d): the sharded fleet tick


def _assemble(ranks_of_world, s, r, model, name):
    """The whole fleet's ticks from the ranks of rollouts coordinate 0, in
    scenario order; and whether each rollouts line's ranks hold the same
    bits at every tick."""
    key = ("fleet", s, r, model, name)
    per_rank = [res[key] for res in ranks_of_world]
    equal = all(all(torch.equal(per_rank[sc * r + rr][t][f], per_rank[sc * r][t][f])
                    for t in range(TICKS) for f in per_rank[0][t])
                for sc in range(s) for rr in range(r))
    whole = []
    for t in range(TICKS):
        parts = [per_rank[sc * r][t] for sc in range(s)]
        whole.append({f: torch.cat([p[f] for p in parts], dim=1 if f == "ukf.p" and p0.ndim == 2 else 0)
                      for f, p0 in parts[0].items()})
    return whole, equal


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)], ids=["2x1", "1x2", "2x2"])
def test_sharded_fleet_tick_matches_unsharded_and_jax(ranks, shape, model, dtype):
    """(d): three ticks of the fleet on a (scenario × rollouts) mesh, each
    from the unsharded trajectory's carry, against the unsharded tick (bit
    for bit when only scenarios are split, in the band otherwise) and the
    JAX tick on matched noise; the ranks of a rollouts line hold the same
    bits."""
    s, r = shape
    name = np.dtype(dtype).name
    whole, replicas_equal = _assemble(ranks[0][s * r], s, r, model, name)
    assert replicas_equal
    case = _fleet_case(model, dtype)
    band = BANDS[dtype]
    for t in range(TICKS):
        got, one, want = whole[t], case["port"][t], _jax_ticks(model, dtype)[t]
        if r == 1:
            assert all(torch.equal(got[f], one[f]) for f in one), f"tick {t}"
        assert got["status"].tolist() == one["status"].tolist() == want["status"].tolist() == [0] * B
        for f in one:
            np.testing.assert_allclose(got[f].numpy(), one[f].numpy(), **band, err_msg=f"tick {t} {f}")
        for f, wf in (("u_n", "u_n"), ("x", "x"), ("ukf.x", "ukf_x"), ("ukf.p", "ukf_p")):
            np.testing.assert_allclose(got[f].numpy(), want[wf], **band, err_msg=f"tick {t} {f} vs JAX")


# --------------------------------------------------------------------------
# (e): the checkpoint of a sharded fleet


def test_sharded_checkpoint_is_the_one_rank_file_and_resumes(ranks, tmp_path):
    """(e): the 2×1 fleet's checkpoint after 2 ticks holds the carry and the
    generator state of the one-rank fleet's, and resuming it at W = 1
    continues as the uninterrupted one-rank fleet, bit for bit."""
    one = build_fleet("cartpole4", K_FLEET, "cpu", scenarios=B, seed=3)
    run_fleet(one, t_end=0.1, report_every=0.05, checkpoint=str(tmp_path / "one.pt"))
    got = torch.load(ranks[1] / "fleet_2x1.pt", weights_only=False)
    want = torch.load(tmp_path / "one.pt", weights_only=False)
    assert set(got["carry"]) == set(want["carry"])
    assert all(torch.equal(got["carry"][f], want["carry"][f]) for f in want["carry"])
    assert torch.equal(got["generator"], want["generator"]) and got["generator_device"] == "cpu"
    resumed = resume_fleet(build_fleet("cartpole4", K_FLEET, "cpu", scenarios=B, seed=3),
                           str(ranks[1] / "fleet_2x1.pt"), 3)
    rest = run_fleet(resumed, t_end=0.1, report_every=0.05)
    straight = run_fleet(build_fleet("cartpole4", K_FLEET, "cpu", scenarios=B, seed=3), t_end=0.2,
                         report_every=0.1)
    a, b = carry_fields(rest.carry), carry_fields(straight.carry)
    assert all(torch.equal(a[f], b[f]) for f in b)


def test_scaling_harness_on_gloo(ranks):
    """The scaling harness at W = 1 and 2 (gloo, two CPU ranks): its fields,
    and efficiency 1.0 at W = 1."""
    res = ranks[0][2][0]["scaling"]
    assert [r["ranks"] for r in res] == [1, 2]
    assert all(set(r) == {"ranks", "solves_per_s", "speedup", "efficiency"} for r in res)
    assert res[0]["efficiency"] == 1.0 and res[0]["speedup"] == 1.0
    assert all(r["solves_per_s"] > 0 for r in res)


@pytest.mark.parametrize("world", [2, 4])
def test_qp_fleet_split_over_scenarios_is_the_one_rank_fleet(ranks, world):
    """The QP fleet split over a scenario axis of 2 and 4 ranks (no
    collective in its tick) is the one-rank fleet, scenario by scenario, bit
    for bit; its report's shares and median are the whole fleet's."""
    one = run_qp_fleet(build_qp_fleet(B, "cpu", seed=4), t_end=0.3, report_every=0.3)
    got = [r["qp"] for r in ranks[0][world]]
    for i in (0, 1):
        assert torch.equal(torch.cat([g.carry[i] for g in got]), one.carry[i])
    assert all((g.parked, g.upright, g.median_abs_x, g.scenarios, g.ticks)
               == (one.parked, one.upright, one.median_abs_x, one.scenarios, one.ticks) for g in got)


def test_scaling_entry_prints_one_json_line(capsys):
    """``python -m mpc_rs_tpu_torch.parallel.scaling`` in one process on the
    CPU (no group: W = 1): one JSON line with its fields."""
    from mpc_rs_tpu_torch.parallel import scaling

    res = scaling.main(["--device", "cpu", "--k", "2048", "--iters", "2"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"kind", "k", "world", "backend", "device", "cards", "nvidia_smi", "results"}
    assert (line["kind"], line["k"], line["world"], line["backend"], line["device"]) == ("scaling", 2048, 1, None,
                                                                                         "cpu")
    assert line["results"] == res and res[0]["ranks"] == 1 and res[0]["efficiency"] == 1.0


# --------------------------------------------------------------------------
# (f): the mesh's and init_distributed's errors


def test_mesh_needs_the_ranks_it_names():
    with pytest.raises(ValueError, match="mesh needs 2 ranks, have 1"):
        make_mesh({"scenario": 2, "rollouts": 1})
    with pytest.raises(ValueError, match="positive"):
        make_mesh({"rollouts": 0})
    mesh = make_mesh({"scenario": 1, "rollouts": 1})
    assert mesh.coords == {"scenario": 0, "rollouts": 0} and mesh.world == 1


def test_sharded_solve_checks_k_and_the_horizon():
    """K must split evenly, and a (model, N) pair the kernels are not built
    for raises, naming the model's built horizons: the flagship at N = 12
    (built at 8) and the HW flagship at N = 8 (built at 20); the cart-pole
    at N = 12, one of serve's horizons, is built."""
    mesh = Mesh({"rollouts": 3}, {"rollouts": 0}, {"rollouts": None}, 0, 3)
    with pytest.raises(ValueError, match="not divisible by 3 ranks"):
        make_sharded_mppi(_cfg(), MODEL, mesh)
    cfg12 = MppiConfig(n_horizon=12, n_rollouts=K, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
    with pytest.raises(ValueError, match=r"N=12 with Flagship4Diag4; it is built for N=\[8\]"):
        make_sharded_mppi(cfg12, Flagship4Diag4(CartPoleParams.two_wheel(), 0.15), make_mesh())
    make_sharded_mppi(cfg12, CartPoleShaped4(CartPoleParams.single_wheel(), 0.8 / 12), make_mesh())
    with pytest.raises(ValueError, match=r"N=8 with Commu4Cost4; it is built for N=\[20\]"):
        make_sharded_mppi(_cfg(), Commu4Cost4(CartPoleParams.two_wheel(), 0.05), make_mesh())


def test_init_distributed_refuses_nccl_on_a_shared_card(monkeypatch):
    """NCCL with two ranks on one card (``torch.cuda.device_count`` stubbed
    to 1) raises, naming gloo, before any group is made; so does NCCL on a
    CPU rank, and a call with no rank in its arguments or environment."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: pytest.fail("set_device called"))
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="one card a rank: 2 ranks on this host, 1 card.*gloo"):
        distributed.init_distributed("file:///nonexistent/store", 2, 0, backend="nccl", device="cuda")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="gloo"):
        distributed.init_distributed("file:///nonexistent/store", 4, 1, backend="nccl", device="cuda")
    assert distributed.rank_device("cuda", local_rank=1) == torch.device("cuda", 0)  # two gloo ranks, one card
    with pytest.raises(ValueError, match="CPU rank takes backend='gloo'"):
        distributed.init_distributed("file:///nonexistent/store", 1, 0, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="RANK and WORLD_SIZE"):
        distributed.init_distributed(device="cpu")
    assert not distributed.launched() and not torch.distributed.is_initialized()
