"""The fleet's AoS estimator layout and ``obs_normalize`` against the JAX
package.

One tick of ``build_fleet(..., ukf_layout="aos", sqrt_method=root)`` on a
perturbed B=8 carry from the JAX package's ``init_scenario_carry(...,
ukf_layout="aos")`` is held against the same tick composed from the JAX
package's functions (the vmap MPPI solver, the plant, the sensor and the
vmapped AoS ``ukf_predict``/``ukf_update``/``ukf_guard``, as its ``rest``,
``mpc_rs_tpu/parallel/scenario.py:190-220``), both fed the same MPPI and
sensor noise. Bands as ``tests/test_torch_fleet.py``'s tick: float64 1e-9,
float32 the JAX package's kernel band (rtol 1e-3 / atol 2e-4). The ``eigh``
root is held in float64 only: two LAPACK builds pick other eigenvectors
for near-equal eigenvalues in float32 (ROADMAP.md §3); ``cholesky`` and
``jacobi`` are held in both precisions.

``obs_normalize`` is held on the torch-op estimator and on the fused
estimator chain (K7's plain version on the CPU): ticks of the flagship
fleet on the scaled sensor against the JAX fleet's normalised tick, the
chain's as the JAX fleet hands the scaled hx and R to its chain
(``mpc_rs_tpu/apps/fleet.py:139-146,185-191``).
"""

import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_rs_tpu.controllers import mppi as jmppi
from mpc_rs_tpu.estimators import ukf as jukf
from mpc_rs_tpu.parallel.scenario import init_scenario_carry as jinit_carry
from mpc_rs_tpu_torch.apps import run as cli
from mpc_rs_tpu_torch.apps.fleet import build_fleet
from mpc_rs_tpu_torch.parallel.scenario import carry_from_numpy, make_scenario_step
from test_torch_fleet import BANDS, _jax_fleet_pieces, _jax_tick, _spd, _tick_case

ROOTS = [("eigh", np.float64), ("cholesky", np.float64), ("cholesky", np.float32), ("jacobi", np.float64),
         ("jacobi", np.float32)]


def _jax_aos_tick(j, params, carry, mppi_noise, sensor_noise, k):
    """One AoS tick composed from the JAX package's functions with injected
    noise: the vmap MPPI solver, then per substep the plant, the sensor and
    the vmapped AoS filter with its guard."""
    cfg = dataclasses.replace(j["cfg"], n_rollouts=k)
    xh = carry["ukf"]["x"] if j["sl"] is None else carry["ukf"]["x"][:, list(j["sl"])]
    res = jax.vmap(lambda x_, u, e: jmppi.mppi_solve(cfg, j["ctrl"], j["cost"], None, tuple(x_), u, noise=e))(
        jnp.asarray(xh), jnp.asarray(carry["u_n"]), jnp.asarray(mppi_noise))
    u0 = res.u_n[:, 0]
    if j["disturbance"] is None:
        fx = j["plant_fx"]
    else:
        fx = lambda xv, u: j["plant_fx"](xv, u, 0.0)  # noqa: E731
    st = jukf.UkfState(*(jnp.asarray(carry["ukf"][f]) for f in ("x", "p", "q", "r", "sigma_f")))

    def filt(s, u, z):
        s = jukf.ukf_update(params, jukf.ukf_predict(params, s, u, fx), z, j["hx"])
        return jukf.ukf_guard(s, j["p0"])

    filt_b = jax.vmap(filt)  # eager: jitting the unrolled Jacobi compiles for minutes
    x, t = jnp.asarray(carry["x"]), jnp.asarray(carry["t"])
    for i in range(j["n_sub"]):
        x = j["plant_fx"](x, u0) if j["disturbance"] is None else j["plant_fx"](x, u0, j["disturbance"](t))
        z = j["hx"](x) + j["sens"] * jnp.asarray(sensor_noise[i])
        st = filt_b(st, u0, z)
    return dict(x=np.asarray(x), u_n=np.asarray(res.u_n), status=np.asarray(res.status),
                ukf_x=np.asarray(st.x), ukf_p=np.asarray(st.p))


def _aos_case(model, dtype, root, b=8, k=256):
    j = _jax_fleet_pieces(model)
    params = j["params"]._replace(sqrt_method=root)
    jc = jinit_carry(b, j["x0"], jnp.zeros(8, jnp.float32), j["ukf0"], jax.random.key(0), ukf_layout="aos")
    rng = np.random.default_rng(23)
    n, s = jc.ukf.x.shape[-1], jc.x.shape[-1]
    f = lambda a: np.asarray(a).astype(dtype)  # noqa: E731
    arrays = dict(
        x=f(np.asarray(jc.x) + 0.05 * rng.normal(size=(b, s))),
        u_n=f(0.5 * rng.normal(size=(b, 8))),
        ukf=dict(x=f(np.asarray(jc.ukf.x) + 0.05 * rng.normal(size=(b, n))), p=f(_spd(rng, b, n, 1e-3)),
                 q=f(jc.ukf.q), r=f(jc.ukf.r), sigma_f=f(jc.ukf.sigma_f)),
        status=np.asarray(jc.status), t=f(np.full(b, 1.2 if model == "flagship6" else 0.0)), key=jc.key,
    )
    mppi_noise = (float(j["cfg"].std_dev) * rng.standard_normal((b, k, 8))).astype(dtype)
    sensor_noise = rng.standard_normal((j["n_sub"], b, len(j["sens"]))).astype(dtype)
    return j, params, arrays, mppi_noise, sensor_noise


@pytest.mark.parametrize("root, dtype", ROOTS)
@pytest.mark.parametrize("model", ["cartpole4", "flagship6"])
def test_aos_fleet_tick_matches_jax(model, root, dtype):
    b, k = 8, 256
    j, params, arrays, mppi_noise, sensor_noise = _aos_case(model, dtype, root, b, k)
    want = _jax_aos_tick(j, params, arrays, mppi_noise, sensor_noise, k)
    fl = build_fleet(model, k, "cpu", scenarios=b, ukf_layout="aos", sqrt_method=root)
    got = fl.tick(carry_from_numpy(arrays), fl.generator, mppi_noise=torch.tensor(mppi_noise),
                  sensor_noise=torch.tensor(sensor_noise))
    assert got.status.tolist() == want["status"].tolist() == [0] * b
    assert got.ukf.p.shape == (b, fl.carry.x.shape[-1], fl.carry.x.shape[-1]) and got.ukf.sigma_f is not None
    band = BANDS[dtype]
    np.testing.assert_allclose(got.u_n.numpy(), want["u_n"], **band)
    np.testing.assert_allclose(got.x.numpy(), want["x"], **band)
    np.testing.assert_allclose(got.ukf.x.numpy(), want["ukf_x"], **band)
    np.testing.assert_allclose(got.ukf.p.numpy(), want["ukf_p"], **band)


def test_aos_fleet_defaults_follow_the_jax_package():
    """The AoS roots off a TPU (``mpc_rs_tpu/apps/fleet.py:81-83``): eigh
    for cartpole4, jacobi for flagship6; the carry is batch-leading with
    sigma_f, and the SoA one stays packed (n², B) without it."""
    cp = build_fleet("cartpole4", 256, "cpu", scenarios=4, ukf_layout="aos")
    fl = build_fleet("flagship6", 2048, "cpu", scenarios=4, ukf_layout="aos")
    assert (cp.ukf_layout, cp.sqrt_method, fl.sqrt_method) == ("aos", "eigh", "jacobi")
    assert cp.carry.ukf.p.shape == (4, 4, 4) and cp.carry.ukf.sigma_f.shape == (4, 9, 4)
    soa = build_fleet("cartpole4", 256, "cpu", scenarios=4)
    assert soa.ukf_layout == "soa" and soa.carry.ukf.p.shape == (16, 4) and soa.carry.ukf.sigma_f is None
    with pytest.raises(ValueError, match="ukf_layout"):
        build_fleet("cartpole4", 256, "cpu", scenarios=4, ukf_layout="mixed")


def test_the_chain_has_no_aos_layout():
    """K7 runs the SoA filter: the chain with the AoS layout raises, where
    the JAX step quietly runs without the chain
    (``mpc_rs_tpu/parallel/scenario.py:135-138``)."""
    with pytest.raises(ValueError, match="no chain for ukf_layout='aos'"):
        build_fleet("cartpole4", 256, "cpu", scenarios=4, ukf_layout="aos", estimator_chain=True)
    with pytest.raises(ValueError, match="no chain"):
        make_scenario_step(None, None, None, None, None, None, torch.ones(3), estimator_chain=True,
                           ukf_layout="aos")


@pytest.mark.parametrize("model, extra", [
    ("cartpole4", ["--k", "256", "--t-end", "0.5"]),
    ("flagship6", ["--k", "2048", "--t-end", "0.2", "--sqrt-method", "cholesky"]),
])
def test_aos_fleet_cli_runs_on_cpu(model, extra, tmp_path, capsys):
    res = cli.main(["fleet", "--model", model, "--device", "cpu", "--scenarios", "8", "--ukf-layout", "aos",
                    "--report-every", "0.1", "--log-dir", str(tmp_path), *extra])
    assert res.statuses_ok and res.survival == 1.0
    assert bool(torch.isfinite(res.carry.ukf.x).all()) and res.carry.ukf.p.shape[0] == 8
    assert "ukf=(aos, " in capsys.readouterr().out


# --------------------------------------------------------------------------
# obs_normalize: z, hx and R scaled by 1/σ a channel (fleet.py:137-146)


def _normalized_case(dtype, b=8, k=256):
    j, arrays, mppi_noise, sensor_noise = _tick_case("flagship6", dtype, b, k)
    sens = np.asarray(j["sens"])
    hx_raw = j["hx"]
    jn = dict(j, hx=lambda x: hx_raw(x) / j["sens"], sens=jnp.ones(5, jnp.float32))
    arrays = dict(arrays, ukf=dict(arrays["ukf"], r=np.broadcast_to(np.diag(1.0 / sens), (b, 5, 5)).astype(dtype)))
    return jn, arrays, mppi_noise, sensor_noise


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_obs_normalize_tick_matches_the_jax_fleets_normalised_tick(dtype):
    b, k = 8, 256
    jn, arrays, mppi_noise, sensor_noise = _normalized_case(dtype, b, k)
    want = _jax_tick(jn, arrays, mppi_noise, sensor_noise, k)
    fl = build_fleet("flagship6", k, "cpu", scenarios=b, obs_normalize=True)
    raw = np.array([200.0, 200.0, 10.0, 0.05, 0.05], np.float32)
    np.testing.assert_array_equal(fl.carry.ukf.r[0].numpy(), np.diag(1.0 / raw))  # diag(σ)/σ²
    got = fl.tick(carry_from_numpy(arrays), fl.generator, mppi_noise=torch.tensor(mppi_noise),
                  sensor_noise=torch.tensor(sensor_noise))
    band = BANDS[dtype]
    np.testing.assert_allclose(got.u_n.numpy(), want["u_n"], **band)
    np.testing.assert_allclose(got.ukf.x.numpy(), want["ukf_x"], **band)
    np.testing.assert_allclose(got.ukf.p.numpy(), want["ukf_p"], **band)


@pytest.mark.parametrize("layout", ["soa", "aos"])
def test_obs_normalize_is_the_same_filter_in_float64(layout):
    """A fixed diagonal change of observation coordinates: the same z
    (hx/σ + ε against hx + σ·ε), the same estimate and covariance after a
    tick, in float64 to 1e-9 (the same plant state: the controller saw the
    same estimate)."""
    b, k = 8, 256
    j, arrays, mppi_noise, sensor_noise = _tick_case("flagship6", np.float64, b, k)
    if layout == "aos":
        _, _, arrays, _, _ = _aos_case("flagship6", np.float64, "jacobi", b, k)
    sens = np.asarray(j["sens"], np.float64)
    out = {}
    for norm in (False, True):
        fl = build_fleet("flagship6", k, "cpu", scenarios=b, obs_normalize=norm, ukf_layout=layout)
        a = dict(arrays, ukf=dict(arrays["ukf"], r=np.broadcast_to(np.diag(1.0 / sens if norm else sens),
                                                                   (b, 5, 5)).copy()))
        out[norm] = fl.tick(carry_from_numpy(a), fl.generator, mppi_noise=torch.tensor(mppi_noise),
                            sensor_noise=torch.tensor(sensor_noise))
    np.testing.assert_array_equal(out[True].x.numpy(), out[False].x.numpy())
    np.testing.assert_allclose(out[True].ukf.x.numpy(), out[False].ukf.x.numpy(), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(out[True].ukf.p.numpy(), out[False].ukf.p.numpy(), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_obs_normalize_on_the_chain_matches_the_jax_fleets_normalised_chain(dtype):
    """``build_fleet("flagship6", estimator_chain=True, obs_normalize=True)``
    over three ticks on matched noise, against the JAX fleet's normalised
    chain: hx/σ, unit injected noise and R = diag(1/σ) (``fleet.py:139-146``)
    handed to its chain (``:185-191``), whose trace (``soa_predict`` /
    ``soa_update(unroll_sum=True)``, ``ops/estimator_pallas.py:129-152``) is
    composed from the JAX package's functions, as the JAX fleet runs it on
    the CPU. Each tick starts both from the port's carry of the tick before
    (chained float32 flagship ticks part from the JAX ones past the band by
    themselves, ``tests/test_torch_sharded.py``); the flagship's clock runs
    through the 2 N pulse. R is the JAX fleet's float32 1/σ, the chain's
    constant."""
    b, k, ticks = 8, 256, 3
    jn, arrays, _, _ = _normalized_case(dtype, b, k)
    sens = np.asarray([200.0, 200.0, 10.0, 0.05, 0.05], np.float32)
    r = np.diag(np.float32(1.0) / sens)
    arrays = dict(arrays, ukf=dict(arrays["ukf"], r=np.broadcast_to(r, (b, 5, 5)).astype(dtype)))
    fl = build_fleet("flagship6", k, "cpu", scenarios=b, estimator_chain=True, obs_normalize=True)
    chain = fl.tick.chain
    assert chain.model.obs_sigma == (200.0, 200.0, 10.0, 0.05, 0.05) and torch.equal(chain.sig, torch.ones(5))
    np.testing.assert_array_equal(chain.r.numpy(), r)
    rng = np.random.default_rng(17)
    for t in range(ticks):
        mppi_noise = (4.0 * rng.standard_normal((b, k, 8))).astype(dtype)
        sensor_noise = rng.standard_normal((1, b, 5)).astype(dtype)
        want = _jax_tick(jn, arrays, mppi_noise, sensor_noise, k, unroll_sum=True)
        got = fl.tick(carry_from_numpy(arrays), fl.generator, mppi_noise=torch.tensor(mppi_noise),
                      sensor_noise=torch.tensor(sensor_noise))
        assert got.status.tolist() == want["status"].tolist() == [0] * b
        band = BANDS[dtype]
        for g, w in ((got.u_n, want["u_n"]), (got.x, want["x"]), (got.ukf.x, want["ukf_x"]),
                     (got.ukf.p, want["ukf_p"])):
            assert g.dtype == torch.float64 if dtype == np.float64 else g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), w, err_msg=f"tick {t}", **band)
        arrays = dict(arrays, x=got.x.numpy(), u_n=got.u_n.numpy(), t=got.t.numpy(),
                      ukf=dict(arrays["ukf"], x=got.ukf.x.numpy(), p=got.ukf.p.numpy()))


def test_obs_normalize_with_the_chain_or_on_cartpole4_raises():
    """cartpole4 has no ``obs_normalize`` in the JAX package: it raises on
    the torch-op estimator and on the chain (the flagship's normalised chain
    runs: the tests above)."""
    with pytest.raises(ValueError, match="obs_normalize"):
        build_fleet("cartpole4", 256, "cpu", scenarios=4, obs_normalize=True, estimator_chain=True)
    with pytest.raises(ValueError, match="obs_normalize"):
        build_fleet("cartpole4", 256, "cpu", scenarios=4, obs_normalize=True)
    assert build_fleet("flagship6", 2048, "cpu", scenarios=4, obs_normalize=False).carry.ukf.r[0, 3, 3] == \
        np.float32(0.05)


def test_fleet_cli_has_the_jax_names_for_the_new_flags():
    args = cli.build_parser().parse_args(["fleet", "--ukf-layout", "aos", "--sqrt-method", "jacobi",
                                          "--resume", "x.pt", "--log-dir", "d"])
    assert (args.ukf_layout, args.sqrt_method, args.resume, args.log_dir) == ("aos", "jacobi", "x.pt", "d")
    defaults = cli.build_parser().parse_args(["fleet"])
    assert (defaults.ukf_layout, defaults.sqrt_method, defaults.resume, defaults.log_dir) == (None, None, None, "logs")
    assert not hasattr(defaults, "obs_normalize")  # no flag, as in the JAX package
