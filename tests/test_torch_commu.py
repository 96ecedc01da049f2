"""The port's hardware-in-the-loop apps and the serve bridge against the JAX
package, on the CPU: the sensor-dropout helpers and ``make_accel6``, the
console streams byte for byte, mppi4-ukf-commu's estimator step, the solves
of mppi4-commu, mppi4-ukf-commu and serve's batch on matched noise, the
fake MCU's sensor noise, and the CLI (``--device cpu``) with the JAX tests'
assertions (``tests/test_apps.py:74-157``).

mppi4-ukf-commu's filter (α=1e-3, its own cos(ẍ) denominator quirk) is
ill-conditioned in both precisions: the JAX package's own jitted and eager
steps part past the float64 band within a few packets, and over a
trajectory the difference compounds. So the estimator is held step by step
(each packet's step from the JAX trajectory's state), at α=1 where one step
is well conditioned, within rtol 1e-8 in float64 and the f32 band in
float32; at the app's α=1e-3 on its first step from P0 = 10·I; and a test
records that the JAX package disagrees with itself there.

The plain path of serve's N=40 batch runs some 2 400 small torch ops a
solve, each of which hands the GIL to the sixteen fake-MCU and reader
threads, so a CPU solve there takes a second or more: the plan-streaming
case runs 2 s of simulated time.
"""

import contextlib
import io
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_rs_tpu.apps import commu_examples as jcommu
from mpc_rs_tpu.controllers import mppi as jmppi
from mpc_rs_tpu.estimators import ukf as jukf
from mpc_rs_tpu.models import costs as jcosts
from mpc_rs_tpu.models import dynamics as jdyn
from mpc_rs_tpu.models import noise as jnoise
from mpc_rs_tpu.models import observation as jobs
from mpc_rs_tpu.models.params import CartPoleParams as JParams
from mpc_rs_tpu.runtime import console as jconsole
from mpc_rs_tpu_torch.apps import commu_examples, registry
from mpc_rs_tpu_torch.apps import run as cli
from mpc_rs_tpu_torch.apps.common import make_mppi_solver, np_step
from mpc_rs_tpu_torch.apps.serve import make_batch_solver
from mpc_rs_tpu_torch.controllers.mppi import MppiConfig, MppiStatus
from mpc_rs_tpu_torch.estimators import ukf as tukf
from mpc_rs_tpu_torch.io import packets as pk
from mpc_rs_tpu_torch.models import dynamics as tdyn
from mpc_rs_tpu_torch.models import noise as tnoise
from mpc_rs_tpu_torch.models import observation as tobs
from mpc_rs_tpu_torch.models.params import CartPoleParams
from mpc_rs_tpu_torch.ops import mppi_cuda
from mpc_rs_tpu_torch.ops.mppi_cuda import CartPoleShaped4, Commu4Cost4
from mpc_rs_tpu_torch.runtime import console

SW, TW = CartPoleParams.single_wheel(), CartPoleParams.two_wheel()
JSW, JTW = JParams.single_wheel(), JParams.two_wheel()
F32_BAND = dict(rtol=1e-3, atol=2e-4)  # tests/test_pallas.py:59
F64_BAND = dict(rtol=1e-8, atol=1e-10)
R_DIAG = np.array(commu_examples.R_DIAG_COMMU)
PHY = commu_examples.PHY_COMMU


# --------------------------------------------------------------------------
# the sensor-dropout helpers and make_accel6


def test_enable_bits_to_mask_matches_jax_for_every_mask():
    for enable in range(32):
        got = tnoise.enable_bits_to_mask(enable)
        assert got.dtype == torch.float32 and got.shape == (5,)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jnoise.enable_bits_to_mask(enable)))
    np.testing.assert_array_equal(tnoise.enable_bits_to_mask(np.arange(32)).numpy(),
                                  np.asarray(jnoise.enable_bits_to_mask(jnp.arange(32))))


def test_gen_r_mask_matches_jax_for_every_mask():
    for dtype in (np.float32, np.float64):
        r = R_DIAG.astype(dtype)
        for enable in range(32):
            mask = np.asarray(jnoise.enable_bits_to_mask(enable))
            got = tnoise.gen_r_mask(torch.tensor(r), torch.tensor(mask))
            want = np.asarray(jnoise.gen_r_mask(jnp.asarray(r), jnp.asarray(mask)))
            assert got.dtype == torch.tensor(r).dtype
            np.testing.assert_array_equal(got.numpy(), want)
        masks = np.asarray(jnoise.enable_bits_to_mask(jnp.arange(32)))
        np.testing.assert_array_equal(tnoise.gen_r_mask(torch.tensor(r), torch.tensor(masks)).numpy(),
                                      np.asarray(jnoise.gen_r_mask(jnp.asarray(r), jnp.asarray(masks))))


def test_make_masked_hx_matches_jax_for_every_mask():
    x = np.random.default_rng(5).uniform(-1.0, 1.0, (13, 6))
    thx, jhx = tobs.make_hx_imu6(TW), jobs.make_hx_imu6(JTW)
    for enable in range(32):
        mask = np.asarray(jnoise.enable_bits_to_mask(enable))
        got = tobs.make_masked_hx(thx, torch.tensor(mask))(torch.tensor(x))
        want = np.asarray(jobs.make_masked_hx(jhx, jnp.asarray(mask))(jnp.asarray(x)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
        assert np.all(got.numpy()[:, mask == 0] == 0.0)


@pytest.mark.parametrize("kw", [dict(with_force=True), dict(with_force=False),
                                dict(with_force=False, quirk_denominator=True)])
def test_make_accel6_matches_jax_in_float64(kw):
    rng = np.random.default_rng(11)
    x = rng.uniform(-1.5, 1.5, (6, 257))
    u, f, dt = rng.uniform(-10.0, 10.0, 257), rng.uniform(-2.0, 2.0, 257), 0.01
    got = tdyn.make_accel6(TW, **kw)(*map(torch.tensor, x), torch.tensor(u), dt, torch.tensor(f))
    want = jdyn.make_accel6(JTW, **kw)(*map(jnp.asarray, x), jnp.asarray(u), dt, jnp.asarray(f))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-12)
    if kw.get("quirk_denominator"):  # cos(ẍ) in the denominator: another model than cos θ's
        plain = tdyn.make_accel6(TW, with_force=False)(*map(torch.tensor, x), torch.tensor(u), dt)
        assert not np.allclose(plain[5].numpy(), got[5].numpy())


# --------------------------------------------------------------------------
# the console streams


def _printed(fn, *args, **kw) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("case", [
    ("print_con", (1.2345, -3.21, [0.1, -0.25, 0.05, -1.5]), {}),
    ("print_rcv", (0.5, 2.0, np.arange(6) * 0.1, np.array([100.0, -100.0, 3.0, 0.98, -0.05])), {}),
    ("print_rcv", (12.0, -0.01, np.linspace(-1, 1, 6), np.array([1.0, 2.0, 3.0, 4.0, 5.0])),
     dict(innov=np.array([0.5, -0.5, 1.5, 0.01, 0.02]), x_act6=np.linspace(1, 2, 6),
          p_diag=np.array([10.0, 0.5, 1e-3, 7.25, 100.0, 3.0]))),
    ("print_rcv", (3.0, 0.0, np.zeros(6), np.array([1.0, 2.0, 3.0])), dict(innov=np.array([0.1, 0.2, 0.3]))),
])
def test_console_lines_match_jax_byte_for_byte(case):
    name, args, kw = case
    got = _printed(getattr(console, name), *args, **kw)
    assert got.encode() == _printed(getattr(jconsole, name), *args, **kw).encode()
    assert got.startswith("\x1b[32mCon:" if name == "print_con" else "\x1b[36mRcv:")


# --------------------------------------------------------------------------
# mppi4-ukf-commu's estimator step


def _jax_commu_estimator(dtype, alpha=1e-3, sqrt_method="eigh"):
    """(state0, est_step) of ``mpc_rs_tpu/apps/commu_examples.py:213-237``
    (its closure, with the spread and root as parameters)."""
    plant6 = jdyn.make_accel6(JTW, with_force=False, quirk_denominator=True)
    hx = jobs.make_hx_imu6(JTW)
    r_diag = jnp.asarray(R_DIAG, jnp.float32)
    _, est = jukf.ukf_init(jnp.zeros(6, dtype), 10.0 * jnp.eye(6, dtype=dtype),
                           jnoise.gen_q6(jnp.float32(0.06), phy=PHY).astype(dtype),
                           jnp.diag(r_diag).astype(dtype), alpha=alpha, sqrt_method=sqrt_method)
    params = jukf.ukf_init(jnp.zeros(6, dtype), jnp.eye(6, dtype=dtype), jnp.eye(6, dtype=dtype),
                           jnp.eye(5, dtype=dtype), alpha=alpha, sqrt_method=sqrt_method)[0]

    def est_step(state, u, z, dt_est, enable_mask):
        def fxd(xv, uu):
            out = plant6(*(xv[..., i] for i in range(6)), uu, dt_est, 0.0)
            return jnp.stack(jnp.broadcast_arrays(*out), axis=-1)

        state = state._replace(q=jnoise.gen_q6(dt_est, phy=PHY).astype(state.q.dtype),
                               r=jnoise.gen_r_mask(r_diag, enable_mask).astype(state.r.dtype))
        state = jukf.ukf_predict(params, state, u, fxd)
        return jukf.ukf_update(params, state, z, jobs.make_masked_hx(hx, enable_mask))

    return est, est_step


def _sensor3_stream(n_packets, seed=0):
    """(u, wire bytes, dt) of seeded Sensor3 packets: the fake MCU's truth
    plant (``make_accel6``, cos θ) under a slow control, its float32 IMU with
    the fake MCU's noise, dt jittered around 10 ms, every third packet with
    a random enable mask."""
    rng = np.random.default_rng(seed)
    truth, hx = jdyn.make_accel6(JTW, with_force=False), jobs.make_hx_imu6(JTW)
    x, out = np.zeros(6), []
    for i in range(n_packets):
        u, dt = 0.5 * np.sin(0.3 * i), float(rng.uniform(0.008, 0.012))
        for _ in range(10):
            x = np.array([float(v) for v in truth(*x, u, dt / 10, 0.0)])
        z = np.array(hx(jnp.asarray(x, jnp.float32)))
        z += rng.normal(size=5) * list(commu_examples.SENSOR3_NOISE)
        enable = int(rng.integers(0, 32)) if i % 3 == 0 else 0b11111
        pkt = pk.Sensor3(enable, int(np.clip(z[0], -32768, 32767)), int(np.clip(z[1], -32768, 32767)),
                         float(z[2]), float(z[3]), float(z[4]))
        out.append((float(u), pkt.as_cobs(), dt))
    return out


def _step_both(jstep, tstep, jstate, u, wire, dt, jdtype, tdtype):
    """One packet through both packages from the same state (the JAX one)."""
    enable, z = pk.Sensor3.from_cobs(wire).parse()
    mask = np.asarray(jnoise.enable_bits_to_mask(enable))
    want = jstep(jstate, u, jnp.asarray(z, jdtype), jdtype(dt), jnp.asarray(mask))
    tstate = tukf.UkfState(x=torch.tensor(np.asarray(jstate.x)), p=torch.tensor(np.asarray(jstate.p)),
                           q=torch.tensor(np.asarray(jstate.q)), r=torch.tensor(np.asarray(jstate.r)),
                           sigma_f=None)
    got = tstep(tstate, u, z, dt, tnoise.enable_bits_to_mask(enable))
    assert got.x.dtype == tdtype
    return want, got


@pytest.mark.parametrize("sqrt_method", ["eigh", "cholesky", "jacobi"])
def test_commu_est_step_float64_replay_matches_jax(sqrt_method):
    """60 seeded Sensor3 packets (bytes → parse → enable mask, dt jittered),
    each packet's step from the JAX trajectory's state, at α=1: x and P
    within rtol 1e-8 of the JAX est_step."""
    jstate, jstep = _jax_commu_estimator(jnp.float64, alpha=1.0, sqrt_method=sqrt_method)
    jstep = jax.jit(jstep)
    _, _, tstep = commu_examples.commu_estimator(TW, 0.06, torch.float64, alpha=1.0, sqrt_method=sqrt_method)
    for u, wire, dt in _sensor3_stream(60):
        want, got = _step_both(jstep, tstep, jstate, u, wire, dt, jnp.float64, torch.float64)
        np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), **F64_BAND)
        np.testing.assert_allclose(got.p.numpy(), np.asarray(want.p), rtol=1e-8,
                                   atol=1e-8 * np.abs(np.asarray(want.p)).max())
        jstate = want


@pytest.mark.parametrize("sqrt_method", ["cholesky", "jacobi"])
def test_commu_est_step_float32_matches_jax_for_20_packets(sqrt_method):
    """The float32 filter for 20 packets, each step from the JAX state, in
    the f32 band. With the roots that are code of both packages: in float32
    LAPACK's eigh of the two packages' builds picks other eigenvectors for
    P's near-equal eigenvalues, and α=1's wide sigma set carries that into
    the estimate (ddx 1-3 % apart where the JAX package's own jitted and
    eager steps agree to 1e-5)."""
    jstate, jstep = _jax_commu_estimator(jnp.float32, alpha=1.0, sqrt_method=sqrt_method)
    jstep = jax.jit(jstep)
    _, _, tstep = commu_examples.commu_estimator(TW, 0.06, torch.float32, alpha=1.0, sqrt_method=sqrt_method)
    for u, wire, dt in _sensor3_stream(20, seed=1):
        want, got = _step_both(jstep, tstep, jstate, u, wire, dt, jnp.float32, torch.float32)
        np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), **F32_BAND)
        jstate = want


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_commu_est_step_at_the_apps_alpha_first_packet(dtype):
    """The app's own filter (α=1e-3, eigh, P0 = 10·I) on its first packet."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jstate, jstep = _jax_commu_estimator(jd)
    _, tstate, tstep = commu_examples.commu_estimator(TW, 0.06, td)
    np.testing.assert_array_equal(tstate.p.numpy(), np.asarray(jstate.p))
    u, wire, dt = _sensor3_stream(1, seed=2)[0]
    want, got = _step_both(jax.jit(jstep), tstep, jstate, u, wire, dt, jd, td)
    band = F64_BAND if dtype == "float64" else F32_BAND
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), **band)


def test_the_jax_filter_at_the_apps_alpha_parts_from_itself_in_float64():
    """A property of the reference, not of the port: at α=1e-3 the JAX
    package's jitted and eager est_steps, from the same states, part past the
    float64 band within 60 packets, which is why the port is held to it at
    α=1 step by step."""
    jstate, jstep = _jax_commu_estimator(jnp.float64)
    jit = jax.jit(jstep)
    worst = 0.0
    for u, wire, dt in _sensor3_stream(60):
        enable, z = pk.Sensor3.from_cobs(wire).parse()
        mask = jnp.asarray(jnoise.enable_bits_to_mask(enable))
        a = jit(jstate, u, jnp.asarray(z), dt, mask)
        b = jstep(jstate, u, jnp.asarray(z), dt, mask)
        xa, xb = np.asarray(a.x), np.asarray(b.x)
        if np.isfinite(xa).all() and np.isfinite(xb).all():
            worst = max(worst, float(np.max(np.abs(xa - xb) / (F64_BAND["atol"] + F64_BAND["rtol"] * np.abs(xa)))))
        jstate = a
    assert worst > 1.0, worst


def test_commu_est_step_goes_nan_where_the_linear_algebra_fails():
    """Where LAPACK gives NaN (a non-finite P, a singular Pz) torch raises;
    the port's step then gives a NaN estimate, as the JAX package's does,
    and the next step keeps it NaN."""
    _, state, tstep = commu_examples.commu_estimator(TW, 0.06, torch.float64)
    jstate, jstep = _jax_commu_estimator(jnp.float64)
    bad = state._replace(p=state.p.clone().fill_(float("nan")))
    z, mask = np.array([10.0, -10.0, 1.0, 1.0, 0.0]), torch.ones(5)
    out = tstep(bad, 0.5, z, 0.01, mask)
    want = jstep(jstate._replace(p=jnp.full((6, 6), jnp.nan)), 0.5, jnp.asarray(z), 0.01, jnp.ones(5))
    assert not torch.isfinite(out.x).any() and not np.isfinite(np.asarray(want.x)).any()
    assert not torch.isfinite(tstep(out, 0.5, z, 0.01, mask).x).any()
    singular = state._replace(p=torch.zeros(6, 6))  # Pz = R = 0 with every channel dropped: singular
    singular = singular._replace(r=torch.zeros(5, 5))
    out = tstep(singular, 0.0, np.zeros(5), 1e-12, torch.zeros(5))
    assert out.x.shape == (6,)


def _closed_loop_stream(n_packets, seed, gains=(40.0, 4.0)):
    """(u, wire bytes, dt, plant θ) of Sensor3 packets from the fake MCU's
    truth plant under a PD control on its own θ and θ̇ (u = kθ·θ + kω·θ̇
    within ±10 A, held for each packet's 10 ms, dt jittered): the same
    stream for both packages whatever their estimates, with a control
    acting from the first packet that keeps the plant upright from θ =
    0.02. ``gains=(0, 0)`` lets it fall."""
    rng = np.random.default_rng(seed)
    truth, hx = jdyn.make_accel6(JTW, with_force=False), jobs.make_hx_imu6(JTW)
    x, out = np.array([0.0, 0.0, 0.0, 0.02, 0.0, 0.0]), []
    for _ in range(n_packets):
        u = float(np.clip(gains[0] * x[3] + gains[1] * x[4], -10.0, 10.0))
        dt = float(rng.uniform(0.008, 0.012))
        for _ in range(10):
            x = np.array([float(v) for v in truth(*x, u, dt / 10, 0.0)])
        z = np.array(hx(jnp.asarray(x, jnp.float32)))
        z += rng.normal(size=5) * list(commu_examples.SENSOR3_NOISE)
        pkt = pk.Sensor3(0b11111, int(np.clip(z[0], -32768, 32767)), int(np.clip(z[1], -32768, 32767)),
                         float(z[2]), float(z[3]), float(z[4]))
        out.append((u, pkt.as_cobs(), dt, float(x[3])))
    return out


def _apps_filters_on(dtype, stream):
    """The app's own filter (α=1e-3, eigh, P0 = 10·I) of both packages, the
    JAX one jitted as its app runs it, each along its own trajectory of
    ``stream``: (JAX's first non-finite packet, the port's, the largest
    |θ̂ − θ| of either while finite); an index is None where the filter
    stayed finite."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jstate, jstep = _jax_commu_estimator(jd)
    jstep = jax.jit(jstep)
    _, tstate, tstep = commu_examples.commu_estimator(TW, 0.06, td)
    jbad = tbad = None
    worst = 0.0
    for i, (u, wire, dt, theta) in enumerate(stream):
        enable, z = pk.Sensor3.from_cobs(wire).parse()
        if jbad is None:
            mask = jnp.asarray(np.asarray(jnoise.enable_bits_to_mask(enable)), jd)
            jstate = jstep(jstate, u, jnp.asarray(z, jd), jd(dt), mask)
            if np.isfinite(np.asarray(jstate.x)).all():
                worst = max(worst, abs(float(jstate.x[3]) - theta))
            else:
                jbad = i
        if tbad is None:
            tstate = tstep(tstate, u, z, dt, tnoise.enable_bits_to_mask(enable))
            if torch.isfinite(tstate.x).all():
                worst = max(worst, abs(float(tstate.x[3]) - theta))
            else:
                tbad = i
    return jbad, tbad, worst


@pytest.mark.parametrize("control", [True, False])
def test_the_apps_float32_filter_goes_non_finite_in_both_packages(control):
    """A property of the reference, which the port keeps: the app's float32
    filter goes non-finite in the JAX package as in the port, on every
    seed, a few packets after a control starts to act (seeds 0-9, first
    non-finite packet: JAX 3 2 3 3 2 3 3 8 12 2, the port 2 4 3 2 2 4 11 3
    2 3) and later, as the pendulum falls, with no control (seeds 0-7: JAX
    48 6 48 8 57 10 6 50, the port 45 9 48 44 67 4 76 69). The packet is
    chaotic in both; the port's median is no earlier than one packet before
    the JAX package's."""
    seeds, n, gains = (range(10), 30, (40.0, 4.0)) if control else (range(8), 100, (0.0, 0.0))
    onsets = [_apps_filters_on("float32", _closed_loop_stream(n, seed, gains))[:2] for seed in seeds]
    assert all(j is not None and t is not None for j, t in onsets), onsets
    jax_at, port_at = np.array(onsets).T
    assert np.median(port_at) >= np.median(jax_at) - 1, onsets
    if control:
        assert max(jax_at) < 15 and max(port_at) < 15, onsets


@pytest.mark.parametrize("seed", range(4))
def test_the_apps_filter_in_float64_stays_finite_in_both_packages(seed):
    """The same filter in float64 (``--ukf-dtype float64``, the Rust
    reference's precision) on the closed-loop stream of the float32 test:
    both packages stay finite for 300 packets (3 s at 100 Hz) and track the
    plant's θ within 0.15 rad."""
    jbad, tbad, worst = _apps_filters_on("float64", _closed_loop_stream(300, seed))
    assert jbad is None and tbad is None, (jbad, tbad)
    assert worst < 0.15, worst


# --------------------------------------------------------------------------
# the fake MCU


def test_fake_mcus_draw_the_same_sensor_noise_for_a_seed():
    """The port's Sensor3 fake MCU (float32 hx, the seeded noise added in
    place) sends the JAX package's packets for the same states and seed:
    the same draws, on an hx whose float32 values may differ in the last
    bit (torch's sin/cos against XLA's)."""
    port = commu_examples.SimMcu(mode="sensor3", seed=7)
    ref = jcommu.SimMcu(mode="sensor3", seed=7)
    try:
        states = np.random.default_rng(3).uniform(-0.5, 0.5, (20, 6))
        for x in states:
            port.x, ref.x = x.copy(), x.copy()
            z = np.array(ref.hx(jnp.asarray(ref.x, jnp.float32)))  # commu_examples.py:103-113
            z += ref.rng.normal(size=5) * [20.0, 20.0, 2.0, 0.05, 0.05]
            got = port.sensor3_packet()
            assert got.enable == ref.enable == 0b11111
            assert abs(got.encoder0 - int(z[0])) <= 1 and abs(got.encoder1 - int(z[1])) <= 1
            np.testing.assert_allclose([got.gyro, got.accel0, got.accel1], z[2:], rtol=1e-6, atol=1e-7)
        assert port.rng.random() == ref.rng.random()  # the same number of draws
    finally:
        port.pair.close()
        ref.pair.close()


@pytest.mark.parametrize("plant", ["cartpole", "accel6"])
def test_the_fake_mcus_float_step_is_np_steps(plant):
    """The fake MCU steps the port's model on Python floats: np_step's
    float64 values up to sin/cos's last bit."""
    if plant == "cartpole":
        step, extra, n = tdyn.make_cartpole_nonlinear(SW, None), (1e-3,), 4
    else:
        step, extra, n = tdyn.make_accel6(TW, with_force=False), (1e-3, 0.0), 6
    rng = np.random.default_rng(8)
    for _ in range(200):
        x, u = rng.uniform(-1.5, 1.5, n), float(rng.uniform(-10.0, 10.0))
        np.testing.assert_allclose(commu_examples.float_step(step, x, u, *extra), np_step(step, x, u, *extra),
                                   rtol=1e-14, atol=1e-14)


# --------------------------------------------------------------------------
# the solves on matched noise


@pytest.mark.parametrize("app", ["mppi4-commu", "mppi4-ukf-commu"])
def test_commu_solve_matches_jax_on_matched_noise(app):
    """One solve of each app's controller through the app's solver (the
    port's Philox noise for the seed) against the JAX ``mppi_solve`` fed
    the same noise."""
    if app == "mppi4-commu":  # commu_examples.py:162-198
        model, jstep, jcost = CartPoleShaped4(SW, 0.1), jdyn.make_cartpole_nonlinear(JSW, 0.1), jcosts.shaped4
        kw, x = dict(n_horizon=8, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0)), np.array([0.01, -0.1, 0.05, 0.2])
    else:  # commu_examples.py:201-212
        model, jstep, jcost = Commu4Cost4(TW, 0.06), jdyn.make_commu4(JTW, 0.06), jcosts.commu4
        kw, x = dict(n_horizon=20, lambda_=2.0, std_dev=2.0, limit=(-10.0, 10.0)), np.array([0.0, 0.1, 0.08, -0.3])
    cfg = MppiConfig(n_rollouts=4096, **kw)
    u_n = 0.2 * np.random.default_rng(4).standard_normal(cfg.n_horizon).astype(np.float32)
    got_u, got_st = make_mppi_solver(cfg, model, "cpu", "box-muller")(13, x, torch.tensor(u_n))
    noise = mppi_cuda.solve_noise(cfg, model, 13, 0, "box-muller")
    res = jmppi.mppi_solve(jmppi.MppiConfig(n_rollouts=4096, **kw), jstep, jcost, None,
                           tuple(jnp.float32(c) for c in x), jnp.asarray(u_n), noise=jnp.asarray(noise.numpy()))
    assert int(got_st) == int(res.status) == MppiStatus.OK
    np.testing.assert_allclose(got_u.numpy(), np.asarray(res.u_n), **F32_BAND)


@pytest.mark.parametrize("n", [8, 9, 16, 20, 31, 32, 39, 40])
def test_serve_batch_solver_matches_jax_robot_by_robot(n):
    """serve's batch of 8 robots (B = 8, no padding) at N = 8 and at the
    plan-streaming horizons N = 9-40 (each end of the row's sums: N = 31 in
    warp 0, N = 32 over two; odd N, whose last box-muller pair is half used)
    against the JAX ``mppi_solve`` robot by robot on each robot's noise;
    robot 3's NaN state fails to a zero sequence and leaves the others
    untouched."""
    dt = 0.1 if n == 8 else 0.8 / n
    model = CartPoleShaped4(SW, dt)
    cfg = MppiConfig(n_horizon=n, n_rollouts=1024, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
    jcfg = jmppi.MppiConfig(n_horizon=n, n_rollouts=1024, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
    rng = np.random.default_rng(n)
    xs = np.zeros((8, 4), np.float32)
    xs[:, 2] = rng.uniform(-0.1, 0.1, 8)
    xs[3, 2] = np.nan
    u_ns = torch.tensor(0.3 * rng.standard_normal((8, n)), dtype=torch.float32)
    seeds = np.arange(8, dtype=np.int32) + 100
    d = make_batch_solver(cfg, model, "cpu", plan=True)(seeds, xs, u_ns)
    noise = mppi_cuda.batch_noise(cfg, model, torch.tensor(seeds), "box-muller")
    plan = d.result()
    assert plan.shape == (8, n) and torch.equal(d.u_n, torch.tensor(plan))
    jstep = jdyn.make_cartpole_nonlinear(JSW, dt)
    for b in range(8):
        res = jmppi.mppi_solve(jcfg, jstep, jcosts.shaped4, None, tuple(jnp.float32(c) for c in xs[b]),
                               jnp.asarray(u_ns[b].numpy()), noise=jnp.asarray(noise[b].numpy()))
        if b == 3:
            assert int(res.status) == MppiStatus.NO_FINITE and np.all(plan[b] == 0.0)
        else:
            assert int(res.status) == MppiStatus.OK
            np.testing.assert_allclose(plan[b], np.asarray(res.u_n), **F32_BAND)
    u0 = make_batch_solver(cfg, model, "cpu")(seeds, xs, u_ns)
    np.testing.assert_array_equal(u0.result(), plan[:, 0])


def test_serve_batch_solver_takes_a_copy_of_the_state_table():
    cfg = MppiConfig(n_horizon=8, n_rollouts=512, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
    solve = make_batch_solver(cfg, CartPoleShaped4(SW, 0.1), "cpu")
    xs, seeds = np.full((8, 4), 0.05, np.float32), np.arange(8, dtype=np.int32)
    first = solve(seeds, xs, torch.zeros(8, 8))
    xs[:] = np.nan  # the next tick rewrites the table
    assert np.isfinite(first.result()).all()


@pytest.mark.parametrize("n, fast, match", [
    (16, True, "no fast-tier kernel for CartPoleShaped4 at N=16"),
    (41, False, r"no kernel for horizon N=41 with CartPoleShaped4; it is built for N=\[8, 9, .*, 39, 40\]"),
])
def test_serve_other_horizons_raise(n, fast, match):
    """The cart-pole is built at every horizon serve can pick, N = 8-40, in
    the exact tier: the fast tier past N = 8 and N = 41 still raise, on
    every device."""
    cfg = MppiConfig(n_horizon=n, n_rollouts=512, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
    with pytest.raises(ValueError, match=match):
        make_batch_solver(cfg, CartPoleShaped4(SW, 0.8 / n, fast=fast), "cpu")


# --------------------------------------------------------------------------
# the CLI on the CPU


def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = cli.main(argv)
    return out, buf.getvalue()


def test_registry_lists_the_ported_examples():
    assert set(registry.EXAMPLES) == {"mppi2", "mppi4", "mppi4-non-liner", "mppi4-non-liner-s",
                                      "mppi4-non-liner-ukf", "fleet", "uart", "mppi4-commu",
                                      "mppi4-ukf-commu", "mpc-ukf-commu", "serve", "tune", "one-liner-kf",
                                      "two-liner-kf", "ukf-one", "ukf-two", "ukf-pen", "ukf-pen2", "ukf-pen3",
                                      "pid", "op-en2", "op-mpc-x", "op-mpc-x-calc", "op-mpc-x-calc-nl",
                                      "mpc-ukf-x", "mpc-ukf-s"}
    assert len(registry.EXAMPLES) == 26
    args = cli.build_parser().parse_args(["serve", "--serial", "/dev/ttyUSB0,/dev/ttyUSB1", "--robots", "2",
                                          "--device", "cpu"])
    assert args.serial == "/dev/ttyUSB0,/dev/ttyUSB1" and args.device == "cpu" and args.robots == 2
    args = cli.build_parser().parse_args(["mppi4-ukf-commu"])
    assert args.serial == "/dev/ttyUSB0" and args.device == "cuda" and args.ukf_dtype == "float32"
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["uart", "--robots", "2"])  # another example's option


@pytest.mark.parametrize("app", ["uart", "mppi4-commu", "mppi4-ukf-commu", "serve"])
def test_hil_apps_take_the_card_by_default(app, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device runs")
    argv = [app, "--sim-mcu", "--t-end", "0.1"] + (["--log-dir", str(tmp_path)] if app == "mppi4-ukf-commu" else [])
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(argv)


def test_uart_sim_mcu():
    n, out = _run(["uart", "--device", "cpu", "--sim-mcu", "--t-end", "1.5"])
    assert n > 10  # ~100 Hz for 1.5 s
    assert "State(" in out and f"received {n} State packets" in out


def test_mppi4_commu_sim_mcu():
    res, out = _run(["mppi4-commu", "--device", "cpu", "--sim-mcu", "--k", "1024", "--t-end", "1.0"])
    assert res.solves > 10 and res.packets == res.solves and len(res.solve_seconds) == res.solves
    assert all(s == MppiStatus.OK for s in res.statuses)
    assert res.upright and res.max_abs_theta < np.radians(60.0)  # balances from θ = 0.05
    assert res.finite_solves == res.solves and res.plant_max_abs_theta < np.radians(60.0)
    assert "over 60 degrees" not in out


# The HW flagship's physical range, (|x| m, |ẋ| m/s, |θ| rad, |θ̇| rad/s) of
# the estimate a solve is made on: within the tip-over guard's π/2, a few
# metres of track, and speeds the robot reaches while it stands. The float32
# filter at α = 1e-3 is chaotic at float32's resolution in both packages and
# now and then throws a finite estimate far past it (|θ̇| of hundreds of
# rad/s), on which a solve finds no finite rollout.
F32_PHYSICAL_RANGE = (2.0, 5.0, np.pi / 2, 20.0)


@pytest.mark.parametrize("ukf_dtype", ["float32", "float64"])
def test_mppi4_ukf_commu_sim_mcu(tmp_path, ukf_dtype, monkeypatch):
    """The HW flagship through its fake MCU. In float64 the filter stays
    finite: at least 20 solves and packets, every solve OK. The float32
    filter at α = 1e-3 is chaotic at float32's resolution in both packages
    (``tests/hil_float32_witness.py``): every solve made on a finite
    estimate inside ``F32_PHYSICAL_RANGE`` is OK, and the run reaches 20
    solves unless the tip-over guard (|θ| past π/2, outside that range)
    ended it. The JAX package's own app met that claim in 48 of 48 runs of
    the witness, the port in 40 of 40."""
    seen = []
    real = commu_examples.make_mppi_solver

    def recording(*a, **kw):
        solve = real(*a, **kw)

        def solve_and_record(seed, x, u_n):
            out = solve(seed, x, u_n)
            seen.append((np.asarray(x, np.float64), int(out[1])))
            return out

        return solve_and_record

    monkeypatch.setattr(commu_examples, "make_mppi_solver", recording)
    res, out = _run(["mppi4-ukf-commu", "--device", "cpu", "--sim-mcu", "--k", "1024", "--time-scale", "0.2",
                     "--t-end", "1.0", "--ukf-dtype", ukf_dtype, "--log-dir", str(tmp_path)])
    assert f"{res.solves} solves" in out and len(seen) == res.solves + 1  # and the solve before traffic
    if ukf_dtype == "float64":
        assert res.solves >= 20 and res.packets >= 20
        # every solve made on a finite estimate succeeds; in float64 that is every solve
        assert all(s == MppiStatus.OK for s in res.statuses[:res.finite_solves])
        assert res.finite and res.finite_solves == res.solves
        assert all(s == MppiStatus.OK for s in res.statuses)
    else:
        inside = [(x.tolist(), s) for x, s in seen[1:]
                  if np.isfinite(x).all() and all(abs(v) <= b for v, b in zip(x, F32_PHYSICAL_RANGE))]
        assert all(s == MppiStatus.OK for _, s in inside), inside
        assert res.solves >= 20 or not res.upright, (res.solves, res.upright)
    assert res.plant_max_abs_theta is not None
    logs = list((tmp_path / "mppi-ukf-com").glob("mppi-ukf-com-*.csv"))
    assert len(logs) == 1  # named by its start time
    rows = np.loadtxt(logs[0], delimiter=",", ndmin=2)
    assert rows.shape[1] == 14  # t, u, x_est[0..6], p_diag[0..6] (mppi4-ukf-commu.rs:353-396)


@pytest.mark.parametrize("app", ["mppi4-commu", "mppi4-ukf-commu", "mpc-ukf-commu"])
def test_hil_apps_solve_on_one_intra_op_thread_on_the_cpu(app, monkeypatch, tmp_path):
    """On the CPU the HIL apps that solve as fast as the host lets them run
    each solve on one intra-op thread, and give the caller's process its
    thread count back after the run: an OpenMP team of a thread a core,
    sharing the cores with the fake MCU's threads and other processes, cut
    eight loaded copies of mppi4-ukf-commu from ~100 solves to 9-14 (and
    mpc-ukf-commu to 1)."""
    seen = []

    def recording(solve):
        def solve_and_record(*a, **kw):
            seen.append(torch.get_num_threads())
            return solve(*a, **kw)

        return solve_and_record

    real_mppi, real_mpc = commu_examples.make_mppi_solver, commu_examples.mpc_ukf_commu_parts
    monkeypatch.setattr(commu_examples, "make_mppi_solver", lambda *a, **kw: recording(real_mppi(*a, **kw)))
    def recording_parts(*a, **kw):
        solve, *rest = real_mpc(*a, **kw)
        return (recording(solve), *rest)

    monkeypatch.setattr(commu_examples, "mpc_ukf_commu_parts", recording_parts)
    before = max(2, torch.get_num_threads())
    torch.set_num_threads(before)
    extra = {"mppi4-commu": ["--k", "256"], "mppi4-ukf-commu": ["--k", "256", "--time-scale", "0.2",
                                                                "--log-dir", str(tmp_path)],
             "mpc-ukf-commu": ["--max-iter", "4", "--ukf-dtype", "float64"]}[app]
    res, _ = _run([app, "--device", "cpu", "--sim-mcu", "--t-end", "0.3", *extra])
    assert res.solves >= 1 and len(seen) == res.solves + 1  # the pre-solve before traffic and the loop's
    assert set(seen) == {1}, seen
    assert torch.get_num_threads() == before


def _serve(extra, seed):
    return _run(["serve", "--device", "cpu", "--sim-mcu", "--robots", "8", "--k", "128", "--time-scale", "0.2",
                 "--seed", str(seed), *extra])


@pytest.mark.parametrize("depth", [0, 2])
def test_serve_bridge_sim_mcus(depth):
    """8 PTY fake robots, a slow-motion twin, one batched solve a tick
    (``tests/test_apps.py:100-140``), synchronous and pipelined."""
    summary, out = _serve(["--t-end", "1.0", "--pipeline-depth", str(depth)], seed=3 + depth)
    assert summary["robots"] == 8 and summary["horizon"] == 8
    assert summary["ticks"] > 5
    assert all(n > 0 for n in summary["rx"]) and all(n > 0 for n in summary["tx"])
    assert summary["bad_frames"] == 0
    assert "robots upright" in out
    assert all(th < np.radians(60.0) for th in summary["max_abs_theta"])


def test_serve_bridge_plan_streaming():
    """``--ticks-per-dispatch 4`` (``tests/test_apps.py:143-157``): N = 40
    plans at the 0.01 s tick, dispatched every 4 ticks, the plan's tail
    applied at the tick cadence."""
    summary, out = _serve(["--t-end", "2.0", "--ticks-per-dispatch", "4", "--pipeline-depth", "1"], seed=5)
    assert summary["ticks"] > 5 and summary["horizon"] == 40 and summary["ticks_per_dispatch"] == 4
    assert summary["dispatches"] <= summary["ticks"] / 4 + 2, summary
    assert all(n >= summary["ticks"] * 0.5 for n in summary["tx"]), summary


def test_mppi4_non_liner_ukf_console_streams(tmp_path):
    res, out = _run(["mppi4-non-liner-ukf", "--device", "cpu", "--k", "256", "--t-end", "0.05", "--console",
                     "--log-dir", str(tmp_path)])
    assert res.n_solves > 0
    assert out.count("\x1b[32mCon:") == res.n_solves and "\x1b[36mRcv:" in out
    quiet = _run(["mppi4-non-liner-ukf", "--device", "cpu", "--k", "256", "--t-end", "0.05",
                  "--log-dir", str(tmp_path)])[1]
    assert "Con:" not in quiet and "Rcv:" not in quiet


def test_mppi4_ukf_commu_console_prints_an_rcv_line_a_traffic_packet(tmp_path):
    """With ``--console`` the HW flagship prints Rcv only in the traffic
    loop, as the JAX app does (``mpc_rs_tpu/apps/commu_examples.py:254-277``):
    the first frame's filter step before control starts prints nothing, so
    the Rcv lines number the packets read less one."""
    res, out = _run(["mppi4-ukf-commu", "--device", "cpu", "--sim-mcu", "--k", "256", "--time-scale", "0.2",
                     "--t-end", "0.4", "--ukf-dtype", "float64", "--console", "--log-dir", str(tmp_path)])
    assert res.packets >= 5
    assert out.count("\x1b[36mRcv:") == res.packets - 1
    assert out.count("\x1b[32mCon:") >= 1


def test_serve_solve_clock_starts_after_the_dispatch_returns(monkeypatch):
    """``solve_ms_p50`` runs from the return of the dispatch to the u0 read
    back, as the JAX runner's (``mpc_rs_tpu/apps/serve.py:255-258``);
    ``dispatch_ms_p50`` from before the dispatch. A dispatch that sleeps
    50 ms on the host lands in the second and not in the first."""
    from mpc_rs_tpu_torch.apps import serve as serve_mod

    real = serve_mod.make_batch_solver

    def slow_solver(*a, **kw):
        solve = real(*a, **kw)

        def slow(*args):
            time.sleep(0.05)
            return solve(*args)

        return slow

    monkeypatch.setattr(serve_mod, "make_batch_solver", slow_solver)
    summary, _ = _run(["serve", "--device", "cpu", "--sim-mcu", "--robots", "2", "--k", "64", "--time-scale", "0.2",
                       "--t-end", "0.5", "--seed", "1"])
    assert summary["dispatches"] >= 2
    assert summary["dispatch_ms_p50"] >= 50.0, summary
    assert summary["solve_ms_p50"] < 25.0, summary


@pytest.mark.parametrize("seed", range(5))
def test_serve_stream_plain_path_meets_its_spec_on_the_cpu(seed):
    """``serve-stream``'s acceptance spec (8 robots, K=128, N=40, time-scale
    0.2, ``--ticks-per-dispatch 2 --pipeline-depth 1``) on the plain path:
    its plain solve runs off the dispatching thread, so the plans reach the
    robots within the tick and every robot stays upright."""
    from mpc_rs_tpu_torch.apps.acceptance import run_one

    ok, detail, _ = run_one("serve-stream", seed, "cpu")
    assert ok, detail


def test_serve_plain_solve_runs_in_a_process_of_its_own_on_one_thread():
    """The CPU solve runs in the solver's own process, on one intra-op
    thread (that process's count); the caller's count is left as it was,
    and ``close()`` ends the process."""
    import os

    before = torch.get_num_threads()
    cfg = MppiConfig(n_horizon=8, n_rollouts=64, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
    solve = make_batch_solver(cfg, CartPoleShaped4(SW, 0.1), "cpu")
    solve(np.arange(2, dtype=np.int32), np.zeros((2, 4), np.float32), torch.zeros(2, 8)).result()
    assert solve.process.pid != os.getpid() and solve.process.is_alive() and solve.intraop_threads == [1]
    solve.close()
    assert not solve.process.is_alive() and torch.get_num_threads() == before


def test_serve_warm_start_advances_by_the_plan_steps_gone_by(monkeypatch):
    """``advance`` drops that many steps of the warm start before the solve
    and repeats its last entry (``_solve``, and the same through the
    solver's process); ``serve`` advances each dispatch's warm start by the
    plan steps between the two state snapshots it was solved from
    (``plan_steps_gone_by`` of the snapshot times it recorded, not the
    host's pace): with ``--ticks-per-dispatch 2`` (N = 40, steps of one
    tick) at least one step a dispatch, M = 2 or more as the host keeps up;
    at N = 8, whose 0.1 s steps are ten ticks long, none wherever under half
    a step went by."""
    from mpc_rs_tpu_torch.apps import serve as serve_mod

    model = CartPoleShaped4(SW, 0.01)
    cfg = MppiConfig(n_horizon=40, n_rollouts=256, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
    rng = np.random.default_rng(7)
    xs = np.zeros((3, 4), np.float32)
    xs[:, 2] = rng.uniform(-0.1, 0.1, 3)
    seeds = torch.arange(3, dtype=torch.int32)
    u = torch.tensor(rng.standard_normal((3, 40)), dtype=torch.float32)
    moved = torch.cat([u[:, 2:], u[:, -1:], u[:, -1:]], dim=1)
    want, _ = serve_mod._solve(cfg, model, "box-muller", True, seeds, torch.from_numpy(xs), moved)
    got, plan = serve_mod._solve(cfg, model, "box-muller", True, seeds, torch.from_numpy(xs), u, 2)
    assert torch.equal(got, want) and torch.equal(plan, want)
    solve = serve_mod.make_batch_solver(cfg, model, "cpu", plan=True)
    np.testing.assert_array_equal(solve(seeds.numpy(), xs, u, 2).result(), want.numpy())
    solve.close()

    advances, snapshots = [], []
    real, real_steps = serve_mod.make_batch_solver, serve_mod.plan_steps_gone_by

    def recording_solver(*a, **kw):
        solve = real(*a, **kw)

        def record(seeds, xs, u_ns, advance=0):
            advances.append(advance)
            return solve(seeds, xs, u_ns, advance)

        return record

    def recording_steps(snap_t, last_snap, step_s):
        snapshots.append((snap_t, last_snap, step_s))
        return real_steps(snap_t, last_snap, step_s)

    monkeypatch.setattr(serve_mod, "make_batch_solver", recording_solver)
    monkeypatch.setattr(serve_mod, "plan_steps_gone_by", recording_steps)
    base = ["serve", "--device", "cpu", "--sim-mcu", "--robots", "2", "--k", "64", "--time-scale", "0.2",
            "--t-end", "0.3", "--seed", "1"]
    summary, _ = _run(base + ["--ticks-per-dispatch", "2"])
    assert summary["horizon"] == 40 and summary["dispatches"] >= 4
    # past the pre-solve and the first dispatch, which have no earlier
    # snapshot, each advance is the rule's of the dispatch's own two snapshots
    streamed = advances[2:]
    assert advances[1] == 0 and len(snapshots) == len(streamed), (advances, snapshots)
    assert streamed == [real_steps(*pair) for pair in snapshots], (advances, snapshots)
    # dispatches come M = 2 ticks (steps) apart, or later when the host falls behind
    assert all(a >= 1 for a in streamed) and {pair[2] for pair in snapshots} == {0.01 / 0.2}, (advances, snapshots)
    advances.clear()
    snapshots.clear()
    summary, _ = _run(base)
    assert summary["horizon"] == 8 and summary["dispatches"] >= 4
    assert advances[1] == 0 and advances[2:] == [real_steps(*pair) for pair in snapshots], (advances, snapshots)
    # a 0.1 s step is 0.5 s of the wall at time-scale 0.2, ten ticks: under half of it, no step went by
    assert all(a == 0 for a, (t, last, step) in zip(advances[2:], snapshots) if t - last < 0.5 * step), (
        advances, snapshots)
    assert {pair[2] for pair in snapshots} == {0.1 / 0.2}


def test_plan_steps_gone_by_rounds_the_steps_between_snapshots():
    """The advance rule at exact times (steps of 0.5 s): under half a step
    none, a half rounds to even, then the nearest count."""
    from mpc_rs_tpu_torch.apps.serve import plan_steps_gone_by

    for gap, steps in ((0.0, 0), (0.125, 0), (0.25, 0), (0.3125, 1), (0.75, 2), (1.0, 2), (1.25, 2), (1.375, 3),
                       (10.0, 20)):
        assert plan_steps_gone_by(100.0 + gap, 100.0, 0.5) == steps, gap
    assert plan_steps_gone_by(3.0, 1.0, 0.05) == 40 and plan_steps_gone_by(1.0, 1.0, 0.01) == 0


def test_serve_plain_dispatch_returns_before_the_solve():
    """On the CPU ``solve()`` queues the plain solve for the solver's process
    and returns at once: at K = 262 144 a dispatch returns in under a tenth
    of the time to its result. The next dispatch, warm-started from the
    first's Dispatch, runs after it in order: at K = 1 024 each plan is the
    solve from the one before, bit for bit (``serve._solve`` in this
    process)."""
    from mpc_rs_tpu_torch.apps.serve import _solve

    model = CartPoleShaped4(SW, 0.1)
    xs, seeds = np.zeros((2, 4), np.float32), np.arange(2, dtype=np.int32)
    xs[:, 2] = 0.1
    big = MppiConfig(n_horizon=8, n_rollouts=262_144, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
    solve = make_batch_solver(big, model, "cpu", plan=True)
    solve(seeds, xs, torch.zeros(2, 8)).result()  # the process is up
    t0 = time.perf_counter()
    first = solve(seeds, xs, torch.zeros(2, 8))
    returned = time.perf_counter() - t0
    first.result()
    assert returned < (time.perf_counter() - t0) / 10
    solve.close()
    cfg = MppiConfig(n_horizon=8, n_rollouts=1024, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
    solve = make_batch_solver(cfg, model, "cpu", plan=True)
    first = solve(seeds, xs, torch.zeros(2, 8))
    second = solve(seeds + 2, xs, first)
    want1, _ = _solve(cfg, model, "box-muller", True, torch.tensor(seeds), torch.tensor(xs), torch.zeros(2, 8))
    want2, _ = _solve(cfg, model, "box-muller", True, torch.tensor(seeds + 2), torch.tensor(xs), want1)
    np.testing.assert_array_equal(first.result(), want1.numpy())
    np.testing.assert_array_equal(second.result(), want2.numpy())
    assert not np.array_equal(want1.numpy(), want2.numpy())
    solve.close()
