"""The port's distributional-parity harness and oracle wrappers (and the
deterministic ``qp-parking`` config).

- ``scripts/oracle.py``'s wrappers against ``tests/test_native_oracle.py``'s
  on the same inputs and the same loaded library, bit for bit; the library
  is the committed one (its stamp matches), and ``native/`` is not written.
- ``cartpole4-est`` seed 5000, re-derived fresh, equals
  ``PARITY_DIST_r05.json``'s ``raw.oracle[0]`` bit for bit.
- The port's library side on the CPU at small N against a fresh small oracle
  run, at ``tests/test_parity_dist.py``'s bands (16 or 12 episodes have little
  KS power; the 200-episode statement is ``PARITY_DIST_TORCH.json``'s).
- ``summarize`` against the JAX script's on the same episodes, and the CLI's
  read-modify-write of one entry.
"""

import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest

import test_native_oracle as jora
from mpc_rs_tpu_torch.scripts import oracle as ora
from mpc_rs_tpu_torch.scripts import parity_dist as pd

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
import parity_dist as jpd  # noqa: E402  (the JAX package's harness, for its statistics)


def _native_digests():
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest() for p in sorted((ROOT / "native").iterdir())}


@pytest.fixture(scope="module")
def lib():
    before = _native_digests()
    native = ora.oracle_library()
    yield native.lib
    assert _native_digests() == before


def test_the_committed_oracle_is_loaded_read_only(lib):
    native = ora.oracle_library()
    assert native.path == ROOT / "native" / "liboracle.so" and not native.built
    assert native.digest == (ROOT / "native" / "liboracle.so.src.sha256").read_text().split()[0]


def test_oracle_wrappers_match_the_jax_tests_wrappers(lib):
    rng = np.random.default_rng(0)
    x4, x6 = rng.normal(size=4) * 0.2, rng.normal(size=6) * 0.2
    for dyn_id, x in ((0, x4), (1, x6), (2, x4)):
        np.testing.assert_array_equal(ora.ora_dynamics(lib, dyn_id, x, 0.7, 0.01),
                                      jora.ora_dynamics(lib, dyn_id, x, 0.7, 0.01))
    np.testing.assert_array_equal(ora.ora_short6(lib, x6, 0.7, 0.01, 2.0), jora.ora_short6(lib, x6, 0.7, 0.01, 2.0))
    for hx_id, x in ((0, x4), (1, x6)):
        np.testing.assert_array_equal(ora.ora_hx(lib, hx_id, x), jora.ora_hx(lib, hx_id, x))
    q = np.empty(36)
    lib.oracle_gen_q6(0.0215, jora._dp(q))
    np.testing.assert_array_equal(ora.ora_gen_q6(lib, 0.0215), q.reshape(6, 6))
    eps, u_n = 3.0 * rng.standard_normal((512, 8)), 0.3 * rng.standard_normal(8)
    for args in ((0, 0, x4, u_n, eps, 0.5, 3.0, (-20.0, 20.0), 0.1), (2, 1, x4, u_n, eps, 1.4, 4.0, (-10, 10), 0.15),
                 (0, 0, x4, u_n, eps, 0.0, 3.0, (-20.0, 20.0), 0.1)):
        (ut, st_t), (uj, st_j) = ora.ora_mppi(lib, *args), jora.ora_mppi(lib, *args)
        np.testing.assert_array_equal(ut, uj)
        assert st_t == st_j
    sens = np.array([200.0, 200.0, 10.0, 0.05, 0.05])
    ft = ora.OraUkf(lib, np.zeros(6), 0.1 * np.eye(6), q.reshape(6, 6), np.diag(sens), fx_id=1, hx_id=1)
    fj = jora.OraUkf(lib, np.zeros(6), 0.1 * np.eye(6), q.reshape(6, 6), np.diag(sens), fx_id=1, hx_id=1)
    for _ in range(5):
        z = sens * rng.standard_normal(5)
        for f in (ft, fj):
            f.predict(0.3, 0.01)
            f.update(z)
        np.testing.assert_array_equal(ft.x, fj.x)
        np.testing.assert_array_equal(ft.p, fj.p)


def test_cartpole4_est_seed_5000_reproduces_the_record(lib):
    assert pd.oracle_episode("cartpole4-est", 5000) == pd.recorded_oracle("cartpole4-est")[0]


@pytest.fixture(scope="module")
def cartpole4_est_oracle():
    """12 fresh oracle episodes of 60 ticks in spawned processes, shared by
    both estimators' checks (the same seeds and ticks)."""
    return pd.run_oracle_side("cartpole4-est", 12, jobs=2, n_ticks=60)


@pytest.mark.parametrize("estimator", ["torch", "chain"])
def test_cartpole4_est_small_n(estimator, cartpole4_est_oracle):
    """The port's cartpole4 fleet (the plain path), 12 episodes of 60 ticks,
    against the 12 fresh oracle episodes, at
    ``tests/test_parity_dist.py:44-62``'s bands."""
    lib_eps = pd.run_library_fleet("cartpole4-est", 12, "cpu", estimator, n_ticks=60)
    s = pd.summarize(lib_eps, cartpole4_est_oracle)
    assert s["library"]["survival"] == 1.0 and s["oracle"]["survival"] == 1.0
    ml, mo = s["library"]["rms_theta_mean"], s["oracle"]["rms_theta_mean"]
    assert abs(ml - mo) < 0.6 * max(ml, mo), (ml, mo)
    assert s["tests"]["ks_rms_theta"]["p"] > 1e-3


def test_cartpole4_small_n():
    """The batched mppi4-non-liner loop at K=2048, 60 ticks, 16 episodes
    (``tests/test_parity_dist.py:28-41``)."""
    n, ticks, k = 16, 60, 2048
    lib_eps = pd.run_library_cartpole4(n, "cpu", n_ticks=ticks, k=k)
    ora_eps = pd.run_oracle_side("cartpole4", n, jobs=2, n_ticks=ticks, k=k)
    s = pd.summarize(lib_eps, ora_eps)
    assert s["library"]["survival"] == 1.0 and s["oracle"]["survival"] == 1.0
    ml, mo = s["library"]["rms_theta_mean"], s["oracle"]["rms_theta_mean"]
    assert abs(ml - mo) < 0.6 * max(ml, mo), (ml, mo)
    assert s["tests"]["ks_rms_theta"]["p"] > 1e-3


def test_summarize_matches_the_jax_script():
    """The same statistics and pass rule on the recorded episodes; with a
    shifted library side, the rule fails."""
    rec = json.loads((ROOT / "PARITY_DIST_r05.json").read_text())
    for config in pd.CONFIGS:
        raw = rec[config]["raw"]
        got, want = pd.summarize(raw["library"], raw["oracle"]), jpd.summarize(config, raw["library"], raw["oracle"])
        assert json.loads(json.dumps(got)) == json.loads(json.dumps(want)), config
        assert got["pass"] == rec[config]["pass"]
    shifted = [dict(e, rms_theta=1.5 * e["rms_theta"]) for e in raw["library"]]
    assert not pd.summarize(shifted, raw["oracle"])["pass"]
    tipped = [dict(e, survived=i % 4 != 0) for i, e in enumerate(raw["library"])]
    assert not pd.summarize(tipped, raw["oracle"])["tests"]["survival_ci_overlap"]
    assert pd.wilson(0, 0) == (0.0, 1.0) and pd.wilson(200, 200) == jpd.wilson(200, 200)


def test_cli_writes_one_entry_and_never_the_record(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(pd.N_TICKS, "cartpole4-est", 5)
    out = tmp_path / "parity.json"
    out.write_text(json.dumps({"other": {"kept": True}}))
    record = hashlib.sha256((ROOT / "PARITY_DIST_r05.json").read_bytes()).hexdigest()
    entry = pd.main(["--config", "cartpole4-est", "--episodes", "4", "--device", "cpu", "--oracle-from-record",
                     "--estimator", "chain", "--out", str(out)])
    data = json.loads(out.read_text())
    assert data["other"] == {"kept": True} and set(data) == {"other", "cartpole4-est:chain"}
    got = data["cartpole4-est:chain"]
    assert got["episodes_library"] == 4 and got["episodes_oracle"] == 200
    assert entry["oracle_source"] == "PARITY_DIST_r05.json raw.oracle" and entry["device"] == "cpu"
    assert entry["oracle"]["survival"] == data["cartpole4-est:chain"]["oracle"]["survival"] == 1.0
    assert len(entry["raw"]["library"]) == 4 and "oracle" not in entry["raw"]
    assert hashlib.sha256((ROOT / "PARITY_DIST_r05.json").read_bytes()).hexdigest() == record
    with pytest.raises(SystemExit):
        pd.main(["--config", "cartpole4-est", "--device", "cpu", "--out", str(ROOT / "PARITY_DIST_r05.json")])
    with pytest.raises(ValueError, match="no estimator"):
        pd.run_library("cartpole4", 2, "cpu", "chain")
    assert '"pass"' in capsys.readouterr().out


# --------------------------------------------------------------------------
# the gradient-MPC oracle calls and the deterministic qp-parking config


def test_qp_oracle_wrappers_match_the_raw_calls(lib):
    """``ora_qp_cost_grad`` and ``ora_qp_solve_box`` against the calls
    ``tests/test_native_oracle.py:746-766, 791`` make on the same library."""
    rng = np.random.default_rng(59)
    for _ in range(4):
        x = rng.uniform(-1.0, 1.0, 4) * np.array([2.0, 1.0, 0.3, 1.0])
        u = rng.uniform(-20.0, 20.0, 8)
        c_o, g_o = np.empty(1), np.empty(8)
        lib.oracle_qp_cost_grad(jora._dp(np.ascontiguousarray(x)), jora._dp(np.ascontiguousarray(u)),
                                jora._dp(c_o), jora._dp(g_o))
        c, g = ora.ora_qp_cost_grad(lib, x, u)
        assert c == c_o[0]
        np.testing.assert_array_equal(g, g_o)
        u_o = np.empty(8)
        assert lib.oracle_qp_solve_box(jora._dp(np.ascontiguousarray(8.0 * x)), -30.0, 30.0, jora._dp(u_o)) == 0
        np.testing.assert_array_equal(ora.ora_qp_solve_box(lib, 8.0 * x, -30.0, 30.0), u_o)


def test_qp_parking_small_n():
    """``tests/test_parity_dist.py:62-66``'s 8 episodes and gates: every
    parked flag agrees, both park, final states within 1e-4 (the 200-episode
    record: 1.98e-9)."""
    r = pd.run_qp_parking(8, "cpu")
    assert r["flag_agreement"] == 1.0 and r["pass"] is True
    assert r["library_park_rate"] == 1.0 and r["oracle_park_rate"] == 1.0
    assert r["max_final_state_diff"] < 1e-4
    # the JAX script's initial states (scripts/parity_dist.py:418-420)
    ics = np.array([0.5, 0.0, 0.1, 0.0]) + np.random.default_rng(777).uniform(-0.15, 0.15, size=(8, 4))
    np.testing.assert_array_equal(pd.qp_parking_ics(8), ics)


def test_qp_parking_library_side_matches_the_jax_tick():
    """The port's batched library side against ``scripts/parity_dist.py:422-429``'s
    jitted tick, episode by episode, for 10 ticks."""
    import jax
    import jax.numpy as jnp

    from mpc_rs_tpu.controllers.qp import active_set_inverse_table, box_qp_newton, build_condensed_qp, qp_linear_term
    from mpc_rs_tpu.models import dynamics, reference
    from mpc_rs_tpu.models.params import CartPoleParams

    sw = CartPoleParams.single_wheel()
    a, bm = dynamics.linear_ab(sw, 0.1)
    qp = build_condensed_qp(a, bm, np.diag([5.0, 5.0, 1.0, 1.0]), 8)
    gen_ref = reference.make_gen_ref_raised_cosine(8)
    tbl = active_set_inverse_table(qp.h)
    plant = dynamics.make_cartpole_nonlinear(sw, 0.1)

    @jax.jit
    def lib_tick(x):
        bvec = qp_linear_term(qp, x, gen_ref(x).reshape(-1))
        u = box_qp_newton(qp.h, bvec, jnp.zeros(8, jnp.float64), -30.0, 30.0, inv_table=tbl)
        return jnp.stack(jnp.broadcast_arrays(*plant(*(x[i] for i in range(4)), u[0])))

    ics = pd.qp_parking_ics(3)
    got = pd.run_qp_parking_library(ics, "cpu")
    assert got.shape == (pd.QP_TICKS + 1, 3, 4)
    for e in range(3):
        x = jnp.asarray(ics[e])
        for t in range(1, 11):
            x = lib_tick(x)
            np.testing.assert_allclose(got[t, e], np.asarray(x), rtol=0, atol=1e-12)


def test_cli_writes_the_qp_parking_entry(tmp_path, capsys):
    out = tmp_path / "parity.json"
    out.write_text(json.dumps({"other": {"kept": True}}))
    entry = pd.main(["--config", "qp-parking", "--episodes", "2", "--device", "cpu", "--jobs", "1", "--out", str(out)])
    data = json.loads(out.read_text())
    assert set(data) == {"other", "qp-parking"} and data["qp-parking"]["episodes"] == 2
    assert entry["pass"] and entry["oracle_source"] == "fresh" and entry["device"] == "cpu"
    with pytest.raises(SystemExit):
        pd.main(["--config", "qp-parking", "--episodes", "2", "--device", "cpu", "--oracle-from-record",
                 "--out", str(out)])
    assert '"flag_agreement"' in capsys.readouterr().out
