"""The port's acceptance harness (``mpc_rs_tpu_torch/apps/acceptance.py``)
against the JAX package's, on the CPU: the same 30 specs (names, argv and
checks), every check's verdict equal to the JAX check's on synthetic
(ret, out) pairs, and ``run_one`` passing on the cheap specs with
``--device cpu``."""

import json
import types

import numpy as np
import pytest
import torch

from mpc_rs_tpu.apps import acceptance as jacc
from mpc_rs_tpu_torch.apps import acceptance as tacc
from mpc_rs_tpu_torch.apps.commu_examples import CommuResult, MpcCommuResult
from mpc_rs_tpu_torch.apps.mpc_examples import MpcRun, SolveLog
from mpc_rs_tpu_torch.apps.mppi_examples import LoopResult


def test_specs_equal_the_jax_table():
    assert list(tacc.SPECS) == list(jacc.SPECS) and len(tacc.SPECS) == 30
    for name, (workload, argv, check, _) in tacc.SPECS.items():
        j_workload, j_argv, j_check, _ = jacc.SPECS[name]
        assert (workload, argv) == (j_workload, j_argv), name
        # the same check: the same function name and the same code
        assert check.__name__ == j_check.__name__, name
        assert check.__code__.co_code == j_check.__code__.co_code, name


def test_notes_carry_no_tpu_figure():
    notes = " ".join(spec[3] for spec in tacc.SPECS.values())
    assert "TPU" not in notes and "574 µs" not in notes and "COMMU_FULLK" not in notes
    assert tacc.SPECS["mpc-ukf-commu"][3] == jacc.SPECS["mpc-ukf-commu"][3]


def _loop_x(x):
    return LoopResult(np.asarray(x, dtype=np.float64), [0], [0.01], False)


def _mpc_run(x):
    return MpcRun(np.asarray(x, dtype=np.float64), 10, SolveLog())


def _ladder(**kw):
    return types.SimpleNamespace(**kw)


def _est(est, act, obs):
    est, act, obs = (np.asarray(a, dtype=np.float64) for a in (est, act, obs))
    return _ladder(est=est, act=act, obs=obs, x=est[-1], p=np.eye(est.shape[1]))


def _cases():
    """(spec name, port ret, JAX ret, out) triples: each check on a passing
    and a failing result, the port's result types beside the JAX ones."""
    rng = np.random.default_rng(0)
    cases = []
    for x in ([0.1, -0.2], [0.5, 0.0], [np.nan, 0.0]):
        cases.append(("mppi2", _loop_x(x), np.asarray(x), ""))
    for out in ("", "x[2] is over 60 degrees"):
        cases.append(("mppi4", _loop_x([0.0, 0.0, 0.1, 0.0]), np.zeros(4), out))
    for t, tipped in ((10.0, False), (9.0, False), (10.0, True)):
        r = types.SimpleNamespace(t=t, tipped=tipped)
        cases.append(("mpc-ukf-s", r, r, ""))
    for u in ([1e-4, -1e-4], [2e-3, 0.0]):
        cases.append(("op-en2", types.SimpleNamespace(u=torch.tensor(u)), types.SimpleNamespace(u=np.asarray(u)), ""))
    for x, out in (([0.1, 0.0, 0.05, 0.0], ""), ([0.5, 0.0, 0.05, 0.0], ""), ([0.1, 0.0, 0.05, 0.0], "Error:")):
        cases.append(("op-mpc-x-calc", _mpc_run(x), np.asarray(x), out))
    for x, out in (([12.0, 1.0, 0.2, 0.0], ""), ([1.0, 0.0, 0.1, 0.0], ""), ([1.0, 0.0, 0.1, 0.0], "Error:")):
        cases.append(("mpc-ukf-x", _mpc_run(x), np.asarray(x), out))
    cases.append(("pid", None, None, "x[2] is over 60 degrees"))
    cases.append(("pid", None, None, ""))
    for mean, var in ((50.5, 1.0), (45.0, 1.0)):
        r = types.SimpleNamespace(mean=mean, var=var)
        cases.append(("one-liner-kf", r, r, ""))
    for x in ([49.0, 99.0], [40.0, 99.0]):
        cases.append(("two-liner-kf", (np.asarray(x), np.eye(2)), (np.asarray(x), np.eye(2)), ""))
    act = rng.normal(size=(120, 6))
    for spec in ("ukf-one", "ukf-two", "ukf-pen", "ukf-pen2", "ukf-pen3"):
        for scale in (0.01, 3.0):
            r = _est(act + scale * rng.normal(size=act.shape), act, act + 0.5 * rng.normal(size=act.shape))
            cases.append((spec, r, r, ""))
    for n in (99, 100, 150):
        res = CommuResult(n, n, [0] * n, [], [], 0.1, True, True, n, 0.1)
        mres = MpcCommuResult(n, n, [60] * n, [], [], 0.1, True, True, 0.1)
        cases.append(("mppi4-commu", res, n, ""))
        cases.append(("mpc-ukf-commu", mres, n, ""))
    cases.append(("uart", 3, 3, ""))
    cases.append(("uart", 0, 0, ""))
    for surv in ("0.990", "0.970"):
        out = f"t=   1.0s  survival={surv}  median max|θ|=0.01\n"
        cases.append(("fleet-cartpole4", None, None, out))
    for parked, upright in (("0.960", "1.000"), ("0.960", "0.990"), ("0.900", "1.000")):
        out = f"t=   3.0s  parked={parked}  upright={upright}  \n"
        cases.append(("fleet-qp", None, None, out))
    serve = {"robots": 8, "ticks": 10, "rx": [3] * 8, "tx": [3] * 8, "max_abs_theta": [0.1] * 8}
    cases.append(("serve", serve, serve, ""))
    cases.append(("serve-stream", dict(serve, rx=[0] + [3] * 7), dict(serve, rx=[0] + [3] * 7), ""))
    cell = {"lambda": 0.5, "sigma": 3.0, "survival": 1.0, "mean_cost": 70.0, "mean_ess": 1.5, "seeds": 2}
    for c, out in ((cell, "[tune] best cell: ..."), (dict(cell, mean_ess=300.0), "best cell"),
                   (dict(cell, survival=0.5), "best cell"), (cell, "")):
        cases.append(("tune", [c, dict(c, **{"lambda": 1.4})], [c, dict(c, **{"lambda": 1.4})], out))
    return cases


@pytest.mark.parametrize("case", range(len(_cases())))
def test_each_check_agrees_with_the_jax_check(case):
    name, ret, jret, out = _cases()[case]
    assert tacc.SPECS[name][2](ret, out) == jacc.SPECS[name][2](jret, out)


def test_the_cases_cover_both_verdicts_of_every_check():
    verdicts = {}
    for name, ret, _, out in _cases():
        verdicts.setdefault(tacc.SPECS[name][2].__name__, set()).add(bool(tacc.SPECS[name][2](ret, out)))
    assert all(v == {True, False} for k, v in verdicts.items() if k != "chk"), verdicts


@pytest.mark.parametrize("name", ["tune", "uart", "op-en2"])
def test_run_one_passes_the_cheap_specs_on_the_cpu(name):
    ok, detail, seconds = tacc.run_one(name, 0, device="cpu")
    assert ok, detail
    assert seconds > 0


def test_main_writes_the_ports_results_file(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    payload = tacc.main(["--only", "op-en2", "--seeds", "2", "--device", "cpu"])
    written = json.loads((tmp_path / "PARITY_RESULTS_TORCH.json").read_text())
    assert written == payload and written["generated_by"] == "mpc_rs_tpu_torch.apps.acceptance"
    assert written["results"]["op-en2"]["rate"] == 1.0 and written["device"] == "cpu"
    assert not (tmp_path / "PARITY_RESULTS.json").exists()
    with pytest.raises(SystemExit):
        tacc.main(["--only", "no-such-spec", "--device", "cpu"])
