"""The plain steps that divide a tensor by a Python number go through
``models.dynamics._div`` (one IEEE division on every device; on a CUDA
tensor PyTorch's own tensor / number multiplies by the reciprocal): the
imu6 and force6 sensors' division by g, the mean diagonal of the unrolled
Cholesky's floor, of ``spd_solve_unrolled``'s jitter and of the AoS UKF's
Cholesky jitter, the plain MPPI controller's division by λ and the PID's
by dt. On the CPU each site computes the bits it computed with a plain
``/``: each is run here with ``_div`` and with ``/`` in its place, float32
and float64. ``tests/test_torch_cuda.py`` holds the same sites on the card.
"""

import numpy as np
import pytest
import torch

from mpc_rs_tpu_torch.controllers import mppi as tmppi
from mpc_rs_tpu_torch.controllers import pid as tpid
from mpc_rs_tpu_torch.estimators import smallalg, ukf
from mpc_rs_tpu_torch.models import costs, dynamics, observation
from mpc_rs_tpu_torch.models.params import CartPoleParams

SW = CartPoleParams.single_wheel()


def _spd(rng, batch: int, n: int, dtype) -> torch.Tensor:
    a = rng.standard_normal((batch, n, n))
    return torch.tensor(a @ a.transpose(0, 2, 1) + 0.1 * np.eye(n), dtype=dtype)


def _sites(rng, dtype):
    """name: (module holding ``_div``, call) for every repaired site."""
    x6 = torch.tensor(rng.uniform(-1.0, 1.0, (257, 6)), dtype=dtype)
    s = _spd(rng, 33, 6, dtype)
    b = torch.tensor(rng.standard_normal((33, 6, 2)), dtype=dtype)
    wm, wc, c = ukf.merwe_weights(6, alpha=1.0, dtype=dtype)
    params = ukf.UkfParams(wm=wm, wc=wc, c=c, n=6, n_obs=5, sqrt_method="cholesky")
    cfg = tmppi.MppiConfig(n_horizon=8, n_rollouts=256, lambda_=0.7, std_dev=3.0, limit=(-20.0, 20.0))
    step = dynamics.make_cartpole_nonlinear(SW, 0.1)
    noise = torch.tensor(3.0 * rng.standard_normal((256, 8)), dtype=dtype)
    x4 = tuple(torch.tensor(v, dtype=dtype) for v in (0.3, 0.0, 0.1, 0.0))
    pcfg = tpid.PidConfig(kp=2.0, ki=0.5, kd=0.3, lo=-10.0, hi=10.0)
    e = torch.tensor(rng.standard_normal(64), dtype=dtype)
    state = tpid.PidState(u=e * 0.1, e1=e * 0.5, e2=e * 0.25)
    return {
        "imu6": (observation, lambda: observation.make_hx_imu6(SW)(x6)),
        "force6": (observation, lambda: observation.make_hx_force6(SW)(x6)),
        "chol_floor": (smallalg, lambda: smallalg.chol_unrolled(s, eps_rel=1e-3)),
        "spd_jitter": (smallalg, lambda: smallalg.spd_solve_unrolled(s, b, jitter_rel=1e-3)),
        "ukf_jitter": (smallalg, lambda: ukf.sigma_points(params, s[:, 0], s)),
        "mppi_lambda": (tmppi, lambda: tmppi.mppi_solve(cfg, step, costs.shaped4, None, x4,
                                                        torch.zeros(8, dtype=dtype), noise=noise).u_n),
        "pid_dt": (tpid, lambda: tpid.pid_update(pcfg, state, e, 0.5 * e, 0.03)[0]),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("site", ["imu6", "force6", "chol_floor", "spd_jitter", "ukf_jitter", "mppi_lambda",
                                  "pid_dt"])
def test_repaired_division_keeps_its_cpu_bits(site, dtype, monkeypatch):
    module, call = _sites(np.random.default_rng(5), dtype)[site]
    got = call()
    monkeypatch.setattr(module, "_div", lambda a, b: a / b)
    want = _sites(np.random.default_rng(5), dtype)[site][1]()
    assert got.dtype == dtype and torch.equal(got, want)
