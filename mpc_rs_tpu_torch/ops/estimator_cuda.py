"""The fused estimator chain of the scenario fleets (K7) and its plain
PyTorch version.

Replaces ``mpc_rs_tpu/ops/estimator_pallas.py::make_estimator_chain``: one
launch per fleet tick runs, for each of B scenarios and each of
``n_substeps`` with u0 held, the plant step, the sensor (hx plus pre-drawn
standard normals), the SoA UKF predict and update and the guard. The kernel
(``ops/csrc/estimator_chain.cuh``, a group of 16 lanes per scenario that
splits its sigma points, sums and gain rows) is instantiated for the two
fleet models, ``CartPole4Rpm`` (cartpole4) and ``Flagship6Imu``
(flagship6), and once more for flagship6 on observations scaled by 1/σ a
channel (``Flagship6Imu(..., obs_sigma=σ)``: the fleet's ``obs_normalize``);
its design notes say what bounds it.

``estimator_chain_plain`` is the same computation in torch ops on the
batch-minor estimator of ``estimators/ukf_soa.py``, with the mean's pair
sums added one after another (``unroll_sum=True``), as the kernel adds them;
it takes any model with ``plant_fx``/``fx``/``hx``. ``estimator_chain_fused``
runs it on CPU tensors and launches the kernel on CUDA tensors, with no
fallback. ``launches`` counts the calls that launched the kernel.
``chain_inputs`` makes the seeded inputs on which the card's checks and
profilers hold the two against each other.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from mpc_rs_tpu_torch.estimators import ukf_soa
from mpc_rs_tpu_torch.estimators.ukf import UkfParams
from mpc_rs_tpu_torch.models import dynamics, observation
from mpc_rs_tpu_torch.models.params import CartPoleParams
from mpc_rs_tpu_torch.ops.mppi_cuda import CartPoleShaped4, Flagship4Diag4, _check, _library, _ptr, _raise_on
from mpc_rs_tpu_torch.runtime.loop import Pulse

# Wrapper calls that launched the kernel since the last reset; CPU calls do not count.
launches = {"estimator_chain_fused": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _vector(step, n: int):
    """Component-wise ``step(*xs, *args)`` as f(x (..., n), *args) -> (..., n)."""

    def f(x, *args):
        out = step(*(x[..., i] for i in range(n)), *args)
        return torch.stack(torch.broadcast_tensors(*out), dim=-1)

    return f


@dataclasses.dataclass(frozen=True)
class CartPole4Rpm:
    """cartpole4's models (``apps/fleet.py:198-238``): the exact
    ``make_cartpole_nonlinear`` at the substep ``dt`` as the plant (which
    takes no force) and the UKF process model, ``make_hx_rpm_gyro4`` as the
    sensor."""

    params: CartPoleParams
    dt: float
    n_state = 4
    n_obs = 3
    model_id = 0  # kCartPoleShaped4 in mppi_kernels.cu
    obs_sigma = None  # no scaled sensor: the JAX package has no obs_normalize for cartpole4

    @functools.cached_property
    def fx(self):
        return _vector(dynamics.make_cartpole_nonlinear(self.params, self.dt), 4)

    def plant_fx(self, x, u, f):
        return self.fx(x, u)

    @functools.cached_property
    def hx(self):
        return observation.make_hx_rpm_gyro4(self.params)

    def constants(self) -> list[float]:
        return CartPoleShaped4(self.params, self.dt).constants()

    def obs_constants(self) -> list[float]:
        return [60.0 / (2.0 * math.pi * self.params.r_w), 180.0 / math.pi]


@dataclasses.dataclass(frozen=True)
class Flagship6Imu:
    """flagship6's models (``apps/fleet.py:100-194``): ``make_flagship6`` at
    ``dt`` as the plant (with the disturbance force) and as the UKF process
    model (f ≡ 0), ``make_hx_imu6`` as the sensor; with ``obs_sigma`` the
    sensor divided by those standard deviations a channel, taken in float32
    (``obs_normalize``, ``fleet.py:139-146``: hx / σ)."""

    params: CartPoleParams
    dt: float
    obs_sigma: tuple[float, ...] | None = None
    n_state = 6
    n_obs = 5
    model_id = 1  # kFlagship4Diag4 in mppi_kernels.cu: the flagship's estimator

    @functools.cached_property
    def _plant6(self):
        return dynamics.make_flagship6(self.params)

    @functools.cached_property
    def _plant(self):
        return _vector(lambda x0, x1, x2, x3, x4, x5, u, f:
                       self._plant6(x0, x1, x2, x3, x4, x5, u, self.dt, f), 6)

    @functools.cached_property
    def fx(self):
        return _vector(lambda x0, x1, x2, x3, x4, x5, u:
                       self._plant6(x0, x1, x2, x3, x4, x5, u, self.dt, 0.0), 6)

    def plant_fx(self, x, u, f):
        return self._plant(x, u, f)

    @functools.cached_property
    def hx(self):
        raw = observation.make_hx_imu6(self.params)
        if self.obs_sigma is None:
            return raw
        sigma = torch.tensor(self.obs_sigma, dtype=torch.float32)
        on = {}  # σ on each (device, dtype) it has been asked for, copied once

        def hx(x):
            key = (x.device, x.dtype)
            if key not in on:
                on[key] = sigma.to(x.device, x.dtype)
            return raw(x) / on[key]

        return hx

    def constants(self) -> list[float]:
        """``Flagship4Consts`` at ``dt``, then mll_j2 = m2·l² + j2."""
        p = self.params
        return Flagship4Diag4(p, self.dt).constants() + [p.m2 * p.l * p.l + p.j2]

    def obs_constants(self) -> list[float]:
        """``HxImu6``'s k, −k, 180/π, g, l, then σ with ``obs_sigma``."""
        p = self.params
        k = 36.0 * 60.0 / (2.0 * math.pi * p.r_w)
        return [k, -k, 180.0 / math.pi, p.g, p.l, *(self.obs_sigma or ())]


@dataclasses.dataclass(frozen=True)
class EstimatorChain:
    """What one K7 launch computes: ``n_substeps`` of plant (``dt_sub``
    each), sensor and UKF per tick, with the filter's constants as the JAX
    package's ``make_estimator_chain`` takes them (``q``, ``r``, ``sig``,
    ``p_reset``)."""

    model: object  # plant_fx(x, u, f), fx(x, u), hx(x); the kernel's model_id and constants
    params: UkfParams
    q: torch.Tensor  # (n, n) additive process noise
    r: torch.Tensor  # (o, o) additive measurement noise
    sig: torch.Tensor  # (o,) sensor noise standard deviations
    p_reset: torch.Tensor | None  # (n, n): the guard's covariance, or None for no guard
    n_substeps: int
    dt_sub: float
    disturbance: Pulse | None = None  # force f(t) on the plant
    control_start: float = 0.0  # u0 is 0 while t < control_start

    @functools.cached_property
    def kernel_constants(self) -> tuple:
        """(plant, sensor, chain) float32 arrays of the C entry, folded once:
        the chain's are 0.5·c, wm1, wc1, Σwc = 1 + (wc0 − wm0) (in the
        weights' dtype, as ``ukf_soa._ut``), dt_sub, control_start, the
        pulse (t0, t1, f, on), the guard's flag, then q, r, sig, p_reset."""
        prm, pulse = self.params, self.disturbance
        if pulse is not None and not isinstance(pulse, Pulse):
            raise ValueError(f"the kernel takes a runtime.loop.Pulse disturbance, got {pulse!r}")
        n, o = prm.n, prm.n_obs
        head = [0.5 * prm.c, float(prm.wm[1]), float(prm.wc[1]), float(1.0 + (prm.wc[0] - prm.wm[0])),
                self.dt_sub, self.control_start,
                *((pulse.t0, pulse.t1, pulse.f, 1.0) if pulse is not None else (0.0,) * 4),
                float(self.p_reset is not None)]
        p_reset = torch.zeros(n, n) if self.p_reset is None else self.p_reset
        mats = [torch.as_tensor(a).double().flatten().tolist() for a in (self.q, self.r, self.sig, p_reset)]
        if [len(v) for v in mats] != [n * n, o * o, o, n * n]:
            raise ValueError(f"q, r, sig and p_reset do not match the filter's n={n}, o={o}")
        f32 = lambda vals: (ctypes.c_float * len(vals))(*vals)  # noqa: E731
        return f32(self.model.constants()), f32(self.model.obs_constants()), f32(head + sum(mats, []))


def estimator_chain_plain(chain: EstimatorChain, x: torch.Tensor, ukf_x: torch.Tensor,
                          p: torch.Tensor, u0: torch.Tensor, t: torch.Tensor,
                          noise: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of K7, in the dtype of ``x``: x (B, S) plant
    states, ukf_x (B, n) estimates, p (n², B) covariances packed batch-minor,
    u0 (B,) controls, t (B,) sim times, noise (n_substeps·o, B) standard
    normals (row i·o + j: substep i, sensor j). Returns (x', ukf_x', p')."""
    b, n = ukf_x.shape
    o = chain.sig.shape[0]
    as_x = dict(dtype=x.dtype, device=x.device)
    q, r, sig = (torch.as_tensor(a).to(**as_x) for a in (chain.q, chain.r, chain.sig))
    if chain.control_start > 0.0:
        u0 = torch.where(t >= chain.control_start, u0, 0.0)
    soa = ukf_soa.SoaUkfState(x=ukf_x.T, p=p.reshape(n, n, b), sigma_f=None)
    for i in range(chain.n_substeps):
        f = (torch.zeros_like(t) if chain.disturbance is None
             else chain.disturbance(t + torch.full_like(t, i) * chain.dt_sub))
        x = chain.model.plant_fx(x, u0, f)
        z = chain.model.hx(x) + sig * noise[i * o:(i + 1) * o].T
        soa = ukf_soa.soa_predict(chain.params, soa, u0, chain.model.fx, q, unroll_sum=True)
        soa = ukf_soa.soa_update(chain.params, soa, z.T, chain.model.hx, r, unroll_sum=True)
        if chain.p_reset is not None:
            soa = ukf_soa.soa_guard(soa, chain.p_reset)
    return x, soa.x.T.contiguous(), soa.p.reshape(n * n, b)


def chain_inputs(chain: EstimatorChain, x: torch.Tensor, ukf_x: torch.Tensor, seed: int = 7) -> tuple:
    """Arguments of one K7 call on a perturbed carry, made on the CPU from
    ``seed`` and moved to the device of ``x``: the (B, ·) states ``x`` and
    ``ukf_x`` plus 0.05 normals, scenario min(5, B − 1)'s estimate NaN (the
    guard's case), random SPD covariances, u0 the strided first column of
    random (B, 8) nominals, t = 1.2 s (the flagship's clock inside the
    pulse) and the sensor normals."""
    g = torch.Generator().manual_seed(seed)
    b, n = ukf_x.shape
    x = x.cpu() + 0.05 * torch.randn(x.shape, generator=g)
    ex = ukf_x.cpu() + 0.05 * torch.randn(ukf_x.shape, generator=g)
    ex[min(5, b - 1), 0] = float("nan")
    a = torch.randn((b, n, n), generator=g)
    p = (1e-3 * a @ a.transpose(1, 2) + 0.05 * torch.eye(n)).permute(1, 2, 0).reshape(n * n, b).contiguous()
    u = torch.randn((b, 8), generator=g)
    t = torch.full((b,), 1.2)
    noise = torch.randn((chain.n_substeps * chain.sig.shape[0], b), generator=g)
    x, ex, p, u, t, noise = (v.to(ukf_x.device) for v in (x, ex, p, u, t, noise))
    return x, ex, p, u[:, 0], t, noise


def estimator_chain_fused(chain: EstimatorChain, x: torch.Tensor, ukf_x: torch.Tensor,
                          p: torch.Tensor, u0: torch.Tensor, t: torch.Tensor,
                          noise: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One tick of the estimator chain of B scenarios (K7), the arguments
    and result of ``estimator_chain_plain``. On CUDA tensors (float32) it
    launches the kernel; ``u0`` may be a strided column, e.g. ``u_n[:, 0]``."""
    if x.device.type == "cpu":
        return estimator_chain_plain(chain, x, ukf_x, p, u0, t, noise)
    if x.device.type != "cuda":
        raise ValueError(f"the estimator chain takes CPU or CUDA tensors, got {x.device}")
    m = chain.model
    if not isinstance(m, (CartPole4Rpm, Flagship6Imu)):
        raise ValueError(f"the K7 kernel is built for CartPole4Rpm and Flagship6Imu, got {m!r}")
    b, n, o = x.shape[0], m.n_state, m.n_obs
    dev = x.device
    _check("x", x, (b, n), torch.float32, dev)
    _check("ukf_x", ukf_x, (b, n), torch.float32, dev)
    _check("p", p, (n * n, b), torch.float32, dev)
    _check("t", t, (b,), torch.float32, dev)
    _check("noise", noise, (chain.n_substeps * o, b), torch.float32, dev)
    if u0.device != dev or u0.dtype != torch.float32 or tuple(u0.shape) != (b,):
        raise ValueError(f"u0 must be a float32 (B,) = ({b},) tensor on {dev}")
    plant_c, obs_c, chain_c = chain.kernel_constants
    x_out, ex_out, p_out = torch.empty_like(x), torch.empty_like(ukf_x), torch.empty_like(p)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().mpc_estimator_chain(
            m.model_id, chain.n_substeps, int(m.obs_sigma is not None), plant_c, obs_c, chain_c, b,
            _ptr(x), _ptr(ukf_x), _ptr(p), _ptr(u0), u0.stride(0), _ptr(t), _ptr(noise),
            _ptr(x_out), _ptr(ex_out), _ptr(p_out), ctypes.c_void_p(stream),
        )
    if err == -3:
        scaled = "" if m.obs_sigma is None else " on scaled observations"
        raise ValueError(f"no K7 kernel for {type(m).__name__}{scaled} with {chain.n_substeps} substeps")
    _raise_on(err, "estimator_chain_fused")
    launches["estimator_chain_fused"] += 1
    return x_out, ex_out, p_out
