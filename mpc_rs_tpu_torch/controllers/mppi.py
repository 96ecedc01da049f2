"""MPPI (Model Predictive Path Integral) controller — plain PyTorch tier.

Port of ``mpc_rs_tpu/controllers/mppi.py:33-146``. This is the semantics
reference of the port: the fused CUDA kernels (``ops/mppi_cuda.py``) are held
against it. Plain functions on (K, N) tensors; sampling takes an explicit
``torch.Generator``, or pre-scaled noise.

Math (src/mppi.rs:33-92):
  v_k   = clamp(u_n + eps_k),  eps_k ~ N(0, σ²)
  c_k   = Σ_t cost(x_{t+1}),   x_{t+1} = dynamics(x_t, v_t)
  s_k   = −c_k − Σ_i u_i σ⁻² v_{k,i}
  m     = max over finite s_k
  w_k   = exp((s_k − m)/λ)
  u'    = Σ_k w_k v_k / Σ_k w_k
with the error paths surfaced as status flags: NO_FINITE, SUM_ZERO,
INVALID_U (NaN/Inf u'[0]). On failure the returned sequence is zeros.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, NamedTuple

import torch

from mpc_rs_tpu_torch.models.dynamics import _div


class MppiStatus(enum.IntEnum):
    OK = 0
    NO_FINITE = 1  # "Cannot calculate max" — src/mppi.rs:69
    SUM_ZERO = 2  # "sum is zero"          — src/mppi.rs:77
    INVALID_U = 3  # "u is invalid"         — src/mppi.rs:88


@dataclasses.dataclass(frozen=True)
class MppiConfig:
    n_horizon: int  # N — prediction horizon steps
    n_rollouts: int  # K — sampled control sequences
    lambda_: float  # softmax temperature λ
    std_dev: float  # sampling σ (also the control-term weight σ⁻²)
    limit: tuple[float, float]  # box constraint on controls
    # Optional override of the control-term coefficient (default σ⁻²);
    # control_inv = λ/R reproduces mppi2's weighting (examples/mppi2.rs:59-70).
    control_inv: float | None = None


class MppiResult(NamedTuple):
    u_n: torch.Tensor  # (N,) new nominal control sequence (zeros on failure)
    status: torch.Tensor  # int32 MppiStatus
    min_cost: torch.Tensor  # best (max) score seen, negated, for logging
    ess: torch.Tensor  # effective sample size of the softmax weights


def rollout_scores(dynamics, cost, x, v, u_n, std_dev, control_inv=None):
    """Scores s_k for sampled sequences v (K, N) from state x (tuple of
    components: 0-d tensors or Python floats). Returns (K,)."""
    k, n = v.shape
    xs = tuple(torch.as_tensor(c, dtype=v.dtype, device=v.device).expand(k) for c in x)
    c_k = torch.zeros(k, dtype=v.dtype, device=v.device)
    for t in range(n):
        xs = dynamics(*xs, v[:, t])
        c_k = c_k + cost(*xs)
    inv = std_dev ** -2.0 if control_inv is None else control_inv
    control_term = torch.sum(u_n * inv * v, dim=-1)  # src/mppi.rs:60-61
    return -c_k - control_term


def mppi_solve(
    cfg: MppiConfig,
    dynamics: Callable,
    cost: Callable,
    generator: torch.Generator | None,
    x,
    u_n: torch.Tensor,
    noise: torch.Tensor | None = None,
) -> MppiResult:
    """One MPPI solve — the functional analogue of ``Mppi::compute``.

    ``x`` is a tuple of state components; ``u_n`` is the warm-started
    nominal sequence (N,), whose dtype (f32 or f64) and device the solve
    runs in. ``noise``: optional (K, N) perturbations ε, already scaled by
    σ; otherwise ε = σ·randn drawn from ``generator``.
    """
    n, k = cfg.n_horizon, cfg.n_rollouts
    dtype, device = u_n.dtype, u_n.device
    if noise is None:
        if generator is None:
            raise ValueError("mppi_solve needs a torch.Generator when noise is None")
        eps = cfg.std_dev * torch.randn(
            (k, n), generator=generator, dtype=dtype, device=device
        )
    else:
        eps = torch.as_tensor(noise, dtype=dtype, device=device)
        if tuple(eps.shape) != (k, n):
            raise ValueError(
                f"noise must have shape (n_rollouts, n_horizon) = ({k}, {n}), "
                f"got {tuple(eps.shape)}; it must also already be scaled by std_dev"
            )
    v = torch.clamp(u_n + eps, cfg.limit[0], cfg.limit[1])  # src/mppi.rs:39-45

    s_k = rollout_scores(dynamics, cost, x, v, u_n, cfg.std_dev, cfg.control_inv)

    finite = torch.isfinite(s_k)
    any_finite = torch.any(finite)
    m = torch.max(torch.where(finite, s_k, -torch.inf))  # src/mppi.rs:65-69
    w = torch.exp(_div(s_k - m, cfg.lambda_))  # src/mppi.rs:71-74
    w = torch.where(finite, w, 0.0)
    w_sum = torch.sum(w)
    sum_zero = w_sum == 0.0

    safe_sum = torch.where(sum_zero, 1.0, w_sum)
    u_new = (w / safe_sum) @ v  # src/mppi.rs:80-84

    invalid = ~torch.isfinite(u_new[0])  # src/mppi.rs:86-89
    status = torch.where(
        ~any_finite,
        MppiStatus.NO_FINITE,
        torch.where(
            sum_zero,
            MppiStatus.SUM_ZERO,
            torch.where(invalid, MppiStatus.INVALID_U, MppiStatus.OK),
        ),
    ).to(torch.int32)
    u_out = torch.where(status == MppiStatus.OK, u_new, torch.zeros_like(u_new))
    ess = (w_sum * w_sum) / torch.clamp(torch.sum(w * w), min=1e-30)
    return MppiResult(u_n=u_out, status=status, min_cost=-m, ess=ess)
