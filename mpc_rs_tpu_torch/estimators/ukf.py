"""Unscented Kalman filter: parameters, state, Merwe weights, init, the
AoS predict/update and the guard.

Port of ``mpc_rs_tpu/estimators/ukf.py``. The fleet runs the batch-minor
math of ``estimators/ukf_soa.py`` on these parameters (always the Jacobi
root); ``sigma_points``, ``unscented_transform``, ``ukf_predict``,
``ukf_update`` and ``ukf_step`` are the AoS filter on (..., n) means and
(..., n, n) covariances, with the JAX package's three sigma roots
(``sqrt_method``): ``eigh`` (``torch.linalg.eigh``, the default),
``cholesky`` (the jittered unrolled Cholesky) and ``jacobi`` (the unrolled
cyclic Jacobi). Every contraction over sigma points is an elementwise
product and a sum, never a matrix product, so no TF32 path can take it
(the JAX package pins ``Precision.HIGHEST``, ``ukf.py:32``).

f32 guidance (``ukf.py:58-68``, ``apps/fleet.py:84-98``): the reference's
α=1e-3 makes the non-center weights 1/(2α²(n+κ)) ≈ 1.7e5, which turns the
ulp rounding of every propagated sigma point into estimate noise in f32.
The fleet uses α=1.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, NamedTuple

import numpy as np
import torch

from mpc_rs_tpu_torch.estimators.smallalg import chol_unrolled, eigh_jacobi_unrolled, mean_diag, spd_solve_unrolled


class UkfParams(NamedTuple):
    wm: torch.Tensor  # (M,) mean weights
    wc: torch.Tensor  # (M,) covariance weights
    c: float  # C = α²(n+κ) — sigma scaling (src/ukf.rs:27)
    n: int
    n_obs: int
    # the AoS filter's sigma root: 'eigh', 'cholesky' or 'jacobi'
    # (ukf.py:46-52); the SoA fleet path always takes Jacobi
    sqrt_method: str = "eigh"

    @classmethod
    def from_arrays(cls, d: Mapping[str, Any], device=None) -> "UkfParams":
        """From the JAX package's ``UkfParams`` fields as numpy arrays and
        numbers (``wm``, ``wc``, ``c``, ``n``, ``n_obs``, ``sqrt_method``,
        default ``"eigh"``); unknown keys are ignored."""
        return cls(
            wm=torch.as_tensor(np.array(d["wm"]), device=device),
            wc=torch.as_tensor(np.array(d["wc"]), device=device),
            c=float(d["c"]), n=int(d["n"]), n_obs=int(d["n_obs"]),
            sqrt_method=_sqrt_method(str(d.get("sqrt_method", "eigh"))),
        )


SQRT_METHODS = ("eigh", "cholesky", "jacobi")


def _sqrt_method(m: str) -> str:
    if m not in SQRT_METHODS:
        raise ValueError(f"sqrt_method must be one of {SQRT_METHODS}, got {m!r}")
    return m


class UkfState(NamedTuple):
    x: torch.Tensor  # (n,) mean; (B, n) in a fleet carry
    p: torch.Tensor  # (n, n) covariance; (n², B) batch-minor in a fleet carry
    q: torch.Tensor  # (n, n) process noise
    r: torch.Tensor  # (o, o) measurement noise
    sigma_f: torch.Tensor | None  # (2n+1, n) last propagated sigma points; None in a fleet carry


def merwe_weights(n: int, alpha: float = 1e-3, beta: float = 2.0, kappa: float | None = None,
                  dtype=torch.float32, device=None):
    """Merwe scaled weights — src/ukf.rs:112-118. Returns (wm, wc, c)."""
    if kappa is None:
        kappa = 3.0 - n
    c = alpha * alpha * (n + kappa)
    lam = c - n
    m = 2 * n + 1
    wm = torch.full((m,), 1.0 / (2.0 * c), dtype=dtype, device=device)
    wc = torch.full((m,), 1.0 / (2.0 * c), dtype=dtype, device=device)
    wm[0] = lam / c
    wc[0] = lam / c + 1.0 - alpha * alpha + beta
    return wm, wc, c


def ukf_init(x0: torch.Tensor, p0, q, r, *, alpha: float = 1e-3, beta: float = 2.0,
             kappa: float | None = None, sqrt_method: str = "eigh") -> tuple[UkfParams, UkfState]:
    """Create (UkfParams, UkfState) in the dtype and on the device of
    ``x0``. sigma_f starts NaN as in src/ukf.rs:32."""
    dt, dev = x0.dtype, x0.device
    n = x0.shape[-1]
    r = torch.as_tensor(r, dtype=dt, device=dev)
    o = r.shape[-1]
    wm, wc, c = merwe_weights(n, alpha, beta, kappa, dtype=dt, device=dev)
    sigma_f = torch.full((2 * n + 1, n), float("nan"), dtype=dt, device=dev)
    return (
        UkfParams(wm=wm, wc=wc, c=c, n=n, n_obs=o, sqrt_method=_sqrt_method(sqrt_method)),
        UkfState(x=x0, p=torch.as_tensor(p0, dtype=dt, device=dev),
                 q=torch.as_tensor(q, dtype=dt, device=dev), r=r, sigma_f=sigma_f),
    )


def sigma_points(params: UkfParams, x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(..., 2n+1, n) sigma set {x, x±Lᵢ} with L = sqrt(C·P), the rows of
    Lᵀ — src/ukf.rs:120-132, ``ukf.py:98-132``. 'eigh': L = V√λ with the
    eigenvalues clamped at 0 (the symmetric-PSD form of the reference's
    SVD); 'jacobi': the same from ``eigh_jacobi_unrolled``; 'cholesky': L =
    chol(C·P + jitter·I) with the jitter relative to the mean diagonal, its
    non-finite entries zeroed."""
    s = params.c * p
    s = (s + s.transpose(-1, -2)) / 2.0
    n = s.shape[-1]
    if params.sqrt_method == "cholesky":
        jitter = 1e-6 * (mean_diag(s) + 1e-30)
        l = chol_unrolled(s + jitter[..., None, None] * torch.eye(n, dtype=s.dtype, device=s.device))
        deltas = l.transpose(-1, -2)
        deltas = torch.where(torch.isfinite(deltas), deltas, 0.0)
    else:
        w, v = eigh_jacobi_unrolled(s) if params.sqrt_method == "jacobi" else torch.linalg.eigh(s)
        deltas = (v * torch.sqrt(torch.clamp(w, min=0.0))[..., None, :]).transpose(-1, -2)
    x0 = x[..., None, :]
    return torch.cat([x0, x0 + deltas, x0 - deltas], dim=-2)


def _wsum_outer(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σₘ w[m] a[m, s] b[m, t] over (..., M, S) and (..., M, T)."""
    return (w[..., :, None, None] * a[..., :, :, None] * b[..., :, None, :]).sum(dim=-3)


def unscented_transform(wm: torch.Tensor, wc: torch.Tensor, sigmas: torch.Tensor, cov: torch.Tensor):
    """(mean, P) of a sigma set (..., M, S) plus additive cov —
    src/ukf.rs:96-110, in the JAX package's cancellation-free mean form
    (``ukf.py:135-154``): wm[0] + 2n·wm[1] = 1, so mean = σ₀ + wm[1]·Σᵢ
    (dᵢ + dᵢ₊ₙ) with dᵢ = σᵢ − σ₀, the ± pairs summed before the large
    non-center weight multiplies them."""
    n = (sigmas.shape[-2] - 1) // 2
    s0 = sigmas[..., 0, :]
    d = sigmas - s0[..., None, :]
    pair = d[..., 1:n + 1, :] + d[..., n + 1:, :]
    mean = s0 + wm[..., 1, None] * pair.sum(dim=-2)
    y = sigmas - mean[..., None, :]
    return mean, _wsum_outer(wc, y, y) + cov


def ukf_predict(params: UkfParams, state: UkfState, u, fx: Callable) -> UkfState:
    """Time update — src/ukf.rs:44-52. ``fx(x (..., n), u) -> (..., n)``
    runs once over the whole sigma stack."""
    sigma_f = fx(sigma_points(params, state.x, state.p), u)
    x, p = unscented_transform(params.wm, params.wc, sigma_f, state.q)
    return state._replace(x=x, p=p, sigma_f=sigma_f)


def ukf_update(params: UkfParams, state: UkfState, z, hx: Callable) -> UkfState:
    """Measurement update — src/ukf.rs:54-74. The gain K = Pxz Pz⁻¹ by a
    linear solve of Pz Kᵀ = Pxzᵀ: ``torch.linalg.solve`` (pivoted LU) for
    'eigh' and 'jacobi', the unrolled SPD solve for 'cholesky'
    (``ukf.py:180-189``: the unrolled f32 solve loses the gain's
    small-channel digits on the flagship's ill-conditioned Pz); the
    covariance symmetrized after."""
    sigmas_h = hx(state.sigma_f)
    zp, pz = unscented_transform(params.wm, params.wc, sigmas_h, state.r)
    yf = state.sigma_f - state.x[..., None, :]
    yh = sigmas_h - zp[..., None, :]
    pxz = _wsum_outer(params.wc, yf, yh)
    if params.sqrt_method == "cholesky":
        k = spd_solve_unrolled(pz, pxz.transpose(-1, -2))
    else:
        k = torch.linalg.solve(pz.transpose(-1, -2), pxz.transpose(-1, -2))
    k = k.transpose(-1, -2)
    x = state.x + (k * (z - zp)[..., None, :]).sum(dim=-1)
    kpz = (k[..., :, :, None] * pz[..., None, :, :]).sum(dim=-2)
    p = state.p - (kpz[..., :, None, :] * k[..., None, :, :]).sum(dim=-1)
    p = (p + p.transpose(-1, -2)) / 2.0
    return state._replace(x=x, p=p)


def ukf_step(params: UkfParams, state: UkfState, u, z, fx: Callable, hx: Callable) -> UkfState:
    """predict + update."""
    return ukf_update(params, ukf_predict(params, state, u, fx), z, hx)


def ukf_guard(state: UkfState, p_reset) -> UkfState:
    """Failure recovery (src/ukf.rs:69 panics instead): non-finite mean
    entries are zeroed and the covariance of a filter whose mean or
    covariance went non-finite is reset to ``p_reset``, per instance over
    leading batch dims of the (..., n) / (..., n, n) layout."""
    p_reset = torch.as_tensor(p_reset, dtype=state.p.dtype, device=state.p.device)
    bad = ~(torch.isfinite(state.x).all(dim=-1) & torch.isfinite(state.p).all(dim=-1).all(dim=-1))
    x = torch.where(torch.isfinite(state.x), state.x, 0.0)
    p = torch.where(bad[..., None, None], p_reset, state.p)
    return state._replace(x=x, p=p)
