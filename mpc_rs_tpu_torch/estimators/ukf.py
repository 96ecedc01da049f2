"""Unscented Kalman filter: parameters, state, Merwe weights, init, guard.

Port of ``mpc_rs_tpu/estimators/ukf.py:35-95,200-216``. The fleet runs the
batch-minor math of ``estimators/ukf_soa.py`` on these; the AoS
predict/update (eigh, LU) come with the apps that use them.

f32 guidance (``ukf.py:58-68``, ``apps/fleet.py:84-98``): the reference's
α=1e-3 makes the non-center weights 1/(2α²(n+κ)) ≈ 1.7e5, which turns the
ulp rounding of every propagated sigma point into estimate noise in f32.
The fleet uses α=1.
"""

from __future__ import annotations

from typing import Any, Mapping, NamedTuple

import numpy as np
import torch


class UkfParams(NamedTuple):
    wm: torch.Tensor  # (M,) mean weights
    wc: torch.Tensor  # (M,) covariance weights
    c: float  # C = α²(n+κ) — sigma scaling (src/ukf.rs:27)
    n: int
    n_obs: int

    @classmethod
    def from_arrays(cls, d: Mapping[str, Any], device=None) -> "UkfParams":
        """From the JAX package's ``UkfParams`` fields as numpy arrays and
        numbers (``wm``, ``wc``, ``c``, ``n``, ``n_obs``); ``sqrt_method``
        and unknown keys are ignored: the fleet's root is always Jacobi."""
        return cls(
            wm=torch.as_tensor(np.array(d["wm"]), device=device),
            wc=torch.as_tensor(np.array(d["wc"]), device=device),
            c=float(d["c"]), n=int(d["n"]), n_obs=int(d["n_obs"]),
        )


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
             kappa: float | None = None) -> tuple[UkfParams, UkfState]:
    """Create (UkfParams, UkfState) in the dtype and on the device of
    ``x0``. sigma_f starts NaN as in src/ukf.rs:32."""
    dt, dev = x0.dtype, x0.device
    n = x0.shape[-1]
    r = torch.as_tensor(r, dtype=dt, device=dev)
    o = r.shape[-1]
    wm, wc, c = merwe_weights(n, alpha, beta, kappa, dtype=dt, device=dev)
    sigma_f = torch.full((2 * n + 1, n), float("nan"), dtype=dt, device=dev)
    return (
        UkfParams(wm=wm, wc=wc, c=c, n=n, n_obs=o),
        UkfState(x=x0, p=torch.as_tensor(p0, dtype=dt, device=dev),
                 q=torch.as_tensor(q, dtype=dt, device=dev), r=r, sigma_f=sigma_f),
    )


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
