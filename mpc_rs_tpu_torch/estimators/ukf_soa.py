"""Batch-minor ("structure-of-arrays") UKF math of the fleet.

Port of ``mpc_rs_tpu/estimators/ukf_soa.py:77-384`` (``soa_predict``,
``soa_update``, ``soa_guard``) as batched tensor math. Every matrix entry is
a (B,) vector, and the small dimensions lead: the mean is (n, B), the
covariance (n, n, B) — the JAX package's nested lists of (B,) arrays, as
one tensor. The algorithm and its f32 safeguards are the JAX package's:

- sigma points {x, x±Lᵢ} with L rows = eigenvector·√λ from the unrolled
  cyclic Jacobi (``smallalg.jacobi_entries``, same rotation order);
- the cancellation-free unscented transform: the mean from pair-summed
  deltas, the covariance in the shifted form Σ wc1 d dᵀ − s_d eᵀ − e s_dᵀ +
  (Σwc) e eᵀ, in which no intermediate carries the 1e6-scale center weight;
- the Kalman gain by the EQUILIBRATED unrolled Cholesky solve with one step
  of iterative refinement (``ukf_soa.py:204-255``): the flagship's Pz mixes
  variances ~4e4 and ~2.5e-3, and the fleet's survival depends on this step;
- the covariance symmetrized after the update.

The k-sums over sigma points are sequential accumulations in the JAX
package's order; the sums over observation components run in the order of
its Python ``sum``. The mean's pair sum is ``torch.sum`` by default and
sequential with ``unroll_sum=True``, the form the fused estimator chain
(``ops/estimator_cuda.py``) computes. The TPU layout forms (``mode="entry"``, the (B/128, 128)
tiles of ``rest_soa``) are not ported: on the GPU the batch is simply the
minor axis.

fx and hx are vector form here: ``fx(x (..., n), u) -> (..., n)`` and
``hx(x (..., n)) -> (..., o)``; the sigma stack is handed to them as an
(m, B, n) view, so each runs once over all m points.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from mpc_rs_tpu_torch.estimators.smallalg import jacobi_entries
from mpc_rs_tpu_torch.estimators.ukf import UkfParams


class SoaUkfState(NamedTuple):
    x: torch.Tensor  # (n, B)
    p: torch.Tensor  # (n, n, B)
    sigma_f: torch.Tensor | None  # (n, m, B) sigma points propagated by the last predict


def _sigma_points(c: float, x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(n, m, B) sigma points {x, x+Lᵢ, x−Lᵢ}, L rows = eigenvector·√λ of
    the symmetrized C·P (src/ukf.rs:120-132)."""
    s = 0.5 * c * (p + p.transpose(0, 1))
    w, v = jacobi_entries(s)
    sq = torch.sqrt(torch.clamp(w, min=0.0))
    deltas = v.transpose(0, 1) * sq[:, None]  # row i = i-th eigen direction
    x0 = x[None]
    return torch.cat([x0, x0 + deltas, x0 - deltas]).transpose(0, 1)


def _ut(params: UkfParams, fm: torch.Tensor, cov: torch.Tensor, unroll_sum: bool = False):
    """Unscented transform of component-stacked sigma values fm (dim, m, B)
    plus the additive (dim, dim) ``cov``. Returns (mean (dim, B), the shift
    pieces (d (2n, dim, B), e (dim, B), s_d (dim, B)), P (dim, dim, B)).

    ``unroll_sum``: the mean's pair sums are added one after another, in
    pair order, as the fused estimator chain adds them (``ukf_soa.py:141-155``);
    otherwise ``torch.sum``, as the JAX package's default tier. The order
    alone can move a marginal low-B fleet seed (``ukf_soa.py:145-148``)."""
    n = params.n
    wm1, wc1 = params.wm[1], params.wc[1]
    sum_wc = 1.0 + (params.wc[0] - params.wm[0])  # = 2+β−α², cancellation-free
    s0 = fm[:, 0]
    deltas = fm[:, 1:] - fm[:, :1]
    pairs = deltas[:, :n] + deltas[:, n:]
    if unroll_sum:
        acc = pairs[:, 0]
        for i in range(1, n):
            acc = acc + pairs[:, i]
    else:
        acc = torch.sum(pairs, dim=1)
    mean = s0 + wm1 * acc
    d = deltas.transpose(0, 1)
    e = mean - s0
    sd = d[0]
    core = d[0][:, None] * d[0][None, :]
    for k in range(1, 2 * n):
        sd = sd + d[k]
        core = core + d[k][:, None] * d[k][None, :]
    sd = wc1 * sd
    core = wc1 * core
    pmat = (core - sd[:, None] * e[None, :] - e[:, None] * sd[None, :]
            + sum_wc * (e[:, None] * e[None, :]))
    return mean, (d, e, sd), pmat + cov[:, :, None]


def _chol_solve_equilibrated(pz: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve Pz·X = rhs for pz (o, o, B) and rhs (o, R, B) (R right-hand
    sides): with D = diag(Pz)^½, the unit-diagonal D⁻¹PzD⁻¹ is factored by an
    unrolled Cholesky and each solve is refined once on its residual."""
    o = pz.shape[0]
    eps = torch.tensor(1e-30, dtype=pz.dtype, device=pz.device)
    dinv = [1.0 / torch.sqrt(torch.maximum(pz[i, i], eps)) for i in range(o)]
    a = [[pz[i, j] * dinv[i] * dinv[j] for j in range(o)] for i in range(o)]
    l = [[None] * o for _ in range(o)]
    for i in range(o):
        for j in range(i + 1):
            acc = a[i][j]
            for k in range(j):
                acc = acc - l[i][k] * l[j][k]
            l[i][j] = torch.sqrt(torch.maximum(acc, eps)) if i == j else acc / l[j][j]

    def tri_solve(b):
        y = [None] * o
        for i in range(o):
            acc = b[i]
            for k in range(i):
                acc = acc - l[i][k] * y[k]
            y[i] = acc / l[i][i]
        z = [None] * o
        for i in reversed(range(o)):
            acc = y[i]
            for k in range(i + 1, o):
                acc = acc - l[k][i] * z[k]
            z[i] = acc / l[i][i]
        return z

    b = [rhs[i] * dinv[i] for i in range(o)]
    z = tri_solve(b)
    resid = [b[i] - sum(a[i][k] * z[k] for k in range(o)) for i in range(o)]
    dz = tri_solve(resid)
    return torch.stack([(z[i] + dz[i]) * dinv[i] for i in range(o)])


def soa_predict(params: UkfParams, state: SoaUkfState, u: torch.Tensor, fx: Callable,
                q: torch.Tensor, unroll_sum: bool = False) -> SoaUkfState:
    """Time update (src/ukf.rs:44-52): sigma points through ``fx`` with the
    (B,) control ``u``, then the UT with the additive (n, n) ``q``.
    ``unroll_sum``: see ``_ut``."""
    pts = _sigma_points(params.c, state.x, state.p)
    fm = fx(pts.permute(1, 2, 0), u).permute(2, 0, 1)
    mean, _, pmat = _ut(params, fm, q, unroll_sum)
    return SoaUkfState(x=mean, p=pmat, sigma_f=fm)


def soa_update(params: UkfParams, state: SoaUkfState, z: torch.Tensor, hx: Callable,
               r: torch.Tensor, unroll_sum: bool = False) -> SoaUkfState:
    """Measurement update (src/ukf.rs:54-74) for z (o, B): UT of
    hx(sigma_f), shifted cross-covariance, equilibrated-Cholesky gain,
    symmetrized covariance. ``unroll_sum``: see ``_ut``."""
    n = params.n
    sf = state.sigma_f
    hm = hx(sf.permute(1, 2, 0)).permute(2, 0, 1)
    zp, (dh, eh, sdh), pz = _ut(params, hm, r, unroll_sum)
    wc1 = params.wc[1]
    sum_wc = 1.0 + (params.wc[0] - params.wm[0])
    df = (sf[:, 1:] - sf[:, :1]).transpose(0, 1)  # (2n, n, B)
    ef = state.x - sf[:, 0]
    sdf = df[0]
    pxz = df[0][:, None] * dh[0][None, :]
    for k in range(1, 2 * n):
        sdf = sdf + df[k]
        pxz = pxz + df[k][:, None] * dh[k][None, :]
    sdf = wc1 * sdf
    pxz = (wc1 * pxz - sdf[:, None] * eh[None, :] - ef[:, None] * sdh[None, :]
           + sum_wc * (ef[:, None] * eh[None, :]))  # (n, o, B)
    # K = Pxz Pz⁻¹: solve Pz Kᵀ = Pxzᵀ (Pz symmetric)
    gain = _chol_solve_equilibrated(pz, pxz.transpose(0, 1)).transpose(0, 1)  # (n, o, B)
    innov = z - zp
    o = innov.shape[0]
    dx = gain[:, 0] * innov[0]
    kpz = gain[:, 0, None] * pz[0][None]
    for k in range(1, o):
        dx = dx + gain[:, k] * innov[k]
        kpz = kpz + gain[:, k, None] * pz[k][None]
    dec = kpz[:, None, 0] * gain[None, :, 0]
    for k in range(1, o):
        dec = dec + kpz[:, None, k] * gain[None, :, k]
    val = 0.5 * (state.p + state.p.transpose(0, 1)) - dec
    upper = torch.ones(n, n, dtype=torch.bool, device=val.device).triu()[:, :, None]
    p = torch.where(upper, val, val.transpose(0, 1))
    return SoaUkfState(x=state.x + dx, p=p, sigma_f=sf)


def soa_guard(state: SoaUkfState, p_reset: torch.Tensor) -> SoaUkfState:
    """Per-instance NaN recovery (mirrors ``ukf.ukf_guard``): non-finite
    mean entries become 0, and a filter with any non-finite mean or
    covariance entry gets P = ``p_reset`` (n, n)."""
    bad = ~(torch.isfinite(state.x).all(dim=0) & torch.isfinite(state.p).flatten(0, 1).all(dim=0))
    x = torch.where(torch.isfinite(state.x), state.x, 0.0)
    p_reset = torch.as_tensor(p_reset, dtype=state.p.dtype, device=state.p.device)
    p = torch.where(bad, p_reset[:, :, None], state.p)
    return SoaUkfState(x=x, p=p, sigma_f=state.sigma_f)
