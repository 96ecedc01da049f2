"""Unrolled small-matrix linear algebra for the batched estimators.

Port of ``mpc_rs_tpu/estimators/smallalg.py``: the unrolled Cholesky
factor, solve and SPD solve (``:16-79``), and cyclic Jacobi with the same
rotation order, the same rotation arithmetic and ``sweeps=4`` (``:82-216``),
so the sigma-point directions of the port's UKF are the JAX package's.
State dims are 2..6, so every factorization unrolls into a few dozen
elementwise tensor ops over the batch. All functions broadcast over leading
batch dims (Jacobi on the SoA layout: over trailing ones).
"""

from __future__ import annotations

import torch

from mpc_rs_tpu_torch.models.dynamics import _div


def _trace(s: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(s, dim1=-2, dim2=-1).sum(dim=-1)


def mean_diag(s: torch.Tensor) -> torch.Tensor:
    """The mean of the diagonal of (..., n, n): the trace over n, one IEEE
    division on every device (``models.dynamics._div``)."""
    return _div(_trace(s), s.shape[-1])


def chol_unrolled(s: torch.Tensor, eps_rel: float = 1e-12) -> torch.Tensor:
    """Lower-triangular L with L Lᵀ = s for SPD s (..., n, n), unrolled.

    Near-PSD semantics (``smallalg.py:16-42``): a pivot that is
    ≤ eps_rel·mean-diag zeroes its whole column instead of producing a
    ~1/√eps explosion or NaNs, as the eigh root clamps its eigenvalues."""
    n = s.shape[-1]
    floor = eps_rel * (mean_diag(s) + 1e-30)
    l = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            acc = s[..., i, j]
            for k in range(j):
                acc = acc - l[i][k] * l[j][k]
            if i == j:
                l[i][j] = torch.sqrt(torch.clamp(acc, min=0.0))
            else:
                piv = l[j][j]
                good = piv * piv > floor
                l[i][j] = torch.where(good, acc / torch.where(good, piv, 1.0), 0.0)
    zero = torch.zeros_like(s[..., 0, 0])
    rows = [torch.stack([l[i][j] if j <= i else zero for j in range(n)], dim=-1) for i in range(n)]
    return torch.stack(rows, dim=-2)


def chol_solve_unrolled(l: torch.Tensor, b: torch.Tensor, eps: float = 1e-25) -> torch.Tensor:
    """x with (L Lᵀ) x = b for lower-triangular L (..., n, n), b (..., n, m):
    forward then backward substitution. A zeroed pivot column (see
    ``chol_unrolled``) gives zero solution components, not infinities."""
    n = l.shape[-1]

    def safe_div(num, piv):
        good = piv * piv > eps
        return torch.where(good, num / torch.where(good, piv, 1.0), 0.0)

    y = [None] * n
    for i in range(n):
        acc = b[..., i, :]
        for k in range(i):
            acc = acc - l[..., i, k, None] * y[k]
        y[i] = safe_div(acc, l[..., i, i, None])
    x = [None] * n
    for i in reversed(range(n)):
        acc = y[i]
        for k in range(i + 1, n):
            acc = acc - l[..., k, i, None] * x[k]
        x[i] = safe_div(acc, l[..., i, i, None])
    return torch.stack(x, dim=-2)


def spd_solve_unrolled(a: torch.Tensor, b: torch.Tensor, jitter_rel: float = 0.0) -> torch.Tensor:
    """x with a x = b for SPD a (..., n, n), b (..., n, m), fully unrolled."""
    if jitter_rel:
        n = a.shape[-1]
        eye = torch.eye(n, dtype=a.dtype, device=a.device)
        a = a + (jitter_rel * mean_diag(a))[..., None, None] * eye
    return chol_solve_unrolled(chol_unrolled(a), b)


def jacobi_entries(a: torch.Tensor, sweeps: int = 4) -> tuple[torch.Tensor, torch.Tensor]:
    """Cyclic Jacobi on symmetric matrices stored with the (n, n) pair as
    the LEADING axes, ``a`` of shape (n, n, *batch) (batch minor, as the
    fleet's SoA layout keeps it).

    Returns (w (n, *batch) eigenvalues, v (n, n, *batch) whose columns are
    the eigenvectors): a ≈ v · diag(w) · vᵀ. Each rotation updates rows
    p, q, then columns p, q of ``a``, then columns p, q of ``v``, exactly as
    ``_jacobi_stacked_leading`` rebuilds them with ``jnp.stack``.
    """
    n = a.shape[0]
    a = a.clone()
    v = torch.zeros_like(a)
    for i in range(n):
        v[i, i] = 1.0
    for _ in range(sweeps):
        for p_ in range(n - 1):
            for q_ in range(p_ + 1, n):
                app, aqq, apq = a[p_, p_], a[q_, q_], a[p_, q_]
                small = torch.abs(apq) < 1e-30
                theta = (aqq - app) / torch.where(small, 1.0, 2.0 * apq)
                t = torch.sign(theta) / (torch.abs(theta) + torch.sqrt(theta * theta + 1.0))
                t = torch.where(small, 0.0, t)
                c = 1.0 / torch.sqrt(t * t + 1.0)
                s = t * c
                rp, rq = a[p_].clone(), a[q_].clone()
                a[p_] = c * rp - s * rq
                a[q_] = s * rp + c * rq
                cp, cq = a[:, p_].clone(), a[:, q_].clone()
                a[:, p_] = c * cp - s * cq
                a[:, q_] = s * cp + c * cq
                vp, vq = v[:, p_].clone(), v[:, q_].clone()
                v[:, p_] = c * vp - s * vq
                v[:, q_] = s * vp + c * vq
    return torch.diagonal(a, dim1=0, dim2=1).movedim(-1, 0), v


def eigh_jacobi_unrolled(s: torch.Tensor, sweeps: int = 4) -> tuple[torch.Tensor, torch.Tensor]:
    """(eigenvalues (..., n), eigenvectors (..., n, n)) of symmetric s by
    ``sweeps`` unrolled cyclic Jacobi sweeps (``smallalg.py:194-216``):
    ``jacobi_entries`` on s with its (n, n) pair moved to the leading axes.
    Columns of v are eigenvectors: s ≈ v · diag(w) · vᵀ."""
    w, v = jacobi_entries(s.movedim((-2, -1), (0, 1)), sweeps)
    return w.movedim(0, -1), v.movedim((0, 1), (-2, -1))
