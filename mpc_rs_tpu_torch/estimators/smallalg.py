"""Unrolled small-matrix linear algebra for the batched estimators.

Port of ``mpc_rs_tpu/estimators/smallalg.py:82-141``: cyclic Jacobi with
the same rotation order, the same rotation arithmetic and ``sweeps=4``, so
the sigma-point directions of the port's UKF are the JAX package's.
"""

from __future__ import annotations

import torch


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
