"""Linear Kalman filter of examples/two-liner-kf.rs.

Port of ``mpc_rs_tpu/estimators/kf.py:13-36``: the state is (x, p), and
F, Q, H, R and B are passed in. The update is the Joseph form
(two-liner-kf.rs:47-51).
"""

from __future__ import annotations

import torch


def kf_predict(x, p, f, q, u=None, b=None):
    """x' = Fx (+ Bu); P' = FPFᵀ + Q — examples/two-liner-kf.rs:17-27."""
    x = f @ x if u is None else f @ x + b @ u
    p = f @ p @ f.T + q
    return x, p


def kf_update_joseph(x, p, z, h, r):
    """Joseph-form measurement update — examples/two-liner-kf.rs:35-53:
    S = HPHᵀ + R; K = PHᵀS⁻¹ by a linear solve of SᵀKᵀ = (PHᵀ)ᵀ;
    x += K(z − Hx); P = (I − KH)P(I − KH)ᵀ + KRKᵀ."""
    s = h @ p @ h.T + r
    k = torch.linalg.solve(s.T, (p @ h.T).T).T
    x = x + k @ (z - h @ x)
    i_kh = torch.eye(p.shape[-1], dtype=p.dtype, device=p.device) - k @ h
    p = i_kh @ p @ i_kh.T + k @ r @ k.T
    return x, p
