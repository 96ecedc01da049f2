"""Condensed-QP gradient MPC: the F/G/Q builders, the QP algebra and the
batched projected-Newton box-QP solver.

Port of ``mpc_rs_tpu/controllers/qp.py``. The reference rebuilds F, G and Q
inside every cost and gradient call (src/mpc.rs, examples/mpc-ukf-s.rs:158-177);
here they are built once in numpy float64 and cast to the solve's dtype on
its device. Prediction over the horizon: X = F x₀ + G U with

  F = [A; A²; …; Aᴺ]                 (src/mpc.rs:2-11)
  G[i,j] = A^(i−j) B  for j ≤ i      (src/mpc.rs:14-25)
  Q = blockdiag(C, …, C)             (src/mpc.rs:28-36)

Cost (examples/op-mpc-x-calc.rs:73-83): J(u) = uᵀGᵀQGu + 2(x₀ᵀFᵀ − x_refᵀ)QGu;
gradient (:90-98): ∇J = 2GᵀQ(Gu + Fx₀ − x_ref).

Every function takes a leading batch: x0 (..., s), u (..., N), x_ref
(..., sN), one row a problem, as the JAX package's are vmapped.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mpc_rs_tpu_torch.estimators.smallalg import spd_solve_unrolled


def create_f_matrix(a: np.ndarray, n: int) -> np.ndarray:
    """F = [A; A²; …; Aᴺ] — src/mpc.rs:2-11."""
    a = np.asarray(a, dtype=np.float64)
    s = a.shape[0]
    f = np.zeros((s * n, s))
    ai = np.eye(s)
    for i in range(n):
        ai = ai @ a
        f[s * i : s * (i + 1), :] = ai
    return f


def create_g_matrix(a: np.ndarray, b: np.ndarray, n: int) -> np.ndarray:
    """Lower-block-triangular G with blocks A^(i−j)B — src/mpc.rs:14-25."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64).reshape(a.shape[0], -1)
    s = a.shape[0]
    g = np.zeros((s * n, n))
    powers = [np.eye(s)]
    for _ in range(n - 1):
        powers.append(powers[-1] @ a)
    for i in range(n):
        for j in range(i + 1):
            g[s * i : s * (i + 1), j : j + 1] = powers[i - j] @ b
    return g


def create_q_matrix(c: np.ndarray, n: int) -> np.ndarray:
    """Q = blockdiag(C,…,C) — src/mpc.rs:28-36."""
    c = np.asarray(c, dtype=np.float64)
    s = c.shape[0]
    q = np.zeros((s * n, s * n))
    for i in range(n):
        q[s * i : s * (i + 1), s * i : s * (i + 1)] = c
    return q


class CondensedQp(NamedTuple):
    f: torch.Tensor  # (sN, s)
    g: torch.Tensor  # (sN, N)
    q: torch.Tensor  # (sN, sN)
    h: torch.Tensor  # GᵀQG (N, N), the Hessian over 2
    gq: torch.Tensor  # GᵀQ (N, sN), for the gradient

    @classmethod
    def from_numpy(cls, f, g, q, h, gq, *, dtype=torch.float64, device="cpu") -> "CondensedQp":
        """From five arrays (e.g. the JAX ``CondensedQp``'s fields), cast to
        ``dtype`` on ``device``."""
        return cls(*(torch.tensor(np.asarray(m), dtype=dtype, device=device) for m in (f, g, q, h, gq)))


def build_condensed_qp(a, b, c, n: int, dtype=torch.float64, device="cpu") -> CondensedQp:
    """F, G, Q, H = GᵀQG and GᵀQ of (A, B, C) over N steps, built in numpy
    float64 and cast to ``dtype`` on ``device``."""
    f = create_f_matrix(a, n)
    g = create_g_matrix(a, b, n)
    q = create_q_matrix(c, n)
    return CondensedQp.from_numpy(f, g, q, g.T @ q @ g, g.T @ q, dtype=dtype, device=device)


def qp_cost(qp: CondensedQp, x0, u, x_ref_flat):
    """J(u) — op-mpc-x-calc.rs:73-83. ``x_ref_flat`` (..., sN): the
    per-step references stacked step-major (the reference's column-major
    4×N flatten)."""
    gu = u @ qp.g.T
    fx = x0 @ qp.f.T
    left = (u * (u @ qp.h.T)).sum(dim=-1)
    right = 2.0 * ((fx - x_ref_flat) * (gu @ qp.q.T)).sum(dim=-1)
    return left + right


def qp_grad(qp: CondensedQp, x0, u, x_ref_flat):
    """∇J = 2GᵀQ(Gu + Fx₀ − x_ref) — op-mpc-x-calc.rs:90-98."""
    return 2.0 * ((u @ qp.g.T + x0 @ qp.f.T - x_ref_flat) @ qp.gq.T)


def qp_linear_term(qp: CondensedQp, x0, x_ref_flat):
    """b with J(u) = uᵀHu + bᵀu + const: b = 2GᵀQ(Fx₀ − x_ref), the affine
    part of ``qp_cost``. Broadcasts over leading batch dims: a fleet's B
    linear terms are two matmuls."""
    fx = x0 @ qp.f.T  # (…, sN)
    return 2.0 * ((fx - x_ref_flat) @ qp.gq.T)  # (…, N)


def active_set_inverse_table(h) -> torch.Tensor:
    """(2ⁿ, n, n) inverses of the projected-Newton system, one per
    active-set bitmask (bit i set ⇔ coordinate i bound-active): the free
    block holds inv(2H_FF), active rows and columns are the identity.
    Computed once in numpy float64 (``qp.py:112-129``) and cast to h's
    dtype on h's device; n = 8 is 256 entries (64 KB in float32)."""
    ht = torch.as_tensor(h)
    h2 = 2.0 * np.asarray(ht.detach().cpu().numpy(), np.float64)
    n = h2.shape[-1]
    tbl = np.zeros((2**n, n, n))
    for mask in range(2**n):
        act = np.array([(mask >> i) & 1 for i in range(n)], bool)
        m = (~act).astype(np.float64)
        a = np.outer(m, m) * h2 + np.diag(act.astype(np.float64))
        tbl[mask] = np.linalg.inv(a)
    return torch.as_tensor(tbl, dtype=ht.dtype, device=ht.device)


# the projected-gradient arc's step factors 4⁰ … 4⁻⁷ (qp.py:216-220)
PG_FACTORS = (1.0, 0.25, 0.0625, 0.015625, 0.00390625, 0.0009765625, 0.000244140625, 6.103515625e-05)


def box_qp_newton(h, b, u0, lo, hi, *, iters: int = 16, inv_table=None, safeguard: bool = True,
                  safeguard_iters: int = 8):
    """Batched projected-Newton solve of  min uᵀHu + bᵀu,  lo ≤ u ≤ hi
    (``qp.py:132-252``), the two-metric projected Newton method (Bertsekas
    1982) on the condensed QP, whose Hessian 2H is a known constant.

    Each of ``iters`` Newton iterations takes the binding set from the sign
    of the gradient at the bounds (``eps = 1e-6·(hi − lo)``), takes the exact
    Newton step on the free block and clips; the best-cost iterate is
    kept, so the fixed budget is monotone. The free-block solve is either
    the masked SPD solve (``spd_solve_unrolled``) or, with ``inv_table``
    (``active_set_inverse_table(h)``), the mask bits' index into the table,
    a gather and a matvec.

    ``safeguard``: the clipped Newton step can cycle between active sets on
    ill-conditioned problems with asymmetric bounds; the Newton phase is
    then followed, from its best iterate, by ``safeguard_iters``
    projected-gradient-arc steps (the Cauchy step of the unconstrained
    quadratic along −g times ``PG_FACTORS``, the cheapest candidate by its
    first index, kept only if better) and a second Newton phase of
    max(4, iters // 2) iterations. At a KKT point both phases keep it.

    ``h`` (N, N) is shared by the batch; ``b`` and ``u0`` (..., N). The
    dtype is u0's. Returns the best iterate (..., N).
    """
    dtype, dev = u0.dtype, u0.device
    h2 = 2.0 * torch.as_tensor(h, dtype=dtype, device=dev)
    n = h2.shape[-1]
    eye = torch.eye(n, dtype=dtype, device=dev)
    lo = torch.as_tensor(lo, dtype=dtype, device=dev)
    hi = torch.as_tensor(hi, dtype=dtype, device=dev)
    eps = 1e-6 * (hi - lo)
    b = torch.as_tensor(b, dtype=dtype, device=dev)
    bits = 2 ** torch.arange(n, device=dev)

    def cost(u):
        return (u * (u @ h2) * 0.5 + b * u).sum(dim=-1)

    def newton_step(u, best_u, best_j):
        g = u @ h2 + b
        act = ((u <= lo + eps) & (g > 0)) | ((u >= hi - eps) & (g < 0))
        m = (~act).to(dtype)
        if inv_table is not None:
            idx = (act.to(bits.dtype) * bits).sum(dim=-1)
            d = (inv_table[idx] @ (-g * m)[..., None])[..., 0]
        else:
            a = m[..., :, None] * m[..., None, :] * h2 + (1.0 - m)[..., :, None] * eye
            d = spd_solve_unrolled(a, (-g * m)[..., None])[..., 0]
        u = torch.clamp(u + d, lo, hi)
        j = cost(u)
        better = j < best_j
        return u, torch.where(better[..., None], u, best_u), torch.minimum(j, best_j)

    def pg_step(u, best_u, best_j):
        g = u @ h2 + b
        ghg = (g * (g @ h2)).sum(dim=-1)
        t_star = (g * g).sum(dim=-1) / torch.clamp(ghg, min=1e-30)
        cands = torch.stack([torch.clamp(u - (t_star * f)[..., None] * g, lo, hi) for f in PG_FACTORS])
        js = cost(cands)
        pick = torch.argmin(js, dim=0)  # the first index of the minimum
        j_new = js.amin(dim=0)
        u_new = torch.gather(cands.movedim(0, -2), -2, pick[..., None, None].expand(*pick.shape, 1, n))[..., 0, :]
        take = j_new < best_j
        u = torch.where(take[..., None], u_new, best_u)
        return u, u, torch.minimum(j_new, best_j)

    u = torch.clamp(u0, lo, hi)
    carry = (u, u, cost(u))
    for _ in range(iters):
        carry = newton_step(*carry)
    if safeguard:
        carry = (carry[1], carry[1], carry[2])  # both phases restart from the best iterate
        for _ in range(safeguard_iters):
            carry = pg_step(*carry)
        carry = (carry[1], carry[1], carry[2])
        for _ in range(max(4, iters // 2)):
            carry = newton_step(*carry)
    return carry[1]


class QpValueAndGrad:
    """value_and_grad(u) of the condensed QP at one state: ``qp_cost`` and
    ``qp_grad``'s values, operation for operation, with Fx₀ and the
    residual Fx₀ − x_ref taken once a state and Gu once a call.

    A closure over static tensors: ``graph_tensors`` are the per-state
    tensors (Fx₀, x_ref, Fx₀ − x_ref), ``rebind(tensors)`` the same oracle
    over other tensors of their shapes, and ``graph_key`` names the QP, so
    ``panoc_solve`` on a card replays its segments from CUDA graphs
    captured once over static copies of them."""

    def __init__(self, qp: CondensedQp, fx: torch.Tensor, x_ref_flat: torch.Tensor, res0: torch.Tensor):
        self.qp, self.fx, self.x_ref_flat, self.res0 = qp, fx, x_ref_flat, res0

    @property
    def graph_tensors(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return self.fx, self.x_ref_flat, self.res0

    @property
    def graph_key(self) -> int:
        return id(self.qp)  # the cached graphs hold the QP, so its id is not reused while they live

    def rebind(self, tensors) -> "QpValueAndGrad":
        return QpValueAndGrad(self.qp, *tensors)

    def __call__(self, u):
        qp = self.qp
        gu = u @ qp.g.T
        cost = (u * (u @ qp.h.T)).sum(dim=-1) + 2.0 * (self.res0 * (gu @ qp.q.T)).sum(dim=-1)
        return cost, 2.0 * ((gu + self.fx - self.x_ref_flat) @ qp.gq.T)


def make_qp_value_and_grad(qp: CondensedQp, gen_ref):
    """(x0) → value_and_grad(u) for ``panoc_solve`` (a ``QpValueAndGrad``):
    ``gen_ref(x0) -> (..., N, s)`` time-major references, flattened
    step-major (op-mpc-x-calc.rs:80)."""

    def for_state(x0):
        x_ref_flat = gen_ref(x0).flatten(-2)
        fx = x0 @ qp.f.T
        return QpValueAndGrad(qp, fx, x_ref_flat, fx - x_ref_flat)

    return for_state
