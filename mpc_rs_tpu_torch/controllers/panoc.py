"""PANOC: box/ball-constrained gradient MPC in batched torch ops.

Port of ``mpc_rs_tpu/controllers/panoc.py``, the reference's
``optimization_engine`` PANOC (an L-BFGS direction on the fixed-point
residual of the projected gradient step, a forward-backward-envelope line
search with τ-halving and a pure-prox fallback; examples/op-mpc-x.rs:158-199,
mpc-ukf-s.rs:246-263, op-en2.rs:22-34) with the JAX package's fixed
iteration budget ``max_iter`` in place of the reference's wall-clock one.

A solve takes a batch: u0 (..., n), one row a problem, and the cost or its
oracle maps (..., n) to (...) and (..., n). The three loops of the JAX
solver (the outer one, the γ backtrack and the τ line search) are
``lax.while_loop``s, which under ``vmap`` run while any lane's condition
holds and update only those lanes. Here each loop is a Python loop that
reads back one ``.any()`` an iteration and masks every carry field with
``torch.where``, so a batch equals a loop over its lanes: a lane that
finished does not move, and ``iterations`` is a lane's own.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

# host read-backs of the loops' conditions since the last reset (one each
# time a loop asks whether any lane goes on): on a card each waits for the
# device, which is what a solve's host syncs cost
readbacks = 0


def reset_readbacks() -> None:
    global readbacks
    readbacks = 0


def _readback(t: torch.Tensor) -> list:
    global readbacks
    readbacks += 1
    return t.tolist()


def _any(mask: torch.Tensor) -> bool:
    return bool(_readback(mask.any()))


def box_projection(lo, hi):
    """constraints::Rectangle — op-mpc-x.rs:188."""
    return lambda u: torch.clamp(u, lo, hi)


def ball2_projection(radius: float, center=None):
    """constraints::Ball2 — examples/op-en2.rs:26, a ball a row."""

    def proj(u):
        d = u if center is None else u - center
        norm = torch.sqrt((d * d).sum(dim=-1, keepdim=True))
        scale = torch.where(norm > radius, radius / torch.clamp(norm, min=1e-30), 1.0)
        p = d * scale
        return p if center is None else p + center

    return proj


def no_projection():
    return lambda u: u


@dataclasses.dataclass(frozen=True)
class PanocConfig:
    tol: float = 1e-6  # PANOCCache tolerance (op-mpc-x.rs:158)
    max_iter: int = 100  # fixed budget replacing max_duration
    lbfgs_mem: int = 20  # lbfgs_memory (op-mpc-x.rs:159)
    gamma_init: float | None = None  # None → estimate from the first gradient
    max_ls: int = 10  # τ-halvings per line search
    sigma: float = 1e-4  # sufficient-decrease coefficient
    # 0 = γ only ever shrinks, the reference solver's behavior class; N > 0 =
    # every N iterations attempt γ ← min(2γ, γ₀) (panoc.py:74-80)
    gamma_recovery_period: int = 0


class LbfgsMem(NamedTuple):
    s: torch.Tensor  # (..., m, n) past steps
    y: torch.Tensor  # (..., m, n) past residual differences
    rho: torch.Tensor  # (..., m) 1/(sᵀy), 0 where a slot is unused
    idx: torch.Tensor  # (...) pushes since the last flush; the next slot is idx % m


class PanocResult(NamedTuple):
    u: torch.Tensor
    iterations: torch.Tensor  # int32
    converged: torch.Tensor  # bool
    fpr_norm: torch.Tensor  # ‖u − T(u)‖∞ / γ at exit
    cost: torch.Tensor  # f(u) at exit
    gamma: torch.Tensor  # final step size (Lipschitz estimate: L ≈ 0.95/γ)


def _dot(a, b):
    return (a * b).sum(dim=-1)


def _where(mask, a, b):
    """``torch.where`` with a (...) lane mask over (..., *trailing) fields
    (``a`` may be a Python number)."""
    return torch.where(mask.reshape(mask.shape + (1,) * (b.dim() - mask.dim())), a, b)


def _lbfgs_init(n: int, m: int, dtype, batch=(), device=None) -> LbfgsMem:
    z = dict(dtype=dtype, device=device)
    return LbfgsMem(s=torch.zeros(*batch, m, n, **z), y=torch.zeros(*batch, m, n, **z),
                    rho=torch.zeros(*batch, m, **z), idx=torch.zeros(batch, dtype=torch.int64, device=device))


def _lbfgs_direction(mem: LbfgsMem, g: torch.Tensor, n_used: int | None = None) -> torch.Tensor:
    """The two-loop recursion d ≈ −H·g (``panoc.py:96-124``) over the slots
    from the most recent, ``(idx − 1 − j) % m``, to the oldest, with the
    initial scaling h0 = sᵀy/yᵀy of slot ``idx − 1`` (1 where that slot is
    empty, yᵀy = 0).

    Each loop's recurrence is a unit-triangular system in the slots'
    coefficients: the first loop's α_j = ρ_j (s_j·g − Σ_{i<j} α_i s_j·y_i),
    the second's β_j = ρ_j (y_j·h0 q + Σ_{i>j} (α_i − β_i) y_j·s_i). So the
    m sequential vector updates become two Gram products and two
    triangular solves, a dozen launches whatever m, with the recursion's
    values (its sums taken in another order).

    ``n_used``: a bound, known to the caller, on the filled slots of every
    lane (the slots past it hold s = y = 0 and ρ = 0, so their terms are
    exact zeros for finite vectors, and are left out; None: all m)."""
    m = mem.s.shape[-2]
    k = m if n_used is None else min(m, n_used)
    if k == 0:  # every slot empty: h0 = 1 and the recursion is the identity
        return -g
    order = (mem.idx[..., None] - 1 - torch.arange(k, device=g.device)) % m  # (..., k), most recent first
    s = torch.take_along_dim(mem.s, order[..., None], dim=-2)
    y = torch.take_along_dim(mem.y, order[..., None], dim=-2)
    rho = torch.take_along_dim(mem.rho, order, dim=-1)
    # products and sums elementwise, no matmul: a lane's numbers do not
    # depend on the batch around it
    sy = _dot(s[..., :, None, :], y[..., None, :, :])  # sy[j, i] = s_j·y_i
    eye = torch.eye(k, dtype=g.dtype, device=g.device)
    first = eye + rho[..., :, None] * torch.tril(sy, -1)
    alpha = torch.linalg.solve_triangular(first, (rho * _dot(s, g[..., None, :]))[..., None], upper=False,
                                          unitriangular=True)[..., 0]
    q = g - (alpha[..., None] * y).sum(dim=-2)
    yy = _dot(y[..., 0, :], y[..., 0, :])
    h0 = torch.where(yy > 0, sy[..., 0, 0] / torch.clamp(yy, min=1e-30), 1.0)
    r = h0[..., None] * q
    ys = torch.triu(sy.transpose(-1, -2), 1)  # ys[j, i] = y_j·s_i for the older slots i > j
    second = eye + rho[..., :, None] * ys
    rhs = rho * (_dot(y, r[..., None, :]) + _dot(ys, alpha[..., None, :]))
    beta = torch.linalg.solve_triangular(second, rhs[..., None], upper=True, unitriangular=True)[..., 0]
    return -(r + ((alpha - beta)[..., None] * s).sum(dim=-2))


def _lbfgs_push(mem: LbfgsMem, s: torch.Tensor, y: torch.Tensor) -> LbfgsMem:
    """Store (s, y) in slot idx % m when sᵀy > 1e-12·√(sᵀs·yᵀy)
    (``panoc.py:127-138``), else keep the memory."""
    sy = _dot(s, y)
    good = sy > 1e-12 * torch.sqrt(_dot(s, s) * _dot(y, y))
    rho = torch.where(good, 1.0 / torch.where(good, sy, 1.0), 0.0)
    m = mem.s.shape[-2]
    # (one_hot would read the index back to check it: a host sync)
    slot = (torch.arange(m, device=s.device) == (mem.idx % m)[..., None]) & good[..., None]  # (..., m)
    return LbfgsMem(s=_where(slot, s[..., None, :].expand_as(mem.s), mem.s),
                    y=_where(slot, y[..., None, :].expand_as(mem.y), mem.y),
                    rho=torch.where(slot, rho[..., None], mem.rho),
                    idx=torch.where(good, mem.idx + 1, mem.idx))


def autograd_value_and_grad(f: Callable) -> Callable:
    """value_and_grad(u) of a cost that maps (..., n) to (...) with the rows
    independent: the gradient of the summed costs by ``torch.autograd``
    (the JAX package's ``jax.value_and_grad(f)``)."""

    def vg(u):
        with torch.enable_grad():
            uu = u.detach().requires_grad_(True)
            val = f(uu)
            (grad,) = torch.autograd.grad(val.sum(), uu)
        return val.detach(), grad

    return vg


def panoc_solve(cfg: PanocConfig, f: Callable | None, proj: Callable, u0: torch.Tensor,
                value_and_grad: Callable | None = None) -> PanocResult:
    """Minimize f(u) s.t. u ∈ C (by ``proj``) from the warm start u0 (..., n)
    (``panoc.py:141-296``). ``f`` must be differentiable by torch.autograd
    unless ``value_and_grad`` is given (e.g. a finite-difference oracle, or
    the condensed QP's), in which case ``f`` may be None and cost values
    come from the oracle."""
    if value_and_grad is None:
        vg, f_eval = autograd_value_and_grad(f), f
    else:
        vg = value_and_grad
        f_eval = f if f is not None else (lambda u: vg(u)[0])
    dtype, dev = u0.dtype, u0.device
    n, batch, m = u0.shape[-1], u0.shape[:-1], cfg.lbfgs_mem

    f0, g0 = vg(u0)
    if cfg.gamma_init is None:
        # conservative local Lipschitz estimate from the first gradient
        gnorm = torch.sqrt(_dot(g0, g0))
        gamma0 = torch.where(gnorm > 0, 0.95 / torch.clamp(gnorm, min=1e-10), 1.0)
        gamma0 = torch.clamp(gamma0, max=1.0).to(dtype)
    else:
        gamma0 = torch.full(batch, cfg.gamma_init, dtype=dtype, device=dev)

    # a lane moves only under its loop's mask; one problem (no batch axis)
    # is inside a loop only while its condition holds, so it needs no mask
    batched = len(batch) > 0

    def sel(mask, new, old):
        return _where(mask, new, old) if batched else new

    def step_to(u, g_u, gamma):
        return proj(u - gamma[..., None] * g_u)

    def backtrack_gamma(u, f_u, g_u, gamma, lanes):
        """Halve γ, in ``lanes``, until the local descent (Lipschitz)
        condition holds, at most 40 times (``panoc.py:175-196``)."""
        z = step_to(u, g_u, gamma)
        k = torch.zeros(batch, dtype=torch.int32, device=dev)

        def violated(gamma, z, k):
            d = z - u
            rhs = f_u + _dot(g_u, d) + _dot(d, d) / (2 * gamma) + 1e-10 * torch.abs(f_u)
            more = (f_eval(z) > rhs) & (k < 40)
            return more & lanes if batched else more

        more = violated(gamma, z, k)
        while _any(more):
            gamma = sel(more, gamma * 0.5, gamma)
            z = sel(more, step_to(u, g_u, gamma), z)
            k = sel(more, k + 1, k)
            more = violated(gamma, z, k)
        return gamma, z

    u, f_u, g_u, gamma = u0, f0, g0, gamma0
    mem = _lbfgs_init(n, m, dtype, batch, dev)
    it = torch.zeros(batch, dtype=torch.int32, device=dev)
    converged = torch.zeros(batch, dtype=torch.bool, device=dev)
    fpr = torch.full(batch, float("inf"), dtype=dtype, device=dev)
    active = (it < cfg.max_iter) & ~converged
    any_active, n_used = cfg.max_iter > 0, 0
    while any_active:
        gamma_try = gamma
        if cfg.gamma_recovery_period > 0:
            period = cfg.gamma_recovery_period
            recover = (it % period) == (period - 1)
            gamma_try = torch.where(recover, torch.minimum(2.0 * gamma, gamma0), gamma)
        gamma_n, z = backtrack_gamma(u, f_u, g_u, gamma_try, active)
        r = u - z  # γ·R(u)
        fpr_n = torch.abs(r).amax(dim=-1) / gamma_n
        conv_n = fpr_n <= cfg.tol

        # γ changed ⇒ flush the L-BFGS memory (panoc.py:224-236)
        changed = gamma_n != gamma
        mem_n = LbfgsMem(*(_where(changed, 0, v) for v in mem))

        rr = _dot(r, r)
        phi_u = f_u + _dot(g_u, z - u) + rr / (2 * gamma_n)
        d = _lbfgs_direction(mem_n, r, n_used)

        # τ line search: u⁺ = u − (1−τ)r + τd, τ ∈ {1, ½, …}; fallback τ=0 ⇒ z
        tau = torch.ones(batch, dtype=dtype, device=dev)
        best_u, accepted = z, torch.zeros(batch, dtype=torch.bool, device=dev)
        k = torch.zeros(batch, dtype=torch.int32, device=dev)
        bar = phi_u - cfg.sigma * rr / gamma_n
        searching = active & (k < cfg.max_ls)
        while _any(searching):
            u_try = u - (1.0 - tau)[..., None] * r + tau[..., None] * d
            f_try, g_try = vg(u_try)
            d_try = step_to(u_try, g_try, gamma_n) - u_try
            phi_try = f_try + _dot(g_try, d_try) + _dot(d_try, d_try) / (2 * gamma_n)
            ok = phi_try <= bar
            best_u = _where(searching & ok & ~accepted if batched else ok, u_try, best_u)
            accepted = sel(searching, accepted | ok, accepted)
            tau = sel(searching, tau * 0.5, tau)
            k = sel(searching, k + 1, k)
            searching = ~accepted & (k < cfg.max_ls)
            searching = searching & active if batched else searching
        u_new = _where(accepted, best_u, z)  # the prox fallback always decreases
        u_new = _where(conv_n, u, u_new)

        f_new, g_new = vg(u_new)
        r_new = u_new - step_to(u_new, g_new, gamma_n)
        mem_n = _lbfgs_push(mem_n, u_new - u, r_new - r)

        u, f_u, g_u = sel(active, u_new, u), sel(active, f_new, f_u), sel(active, g_new, g_u)
        gamma = sel(active, gamma_n, gamma)
        mem = LbfgsMem(*(sel(active, a, b) for a, b in zip(mem_n, mem)))
        it = sel(active, it + 1, it)
        converged = sel(active, conv_n, converged)
        fpr = sel(active, fpr_n, fpr)
        active = (it < cfg.max_iter) & ~converged
        # one read-back: whether a lane goes on, and its memory's fill
        any_active, n_used = _readback(torch.stack([active.any().to(torch.int64),
                                                    torch.where(active, mem.idx, 0).amax()]))
    return PanocResult(u=u, iterations=it, converged=converged, fpr_norm=fpr, cost=f_u, gamma=gamma)


def make_fd_value_and_grad(f: Callable, eps: float = 1e-3):
    """Plain central-difference gradient of ``f`` (``panoc.py:299-313``;
    EPS as op-mpc-x.rs:131). The textbook scheme, not the reference's: see
    ``make_shifted_fd_value_and_grad``. ``f`` maps (..., n) to (...)."""

    def vg(u):
        e = torch.eye(u.shape[-1], dtype=u.dtype, device=u.device) * eps
        f_pos = f(u[..., None, :] + e)
        f_neg = f(u[..., None, :] - e)
        return f(u), (f_pos - f_neg) / (2 * eps)

    return vg


def make_shifted_fd_value_and_grad(cost_from_state: Callable, step: Callable, eps: float = 1e-3):
    """The reference's numeric gradient, op-mpc-x.rs:132-151, quirk kept
    (``panoc.py:316-344``): component i differentiates the cost evaluated
    from ``dynamics_cpy(x, u[i])``, the state pre-stepped once by u[i], not
    from x, so df is inconsistent with f by one plant step a component.

    ``cost_from_state(x, u) -> (...)`` and ``step(x, u) -> x`` in vector
    form. Returns ``vg(x) -> (u) -> (f(u), df(u))``, f(u) = cost_from_state(x, u)."""

    def make(x):
        def vg(u):
            e = torch.eye(u.shape[-1], dtype=u.dtype, device=u.device) * eps
            x_pre = step(x[..., None, :], u)  # (..., N, S) — :135-136
            uu = u[..., None, :]
            grad = (cost_from_state(x_pre, uu + e) - cost_from_state(x_pre, uu - e)) / (2 * eps)
            return cost_from_state(x, u), grad

        return vg

    return make
