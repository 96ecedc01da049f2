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

The operations between two read-backs are straight-line segments
(``_Segments``). On a card a solve whose value-and-grad is a closure over
static tensors (the condensed QP's, ``controllers/qp.py``) replays each
segment from a CUDA graph captured on its first solve (``_GraphSolve``):
the same operations in the same order, the same read-backs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

# host read-backs of the loops' conditions since the last reset (one each
# time a loop asks whether any lane goes on): on a card each waits for the
# device, which is what a solve's host syncs cost; and the CUDA-graph
# replays of the solves' segments (one a segment run on a card)
readbacks = 0
replays = 0


def reset_readbacks() -> None:
    """Zero ``readbacks`` and ``replays``."""
    global readbacks, replays
    readbacks = replays = 0


def _readback(t: torch.Tensor) -> list:
    global readbacks
    readbacks += 1
    return t.tolist()


@dataclasses.dataclass(frozen=True)
class BoxProjection:
    """constraints::Rectangle — op-mpc-x.rs:188: clamp to [lo, hi]. A value
    (hashable), so a solve's CUDA graphs can be keyed by it."""

    lo: float
    hi: float

    def __call__(self, u):
        return torch.clamp(u, self.lo, self.hi)


def box_projection(lo, hi) -> BoxProjection:
    """constraints::Rectangle — op-mpc-x.rs:188."""
    return BoxProjection(lo, hi)


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


class _Segments:
    """The straight-line stretches of a PANOC solve (``panoc.py:141-296``)
    between its host read-backs, each a function of the solve's state (a
    dict of tensors) that returns the tensors it sets, the flag the next
    read-back takes among them:

    - ``init``: the first oracle call, γ₀, the empty memory;
    - ``bt_start``: an iteration's γ to try, its first projected step and
      the backtrack's ``violated`` check (read back: any lane violated);
    - ``bt_step``: one backtrack halving, its step and ``violated``;
    - ``post``: the fixed-point residual, the memory flush, the L-BFGS
      direction over the filled slots (``n_used``) and the line search's
      start (read back: any lane searching);
    - ``ls_trial``: one line-search trial (read back: any lane searching);
    - ``update``: the accepted point, its oracle call, the memory push, the
      masked carry (read back: any lane active, and the memory's fill).

    The eager solve runs them in this order on a dict; on a card
    ``_GraphSolve`` replays each from a CUDA graph captured on static
    buffers: the same operations in the same order."""

    def __init__(self, cfg: PanocConfig, vg: Callable, f_eval: Callable, proj: Callable, u0: torch.Tensor):
        self.cfg, self.vg, self.f_eval, self.proj = cfg, vg, f_eval, proj
        self.dtype, self.dev = u0.dtype, u0.device
        self.n, self.batch, self.m = u0.shape[-1], u0.shape[:-1], cfg.lbfgs_mem
        # a lane moves only under its loop's mask; one problem (no batch axis)
        # is inside a loop only while its condition holds, so it needs no mask
        self.batched = len(self.batch) > 0

    def sel(self, mask, new, old):
        return _where(mask, new, old) if self.batched else new

    def step_to(self, u, g_u, gamma):
        return self.proj(u - gamma[..., None] * g_u)

    def violated(self, st, gamma, z, k):
        """The local descent (Lipschitz) condition fails, in the active lanes,
        at most 40 halvings (``panoc.py:175-196``)."""
        u, f_u, g_u = st["u"], st["f_u"], st["g_u"]
        d = z - u
        rhs = f_u + _dot(g_u, d) + _dot(d, d) / (2 * gamma) + 1e-10 * torch.abs(f_u)
        more = (self.f_eval(z) > rhs) & (k < 40)
        return more & st["active"] if self.batched else more

    def init(self, st):
        cfg, batch, dtype, dev = self.cfg, self.batch, self.dtype, self.dev
        u0 = st["u0"]
        f0, g0 = self.vg(u0)
        if cfg.gamma_init is None:
            # conservative local Lipschitz estimate from the first gradient
            gnorm = torch.sqrt(_dot(g0, g0))
            gamma0 = torch.where(gnorm > 0, 0.95 / torch.clamp(gnorm, min=1e-10), 1.0)
            gamma0 = torch.clamp(gamma0, max=1.0).to(dtype)
        else:
            gamma0 = torch.full(batch, cfg.gamma_init, dtype=dtype, device=dev)
        mem = _lbfgs_init(self.n, self.m, dtype, batch, dev)
        it = torch.zeros(batch, dtype=torch.int32, device=dev)
        converged = torch.zeros(batch, dtype=torch.bool, device=dev)
        fpr = torch.full(batch, float("inf"), dtype=dtype, device=dev)
        active = (it < cfg.max_iter) & ~converged
        return dict(u=u0, f_u=f0, g_u=g0, gamma=gamma0, gamma0=gamma0, s=mem.s, y=mem.y, rho=mem.rho, idx=mem.idx,
                    it=it, converged=converged, fpr=fpr, active=active)

    def bt_start(self, st):
        gamma_try = st["gamma"]
        if self.cfg.gamma_recovery_period > 0:
            period = self.cfg.gamma_recovery_period
            recover = (st["it"] % period) == (period - 1)
            gamma_try = torch.where(recover, torch.minimum(2.0 * st["gamma"], st["gamma0"]), st["gamma"])
        z = self.step_to(st["u"], st["g_u"], gamma_try)
        k = torch.zeros(self.batch, dtype=torch.int32, device=self.dev)
        more = self.violated(st, gamma_try, z, k)
        return dict(bt_gamma=gamma_try, z=z, bt_k=k, more=more, more_any=more.any())

    def bt_step(self, st):
        more = st["more"]
        gamma = self.sel(more, st["bt_gamma"] * 0.5, st["bt_gamma"])
        z = self.sel(more, self.step_to(st["u"], st["g_u"], gamma), st["z"])
        k = self.sel(more, st["bt_k"] + 1, st["bt_k"])
        more = self.violated(st, gamma, z, k)
        return dict(bt_gamma=gamma, z=z, bt_k=k, more=more, more_any=more.any())

    def post(self, st, n_used: int):
        cfg, batch, dtype, dev = self.cfg, self.batch, self.dtype, self.dev
        u, f_u, g_u, gamma_n, z = st["u"], st["f_u"], st["g_u"], st["bt_gamma"], st["z"]
        r = u - z  # γ·R(u)
        fpr_n = torch.abs(r).amax(dim=-1) / gamma_n
        conv_n = fpr_n <= cfg.tol
        # γ changed ⇒ flush the L-BFGS memory (panoc.py:224-236)
        changed = gamma_n != st["gamma"]
        mem_n = LbfgsMem(*(_where(changed, 0, st[k]) for k in ("s", "y", "rho", "idx")))
        rr = _dot(r, r)
        phi_u = f_u + _dot(g_u, z - u) + rr / (2 * gamma_n)
        d = _lbfgs_direction(mem_n, r, n_used)
        # τ line search: u⁺ = u − (1−τ)r + τd, τ ∈ {1, ½, …}; fallback τ=0 ⇒ z
        tau = torch.ones(batch, dtype=dtype, device=dev)
        accepted = torch.zeros(batch, dtype=torch.bool, device=dev)
        k = torch.zeros(batch, dtype=torch.int32, device=dev)
        bar = phi_u - cfg.sigma * rr / gamma_n
        searching = st["active"] & (k < cfg.max_ls)
        return dict(gamma_n=gamma_n, r=r, fpr_n=fpr_n, conv_n=conv_n, mn_s=mem_n.s, mn_y=mem_n.y, mn_rho=mem_n.rho,
                    mn_idx=mem_n.idx, d=d, tau=tau, best_u=z, accepted=accepted, ls_k=k, bar=bar,
                    searching=searching, searching_any=searching.any())

    def ls_trial(self, st):
        u, r, d, tau, gamma_n = st["u"], st["r"], st["d"], st["tau"], st["gamma_n"]
        searching, accepted, k = st["searching"], st["accepted"], st["ls_k"]
        u_try = u - (1.0 - tau)[..., None] * r + tau[..., None] * d
        f_try, g_try = self.vg(u_try)
        d_try = self.step_to(u_try, g_try, gamma_n) - u_try
        phi_try = f_try + _dot(g_try, d_try) + _dot(d_try, d_try) / (2 * gamma_n)
        ok = phi_try <= st["bar"]
        best_u = _where(searching & ok & ~accepted if self.batched else ok, u_try, st["best_u"])
        accepted = self.sel(searching, accepted | ok, accepted)
        tau = self.sel(searching, tau * 0.5, tau)
        k = self.sel(searching, k + 1, k)
        searching = ~accepted & (k < self.cfg.max_ls)
        searching = searching & st["active"] if self.batched else searching
        return dict(best_u=best_u, accepted=accepted, tau=tau, ls_k=k, searching=searching,
                    searching_any=searching.any())

    def update(self, st):
        sel, active, u, gamma_n, r = self.sel, st["active"], st["u"], st["gamma_n"], st["r"]
        u_new = _where(st["accepted"], st["best_u"], st["z"])  # the prox fallback always decreases
        u_new = _where(st["conv_n"], u, u_new)
        f_new, g_new = self.vg(u_new)
        r_new = u_new - self.step_to(u_new, g_new, gamma_n)
        mem_n = _lbfgs_push(LbfgsMem(st["mn_s"], st["mn_y"], st["mn_rho"], st["mn_idx"]), u_new - u, r_new - r)
        mem = LbfgsMem(*(sel(active, a, st[k]) for a, k in zip(mem_n, ("s", "y", "rho", "idx"))))
        it = sel(active, st["it"] + 1, st["it"])
        converged = sel(active, st["conv_n"], st["converged"])
        new_active = (it < self.cfg.max_iter) & ~converged
        # one read-back: whether a lane goes on, and its memory's fill
        stop = torch.stack([new_active.any().to(torch.int64), torch.where(new_active, mem.idx, 0).amax()])
        return dict(u=sel(active, u_new, u), f_u=sel(active, f_new, st["f_u"]), g_u=sel(active, g_new, st["g_u"]),
                    gamma=sel(active, gamma_n, st["gamma"]), s=mem.s, y=mem.y, rho=mem.rho, idx=mem.idx, it=it,
                    converged=converged, fpr=sel(active, st["fpr_n"], st["fpr"]), active=new_active, stop=stop)


def _drive(run: Callable, cfg: PanocConfig) -> None:
    """The loops of a solve on a segment runner: ``run(name, n_used=None)``
    runs segment ``name`` and returns the flag it sets (for ``post``, the
    L-BFGS slots known to be filled)."""
    run("init")
    any_active, n_used = cfg.max_iter > 0, 0
    while any_active:
        more = run("bt_start")
        while bool(_readback(more)):
            more = run("bt_step")
        searching = run("post", min(cfg.lbfgs_mem, n_used))
        while bool(_readback(searching)):
            searching = run("ls_trial")
        any_active, n_used = _readback(run("update"))


_FLAGS = {"bt_start": "more_any", "bt_step": "more_any", "post": "searching_any", "ls_trial": "searching_any",
          "update": "stop"}
_RESULT = ("u", "it", "converged", "fpr", "f_u", "gamma")


def _result(st) -> PanocResult:
    return PanocResult(*(st[k] for k in _RESULT))


def _capture(fn: Callable, pool) -> "torch.cuda.CUDAGraph":
    """``fn``'s operations as a CUDA graph (allocations from ``pool``)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        fn()
    return graph


def _on_side_stream(device, fn: Callable) -> None:
    """Run ``fn`` on a side stream of ``device``, ordered after the work
    queued so far and before the work queued after it (the warm-up before a
    capture)."""
    side = torch.cuda.Stream(device=device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)


class _GraphSolve:
    """A solve's segments, each captured once as a ``torch.cuda.CUDAGraph``
    on static buffers and replayed (``post`` once for each number of filled
    L-BFGS slots, 0 … min(m, max_iter)). Every buffer a segment reads is
    one that an earlier segment of the same solve wrote, except u0 and the
    value-and-grad closure's tensors, which a solve copies in first. A
    capture or a replay that fails raises: there is no eager fallback on a
    card."""

    def __init__(self, cfg: PanocConfig, vg, f_eval_of, proj, u0: torch.Tensor):
        self.cfg = cfg
        self.inputs = [torch.empty_like(t) for t in vg.graph_tensors]
        self.vg = vg.rebind(self.inputs)
        self.seg = _Segments(cfg, self.vg, f_eval_of(self.vg), proj, u0)
        self.state = {"u0": torch.empty_like(u0)}
        m = min(cfg.lbfgs_mem, cfg.max_iter)
        names = [("init", None), ("bt_start", None), ("bt_step", None), *(("post", k) for k in range(m + 1)),
                 ("ls_trial", None), ("update", None)]

        def warm_up():
            # one eager pass of each kind of segment: lazy initialisation
            # before the captures, and the static buffers' shapes and dtypes
            self._fill(u0, vg)
            found = dict(self.state)
            for name, k in names[:4] + names[-2:]:
                found.update(self._segment(found, name, k))
            for key, val in found.items():
                self.state.setdefault(key, torch.empty_like(val))

        _on_side_stream(u0.device, warm_up)
        pool = torch.cuda.graph_pool_handle() if u0.device.type == "cuda" else None
        self.graphs = {(name, k): _capture(lambda name=name, k=k: self._body(name, k), pool) for name, k in names}

    def _segment(self, st, name, k):
        return getattr(self.seg, name)(st) if k is None else self.seg.post(st, k)

    def _body(self, name, k) -> None:
        """Segment ``name`` on the static buffers, its results copied into
        theirs (a result that is another static buffer is cloned first, so
        no copy overwrites what a later one reads)."""
        st = self.state
        out = self._segment(st, name, k)
        static = {t.data_ptr() for t in st.values()}
        out = {key: v.clone() if v is not st[key] and v.data_ptr() in static else v for key, v in out.items()}
        for key, v in out.items():
            if v is not st[key]:
                st[key].copy_(v)

    def _fill(self, u0, vg) -> None:
        self.state["u0"].copy_(u0)
        for dst, src in zip(self.inputs, vg.graph_tensors):
            dst.copy_(src)

    def solve(self, u0, vg) -> PanocResult:
        self._fill(u0, vg)

        def run(name, n_used=None):
            global replays
            self.graphs[(name, n_used)].replay()
            replays += 1
            return self.state.get(_FLAGS.get(name))

        _drive(run, self.cfg)
        return PanocResult(*(self.state[k].clone() for k in _RESULT))


_GRAPHS: dict = {}
MAX_GRAPH_SOLVES = 8  # captured solves kept, the oldest dropped first


def _graph_solve(cfg, vg, f_eval_of, proj, u0) -> _GraphSolve:
    """The captured solve of (config, box, closure kind, shapes, dtype,
    device), captured on its first use."""
    key = (cfg, proj, vg.graph_key, tuple(u0.shape), u0.dtype, u0.device,
           tuple((tuple(t.shape), t.dtype) for t in vg.graph_tensors))
    if key not in _GRAPHS:
        if len(_GRAPHS) >= MAX_GRAPH_SOLVES:
            del _GRAPHS[next(iter(_GRAPHS))]
        _GRAPHS[key] = _GraphSolve(cfg, vg, f_eval_of, proj, u0)
    return _GRAPHS[key]


def panoc_solve(cfg: PanocConfig, f: Callable | None, proj: Callable, u0: torch.Tensor,
                value_and_grad: Callable | None = None) -> PanocResult:
    """Minimize f(u) s.t. u ∈ C (by ``proj``) from the warm start u0 (..., n)
    (``panoc.py:141-296``). ``f`` must be differentiable by torch.autograd
    unless ``value_and_grad`` is given (e.g. a finite-difference oracle, or
    the condensed QP's), in which case ``f`` may be None and cost values
    come from the oracle.

    On a CUDA u0 with a box projection and a value-and-grad closure over
    static tensors (``graph_tensors``, ``rebind``, ``graph_key``: the
    condensed QP's, ``controllers/qp.py``), each straight-line segment is
    replayed from a CUDA graph captured on the first solve of its (config,
    box, closure kind, shapes, dtype, device): the eager operations in the
    eager order, the same read-backs. Otherwise the segments run eagerly."""
    if value_and_grad is None:
        vg, f_eval_of = autograd_value_and_grad(f), (lambda _vg: f)
    else:
        vg = value_and_grad
        f_eval_of = (lambda v: f) if f is not None else (lambda v: (lambda u: v(u)[0]))
    if u0.device.type == "cuda" and isinstance(proj, BoxProjection) and hasattr(vg, "rebind"):
        return _graph_solve(cfg, vg, f_eval_of, proj, u0).solve(u0, vg)
    seg = _Segments(cfg, vg, f_eval_of(vg), proj, u0)
    st = {"u0": u0}

    def run(name, n_used=None):
        st.update(getattr(seg, name)(st) if n_used is None else seg.post(st, n_used))
        return st.get(_FLAGS.get(name))

    _drive(run, cfg)
    return _result(st)


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
