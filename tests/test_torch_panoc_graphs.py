"""PANOC's CUDA-graph runner (``controllers/panoc.py``: ``_GraphSolve``)
rehearsed on the CPU: each captured segment is stood in for by the Python
call it would record, replayed on the same static buffers, so what the
runner does around the graphs (the buffers, the copies in and out, the
aliased results, the read-backs) runs here. Its solves must be the eager
solve's bits with the eager read-backs, on one problem and on a batch; the
card's graphs are held to the eager solve in ``tests/test_torch_cuda.py``
and ``chip_smoke.py``."""

import numpy as np
import pytest
import torch

from mpc_rs_tpu_torch.controllers import panoc
from mpc_rs_tpu_torch.controllers.qp import QpValueAndGrad, build_condensed_qp, make_qp_value_and_grad
from mpc_rs_tpu_torch.models import dynamics, reference
from mpc_rs_tpu_torch.models.params import CartPoleParams


class _Recorded:
    """A graph stand-in: replay runs the captured segment's Python call."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


@pytest.fixture
def stand_in_graphs(monkeypatch):
    monkeypatch.setattr(panoc, "_capture", lambda fn, pool: _Recorded(fn))
    monkeypatch.setattr(panoc, "_on_side_stream", lambda device, fn: fn())
    monkeypatch.setattr(panoc, "_GRAPHS", {})


def _calc_qp(n=8):
    a, b = dynamics.linear_ab(CartPoleParams.single_wheel(), 0.1)
    return build_condensed_qp(a, b, np.diag([5.0, 5.0, 1.0, 1.0]), n)


@pytest.mark.parametrize("batch", [(), (5,)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_graph_runner_gives_the_eager_bits(stand_in_graphs, batch, dtype):
    """Ten warm-started op-mpc-x-calc solves (one problem, and a batch of 5
    whose lanes stop at different iterations): every result field and the
    read-back count equal the eager solve's; the capture is made once."""
    qp = _calc_qp()
    qp = qp._replace(**{k: v.to(dtype) for k, v in qp._asdict().items()})
    vg_factory = make_qp_value_and_grad(qp, reference.make_gen_ref_raised_cosine(8))
    cfg = panoc.PanocConfig(tol=1e-6, max_iter=80, lbfgs_mem=20)
    proj = panoc.box_projection(-30.0, 30.0)
    rng = np.random.default_rng(0)
    u = torch.zeros(batch + (8,), dtype=dtype)
    for _ in range(10):
        vg = vg_factory(torch.tensor(rng.normal(size=batch + (4,)) * 0.3, dtype=dtype))
        panoc.reset_readbacks()
        eager = panoc.panoc_solve(cfg, None, proj, u, value_and_grad=lambda v: vg(v))  # not a closure kind: eager
        eager_readbacks = panoc.readbacks
        panoc.reset_readbacks()
        graph = panoc._graph_solve(cfg, vg, lambda v: (lambda w: v(w)[0]), proj, u).solve(u, vg)
        assert panoc.readbacks == eager_readbacks
        for got, want in zip(graph, eager):
            assert torch.equal(got, want)
        u = graph.u
    assert len(panoc._GRAPHS) == 1
    solve = next(iter(panoc._GRAPHS.values()))
    assert len(solve.graphs) == 5 + 21  # post once for each filled-slot count 0 … 20


def test_graph_solve_is_keyed_by_shape_and_bounded(stand_in_graphs, monkeypatch):
    """Another shape, box or config is another capture; the cache keeps at
    most ``MAX_GRAPH_SOLVES`` and drops the oldest."""
    monkeypatch.setattr(panoc, "MAX_GRAPH_SOLVES", 2)
    vg_factory = make_qp_value_and_grad(_calc_qp(), reference.make_gen_ref_raised_cosine(8))
    cfg = panoc.PanocConfig(tol=1e-6, max_iter=4, lbfgs_mem=3)
    f_eval_of = lambda v: (lambda w: v(w)[0])  # noqa: E731
    for batch, lo in (((), -30.0), ((2,), -30.0), ((), -5.0)):
        u = torch.zeros(batch + (8,), dtype=torch.float64)
        vg = vg_factory(torch.zeros(batch + (4,), dtype=torch.float64))
        panoc._graph_solve(cfg, vg, f_eval_of, panoc.box_projection(lo, 30.0), u).solve(u, vg)
    assert len(panoc._GRAPHS) == 2
    assert all(key[1] != panoc.box_projection(-30.0, 30.0) or key[3] == (2, 8) for key in panoc._GRAPHS)


def test_which_solves_take_the_graphs():
    """The condensed QP's closure carries the graph protocol; the autodiff
    and finite-difference oracles do not (they stay eager on a card), and a
    box projection is a hashable value."""
    vg = make_qp_value_and_grad(_calc_qp(), reference.make_gen_ref_zero(8))(torch.zeros(4, dtype=torch.float64))
    assert isinstance(vg, QpValueAndGrad) and hasattr(vg, "rebind") and len(vg.graph_tensors) == 3
    assert torch.equal(vg.rebind(vg.graph_tensors)(torch.ones(8, dtype=torch.float64))[1],
                       vg(torch.ones(8, dtype=torch.float64))[1])
    assert not hasattr(panoc.autograd_value_and_grad(lambda u: (u * u).sum(-1)), "rebind")
    assert panoc.box_projection(-1.0, 1.0) == panoc.box_projection(-1.0, 1.0)
    assert hash(panoc.box_projection(-1.0, 1.0)) == hash(panoc.box_projection(-1.0, 1.0))
