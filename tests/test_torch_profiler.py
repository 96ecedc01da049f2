"""``runtime/profiler.py`` against the JAX package's: ``SolveTimer``'s
summary and printed line on the same samples, ``wrap`` timing a call, and
``torch_trace`` writing a Chrome trace."""

import contextlib
import io
import json

import numpy as np
import torch

from mpc_rs_tpu.runtime import profiler as jprof
from mpc_rs_tpu_torch.runtime import profiler


def test_summary_and_print_line_equal_jaxs_on_the_same_samples():
    samples = list(np.random.default_rng(0).lognormal(0.0, 0.5, size=257))
    port, jax_timer = profiler.SolveTimer("tick"), jprof.SolveTimer("tick")
    port.samples_ms, jax_timer.samples_ms = list(samples), list(samples)
    assert port.summary() == jax_timer.summary()
    assert profiler.SolveTimer().summary() == jprof.SolveTimer().summary() == {"name": "solve", "count": 0}
    lines = []
    for timer in (port, jax_timer):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            timer.print_summary()
        lines.append(buf.getvalue())
    assert lines[0] == lines[1] and lines[0].startswith("[tick] n=257 mean=")


def test_wrap_and_measure_record_a_sample_a_call():
    timer = profiler.SolveTimer()
    timed = timer.wrap(lambda x: (x * 2, {"y": x + 1}))
    out = timed(torch.ones(3))
    assert torch.equal(out[0], 2 * torch.ones(3)) and len(timer.samples_ms) == 1
    with timer.measure():
        sum(range(1000))
    assert len(timer.samples_ms) == 2 and all(s >= 0.0 for s in timer.samples_ms)
    assert timer.summary()["count"] == 2


def test_torch_trace_writes_a_chrome_trace(tmp_path):
    with profiler.torch_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64).sum()
    assert prof is not None
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert "traceEvents" in trace and len(trace["traceEvents"]) > 0
