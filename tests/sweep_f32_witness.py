"""tune's sweep at a long horizon on a CUDA card, the case of
``tests/test_torch_cuda.py::test_cuda_sweep_at_horizons_matches_plain`` at
N = 224 (tune's grid, B = 96, λ·N/8, dt = 0.8/N, K = 8 192, box-muller):
how far the kernel sits from the float64 plain version against the test's
band (the f32 band, or twice the plain float32 version's own distance),
with the plain cart-pole dividing kt·u / r_w once (``dynamics._div``) or as
PyTorch divides a CUDA tensor by a Python float (a multiply by the float32
reciprocal); and each problem's rollouts as the kernel steps them
(``tests/sweep_f32_witness.cu``: the statements of ``sweep_rollout``, its
sums taken one after another or with Kahan's compensation) against the
plain float32 states (run manually; prints JSON lines).

    python tests/sweep_f32_witness.py [--seeds 224,3] [--n 224]

A line a data seed and division: ``kernel_over_band``, the kernel's largest
ratio to the band over the 96 problems, and ``problems_over_band``;
``trace_over_band`` and ``kahan_over_band``, the same for the traced
rollouts' scores merged as the plain version merges; ``rollouts_parting``,
the rollouts whose states differ from the plain float32 states at some
step, and the median step where they first do; ``noise_equal``, whether
the traced normals equal ``sweep_noise``'s. A last line counts the points
where ``sincosf`` differs from ``torch.sin``/``cos`` and the quotients
where PyTorch's division of a CUDA tensor by r_w differs from ``_div``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from mpc_rs_tpu_torch.controllers.mppi import MppiConfig  # noqa: E402
from mpc_rs_tpu_torch.models import dynamics  # noqa: E402
from mpc_rs_tpu_torch.models.params import CartPoleParams  # noqa: E402
from mpc_rs_tpu_torch.ops import build, mppi_cuda  # noqa: E402

BAND = (2e-4, 1e-3)  # atol, rtol: tests/test_torch_cuda.py's F32_BAND
K = 8192
DIVISIONS = {"exact": dynamics._div, "reciprocal": lambda a, b: a / b}


def load_trace():
    so = Path(tempfile.mkdtemp()) / "sweep_f32_witness.so"
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS[:-2], "-shared", "-I", str(build.CSRC), "-o", str(so),
                    str(Path(__file__).with_suffix(".cu"))], check=True)
    return ctypes.CDLL(str(so))


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def inputs(card, seed, n):
    """The card test's inputs at horizon n, data seed ``seed``."""
    cells = [(lam, sig, s) for lam in (0.1, 0.5, 1.4, 2.5) for sig in (1.0, 3.0, 10.0) for s in range(8)]
    lam, sig, seeds = (torch.tensor([c[i] for c in cells], dtype=dt, device=card)
                       for i, dt in ((0, torch.float32), (1, torch.float32), (2, torch.int32)))
    dt, scale = (0.1, 1.0) if n <= 8 else (0.8 / n, n / 8)
    gen = torch.Generator(device=card).manual_seed(seed)
    xs = torch.randn((96, 4), generator=gen, device=card) * torch.tensor([0.3, 0.1, 0.1, 0.1], device=card)
    u_ns = torch.randn((96, n), generator=gen, device=card)
    cfg = MppiConfig(n_horizon=n, n_rollouts=K, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
    return mppi_cuda.CartPoleShaped4(CartPoleParams.single_wheel(), dt), cfg, lam * scale, sig, seeds, xs, u_ns


def plain_states(model, xs, u_ns, v, inv):
    """The plain version's states after each step (B, K, N, 4) and scores."""
    b, k, n = v.shape
    x = tuple(xs[:, i:i + 1].expand(b, k) for i in range(4))
    c = torch.zeros((b, k), dtype=v.dtype, device=v.device)
    states = torch.empty((b, k, n, 4), dtype=v.dtype, device=v.device)
    for t in range(n):
        x = model.step(*x, v[:, :, t])
        c = c + model.cost(*x)
        states[:, :, t] = torch.stack(x, -1)
    return states, -c - torch.sum(u_ns[:, None] * inv[:, None, None] * v, dim=-1)


def u_from_scores(score, v, lam):
    """u_n' from (B, K) scores, merged as ``sweep_partials_plain`` merges
    rows of 256 rollouts."""
    b, k, n = v.shape
    inv_l = mppi_cuda._inv_lambdas(lam, score.dtype)[:, None, None]
    s, vv = score.reshape(b, -1, 256), v.reshape(b, -1, 256, n)
    finite = torch.isfinite(s)
    m_b = torch.where(finite, s, mppi_cuda.NEG_BIG).amax(-1)
    w = torch.where(finite, torch.exp((s - m_b[..., None]) * inv_l), 0.0)
    rows = torch.cat([m_b[..., None], w.sum(-1)[..., None], (w[..., None] * vv).sum(-2), (w * w).sum(-1)[..., None]],
                     -1)
    return mppi_cuda.finalize_sweep_plain(rows, lam)[0].double().cpu()


def over_band(got, want, f32):
    tol = torch.maximum(BAND[0] + BAND[1] * want.abs(), 2.0 * (f32 - want).abs())
    return ((got - want).abs() / tol).amax(-1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="224,3")
    ap.add_argument("--n", type=int, default=224)
    args = ap.parse_args(argv)
    card = torch.device("cuda", 0)
    build.load_library()
    lib = load_trace()
    n = args.n
    for seed in (int(s) for s in args.seeds.split(",")):
        model, cfg, lam, sig, seeds, xs, u_ns = inputs(card, seed, n)
        noise = mppi_cuda.sweep_noise(cfg, seeds, 5, sig)
        got = mppi_cuda.mppi_sweep_batch_fused(cfg, model, xs, u_ns, lam, sig, seeds=seeds, solve=5)[0].double().cpu()
        _, _, inv = mppi_cuda.sweep_coefficients(lam, sig)
        v = torch.clamp(u_ns[:, None] + noise, *cfg.limit)
        traced = {kahan: (torch.empty((96, K, n), device=card), torch.empty((96, K, n, 4), device=card),
                          torch.empty((96, K), device=card)) for kahan in (0, 1)}
        for kahan, (e, xo, sc) in traced.items():
            for p in range(96):
                rc = lib.rollout_trace(model.c_constants[0], n, K, ctypes.c_uint(int(seeds[p])), ctypes.c_uint(5),
                                       ctypes.c_float(float(sig[p])), ctypes.c_float(float(inv[p])),
                                       ctypes.c_float(cfg.limit[0]), ctypes.c_float(cfg.limit[1]), ptr(xs[p].contiguous()),
                                       ptr(u_ns[p].contiguous()), ptr(e[p]), ptr(xo[p]), ptr(sc[p]), kahan)
                assert rc == 0, rc
        for name, div in DIVISIONS.items():
            dynamics._div = div
            try:
                want = mppi_cuda.mppi_sweep_batch_plain(cfg, model, xs.double(), u_ns.double(), lam, sig,
                                                        noise=noise)[0].double().cpu()
                f32 = mppi_cuda.mppi_sweep_batch_plain(cfg, model, xs, u_ns, lam, sig, noise=noise)[0].double().cpu()
                states, _ = plain_states(model, xs, u_ns, v, inv)
            finally:
                dynamics._div = DIVISIONS["exact"]
            kernel = over_band(got, want, f32)
            parting = (traced[0][1] != states).any(-1)  # (B, K, N)
            first = parting.float().argmax(-1)[parting.any(-1)]
            print(json.dumps({
                "seed": seed, "n": n, "division": name, "kernel_over_band": float(kernel.max()),
                "problems_over_band": int((kernel > 1).sum()),
                "trace_over_band": float(over_band(u_from_scores(traced[0][2], v, lam), want, f32).max()),
                "kahan_over_band": float(over_band(u_from_scores(traced[1][2], v, lam), want, f32).max()),
                "rollouts_parting": int(parting.any(-1).sum()), "rollouts": 96 * K,
                "first_parting_step_median": float(first.median()) + 1 if first.numel() else None,
                "noise_equal": bool(torch.equal(traced[0][0], noise)), "card": torch.cuda.get_device_name(card)}),
                flush=True)
            del states, parting
    a = (torch.rand(1 << 22, device=card, generator=torch.Generator(device=card).manual_seed(0)) - 0.5) * 20
    s, c = torch.empty_like(a), torch.empty_like(a)
    assert lib.sincos_eval(a.numel(), ptr(a), ptr(s), ptr(c)) == 0
    p = CartPoleParams.single_wheel()
    thrust = p.kt * ((torch.rand(1 << 22, device=card) - 0.5) * 40)
    print(json.dumps({"points": a.numel(), "sincosf_differs": int((s != torch.sin(a)).sum() + (c != torch.cos(a)).sum()),
                      "reciprocal_quotients_off": int((thrust / p.r_w != dynamics._div(thrust, p.r_w)).sum())}))


if __name__ == "__main__":
    main()
