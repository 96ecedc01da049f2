"""The diagnostic probes of the port on the CPU, where the wrappers of
``ops/diag_cuda.py`` run their plain versions, against the JAX scripts'
Pallas kernels: the kernel op-mix chain (D1, ``scripts/diag_kernel_mix.py``)
and the mul-add chain (D2, ``scripts/diag_bf16_vpu.py``).

The scripts' kernels run in TPU interpret mode. A fixture loads each script
by path as a fresh module and swaps names in that module object, never in
the file:

- ``pl`` for a namespace whose ``pallas_call`` passes
  ``interpret=pltpu.InterpretParams()`` and keeps the call's outputs;
- ``jax`` for a namespace whose ``jit`` is the identity, so the kernel runs
  eagerly and its per-solve u0s rows can be read;
- ``pltpu.prng_seed`` / ``prng_random_bits`` for a shim whose words are a
  known function of (the counter j·100003 + i that the kernel seeds with,
  the position in the words the block has asked for since): a hash, since a
  Pallas kernel cannot capture an array constant, evaluated by ``jnp`` in
  the kernel and by numpy here (the pool). ``_port_words`` reorders the
  pool from the TPU's blocks of bs·128 rollouts into the port's (J, K, W)
  words; the layout lives in this test, not in the package;
- D1's ``fastmath`` for a namespace whose ``hw_rcp_scope`` is a null
  context: the dynamics then divide exactly, as the port's plain version
  does (the kernel's ``rcp.approx`` is held against the plain version on
  the card, ``tests/test_torch_cuda.py`` and ``chip_smoke.py``).

Bands: D1 in float32 at the JAX package's kernel band (rtol 1e-3 /
atol 2e-4, ``tests/test_pallas.py:59``), and the float64 plain version within
that band; D2 bit for bit (XLA's CPU backend fuses x·a + b into one rounding
in float32, and rounds after each op in bf16).
"""

import contextlib
import importlib.util
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mpc_rs_tpu.controllers import mppi as jmppi
from mpc_rs_tpu.models import costs as jcosts
from mpc_rs_tpu.models import dynamics as jdyn
from mpc_rs_tpu.models.params import CartPoleParams as JParams
from mpc_rs_tpu_torch.controllers.mppi import MppiConfig
from mpc_rs_tpu_torch.models.params import CartPoleParams
from mpc_rs_tpu_torch.ops import diag_cuda, philox
from mpc_rs_tpu_torch.ops.mppi_cuda import CartPoleShaped4
from mpc_rs_tpu_torch.scripts import diag_bf16_fma, diag_kernel_mix

ROOT = Path(__file__).resolve().parents[1]
N, K, BS, J = 8, 2048, 8, 8  # two TPU blocks of 8 sublanes x 128 lanes
BLK = BS * 128
X0 = (0.5, 0.0, 0.1, 0.0)
F32_BAND = dict(rtol=1e-3, atol=2e-4)  # tests/test_pallas.py:59
MODEL = CartPoleShaped4(CartPoleParams.single_wheel(), 0.1, fast=True)
JDYN = jdyn.make_cartpole_nonlinear(JParams.single_wheel(), 0.1, fast=True)
COUNTER_STRIDE = 100003  # diag_kernel_mix.py:59, the solve's stride in the seed counter


def _cfg(k=K, lam=0.5):
    return MppiConfig(n_horizon=N, n_rollouts=k, lambda_=lam, std_dev=3.0, limit=(-20.0, 20.0))


# --------------------------------------------------------------------------
# the word pool: one hash, in numpy and in jnp


def _mix(x):
    """A uint32 bijection (two multiply-xorshift rounds), numpy or jnp."""
    x = x ^ (x >> 16)
    x = x * np.uint32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * np.uint32(0x846CA68B)
    return x ^ (x >> 16)


def _pool(counter, pos):
    """Word ``pos`` of the words drawn after seeding with ``counter``."""
    return _mix(_mix(counter ^ np.uint32(0x9E3779B9)) ^ pos)


def _port_words(mode: str, j: int = J, k: int = K, bs: int = BS) -> torch.Tensor:
    """The pool as the port's (J, K, W) words: rollout k = i·bs·128 + p of
    TPU block i (p = sublane·128 + lane) takes its word w from position
    w·bs·128 + p of the words of counter j·100003 + i. Every mode asks for
    its words in that order: call after call, each call's planes in turn."""
    blk, w = bs * 128, diag_cuda.WORDS[mode]
    counter = (np.arange(j)[:, None] * COUNTER_STRIDE + np.arange(k // blk)[None, :]).astype(np.uint32)
    pos = (np.arange(w)[:, None] * blk + np.arange(blk)[None, :]).astype(np.uint32)
    with np.errstate(over="ignore"):
        words = _pool(counter[:, :, None, None], pos[None, None])  # (J, nb, W, blk)
    return torch.from_numpy(words.transpose(0, 1, 3, 2).reshape(j, k, w).astype(np.int64))


class _PrngShim:
    """``pltpu.prng_seed`` / ``prng_random_bits`` returning the pool."""

    def __init__(self):
        self.counter, self.offset = None, 0

    def prng_seed(self, seed, counter):
        self.counter, self.offset = jnp.asarray(counter).astype(jnp.uint32), 0

    def prng_random_bits(self, shape):
        pos, stride = jnp.full(shape, np.uint32(self.offset)), 1
        for ax in reversed(range(len(shape))):
            pos = pos + jax.lax.broadcasted_iota(jnp.uint32, shape, ax) * np.uint32(stride)
            stride *= shape[ax]
        self.offset += stride
        return pltpu.bitcast(_pool(self.counter, pos), jnp.int32)


def _load_script(name: str, outputs: list, prng: _PrngShim | None = None):
    spec = importlib.util.spec_from_file_location(f"_diag_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def pallas_call(*args, **kw):
        call = pl.pallas_call(*args, interpret=pltpu.InterpretParams(), **kw)

        def run(*operands):
            out = call(*operands)
            outputs.append(out)
            return out

        return run

    mod.pl = types.SimpleNamespace(**{a: getattr(pl, a) for a in dir(pl) if not a.startswith("__")})
    mod.pl.pallas_call = pallas_call
    mod.jax = types.SimpleNamespace(jit=lambda f: f, lax=jax.lax, ShapeDtypeStruct=jax.ShapeDtypeStruct)
    if prng is not None:
        mod.pltpu = types.SimpleNamespace(**{a: getattr(pltpu, a) for a in dir(pltpu) if not a.startswith("__")})
        mod.pltpu.prng_seed, mod.pltpu.prng_random_bits = prng.prng_seed, prng.prng_random_bits
        mod.fastmath = types.SimpleNamespace(hw_rcp_scope=contextlib.nullcontext)
    return mod


@pytest.fixture(scope="module")
def d1_script():
    outputs = []
    return _load_script("diag_kernel_mix", outputs, _PrngShim()), outputs


@pytest.fixture(scope="module")
def d2_script():
    outputs = []
    return _load_script("diag_bf16_vpu", outputs), outputs


def test_pool_gives_box_muller_no_unit_u1():
    """A box-muller word below 2⁹ makes u1 = 1 exactly, and the JAX fast
    tier's fsqrt(−0.0) is NaN on a backend that flushes subnormals (f32(1e-38)
    is one), where the port's is 0: the pool must not hold such a word."""
    words = _port_words("full")
    assert bool(((words[..., 0::2] >> 9) != 0).all())


# --------------------------------------------------------------------------
# D1: the plain version against the script's kernel in interpret mode


@pytest.mark.parametrize("lam", [0.5, 20.0])
@pytest.mark.parametrize("mode", diag_cuda.MODES)
def test_d1_plain_matches_jax_interpret(d1_script, mode, lam):
    """Eight warm-started solves at K=2048 (two blocks of bs=8), state held:
    the port's plain chain fed the pool's words against the kernel's u0s."""
    mod, outputs = d1_script
    jcfg = jmppi.MppiConfig(n_horizon=N, n_rollouts=K, lambda_=lam, std_dev=3.0, limit=(-20.0, 20.0))
    run = mod.make_chain(jcfg, JDYN, jcosts.shaped4, 4, K, BS, J, mode)
    run(jnp.asarray(X0, jnp.float32), jnp.zeros(N, jnp.float32), jnp.int32(0))
    want = np.asarray(outputs[-1][0])[:J, 0]  # row j holds solve j's u0 in every lane
    assert np.isfinite(want).all()
    words = _port_words(mode)
    x = torch.tensor(X0, dtype=torch.float64)
    for dtype in (torch.float32, torch.float64):
        got, u_n = diag_cuda.kernel_mix_chain_plain(_cfg(lam=lam), MODEL, x.to(dtype), torch.zeros(N, dtype=dtype),
                                                    mode=mode, n_solves=J, ramp_block=BLK, words=words)
        assert got.dtype == dtype and torch.isfinite(u_n).all()
        np.testing.assert_allclose(got.numpy(), want, **F32_BAND)


@pytest.mark.parametrize("mode", diag_cuda.MODES)
def test_d1_seeded_chain_draws_the_philox_contract(mode):
    """The seeded plain chain equals the chain fed the words of the module
    docstring's contract, built here from Philox4x32-10 itself: key
    (seed, 0), counter (k, c, j, 0), word w = output w mod 4 of call w div 4."""
    seed, j, k = -7, 3, 700
    w = diag_cuda.WORDS[mode]
    kk = torch.arange(k, dtype=torch.int64)[None, :, None]
    c = torch.arange(max(1, -(-w // 4)), dtype=torch.int64)[None, None, :]
    jj = torch.arange(j, dtype=torch.int64)[:, None, None]
    out = philox.philox4x32_10((kk, c, jj, torch.zeros((), dtype=torch.int64)), (seed & 0xFFFFFFFF, 0))
    words = torch.stack(out, dim=-1).flatten(2)[:, :, :w]  # (J, K, 4 calls) -> word 4c + i
    x = torch.tensor(X0)
    seeded = diag_cuda.kernel_mix_chain_plain(_cfg(k), MODEL, x, torch.zeros(N), mode=mode, n_solves=j,
                                              base_seed=seed)
    fed = diag_cuda.kernel_mix_chain_plain(_cfg(k), MODEL, x, torch.zeros(N), mode=mode, n_solves=j,
                                           words=words)
    assert torch.equal(seeded[0], fed[0]) and torch.equal(seeded[1], fed[1])
    assert torch.equal(diag_cuda.solve_words(mode, seed, 2, k), words[2])


def test_d1_clt_family_computes_clt():
    """cltone, cltbig and cltreg are clt's arithmetic on clt's words, and
    cltf's mantissa floats sum to clt's byte sum exactly: all five equal."""
    x, u = torch.tensor(X0), torch.zeros(N)
    runs = [diag_cuda.kernel_mix_chain_fused(_cfg(1024), MODEL, x, u, mode=m, n_solves=3, base_seed=5)
            for m in ("clt", "cltone", "cltbig", "cltreg", "cltf")]
    for u0s, u_n in runs[1:]:
        assert torch.equal(u0s, runs[0][0]) and torch.equal(u_n, runs[0][1])


def test_d1_nosample_ramp_is_defined_on_the_block():
    """Rollout k's control is (u_n + f32(k mod 128)·1e-3) + 1e-4·(k div
    ramp_block), clamped; the block is a parameter (8192 at bs = 64)."""
    u = torch.linspace(-1.0, 19.99, N)
    for block in (1024, 8192):
        v = diag_cuda._mix_controls("nosample", _cfg(16384), u, None, block)
        k = torch.arange(16384)
        ramp = (k % 128).to(torch.float32) * torch.tensor(1e-3)
        want = torch.clamp((u[None] + ramp[:, None]) + torch.tensor(1e-4) * (k // block).to(torch.float32)[:, None],
                           -20.0, 20.0)
        assert torch.equal(v, want)


def test_d1_wrappers_check_arguments_and_count_no_cpu_launch():
    x, u = torch.tensor(X0), torch.zeros(N)
    diag_cuda.reset_launches()
    with pytest.raises(ValueError, match="unknown mode"):
        diag_cuda.kernel_mix_chain_fused(_cfg(256), MODEL, x, u, mode="cltx", n_solves=1)
    with pytest.raises(ValueError, match="words has shape"):
        diag_cuda.kernel_mix_chain_plain(_cfg(256), MODEL, x, u, mode="clt2q", n_solves=2,
                                         words=torch.zeros((2, 256, 8), dtype=torch.int64))
    with pytest.raises(ValueError, match="lambda"):
        diag_cuda.kernel_mix_chain_fused(_cfg(256, lam=0.0), MODEL, x, u, mode="full", n_solves=1)
    with pytest.raises(ValueError, match="horizon"):
        diag_cuda.kernel_mix_chain_fused(MppiConfig(n_horizon=4, n_rollouts=256, lambda_=0.5, std_dev=3.0,
                                                    limit=(-20.0, 20.0)), MODEL, x, torch.zeros(4),
                                         mode="full", n_solves=1)
    u0s, u_n = diag_cuda.kernel_mix_chain_fused(_cfg(256), MODEL, x, u, mode="full", n_solves=2)
    assert u0s.shape == (2,) and u_n.shape == (N,) and u0s[1] == u_n[0]
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        diag_cuda.fma_chain_fused(torch.zeros(64, 128, dtype=torch.float16), 4, 1)
    assert not any(diag_cuda.launches.values())


def test_d1_wrapper_takes_rollouts_per_thread():
    """R = 1 and 4 are the kernel's (one launch a solve at either); the
    plain version on the CPU does not depend on it; another R raises."""
    x, u = torch.tensor(X0), torch.zeros(N)
    runs = [diag_cuda.kernel_mix_chain_fused(_cfg(1024), MODEL, x, u, mode="clt", n_solves=2, base_seed=3,
                                             rollouts_per_thread=r) for r in (None, 1, 4)]
    for u0s, u_n in runs[1:]:
        assert torch.equal(u0s, runs[0][0]) and torch.equal(u_n, runs[0][1])
    with pytest.raises(ValueError, match="rollouts_per_thread"):
        diag_cuda.kernel_mix_chain_fused(_cfg(1024), MODEL, x, u, mode="clt", n_solves=1, rollouts_per_thread=2)


# --------------------------------------------------------------------------
# D2: the plain version against the script's kernel in interpret mode


def _d2_tile(rows, dtype, which):
    if which == "1.5":  # the script's tile
        return np.full((rows, 128), 1.5, np.float32)
    rng = np.random.default_rng(rows)
    return (rng.choice([-1.0, 1.0], (rows, 128)) * rng.uniform(1.0, 2.0, (rows, 128))).astype(np.float32)


@pytest.mark.parametrize("tile", ["1.5", "pm_1_2"])
@pytest.mark.parametrize("dtype, rows", [(torch.float32, 64), (torch.bfloat16, 64), (torch.bfloat16, 128)])
def test_d2_plain_matches_jax_interpret_bit_for_bit(d2_script, dtype, rows, tile):
    mod, outputs = d2_script
    x = _d2_tile(rows, dtype, tile)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    mod.make_chain(jdtype, 256, rows)(jnp.asarray(x, jdtype), 2)
    want = np.asarray(outputs[-1].astype(jnp.float32))
    got = diag_cuda.fma_chain_fused(torch.from_numpy(x).to(dtype), 256, 2)
    assert got.dtype == dtype
    assert np.array_equal(got.float().numpy(), want), float(np.abs(got.float().numpy() - want).max())


def test_d2_plain_float32_rounds_once():
    """One update of the plain float32 version is the fused rounding of
    x·a + b (its exact value rounded once), not two roundings."""
    x = torch.tensor([[1.0 + 2.0**-23, 1.75, -1.2345678]], dtype=torch.float32)
    a = float(torch.tensor(diag_cuda.FMA_A[torch.float32]))
    exact = x.double() * a + x.double() * 0.5
    assert torch.equal(diag_cuda.fma_chain_plain(x, 1), exact.to(torch.float32))


# --------------------------------------------------------------------------
# the two entry points on the CPU


def test_d1_entry_runs_on_cpu(monkeypatch):
    monkeypatch.setattr(diag_kernel_mix, "K", 1024)
    monkeypatch.setattr(diag_kernel_mix, "J_SHORT", 1)
    monkeypatch.setattr(diag_kernel_mix, "J_LONG", 3)
    out = diag_kernel_mix.main(["full", "nosample", "noroll", "cvtonly", "--device", "cpu"])
    assert out["device"] == "cpu" and set(out["modes"]) == {"full", "nosample", "noroll", "cvtonly"}
    assert all(r["us_per_solve"] > 0 and r["lane_cycles_per_step"] is None for r in out["modes"].values())
    assert "sampling_share" in out and "rollout_share" in out


def test_d2_entry_runs_on_cpu():
    out = diag_bf16_fma.main(["--device", "cpu"])
    assert [(c["dtype"], c["rows"]) for c in out["configs"]] == [("float32", 64), ("bfloat16", 64),
                                                                  ("bfloat16", 128)]
    assert all(c["peak_share"] is None for c in out["configs"])


def test_entries_refuse_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device runs")
    for module in ("diag_kernel_mix", "diag_bf16_fma"):
        out = subprocess.run([sys.executable, "-m", f"mpc_rs_tpu_torch.scripts.{module}"], capture_output=True,
                             text=True, timeout=120, cwd=ROOT)
        assert out.returncode != 0 and "--device cpu" in out.stderr
