"""Build and load the port's CUDA kernels (``ops/csrc/mppi_kernels.cu`` and
the headers it includes).

The source is compiled with one ``nvcc`` into a shared library with a plain
C interface, loaded through ``ctypes``. The build runs at first use and is
keyed by a hash of the source, its headers and the flags, so a fresh
checkout builds once and a changed source rebuilds. Output goes to
``mpc_rs_tpu_torch/_build/``; delete that directory to force a rebuild.

Nothing here runs at import time: this module imports on machines without
``nvcc`` or a GPU, and only ``load_library()`` needs them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCE = "mppi_kernels.cu"  # K1/K2, the fleet's K5/K6 and K7, the fast-math probe, D1/D2
HEADERS = ("mppi_common.cuh", "fastmath.cuh", "estimator_chain.cuh", "diag_kernels.cuh")

# No --use_fast_math (sinf/cosf/logf/expf and '/' stay the accurate forms;
# the fast tier writes its polynomials and rcp.approx out in fastmath.cuh),
# and -fmad=false so that every product and sum is rounded on its own, as in
# the plain PyTorch version's one-op-per-kernel arithmetic and the JAX
# reference. sm_90a is Hopper's architecture-specific target.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` (default /usr/local/cuda)."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; the CUDA kernels cannot be built")


def _source_key() -> str:
    h = hashlib.sha256()
    for f in (SOURCE, *HEADERS):
        h.update(f.encode())
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> tuple[Path, float]:
    """Compile the source if no library for its hash exists.

    Returns (library path, seconds spent compiling; 0.0 when cached). The
    compiler's output, ptxas register and spill counts included, is kept in
    ``_build/<library>.log``. A failed compile raises with that output.
    """
    so = BUILD_DIR / f"libmpc_kernels_{_source_key()}.so"
    if so.is_file():
        return so, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    so.with_suffix(".log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees the whole file or none
    return so, seconds


_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C signatures."""
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    lib.mpc_mppi_solve.argtypes = [
        _P, _I, _I, _P,  # model consts, fast, sampler, sampler consts
        _I, _I, _F, _F, _F, _F, _F, _I,  # n, k, 1/lambda, inv, lo, hi, std_dev, rollouts a thread
        _P, _P, _P, _P, _I, _U, _U,  # x, u_n, noise, seeds, seed_index, base_seed, solve_word
        _P, _P, _P, _P, _P,  # partials, tickets, u_out, status, stream
    ]
    lib.mpc_mppi_solve.restype = _I
    lib.mpc_mppi_chain.argtypes = [
        _P, _I, _I, _P,  # model consts, fast, sampler, sampler consts
        _I, _I, _F, _F, _F, _F, _F, _I,  # n, k, 1/lambda, inv, lo, hi, std_dev, rollouts a thread
        _P, _P, _P, _P, _U, _I, _I,  # x, u_n, noise, seeds, base_seed, n_solves, plant
        _P, _P, _P, _P, _P,  # partials, tickets, u0s, statuses, stream
    ]
    lib.mpc_mppi_chain.restype = _I
    lib.mpc_fleet_partials.argtypes = [
        _I, _I, _I, _P, _P, _P,  # model, fast, sampler, model, cost and sampler consts
        _I, _I, _I, _F, _F, _F, _F, _F, _I,  # n, b, k, 1/lambda, inv, lo, hi, std_dev, rollouts a thread
        _P, _P, _P, _P, _P, _P,  # x, u_n, noise, seeds, partials, noise_out
        _P, _P, _P, _P,  # tickets, u_out, status, stream
    ]
    lib.mpc_fleet_partials.restype = _I
    lib.mpc_estimator_chain.argtypes = [
        _I, _I, _P, _P, _P, _I,  # model, n_sub, plant, obs and chain consts, b
        _P, _P, _P, _P, _I, _P, _P,  # x, ex, p, u0, u_stride, t, noise
        _P, _P, _P, _P,  # x_out, ex_out, p_out, stream
    ]
    lib.mpc_estimator_chain.restype = _I
    lib.mpc_fleet_finalize.argtypes = [_I, _I, _I, _F, _P, _P, _P, _P]
    lib.mpc_fleet_finalize.restype = _I
    lib.mpc_fastmath_eval.argtypes = [_I, _I, _P, _P, _P, _P]
    lib.mpc_fastmath_eval.restype = _I
    lib.mpc_kernel_mix_chain.argtypes = [
        _I, _P, _P, _I, _I,  # mode, model consts, sampler consts, n, k
        _F, _F, _F, _F, _F, _F, _F, _I, _I,  # 1/lambda, inv, lo, hi, std_dev, cltf mu and 1/sigma, ramp
        # block, rollouts a thread
        _P, _P, _P, _I, _P, _P, _P, _P,  # x, u_n, seed (device int32), n_solves, partials, tickets, u0s, stream
    ]
    lib.mpc_kernel_mix_chain.restype = _I
    lib.mpc_fma_chain.argtypes = [_I, _I, _I, _I, _F, _P, _P, _P]
    lib.mpc_fma_chain.restype = _I
    return lib
