"""Build and load the port's CUDA kernels (``ops/csrc/*.cu``).

The sources are compiled with ``nvcc`` into a shared library with a plain C
interface, loaded through ``ctypes``. The build runs at first use and is
keyed by a hash of the sources and flags, so a fresh checkout builds once and
a changed source rebuilds. Output goes to ``mpc_rs_tpu_torch/_build/``;
delete that directory to force a rebuild.

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
SOURCES = ("mppi_kernels.cu",)

# The exact tier: no --use_fast_math (sinf/cosf/logf/expf and '/' stay the
# accurate forms), and -fmad=false so that every product and sum is rounded
# on its own, as in the plain PyTorch version's one-op-per-kernel arithmetic
# and the JAX reference. sm_90a is Hopper's architecture-specific target.
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
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> tuple[Path, float]:
    """Compile the sources if no library for their hash exists.

    Returns (library path, seconds spent compiling; 0.0 when cached). The
    compiler's output, ptxas register and spill counts included, is kept in
    ``_build/<name>.log``. A failed compile raises with that output.
    """
    so = BUILD_DIR / f"libmpc_kernels_{_source_key()}.so"
    if so.is_file():
        return so, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in SOURCES)]
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
        _P, _I, _I, _F, _F, _F, _F, _F,  # consts, n, k, lambda, inv, lo, hi, std_dev
        _P, _P, _P, _P, _I, _U, _U,  # x, u_n, noise, seeds, seed_index, base_seed, solve_word
        _P, _P, _P, _P,  # partials, u_out, status, stream
    ]
    lib.mpc_mppi_solve.restype = _I
    lib.mpc_mppi_chain.argtypes = [
        _P, _I, _I, _F, _F, _F, _F, _F,  # consts, n, k, lambda, inv, lo, hi, std_dev
        _P, _P, _P, _P, _U, _I, _I,  # x, u_n, noise, seeds, base_seed, n_solves, plant
        _P, _P, _P, _P,  # partials, u0s, statuses, stream
    ]
    lib.mpc_mppi_chain.restype = _I
    return lib

