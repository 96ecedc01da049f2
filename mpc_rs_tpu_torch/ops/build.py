"""Build and load the port's CUDA kernels (the sources of ``ops/csrc/`` and
the headers they include).

Each source is compiled by its own ``nvcc``, one a core at a time, and the
objects are linked into one shared library with a plain C interface,
loaded through ``ctypes``. The build runs at first use and is keyed by a
hash of the sources, their headers and the flags, so a fresh checkout
builds once and a changed source rebuilds. Output goes to
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# mppi_kernels.cu: the C entries, K1/K2 and the fleet's K5/K6 at N = 8, K7,
# the fast-math probe, D1/D2; family_*.cu: K1/K2 of the MPPI application
# family, one model each (mppi_launch.cuh); horizons_<a>[_<b>].cu, a span of
# horizons each (horizons.cuh): serve's cart-pole at N = 9-40 and the rows'
# finalize at N = 8-40 (N = 8 in horizons_32.cu); sweep.cu: tune's sweep,
# one kernel for every horizon (sweep.cuh), and its C entries. Serve's spans
# were cut by each horizon's nvcc time on the H100 machine's host (runtime/
# profile_build.py --per-horizon; PERF.md §6); fewer, longer spans cost
# more CPU seconds in all (the compiles slow one another on the host's 8
# cores). In the order they are started: the longest compiles first, by the
# CPU seconds each took in a whole build there when each span also held
# tune's sweep at its horizons; in brackets, what each took in one build
# without it (NVIDIA H100 80GB HBM3 machine): mppi_kernels.cu sets the wall.
HORIZON_SPANS = ((9, 15), (40, 40), (19, 21), (30, 31), (28, 29), (26, 27), (16, 18), (39, 39), (24, 25),
                 (37, 37), (22, 23), (38, 38), (36, 36), (35, 35), (33, 33), (34, 34), (32, 32))


def _span_source(a: int, b: int) -> str:
    return f"horizons_{a}.cu" if a == b else f"horizons_{a}_{b}.cu"


SOURCES = ("mppi_kernels.cu",  # [68.1]
           "family_commu4.cu",  # [43.7]
           _span_source(9, 15),  # [21.5]
           "family_mppi2.cu",  # [34.2]
           *(_span_source(a, b) for a, b in HORIZON_SPANS[1:]),  # [22.6 at N = 40 ... 10.8 at 32]
           "family_mppi4.cu",  # [11.8]
           "sweep.cu")  # [6.2]
HEADERS = ("mppi_common.cuh", "mppi_launch.cuh", "horizons.cuh", "fastmath.cuh", "estimator_chain.cuh",
           "diag_kernels.cuh", "sweep.cuh")

# No --use_fast_math (sinf/cosf/logf/expf and '/' stay the accurate forms;
# the fast tier writes its polynomials and rcp.approx out in fastmath.cuh),
# and -fmad=false so that every product and sum is rounded on its own, as in
# the plain PyTorch version's one-op-per-kernel arithmetic and the JAX
# reference. sm_90a is Hopper's architecture-specific target.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    for f in (*SOURCES, *HEADERS):
        h.update(f.encode())
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def compile_width() -> int:
    """How many ``nvcc`` run at once: one a core, at most one a source. More
    would share the cores and stretch the longest compile, which sets the
    wall."""
    return min(len(SOURCES), os.cpu_count() or 1)


def build() -> tuple[Path, float]:
    """Compile the sources if no library for their hash exists: one ``nvcc
    -c`` a source, ``compile_width()`` at a time in the order of
    ``SOURCES`` (the longest first), then one link.

    Returns (library path, wall seconds spent compiling and linking; 0.0
    when cached). The compilers' output, ptxas register and spill counts
    included, is kept in ``_build/<library>.log``, one section a source. A
    failed compile raises with that output.
    """
    so = BUILD_DIR / f"libmpc_kernels_{_source_key()}.so"
    if so.is_file():
        return so, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    jobs = [([nvcc, *NVCC_FLAGS, "-c", "-o", str(BUILD_DIR / f"{tag}.{Path(src).stem}.o"), str(CSRC / src)],
             BUILD_DIR / f"{tag}.{Path(src).stem}.o") for src in SOURCES]
    with ThreadPoolExecutor(max_workers=compile_width()) as pool:  # takes the jobs in order
        done = list(pool.map(lambda job: subprocess.run(job[0], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                        text=True), jobs))
    log, failed = [], []
    for (cmd, _), proc in zip(jobs, done):
        log.append(" ".join(cmd) + "\n" + proc.stdout)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{proc.stdout}")
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *(str(obj) for _, obj in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    seconds = time.perf_counter() - t0
    so.with_suffix(".log").write_text("\n".join(log))
    for _, obj in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
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
        _I, _P, _P, _I, _I, _P,  # model, model and cost consts, fast, sampler, sampler consts
        _I, _I, _F, _F, _F, _F, _F, _I,  # n, k, 1/lambda, inv, lo, hi, std_dev, rollouts a thread
        _P, _P, _P, _P, _I, _U, _U,  # x, u_n, noise, seeds, seed_index, base_seed, solve_word
        _P, _P, _P, _P, _P,  # partials, tickets, u_out, status, stream
    ]
    lib.mpc_mppi_solve.restype = _I
    lib.mpc_mppi_chain.argtypes = [
        _I, _P, _P, _I, _I, _P,  # model, model and cost consts, fast, sampler, sampler consts
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
    lib.mpc_partials_merged.argtypes = [
        _I, _I, _I, _P, _P, _P,  # model, fast, sampler, model, cost and sampler consts
        _I, _I, _I, _F, _F, _F, _F, _F, _I,  # n, p, k, 1/lambda, inv, lo, hi, std_dev, rollouts a thread
        _P, _P, _P, _P, _U, _U,  # x, u_n, noise, seeds, base_seed, word0
        _P, _P, _P, _P, _P,  # partials, noise_out, tickets, row_out, stream
    ]
    lib.mpc_partials_merged.restype = _I
    lib.mpc_mppi_sweep.argtypes = [
        _P, _I, _I, _I, _I, _I, _F, _F,  # model consts, n, b, k, tiles a block, rollouts a thread, lo, hi
        _P, _P, _P, _P, _U,  # x, u_n, noise, seeds, tick
        _P, _P, _P,  # f32(1/lambda), sigma, f32(sigma^-2), each (B)
        _P, _P, _P, _P, _P, _P,  # partials, tickets, u_out, status, ess, stream
    ]
    lib.mpc_mppi_sweep.restype = _I
    # n, rollouts a thread; out: blocks an SM, registers, local bytes, shared bytes
    lib.mpc_sweep_occupancy.argtypes = [_I, _I, _P, _P, _P, _P]
    lib.mpc_sweep_occupancy.restype = _I
    lib.mpc_estimator_chain.argtypes = [
        _I, _I, _I, _P, _P, _P, _I,  # model, n_sub, obs_scaled, plant, obs and chain consts, b
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
