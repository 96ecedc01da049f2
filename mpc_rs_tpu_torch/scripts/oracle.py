"""The independent float64 C++ oracle ``native/liboracle.so`` through ctypes.

``native/oracle.cpp`` is a transcription of the reference's MPPI solve,
UKF predict/update, dynamics, costs and observation models in another
language, sharing no code with either package. This module declares its
signatures and wraps the calls the parity harness makes, as the JAX
package's tests do (``tests/test_native_oracle.py:44-186``), without
importing that file.

The library is loaded read-only: the committed ``native/liboracle.so`` when
its ``.src.sha256`` stamp is the sha256 of ``native/oracle.cpp``, else a
build of the source into ``mpc_rs_tpu_torch/_build/``
(``io/native.py``). ``make -C native``, which the JAX loader runs, is
never run.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from mpc_rs_tpu_torch.io.native import NativeLibrary, load_stamped

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
SOURCE = NATIVE_DIR / "oracle.cpp"
COMMITTED = NATIVE_DIR / "liboracle.so"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

_D = ctypes.POINTER(ctypes.c_double)


def _dp(a: np.ndarray):
    return a.ctypes.data_as(_D)


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The ``oracle_*`` signatures (``tests/test_native_oracle.py:69-96``)."""
    i, d = ctypes.c_int, ctypes.c_double
    lib.oracle_dynamics.restype = None
    lib.oracle_dynamics.argtypes = [i, _D, d, d, _D]
    lib.oracle_dynamics_short6.restype = None
    lib.oracle_dynamics_short6.argtypes = [_D, d, d, d, _D]
    lib.oracle_cost.restype = d
    lib.oracle_cost.argtypes = [i, _D]
    lib.oracle_hx.restype = None
    lib.oracle_hx.argtypes = [i, _D, _D]
    lib.oracle_gen_q6.restype = None
    lib.oracle_gen_q6.argtypes = [d, _D]
    lib.oracle_mppi_solve.restype = i
    lib.oracle_mppi_solve.argtypes = [i, i, ctypes.c_longlong, i, _D, _D, _D, d, d, d, d, d, _D]
    lib.oracle_ukf_predict.restype = i
    lib.oracle_ukf_predict.argtypes = [i, i, d, d, d, _D, _D, _D, _D]
    lib.oracle_ukf_update.restype = i
    lib.oracle_ukf_update.argtypes = [i, i, i, _D, _D, _D, _D, _D]
    lib.oracle_qp_cost_grad.restype = None
    lib.oracle_qp_cost_grad.argtypes = [_D, _D, _D, _D]
    lib.oracle_qp_solve_box.restype = i
    lib.oracle_qp_solve_box.argtypes = [_D, d, d, _D]
    return lib


@functools.cache
def oracle_library() -> NativeLibrary:
    """The loaded oracle (which binary, its source's sha256); raises
    OSError when neither the committed binary nor a build loads."""
    return load_stamped(SOURCE, COMMITTED, BUILD_DIR, _declare)


def load_oracle() -> ctypes.CDLL:
    return oracle_library().lib


def ora_dynamics(lib, dyn_id: int, x, u: float, dt: float) -> np.ndarray:
    """One plant step: 0 the nonlinear cart-pole, 1 the 6-state flagship
    (6 out), 2 the 4-state flagship model of the controller."""
    x = np.ascontiguousarray(x, np.float64)
    out = np.empty(x.shape[0] if dyn_id != 1 else 6, np.float64)
    lib.oracle_dynamics(dyn_id, _dp(x), float(u), float(dt), _dp(out))
    return out


def ora_short6(lib, x, u: float, dt: float, f: float) -> np.ndarray:
    """The flagship's 6-state plant step with the disturbance force f."""
    x = np.ascontiguousarray(x, np.float64)
    out = np.empty(6, np.float64)
    lib.oracle_dynamics_short6(_dp(x), float(u), float(dt), float(f), _dp(out))
    return out


def ora_hx(lib, hx_id: int, x) -> np.ndarray:
    """0: rpm/gyro (3 out); 1: the flagship's IMU (5 out)."""
    x = np.ascontiguousarray(x, np.float64)
    out = np.empty(3 if hx_id == 0 else 5, np.float64)
    lib.oracle_hx(hx_id, _dp(x), _dp(out))
    return out


def ora_gen_q6(lib, dt: float) -> np.ndarray:
    """The flagship's piecewise-white-noise process noise (6, 6)."""
    q = np.empty(36, np.float64)
    lib.oracle_gen_q6(float(dt), _dp(q))
    return q.reshape(6, 6)


def ora_mppi(lib, dyn_id: int, cost_id: int, x0, u_n, eps, lam: float, sigma: float, limit, dt: float):
    """One MPPI solve on the noise ``eps`` (K, N): (u_n', status)."""
    x0 = np.ascontiguousarray(x0, np.float64)
    u_n = np.ascontiguousarray(u_n, np.float64)
    eps = np.ascontiguousarray(eps, np.float64)
    k, n = eps.shape
    out = np.empty(n, np.float64)
    st = lib.oracle_mppi_solve(dyn_id, cost_id, k, n, _dp(x0), _dp(u_n), _dp(eps), float(lam), float(sigma),
                               float(limit[0]), float(limit[1]), float(dt), _dp(out))
    return out, st


def ora_qp_cost_grad(lib, x, u) -> tuple[float, np.ndarray]:
    """The op-mpc-x-calc condensed QP's cost and gradient at (x, u) (N = 8),
    from the oracle's own F/G/Q built from its literals."""
    x = np.ascontiguousarray(x, np.float64)
    u = np.ascontiguousarray(u, np.float64)
    c, g = np.empty(1), np.empty(u.shape[0])
    lib.oracle_qp_cost_grad(_dp(x), _dp(u), _dp(c), _dp(g))
    return float(c[0]), g


def ora_qp_solve_box(lib, x, lo: float, hi: float) -> np.ndarray:
    """The exact minimizer of the same QP on the box [lo, hi]⁸, by the
    oracle's enumeration of all 3⁸ active sets and their KKT conditions."""
    x = np.ascontiguousarray(x, np.float64)
    u = np.empty(8)
    rc = lib.oracle_qp_solve_box(_dp(x), float(lo), float(hi), _dp(u))
    if rc != 0:
        raise RuntimeError(f"oracle_qp_solve_box returned {rc}")
    return u


class OraUkf:
    """The oracle's stateful UKF (src/ukf2.rs's UnscentedKalmanFilter)."""

    def __init__(self, lib, x0, p0, q, r, fx_id: int, hx_id: int):
        self.lib = lib
        self.n = len(x0)
        self.o = r.shape[0]
        self.fx_id, self.hx_id = fx_id, hx_id
        self.x = np.ascontiguousarray(x0, np.float64).copy()
        self.p = np.ascontiguousarray(p0, np.float64).copy()
        self.q = np.ascontiguousarray(q, np.float64).copy()
        self.r = np.ascontiguousarray(r, np.float64).copy()
        self.sigma_f = np.full(((2 * self.n + 1) * self.n,), np.nan)

    def predict(self, u: float, dt: float, f: float = 0.0) -> None:
        rc = self.lib.oracle_ukf_predict(self.n, self.fx_id, float(u), float(dt), float(f), _dp(self.q),
                                         _dp(self.x), _dp(self.p), _dp(self.sigma_f))
        if rc != 0:
            raise RuntimeError(f"oracle_ukf_predict returned {rc}")

    def update(self, z) -> None:
        z = np.ascontiguousarray(z, np.float64)
        rc = self.lib.oracle_ukf_update(self.n, self.o, self.hx_id, _dp(z), _dp(self.r), _dp(self.sigma_f),
                                        _dp(self.x), _dp(self.p))
        if rc != 0:
            raise RuntimeError(f"oracle_ukf_update returned {rc}")
