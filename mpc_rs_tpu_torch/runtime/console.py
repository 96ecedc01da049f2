"""ANSI dual console streams — parity with the reference's colored
control/receive prints (mppi4-non-liner-ukf.rs:291-349): ``Con:`` in green
from the control loop, ``Rcv:`` in cyan from the sensor/UKF loop.

Port of ``mpc_rs_tpu/runtime/console.py:21-59``, byte for byte.

Formats mirror the reference: positions in meters, angles printed in
degrees, observation/innovation/covariance rows on the Rcv stream.
"""

from __future__ import annotations

import math

import numpy as np

_GREEN = "\x1b[32m"
_CYAN = "\x1b[36m"
_RESET = "\x1b[m"
_DEG = 180.0 / math.pi


def print_con(t: float, u0: float, x_est4) -> None:
    """Control-thread line — mppi4-non-liner-ukf.rs:291-303."""
    e = np.asarray(x_est4, dtype=float)
    print(
        f"{_GREEN}Con:{t:6.2f} u:{u0:6.2f} "
        f"e:[{e[0]:6.2f},{e[1]:6.2f},{e[2] * _DEG:5.0f},{e[3] * _DEG:5.0f}] {_RESET}"
    )


def print_rcv(t: float, u: float, x_est6, x_obs, innov=None, x_act6=None, p_diag=None) -> None:
    """Receive/UKF-thread line — mppi4-non-liner-ukf.rs:304-349.

    ``x_act6`` is only available in sim (the HW twin passes None and the
    ``x:`` column is omitted, as the real robot's state is unknowable)."""
    e = np.asarray(x_est6, dtype=float)
    o = np.asarray(x_obs, dtype=float)
    parts = [
        f"{_CYAN}Rcv:{_RESET}{t:6.2f} u:{u:6.2f} ",
        f"e:[{e[0]:6.2f},{e[1]:6.2f},{e[3] * _DEG:5.0f},{e[4] * _DEG:5.0f}] ",
    ]
    if x_act6 is not None:
        x = np.asarray(x_act6, dtype=float)
        parts.append(f"x:[{x[0]:6.2f},{x[1]:6.2f},{x[3] * _DEG:5.0f},{x[4] * _DEG:5.0f}] ")
    parts.append(
        f"o:[{o[0]:6.0f},{o[1]:6.0f},{o[2]:4.0f},{o[3]:5.2f},{o[4]:5.2f}] "
        if o.shape[0] >= 5
        else f"o:{np.array2string(o, precision=2)} "
    )
    if innov is not None:
        z = np.asarray(innov, dtype=float)
        parts.append(
            f"z:[{z[0]:6.0f},{z[1]:6.0f},{z[2]:4.0f},{z[3]:5.2f},{z[4]:5.2f}] "
            if z.shape[0] >= 5
            else f"z:{np.array2string(z, precision=2)} "
        )
    if p_diag is not None:
        pd = np.asarray(p_diag, dtype=float)
        parts.append("p:[" + ",".join(f"{v:5.2f}" for v in pd[:6]) + "] ")
    print("".join(parts))
