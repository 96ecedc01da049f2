"""Physical parameter sets for the wheeled-inverted-pendulum model family.

Port of ``mpc_rs_tpu/models/params.py``: the same frozen dataclass of Python
floats, the same named sets and derived properties. The values stay Python
floats so that products of them are evaluated in double before they meet a
tensor, exactly as the JAX trace folds them; the CUDA kernels receive them
folded the same way on the host (``ops/mppi_cuda.py``).

Named sets (citations into the reference crate, as in the JAX package):

- ``single_wheel``       — examples/mppi4.rs:73-81, mppi4-non-liner.rs:73-80
- ``single_wheel_light`` — examples/op-mpc-x.rs:26-48 (M2 = 2.3 - 2*M1)
- ``single_wheel_heavy_j`` — examples/mpc-ukf-x.rs:17-27 (M2 = 2.0, J2 = 1.2)
- ``single_wheel_j01``   — examples/ukf-pen.rs:6-14 (J2 = 0.1)
- ``two_wheel``          — examples/mppi4-non-liner-ukf.rs:105-125
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping


@dataclasses.dataclass(frozen=True)
class CartPoleParams:
    m1: float  # wheel mass [kg]
    r_w: float  # wheel radius [m]
    m2: float  # pendulum (body) mass [kg]
    l: float  # distance to the center of mass [m]
    j1: float  # wheel moment of inertia [kg m^2]
    j2: float  # body moment of inertia [kg m^2]
    g: float = 9.81
    kt: float = 0.15  # motor torque constant (m2006)

    @classmethod
    def from_mapping(cls, d: Mapping[str, Any]) -> "CartPoleParams":
        """Build from ``dataclasses.asdict()`` of the JAX package's params,
        or any mapping of field names to numbers (numpy scalars included).
        Every value becomes a Python float; unknown keys raise."""
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(f"unknown CartPoleParams fields: {sorted(unknown)}")
        return cls(**{k: float(v) for k, v in d.items()})

    # --- single-wheel formulation (examples/mppi4.rs:73-81) ---
    @property
    def d_lin(self) -> float:
        """(M1+M2+J1/R²)(M2 L²+J2) − M2²L² — examples/mppi4.rs:81."""
        return (self.m1 + self.m2 + self.j1 / (self.r_w * self.r_w)) * (
            self.m2 * self.l * self.l + self.j2
        ) - self.m2 * self.m2 * self.l * self.l

    @property
    def d0(self) -> float:
        """(M1+M2+J1/R²)(M2 L²+J2) — examples/mppi4-non-liner.rs:83."""
        return (self.m1 + self.m2 + self.j1 / (self.r_w * self.r_w)) * (
            self.m2 * self.l * self.l + self.j2
        )

    @property
    def mass_line(self) -> float:
        """M1 + M2 + J1/R² (single wheel)."""
        return self.m1 + self.m2 + self.j1 / (self.r_w * self.r_w)

    # --- two-wheel formulation (examples/mppi4-non-liner-ukf.rs:124-125) ---
    @property
    def d1_two(self) -> float:
        """(2M1+M2+2J1/R²)(M2 L²+J2) — examples/mppi4-non-liner-ukf.rs:125."""
        return (2.0 * self.m1 + self.m2 + 2.0 * self.j1 / (self.r_w * self.r_w)) * (
            self.m2 * self.l * self.l + self.j2
        )

    @property
    def mass_line_two(self) -> float:
        """2M1 + M2 + 2J1/R² (two driven wheels)."""
        return 2.0 * self.m1 + self.m2 + 2.0 * self.j1 / (self.r_w * self.r_w)

    @property
    def d_lin_two(self) -> float:
        """D1 − M2²L² — examples/mpc-ukf-s.rs:133."""
        return self.d1_two - self.m2 * self.m2 * self.l * self.l

    # --- named parameter sets ---
    @staticmethod
    def single_wheel(j2: float = 0.2, m2: float | None = None) -> "CartPoleParams":
        m1 = 150e-3
        r_w = 50e-3
        return CartPoleParams(
            m1=m1,
            r_w=r_w,
            m2=(2.3 - 2.0 * m1 + 2.0) if m2 is None else m2,
            l=0.2474,
            j1=m1 * r_w * r_w,
            j2=j2,
        )

    @staticmethod
    def single_wheel_light() -> "CartPoleParams":
        # examples/op-mpc-x.rs:30 — M2 = 2.3 - 2*M1 (no +2.0 payload)
        return CartPoleParams.single_wheel(j2=0.2, m2=2.3 - 2.0 * 150e-3)

    @staticmethod
    def single_wheel_heavy_j() -> "CartPoleParams":
        # examples/mpc-ukf-x.rs:19-23 — M2 = 2.0, J2 = 1.2
        return CartPoleParams.single_wheel(j2=1.2, m2=2.3 - 2.0 * 150e-3)

    @staticmethod
    def single_wheel_j01() -> "CartPoleParams":
        # examples/ukf-pen.rs:11 — J2 = 0.1
        return CartPoleParams.single_wheel(j2=0.1)

    @staticmethod
    def two_wheel() -> "CartPoleParams":
        # examples/mppi4-non-liner-ukf.rs:105-123
        return CartPoleParams(
            m1=160e-3,
            r_w=50e-3,
            m2=2.4,
            l=0.4,
            j1=2.23e5 * 1e-9,
            j2=1.168e8 * 1e-9,
        )
