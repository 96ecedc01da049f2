"""Scalar Gaussian algebra of the 1-D Kalman demo — src/gaussian.rs.

Port of ``mpc_rs_tpu/estimators/gaussian.py:16-52``: ``+``/``-`` convolve
(add or subtract the means and the variances; the reference subtracts
variances too, src/gaussian.rs:34-41), ``*`` of two Gaussians is the
Bayesian product (the 1-D measurement update, src/gaussian.rs:44-52) and
``*`` with a scalar scales both moments (src/gaussian.rs:54-63). The
moments may be tensors of any shape, for batched 1-D filters.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Gaussian(NamedTuple):
    mean: torch.Tensor
    var: torch.Tensor

    def __add__(self, other):
        return Gaussian(self.mean + other.mean, self.var + other.var)

    def __sub__(self, other):
        return Gaussian(self.mean - other.mean, self.var - other.var)

    def __mul__(self, other):
        if isinstance(other, Gaussian):
            denom = self.var + other.var
            return Gaussian((self.var * other.mean + other.var * self.mean) / denom,
                            (self.var * other.var) / denom)
        return Gaussian(self.mean * other, self.var * other)

    __rmul__ = __mul__


def kf1d_predict(x: Gaussian, u: Gaussian) -> Gaussian:
    """x' = x + u (convolution) — examples/one-liner-kf.rs:13-18."""
    return Gaussian(x.mean + u.mean, x.var + u.var)
