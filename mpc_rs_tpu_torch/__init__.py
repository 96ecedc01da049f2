"""mpc_rs_tpu_torch — the PyTorch/CUDA port of ``mpc_rs_tpu``.

A second package beside the JAX one, laid out like it so that each module's
counterpart has the same path. It imports ``torch`` and never ``jax`` or
``mpc_rs_tpu``. Plain tensor code is PyTorch; each Pallas TPU kernel of the
JAX package becomes a CUDA kernel written for Hopper (``ops/csrc/``), with a
plain PyTorch version beside it that the CPU tests hold against the JAX
package.

Ported so far: the ``mppi4-non-liner`` slice — models (params, nonlinear
cart-pole, shaped4 cost), the MPPI controller, the fused single-solve and
chain kernels with their Philox sampler, the CSV logger, and the
``python -m mpc_rs_tpu_torch.apps.run mppi4-non-liner`` CLI.
"""

__version__ = "0.1.0"

from mpc_rs_tpu_torch.controllers.mppi import MppiConfig, MppiStatus, mppi_solve

__all__ = ["MppiConfig", "MppiStatus", "mppi_solve"]
