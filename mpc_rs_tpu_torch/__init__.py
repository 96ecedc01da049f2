"""mpc_rs_tpu_torch — the PyTorch/CUDA port of ``mpc_rs_tpu``.

A second package beside the JAX one, laid out like it so that each module's
counterpart has the same path. It imports ``torch`` and never ``jax`` or
``mpc_rs_tpu``. Plain tensor code is PyTorch; each Pallas TPU kernel of the
JAX package becomes a CUDA kernel written for Hopper (``ops/csrc/``), with a
plain PyTorch version beside it that the CPU tests hold against the JAX
package.

Ported so far: the ``mppi4-non-liner`` slice (models, the MPPI controller,
the fused single-solve and chain kernels, the CSV logger, its CLI) and the
scenario fleet (the flagship and fast-tier models, the fleet's SoA UKF, the
scenario-batched kernel with the clt4/clt4a/wallace samplers and the fast
math, the fleet tick and ``python -m mpc_rs_tpu_torch.apps.run fleet``).
"""

__version__ = "0.1.0"

from mpc_rs_tpu_torch.controllers.mppi import MppiConfig, MppiStatus, mppi_solve

__all__ = ["MppiConfig", "MppiStatus", "mppi_solve"]
