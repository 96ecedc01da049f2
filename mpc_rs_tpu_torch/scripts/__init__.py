"""Port of the diagnostic scripts of the JAX package that run a Pallas
kernel: ``diag_kernel_mix`` (``scripts/diag_kernel_mix.py``, D1) and
``diag_bf16_fma`` (``scripts/diag_bf16_vpu.py``, D2), each an entry point
(``python -m mpc_rs_tpu_torch.scripts.<name>``) with a ``main(argv)`` that
returns its results."""
