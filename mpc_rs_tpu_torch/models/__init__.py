"""Port of the models layer of mpc_rs_tpu (see the package docstring)."""
