"""Port of the runtime layer of mpc_rs_tpu (see the package docstring)."""
