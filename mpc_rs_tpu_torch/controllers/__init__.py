"""Port of the controllers layer of mpc_rs_tpu (see the package docstring)."""
