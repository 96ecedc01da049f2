"""Port of the ops layer of mpc_rs_tpu (see the package docstring)."""
