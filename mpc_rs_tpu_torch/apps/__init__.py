"""Port of the apps layer of mpc_rs_tpu (see the package docstring)."""
