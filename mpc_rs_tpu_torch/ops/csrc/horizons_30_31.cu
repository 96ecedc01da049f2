// tune's sweep at N = 30-31; serve's cart-pole and the rows' finalize at N = 30-31 (horizons.cuh).

#include "horizons.cuh"

MPC_SERVE_HORIZON(30)
MPC_SWEEP_HORIZON(30)
MPC_SERVE_HORIZON(31)
MPC_SWEEP_HORIZON(31)
