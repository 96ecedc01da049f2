// tune's sweep at N = 32; serve's cart-pole and the rows' finalize at N = 32 (horizons.cuh).

#include "horizons.cuh"

MPC_SERVE_HORIZON(32)
MPC_SWEEP_HORIZON(32)
