// tune's sweep at N = 36; serve's cart-pole and the rows' finalize at N = 36 (horizons.cuh).

#include "horizons.cuh"

MPC_SERVE_HORIZON(36)
MPC_SWEEP_HORIZON(36)
