// tune's sweep at N = 35; serve's cart-pole and the rows' finalize at N = 35 (horizons.cuh).

#include "horizons.cuh"

MPC_SERVE_HORIZON(35)
MPC_SWEEP_HORIZON(35)
