// tune's sweep at N = 39; serve's cart-pole and the rows' finalize at N = 39 (horizons.cuh).

#include "horizons.cuh"

MPC_SERVE_HORIZON(39)
MPC_SWEEP_HORIZON(39)
