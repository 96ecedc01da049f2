// tune's sweep at N = 33; serve's cart-pole and the rows' finalize at N = 33 (horizons.cuh).

#include "horizons.cuh"

MPC_SERVE_HORIZON(33)
MPC_SWEEP_HORIZON(33)
