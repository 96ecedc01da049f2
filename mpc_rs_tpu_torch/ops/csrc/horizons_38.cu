// tune's sweep at N = 38; serve's cart-pole and the rows' finalize at N = 38 (horizons.cuh).

#include "horizons.cuh"

MPC_SERVE_HORIZON(38)
MPC_SWEEP_HORIZON(38)
