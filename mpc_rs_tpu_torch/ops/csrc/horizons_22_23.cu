// tune's sweep at N = 22-23; serve's cart-pole and the rows' finalize at N = 22-23 (horizons.cuh).

#include "horizons.cuh"

MPC_SERVE_HORIZON(22)
MPC_SWEEP_HORIZON(22)
MPC_SERVE_HORIZON(23)
MPC_SWEEP_HORIZON(23)
