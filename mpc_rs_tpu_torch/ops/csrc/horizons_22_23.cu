// serve's cart-pole and the rows' finalize at N = 22-23 (horizons.cuh).

#include "horizons.cuh"

MPC_SERVE_HORIZON(22)
MPC_SERVE_HORIZON(23)
