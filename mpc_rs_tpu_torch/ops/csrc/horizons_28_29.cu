// serve's cart-pole and the rows' finalize at N = 28-29 (horizons.cuh).

#include "horizons.cuh"

MPC_SERVE_HORIZON(28)
MPC_SERVE_HORIZON(29)
