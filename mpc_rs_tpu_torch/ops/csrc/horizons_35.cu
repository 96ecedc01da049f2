// serve's cart-pole and the rows' finalize at N = 35 (horizons.cuh).

#include "horizons.cuh"

MPC_SERVE_HORIZON(35)
