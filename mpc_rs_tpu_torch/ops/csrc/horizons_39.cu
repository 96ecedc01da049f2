// serve's cart-pole and the rows' finalize at N = 39 (horizons.cuh).

#include "horizons.cuh"

MPC_SERVE_HORIZON(39)
