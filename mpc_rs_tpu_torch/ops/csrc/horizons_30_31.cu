// serve's cart-pole and the rows' finalize at N = 30-31 (horizons.cuh).

#include "horizons.cuh"

MPC_SERVE_HORIZON(30)
MPC_SERVE_HORIZON(31)
