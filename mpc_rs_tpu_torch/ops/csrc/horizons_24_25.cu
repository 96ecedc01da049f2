// serve's cart-pole and the rows' finalize at N = 24-25 (horizons.cuh).

#include "horizons.cuh"

MPC_SERVE_HORIZON(24)
MPC_SERVE_HORIZON(25)
