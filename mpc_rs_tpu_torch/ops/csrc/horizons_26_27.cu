// serve's cart-pole and the rows' finalize at N = 26-27 (horizons.cuh).

#include "horizons.cuh"

MPC_SERVE_HORIZON(26)
MPC_SERVE_HORIZON(27)
