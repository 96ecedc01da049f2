// serve's cart-pole and the rows' finalize at N = 32, and the rows' finalize at N = 8 (horizons.cuh).

#include "horizons.cuh"

MPC_FINALIZE_HORIZON(8)
MPC_SERVE_HORIZON(32)
