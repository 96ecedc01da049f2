// serve's cart-pole and the rows' finalize at N = 16-18 (horizons.cuh).

#include "horizons.cuh"

MPC_SERVE_HORIZON(16)
MPC_SERVE_HORIZON(17)
MPC_SERVE_HORIZON(18)
