// serve's cart-pole and the rows' finalize at N = 19-21 (horizons.cuh).

#include "horizons.cuh"

MPC_SERVE_HORIZON(19)
MPC_SERVE_HORIZON(20)
MPC_SERVE_HORIZON(21)
