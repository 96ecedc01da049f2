// serve's cart-pole and the rows' finalize at N = 40 (box-muller at R = 1 and 4) (horizons.cuh).

#include "horizons.cuh"

MPC_SERVE_HORIZON(40)
