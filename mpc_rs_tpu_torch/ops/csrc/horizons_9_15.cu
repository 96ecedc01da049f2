// serve's cart-pole and the rows' finalize at N = 9-15 (horizons.cuh).

#include "horizons.cuh"

MPC_SERVE_HORIZON(9)
MPC_SERVE_HORIZON(10)
MPC_SERVE_HORIZON(11)
MPC_SERVE_HORIZON(12)
MPC_SERVE_HORIZON(13)
MPC_SERVE_HORIZON(14)
MPC_SERVE_HORIZON(15)
