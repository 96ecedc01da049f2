// tune's sweep at N = 24-25; serve's cart-pole and the rows' finalize at N = 24-25 (horizons.cuh).

#include "horizons.cuh"

MPC_SERVE_HORIZON(24)
MPC_SWEEP_HORIZON(24)
MPC_SERVE_HORIZON(25)
MPC_SWEEP_HORIZON(25)
