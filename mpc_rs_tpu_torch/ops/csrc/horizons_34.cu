// tune's sweep at N = 34; serve's cart-pole and the rows' finalize at N = 34 (horizons.cuh).

#include "horizons.cuh"

MPC_SERVE_HORIZON(34)
MPC_SWEEP_HORIZON(34)
