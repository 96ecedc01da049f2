// The serve bridge's plan-streaming horizon at the default 0.01 s control
// period (mpc_rs_tpu/apps/serve.py:202, --ticks-per-dispatch M > 1): the
// nonlinear cart-pole with shaped4 at N = 40, the exact tier, box-muller
// (serve's only sampler) at R = 1 and 4 (R = 4 from K >= 66 561 at 8
// robots): 2 instantiations of mppi_partials_kernel, and the rows' finalize
// at N = 40 (horizons.cuh). At R = 4 the kernel asks for one block an SM
// (kMinBlocksWide<40>, mppi_common.cuh), as mppi2's N = 40.

#include "horizons.cuh"

MPC_SERVE_HORIZON(40)
