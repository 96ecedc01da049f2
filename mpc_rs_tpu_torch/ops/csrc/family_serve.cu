// The serve bridge's plan-streaming horizon (mpc_rs_tpu/apps/serve.py:202,
// --ticks-per-dispatch M > 1 at the default 0.01 s control period): the
// nonlinear cart-pole with shaped4 at N = 40, the exact tier, every noise
// source at R = 1 and 4 (14 instantiations of mppi_partials_kernel). One
// instantiation serves K1, K2 and the scenario batch (K5/K6: serve's B
// robots on a grid of B problems), as they share launch_call. Replaces the
// Pallas kernels of mppi_solve_pallas_batch / mppi_pallas_batch_partials
// (mpc_rs_tpu/ops/mppi_pallas.py:692, 739) and mppi_pallas_partials (:438)
// traced on that model at N = 40. A step pays one accurate sincosf and two
// IEEE divisions, so the FP32 instruction rate bounds it; the row's 41 sums
// span two warps (partials_end_wide), and at R = 4 the kernel asks for one
// block an SM (kMinBlocksWide<40>, mppi_common.cuh), as mppi2's N = 40.
// Its own source so that nvcc builds it beside the others.

#include "mppi_launch.cuh"

namespace mpc {

int launch_cartpole_shaped4_n40(const SolveCall& c) {
  const float* m = c.model_consts;
  return launch_call<40, false>(CartPoleNonlinearT<false>{m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7], m[8]},
                                Shaped4{}, c);
}

}  // namespace mpc
