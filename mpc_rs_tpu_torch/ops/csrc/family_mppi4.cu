// K1/K2 of mppi4 (mpc_rs_tpu/apps/mppi_examples.py:47-80): the linear
// cart-pole with shaped4 at N = 8, the exact tier, every noise source at
// R = 1 and 4 (14 instantiations of mppi_partials_kernel). Replaces the
// Pallas kernel of mppi_solve_pallas traced on that model
// (mpc_rs_tpu/ops/mppi_pallas.py:438, 1004). No transcendental in the
// rollout: the sampler and the clamps of shaped4 set the time. Its own
// source so that nvcc builds it beside the others.

#include "mppi_launch.cuh"

namespace mpc {

int launch_cartpole_linear_shaped4(const SolveCall& c) {
  const float* m = c.model_consts;
  return launch_call<kN, false>(CartPoleLinear{m[0], m[1], m[2], m[3], m[4]}, Shaped4{}, c);
}

}  // namespace mpc
