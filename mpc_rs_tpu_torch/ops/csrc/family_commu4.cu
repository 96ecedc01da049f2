// K1/K2 of the HW flagship (bench.py:230-288, _bench_hw_flagship; the
// controller of mppi4-ukf-commu): make_commu4 with costs.commu4 at N = 20,
// the exact tier, every noise source at R = 1 and 4 (14 instantiations of
// mppi_partials_kernel). Replaces the Pallas kernel of mppi_solve_pallas /
// mppi_pallas_chain traced on that model (mpc_rs_tpu/ops/mppi_pallas.py:438,
// 1004). A step pays one accurate sincosf and four IEEE divisions, so the
// FP32 instruction rate bounds it, as the nonlinear cart-pole. wallace's window
// of 8 steps ends in mid-window at N = 20 (steps 16-19 are phases 0-3).
// Its own source so that nvcc builds it beside the others.

#include "mppi_launch.cuh"

namespace mpc {

int launch_commu4(const SolveCall& c) {
  const float* m = c.model_consts;
  return launch_call<20, false>(
      Commu4{m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7], m[8], m[9], m[10]}, Commu4Cost{}, c);
}

}  // namespace mpc
