// K1/K2 of mppi2 (mpc_rs_tpu/apps/mppi_examples.py:18-44): the double
// integrator with quad2 at N = 40, two states, the exact tier, every noise
// source at R = 1 and 4 (14 instantiations of mppi_partials_kernel).
// Replaces the Pallas kernel of mppi_solve_pallas traced on that model
// (mpc_rs_tpu/ops/mppi_pallas.py:438, 1004). The model is a few mul-adds a
// step, so the sampler and the 41 running sums a rollout carries set the
// time; at N = 40 a thread holds 40 nominals, 40 controls and 41 sums in
// registers. Its own source so that nvcc builds it beside the others.

#include "mppi_launch.cuh"

namespace mpc {

int launch_double_integrator_quad2(const SolveCall& c) {
  return launch_call<40, false>(DoubleIntegrator{c.model_consts[0]}, Quad2{}, c);
}

}  // namespace mpc
