// The instantiations a horizon at a time: past N = 8 what serve's plan
// streaming reaches, split over the horizons_*.cu sources, a span of
// horizons each, so that nvcc builds them beside each other (ops/build.py):
// the nonlinear cart-pole with shaped4 in the exact tier at N = kServeFirst..kServeLast, box-muller
// alone, at R = 1 (and R = 4 at N = 40 only), and fleet_finalize_kernel at
// every horizon of launch_model's pairs, N = kN..kServeLast. Each source
// instantiates its span explicitly; mppi_kernels.cu sees only the
// declarations in mppi_launch.cuh and reaches them through tables indexed
// by N.
//
// With --ticks-per-dispatch M > 1 the JAX serve runs
// N = clip(round(0.8 / period), max(8, M), 40) (mpc_rs_tpu/apps/serve.py:202):
// every N of 8-40. The cart-pole replaces the Pallas kernels of
// mppi_solve_pallas_batch / mppi_pallas_batch_partials
// (mpc_rs_tpu/ops/mppi_pallas.py:692, 739) and mppi_pallas_partials (:438)
// traced on that model at each N. A step pays one accurate sincosf and two
// IEEE divisions, so the FP32 instruction rate bounds it. The row's N + 1
// sums fit in warp 0 up to N = 31 and span two warps from N = 32
// (partials_end_wide, mppi_common.cuh); box-muller's last pair is half used
// at odd N. kMinBlocksR1<N> is 1 past N = 8, so ptxas takes the registers
// a horizon needs: 48 at N = 9 to 145 at N = 39, no spill (chip_smoke.py,
// SERVE_R1_PTXAS); past 128, from N = 38, a block of 256 threads leaves
// room for one block an SM, not two.

#pragma once

#include "mppi_launch.cuh"

namespace mpc {

// Rows merged outside the partials launch (the rows-only entry, and the
// multi-GPU merge's all-reduced rows at nb = 1): one warp per scenario merges its nb rows
// by log-sum-exp (merge_rows_warp, as the partials launch's last block does
// for a few rows), then the status ladder and zero fallback
// (mppi_pallas.py:1021-1036). Instantiated at every horizon of launch_model's
// pairs, N = 8-40, so the K-sharded solve finishes any built pair. A lane
// folds its rows one after another (fold_rows) and keeps the N + 1 sums
// (s, uw) in registers; the warp's shuffles then add them sum by sum. So at
// N = 40 the 41 sums need no lane per sum, unlike partials_end_wide, whose
// block_sums leave sum i in thread i and gather them in shared memory.
template <int N>
__global__ void __launch_bounds__(kThreads)
fleet_finalize_kernel(float inv_lambda, int n_scen, int nb, const float* __restrict__ partials,
                      float* __restrict__ u_out, int* __restrict__ status) {
  const int sc = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (sc >= n_scen) return;  // the whole warp leaves together
  float tot[N + 1];
  const float m_all = merge_rows_warp<N>(partials + (size_t)sc * nb * (N + 2), nb, inv_lambda, tot);
  if ((threadIdx.x & 31) == 0) status[sc] = status_ladder<N>(m_all, tot, u_out + (size_t)sc * N);
}

template <int N>
int launch_finalize(int n_scen, int nb, float inv_lambda, const float* partials, float* u_out, int* status,
                    cudaStream_t stream) {
  const int blocks = (n_scen + kWarps - 1) / kWarps;
  fleet_finalize_kernel<N><<<blocks, kThreads, 0, stream>>>(inv_lambda, n_scen, nb, partials, u_out, status);
  return (int)cudaGetLastError();
}

template <int N>
int launch_cartpole_shaped4(const SolveCall& c) {
  static_assert(N >= kServeFirst && N <= kServeLast, "serve's plan-streaming horizons");
  const float* m = c.model_consts;
  return launch_call<N, false, N == 40 ? kBoxMullerR14 : kBoxMullerR1>(
      CartPoleNonlinearT<false>{m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7], m[8]}, Shaped4{}, c);
}

}  // namespace mpc

// The explicit instantiations of one horizon, for the horizons_*.cu sources:
// the finalize alone (N = kN), or the cart-pole and the finalize.
#define MPC_FINALIZE_HORIZON(N) \
  template int mpc::launch_finalize<N>(int, int, float, const float*, float*, int*, cudaStream_t);
#define MPC_SERVE_HORIZON(N)                                            \
  template int mpc::launch_cartpole_shaped4<N>(const mpc::SolveCall&); \
  MPC_FINALIZE_HORIZON(N)
