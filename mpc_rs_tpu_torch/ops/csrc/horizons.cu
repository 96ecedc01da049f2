// The cart-pole's solves past N = 8 and the rows' finalize, each one kernel
// that takes the horizon at run time, and their launchers (declared in
// mppi_launch.cuh, reached from the C entries of mppi_kernels.cu).
//
// mppi_horizons_kernel: the nonlinear cart-pole with shaped4 in the exact
// tier at serve's plan-streaming horizons, N = kServeFirst..kServeLast
// (9-40). With --ticks-per-dispatch M > 1 the JAX serve runs
// N = clip(round(0.8 / period), max(8, M), 40) (mpc_rs_tpu/apps/serve.py:202).
// It replaces the Pallas kernels of mppi_solve_pallas_batch /
// mppi_pallas_batch_partials (mpc_rs_tpu/ops/mppi_pallas.py:692, 739) and
// mppi_pallas_partials (:438) traced on that model at each N, for every
// entry that takes the pair: K2 (one problem), K1 (J launches), serve's
// batch of B robots, the rows alone and the merged rows of the K-sharded
// solve. It is tile_solve<false> (tile_solve.cuh, the body of tune's sweep
// too): the tile's controls and u_n in shared memory, a rollout's steps
// streamed, so its registers and blocks an SM do not depend on N. A block
// covers the rollouts of the partials kernel's block at R rollouts a thread
// (rollouts (g R + j) 256 + tid, j < R), as tiles = R tiles of 256, one
// rollout a thread each: the rows, their number nb = ceil(K / (256 R)) and
// the Philox words (key seeds[b] or the base seed, counter (k, c,
// word0 + b, 0), box-muller: mppi_common.cuh sample<>) are the partials
// kernel's. Its shared memory, tile_shared_bytes(N, 1), is 42 408 bytes at
// N = 40, under the 48 KB a launch takes without asking, and five blocks
// fit an SM's 228 KB at every N.
//
// fleet_finalize_kernel: rows merged outside the partials launch (the
// rows-only entry, and the multi-GPU merge's all-reduced rows at nb = 1): a
// block a scenario merges its nb rows by log-sum-exp, then the status ladder
// and zero fallback (mppi_pallas.py:1021-1036), at any N of kN..kServeLast
// (8-40). The merge is merge_rows_warp_n (mppi_common.cuh): the bits of the
// partials kernel's own warp merge, merge_rows_warp, with the N + 1 sums
// split over ceil((N + 1) / 8) warps, eight a warp (2 warps at N = 8, 6 at
// N = 40), each one pass over the rows, into shared memory; so no array of
// N floats is held, and the rows-only launch finished here is the
// merged-in-launch solve bit for bit, at N = 8 as at the family's N = 20
// and 40 and the cart-pole's N = 9-40 (whose kernel merges up to
// kWarpMergeRows rows the same way). The work is a few hundred floats a
// scenario, so the launch's own time bounds it.

#include "mppi_launch.cuh"
#include "tile_solve.cuh"

namespace mpc {

__global__ void __launch_bounds__(kThreads, kTileMinBlocks)
mppi_horizons_kernel(CartPoleNonlinearT<false> model, TileArgs a) {
  tile_solve<false>(model, a);
}

// The finalize's warps a scenario: one a chunk of kFinalizeChunk sums.
constexpr int kFinalizeChunk = 8;

__global__ void __launch_bounds__(kThreads)
fleet_finalize_kernel(int n, float inv_lambda, int nb, const float* __restrict__ partials, float* __restrict__ u_out,
                      int* __restrict__ status) {
  __shared__ float tot[kServeLast + 1];
  const int sc = blockIdx.x;
  const float m_all = merge_rows_warp_n<kFinalizeChunk>(partials + (size_t)sc * nb * (n + 2), nb, n, inv_lambda, tot,
                                                        threadIdx.x >> 5, blockDim.x >> 5);
  __syncthreads();
  // status_ladder on the merged sums, a thread a control
  const float s_all = tot[0];
  const bool no_finite = m_all <= kNoFiniteBelow;
  const bool sum_zero = s_all == 0.0f;
  const float denom = sum_zero ? 1.0f : s_all;
  const int st = no_finite ? kNoFinite : sum_zero ? kSumZero : !isfinite(tot[1] / denom) ? kInvalidU : kOk;
  if ((int)threadIdx.x < n) u_out[(size_t)sc * n + threadIdx.x] = st == kOk ? tot[1 + threadIdx.x] / denom : 0.0f;
  if (threadIdx.x == 0) status[sc] = st;
}

int launch_cartpole_horizon(int n, const SolveCall& c) {
  if (n < kServeFirst || n > kServeLast) return -1;
  if (c.io.noise != nullptr || c.sampler != kBoxMuller) return -2;  // built for box-muller alone
  if (c.rpt != 1 && c.rpt != 4) return -3;
  const float* m = c.model_consts;
  const CartPoleNonlinearT<false> model{m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7], m[8]};
  TileArgs a{};
  a.n = n;
  a.k = c.a.k;
  a.tiles = c.rpt;
  a.r = 1;
  a.lo = c.a.lo;
  a.hi = c.a.hi;
  a.x = c.io.x;
  a.u_n = c.io.u_n;
  a.seeds = c.io.seeds;
  a.key = c.io.base_seed;
  a.word0 = c.io.word0;
  a.inv_lambda = c.a.inv_lambda;
  a.sigma = c.a.std_dev;
  a.inv = c.a.inv;
  a.partials = c.io.partials;
  a.tickets = c.io.tickets;
  a.u_out = c.io.u_out;
  a.status = c.io.status;
  a.noise_out = c.io.noise_out;
  a.u0 = c.io.u0;
  a.x_plant = c.io.x_plant;
  a.row_out = c.io.row_out;
  const int per_block = kThreads * c.rpt;
  const int nb = (c.a.k + per_block - 1) / per_block;
  const size_t bytes = tile_shared_bytes(n, 1);
  if (c.n_solves == 0) {
    mppi_horizons_kernel<<<dim3(nb, c.n_problems), kThreads, bytes, c.stream>>>(model, a);
    return (int)cudaGetLastError();
  }
  // the chain (K1): solve j keys seeds[j] with word 0, else the base seed
  // with word j, and writes statuses[j] and u0s[j] (launch_call's rule)
  for (int j = 0; j < c.n_solves; ++j) {
    TileArgs aj = a;
    if (aj.seeds != nullptr) aj.seeds += j; else aj.word0 = (uint32_t)j;
    aj.status += j;
    aj.u0 += j;
    mppi_horizons_kernel<<<dim3(nb, 1), kThreads, bytes, c.stream>>>(model, aj);
    if (const int err = (int)cudaGetLastError()) return err;
  }
  return 0;
}

int launch_finalize(int n, int n_scen, int nb, float inv_lambda, const float* partials, float* u_out, int* status,
                    cudaStream_t stream) {
  if (n < kN || n > kServeLast) return -1;
  const int warps = (n + 1 + kFinalizeChunk - 1) / kFinalizeChunk;  // n < blockDim.x too
  fleet_finalize_kernel<<<n_scen, 32 * warps, 0, stream>>>(n, inv_lambda, nb, partials, u_out, status);
  return (int)cudaGetLastError();
}

}  // namespace mpc

extern "C" {

// mppi_horizons_kernel at horizon n (kServeFirst..kServeLast): the blocks an
// SM holds at its dynamic shared memory
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) into *blocks; registers a
// thread and local bytes (cudaFuncGetAttributes) into *regs and
// *local_bytes; the launch's dynamic shared bytes into *shared_bytes.
// Returns 0, -1 for another n, or the CUDA error.
int mpc_horizons_occupancy(int n, int* blocks, int* regs, int* local_bytes, int* shared_bytes) {
  if (n < mpc::kServeFirst || n > mpc::kServeLast) return -1;
  const size_t bytes = mpc::tile_shared_bytes(n, 1);
  *shared_bytes = (int)bytes;
  cudaFuncAttributes attr{};
  cudaError_t err = cudaFuncGetAttributes(&attr, mpc::mppi_horizons_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, mpc::mppi_horizons_kernel, mpc::kThreads, bytes);
}

}  // extern "C"
