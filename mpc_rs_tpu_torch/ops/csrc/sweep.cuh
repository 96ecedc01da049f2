// tune's sweep (mpc_rs_tpu/apps/tune.py:40-81, a vmap of mppi_solve over
// per-episode (lambda, sigma); the JAX package has no Pallas kernel of its
// own for it, so it stands for the batch kernel's work, mppi_pallas.py:692):
// B MPPI solves of the exact cart-pole with shaped4, problem b at its own
// f32(1/lambda_b), sigma_b and f32(sigma_b^-2), in one launch, at any
// horizon N from 1 to the largest whose shared memory fits one block
// (SWEEP_MAX_HORIZON in ops/mppi_cuda.py, sweep_shared_bytes below).
//
// One kernel for every N, in the tile layout of tile_solve.cuh (the tile's
// controls and u_n in shared memory, a rollout's steps streamed), whose
// body it shares with the cart-pole's solves past N = 8 (horizons.cu):
// tile_solve<true> draws every problem with the counter word of the tick
// (box-muller keyed seeds[b], counter (k, c, tick, 0): the words of
// sweep_noise), carries the sum of w^2 beside (m, s, uw) in a block's row
// (N + 3 floats) and ends each solve with the ladder and ESS_b = s^2 /
// max(sum w^2, 1e-30) (mpc_rs_tpu/controllers/mppi.py:145).
//
// A tile holds 256 R rollouts, R a thread: the wrapper picks R
// (sweep_rollouts_a_thread in ops/mppi_cuda.py) and the tiles a block
// (sweep_tiles) and passes both in TileArgs. The design asked for a tile of
// 256 rollouts, one a thread; measured on an H100 at tune's grid (N = 8,
// B = 96, K = 800 000) it ran slower than the partials kernel it replaces at
// R = 4, whose block reduces once per 1 024 rollouts: R rollouts a thread a
// tile brought the reductions to the same count and the time level with it
// (PERF.md §6). R N is held to 40, so that the tile's controls take at most
// 40 KB and shared memory keeps five blocks an SM.
//
// Shared memory is tile_shared_bytes(N, R): at the wrapper's R at most
// 45 240 bytes up to N = 40, so that it holds five blocks an SM there; past
// N = 40 shared memory sets the count (3 at N = 64, 1 at N = 224).

#pragma once

#include "tile_solve.cuh"

namespace mpc {

// Blocks an SM the launch bounds ask for (tile_solve.cuh's count).
constexpr int kSweepMinBlocks = kTileMinBlocks;

// The dynamic shared memory of a sweep block at horizon n with R = r
// rollouts a thread a tile.
__host__ __device__ constexpr size_t sweep_shared_bytes(int n, int r) { return tile_shared_bytes(n, r); }

__global__ void __launch_bounds__(kThreads, kSweepMinBlocks)
mppi_sweep_kernel(CartPoleNonlinearT<false> model, TileArgs a) {
  tile_solve<true>(model, a);
}

}  // namespace mpc
