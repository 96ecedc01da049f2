// Host launchers of mppi_partials_kernel (mppi_common.cuh), shared by the
// sources that instantiate it: mppi_kernels.cu (the main paths' N = 8
// models, both tiers, and the C entries) and one source a model of the
// MPPI application family (family_*.cu, the exact tier at the app's
// horizon). build.py compiles the sources in parallel, one nvcc each, and
// links them into one library; the C entries reach a family model through
// its launch_* function below.

#pragma once

#include "mppi_common.cuh"

namespace mpc {

// The partials kernel at N steps and R rollouts a thread, by noise source
// (external noise or a sampler ID); returns the launch's
// cudaGetLastError(), or -2 for an unknown source.
template <int N, bool Fast, int R, class Model, class Cost>
int launch_partials_r(int source, const Model& model, const Cost& cost, const PartialsArgs& a,
                      dim3 grid, const PartialsIO& io, cudaStream_t stream) {
#define MPC_PARTIALS_LAUNCH(S)                                                                \
  mppi_partials_kernel<N, Model, Cost, Fast, S, R><<<grid, kThreads, 0, stream>>>(model, cost, a, io)
  switch (source) {
    case kExternal: MPC_PARTIALS_LAUNCH(kExternal); break;
    case kBoxMuller: MPC_PARTIALS_LAUNCH(kBoxMuller); break;
    case kClt4: MPC_PARTIALS_LAUNCH(kClt4); break;
    case kClt4a: MPC_PARTIALS_LAUNCH(kClt4a); break;
    case kWallace: MPC_PARTIALS_LAUNCH(kWallace); break;
    case kClt2q: MPC_PARTIALS_LAUNCH(kClt2q); break;
    case kBoxMullerA: MPC_PARTIALS_LAUNCH(kBoxMullerA); break;
    default: return -2;
  }
#undef MPC_PARTIALS_LAUNCH
  return (int)cudaGetLastError();
}

// The partials kernel on a grid of n_problems problems of ceil(K/(256 R))
// blocks each, sampler by ID (or external noise when io.noise is not null);
// -2 for an unknown sampler or for external noise without a noise pointer,
// -3 for an R other than 1 and 4.
template <int N, bool Fast, class Model, class Cost>
int launch_partials_grid(int sampler, int rpt, const Model& model, const Cost& cost,
                         const PartialsArgs& a, int n_problems, const PartialsIO& io,
                         cudaStream_t stream) {
  if (io.noise == nullptr && sampler == kExternal) return -2;
  const int source = io.noise != nullptr ? (int)kExternal : sampler;
  const int per_block = kThreads * rpt;
  const dim3 grid((a.k + per_block - 1) / per_block, n_problems);
  if (rpt == 1) return launch_partials_r<N, Fast, 1>(source, model, cost, a, grid, io, stream);
  if (rpt == 4) return launch_partials_r<N, Fast, 4>(source, model, cost, a, grid, io, stream);
  return -3;
}

// One call of a C entry: the launch of n_problems problems on io (K2: one
// problem; the fleet: B), or, with n_solves = J > 0, the receding-horizon
// chain (K1) of J launches on one problem, io describing solve 0.
struct SolveCall {
  const float* model_consts;  // the model functor's floats, in its field order
  const float* cost_consts;   // the cost functor's floats (Diag4's four; else unused)
  int sampler;                // enum Sampler (ignored when io.noise is set)
  int rpt;                    // rollouts a thread R, 1 or 4
  PartialsArgs a;
  PartialsIO io;
  int n_problems;
  int n_solves;
  cudaStream_t stream;
};

// Solve j of a chain reads noise[j] (J, K, N) or keys seeds[j] with counter
// word 0 (the draw of a single solve with seed seeds[j]), else base_seed
// with word j; its merge writes statuses[j], u0s[j], u_n in place (the
// verbatim warm start of solve j+1) and, in plant mode, steps x. All
// launches go to one stream, with no host synchronisation between them.
template <int N, bool Fast, class Model, class Cost>
int launch_call(const Model& model, const Cost& cost, const SolveCall& c) {
  if (c.n_solves == 0) {
    return launch_partials_grid<N, Fast>(c.sampler, c.rpt, model, cost, c.a, c.n_problems, c.io, c.stream);
  }
  for (int j = 0; j < c.n_solves; ++j) {
    PartialsIO io = c.io;
    if (io.noise != nullptr) io.noise += (size_t)j * c.a.k * N;
    if (io.seeds != nullptr) io.seeds += j; else io.word0 = (uint32_t)j;
    io.status += j;
    io.u0 += j;
    const int err = launch_partials_grid<N, Fast>(c.sampler, c.rpt, model, cost, c.a, 1, io, c.stream);
    if (err != 0) return err;
  }
  return 0;
}

// The MPPI application family, one source each (exact tier):
int launch_double_integrator_quad2(const SolveCall& c);  // mppi2, N = 40 (family_mppi2.cu)
int launch_cartpole_linear_shaped4(const SolveCall& c);  // mppi4, N = 8 (family_mppi4.cu)
int launch_commu4(const SolveCall& c);                   // the HW flagship, N = 20 (family_commu4.cu)

// The cart-pole + shaped4 at serve's plan-streaming horizons, N =
// kServeFirst..kServeLast, exact tier, box-muller (mppi_horizons_kernel, one
// kernel that takes N at run time), and the rows' finalize at every horizon
// of launch_model's pairs, N = kN..kServeLast (fleet_finalize_kernel, the
// same): horizons.cu. Each returns -1 for a horizon outside its range; the
// cart-pole -2 for another noise source and -3 for an R other than 1 and 4.
constexpr int kServeFirst = 9;
constexpr int kServeLast = 40;
int launch_cartpole_horizon(int n, const SolveCall& c);
int launch_finalize(int n, int n_scen, int nb, float inv_lambda, const float* partials, float* u_out, int* status,
                    cudaStream_t stream);

}  // namespace mpc
