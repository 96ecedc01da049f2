// Fused kernels for Hopper (sm_90a): one MPPI solve (K2), the
// receding-horizon chain of solves (K1), the scenario batch of the fleet
// (K5 + K6), the fleet's fused estimator chain (K7, estimator_chain.cuh), an
// elementwise probe of the fast-math device functions (K4), and the two
// diagnostic probes, the kernel op-mix chain (D1) and the mul-add chain (D2)
// (diag_kernels.cuh, whose notes say what they replace and what bounds them).
//
// Replaces the Pallas TPU kernels of mpc_rs_tpu/ops/mppi_pallas.py. Every
// solve runs one partials kernel, mppi_partials_kernel (mppi_common.cuh),
// on a grid (ceil(K/256), P) of P problems, then a finalize:
//   - K2 (mppi_pallas_partials / _make_kernel + finalize_partials): P = 1,
//     the solve index in the Philox counter word, either tier, any sampler
//     or external noise; mppi_finalize_kernel merges the rows in one block;
//   - K1 (mppi_pallas_chain / _make_chain_kernel): J such solves issued
//     from a C loop on one stream, the finalize optionally stepping the
//     plant on the device;
//   - K5 and K6 (mppi_pallas_batch_partials: _make_fleet_kernel, one
//     (bs, 128) block per scenario with 8 scenarios unrolled per grid step,
//     and _make_batched_kernel, a scenario's K-blocks streamed through
//     carried accumulators): P = B scenarios, with the six branches of
//     _fill_vbuf (K3) and the fast tier of ops/fastmath.py (K4) inlined. The TPU needed two kernels only for its
//     layout; here one grid covers both shapes: at K = 1 024 each scenario
//     has 4 blocks, at K = 8 192 it has 32, at K = 65 536 it has 256. Blocks
//     run in no order, so instead of K6's carried accumulators each block
//     writes one row of a (B, nb, N+2) streaming log-sum-exp, and
//     fleet_finalize_kernel (one warp per scenario) merges a scenario's rows
//     and writes u_n' (B, N) and the status (B,) on the device.
//
// What bounds it on the card: the FP32 issue rate and the transcendentals,
// not bytes. One thread is one rollout: its N samples and the state stay in
// registers (N is a template parameter, so every loop unrolls; ptxas's
// register and stack report is in the build log), and device memory sees
// the states, the nominals and the partials rows (plus the (P, K, N) noise
// in external-noise mode). Per rollout and step the exact tier pays an
// accurate sinf/cosf and IEEE divisions; the fast tier pays the polynomials
// of fastmath.cuh and one rcp.approx. Box-muller pays a log, a sqrt and a
// sincos per pair (box-muller-a half of that, the two lanes of a rollout
// pair splitting the calls); clt4/clt4a integer ops and a cubic, a quarter
// of a Philox call per sample (clt4a half of that); clt2q a quintic and an
// eighth of a call; wallace one exact Box-Muller pair per window of 8 steps. At B = 1 024 the fleet's launch is 4 096 blocks of 256 threads
// at K = 1 024 and 32 768 at K = 8 192, 31 and 248 waves of the 132 SMs.
//
// The build has no --use_fast_math: sinf/cosf/logf/expf and '/' are the
// accurate forms, as jnp.sin/cos/log/exp and true division are in the JAX
// package; and -fmad=false, so that no product is fused into a sum and the
// rounding is that of the plain version (ops/build.py).
//
// Sampling follows the layout contract of mpc_rs_tpu_torch/ops/philox.py:
// key (seed, 0), counter (rollout or pair, call, word, 0), with word the
// solve index of a K2 solve and the scenario index b in the fleet, so
// scenario b's box-muller noise is that of a single solve with seed
// seeds[b], solve b. External noise is read in natural (P, K, N) order.
//
// The chain updates the caller's u_n and x buffers in place: the finalize
// kernel of solve j writes u_n (the verbatim warm start of solve j+1) and,
// in plant mode, steps x. All launches go to the caller's stream, with no
// host synchronisation between them.
//
// Instantiated for one horizon, N = kN = 8, the main paths'
// (mpc_rs_tpu/apps/mppi_examples.py:49, apps/fleet.py); the partials kernel
// for the two models (cart-pole + shaped4, flagship4 + diag4), the two
// tiers and the seven noise sources (external noise and the six samplers):
// 28 instantiations, K1/K2 using the cart-pole's 14. The estimator chain is
// instantiated once per fleet model; D1's partials kernel once per MixMode
// (8), D2's chain for float and bf16 pairs at 16 and 32 values a thread.
//
// C interface (loaded with ctypes): every function returns the
// cudaGetLastError() value after its last launch (0 on success), -1 for a
// horizon other than kN, -2 for an unknown sampler, -3 for an unknown model
// or function, -4 for a batch the grid cannot hold.

#include "diag_kernels.cuh"
#include "estimator_chain.cuh"
#include "mppi_common.cuh"

namespace {

using namespace mpc;

// One block: merge the nb partials rows by log-sum-exp, apply the status
// ladder and zero fallback of finalize_partials (mppi_pallas.py:1021-1036),
// write u_out (may alias the u_n the partials read: the launches are
// stream-ordered), the status and u0, and in plant mode step x with u0.
template <int N, class Model>
__global__ void __launch_bounds__(kThreads)
mppi_finalize_kernel(Model model, float lambda, int nb, const float* __restrict__ partials,
                     float* u_out, int* __restrict__ status, float* __restrict__ u0,
                     float* __restrict__ x) {
  __shared__ float red_max[kWarps];
  __shared__ float red_sum[kWarps][N + 1];

  float m = kNegBig;
  for (int b = threadIdx.x; b < nb; b += kThreads) m = fmaxf(m, partials[(size_t)b * (N + 2)]);
  const float m_all = block_max(m, red_max);

  float acc[N + 1];
#pragma unroll
  for (int i = 0; i <= N; ++i) acc[i] = 0.0f;
  for (int b = threadIdx.x; b < nb; b += kThreads) {
    const float* row = partials + (size_t)b * (N + 2);
    // an all-masked row (m_b = neg_big, s_b = 0) contributes exactly 0
    const float scale = row[0] > kNoFiniteBelow ? expf((row[0] - m_all) / lambda) : 0.0f;
#pragma unroll
    for (int i = 0; i <= N; ++i) acc[i] += row[1 + i] * scale;
  }
  const float tot = block_sums<N + 1>(acc, red_sum);

  __shared__ float tot_s[N + 1];
  if (threadIdx.x < N + 1) tot_s[threadIdx.x] = tot;
  __syncthreads();
  if (threadIdx.x != 0) return;

  const int st = status_ladder<N>(m_all, tot_s, u_out);
  const float u_first = u_out[0];
  *status = st;
  if (u0 != nullptr) *u0 = u_first;
  if (x != nullptr) {
    float x0 = x[0], x1 = x[1], x2 = x[2], x3 = x[3];
    model.step(x0, x1, x2, x3, u_first);
    x[0] = x0;
    x[1] = x1;
    x[2] = x2;
    x[3] = x3;
  }
}

template <bool Fast>
CartPoleNonlinearT<Fast> make_model(const float* c) {
  return CartPoleNonlinearT<Fast>{c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8]};
}

// The partials kernel on a grid of P problems, sampler by ID (or external
// noise when noise is not null); returns the launch's cudaGetLastError(), or
// -2 for an unknown sampler or for external noise without a noise pointer.
template <bool Fast, class Model, class Cost>
int launch_partials_grid(int sampler, const Model& model, const Cost& cost, const PartialsArgs& a,
                         dim3 grid, const float* x, const float* u_n, const float* noise,
                         const int* seeds, uint32_t base_seed, uint32_t word0, float* partials,
                         float* noise_out, cudaStream_t stream) {
  if (noise == nullptr && sampler == kExternal) return -2;
#define MPC_PARTIALS_LAUNCH(S)                                                          \
  mppi_partials_kernel<kN, Model, Cost, Fast, S><<<grid, kThreads, 0, stream>>>(       \
      model, cost, a, x, u_n, noise, seeds, base_seed, word0, partials, noise_out)
  switch (noise != nullptr ? (int)kExternal : sampler) {
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

template <int N, bool Fast>
int launch_solve(const CartPoleNonlinearT<Fast>& model, int sampler, const PartialsArgs& a,
                 const float* x, const float* u_n, const float* noise, const int* seeds,
                 int seed_index, uint32_t base_seed, uint32_t solve_word, float* partials,
                 float* u_out, int* status, float* u0, float* x_plant, cudaStream_t stream) {
  const int nb = (a.k + kThreads - 1) / kThreads;
  const int* key = seeds != nullptr ? seeds + seed_index : nullptr;
  const int err = launch_partials_grid<Fast>(sampler, model, Shaped4{}, a, dim3(nb, 1), x, u_n,
                                             noise, key, base_seed, solve_word, partials, nullptr,
                                             stream);
  if (err != 0) return err;
  mppi_finalize_kernel<N, CartPoleNonlinearT<Fast>><<<1, kThreads, 0, stream>>>(
      model, a.lambda, nb, partials, u_out, status, u0, x_plant);
  return (int)cudaGetLastError();
}

template <int N, bool Fast>
int launch_chain(const CartPoleNonlinearT<Fast>& model, int sampler, const PartialsArgs& a,
                 float* x, float* u_n, const float* noise, const int* seeds, uint32_t base_seed,
                 int n_solves, int plant, float* partials, float* u0s, int* statuses,
                 cudaStream_t stream) {
  for (int j = 0; j < n_solves; ++j) {
    const float* noise_j = noise != nullptr ? noise + (size_t)j * a.k * N : nullptr;
    // per-solve seeds: key seeds[j], solve word 0 (a single solve with
    // seed seeds[j] draws the same noise); scalar seed: key base_seed, word j
    const int err = launch_solve<N, Fast>(model, sampler, a, x, u_n, noise_j, seeds, j, base_seed,
                                          seeds != nullptr ? 0u : (uint32_t)j, partials, u_n,
                                          statuses + j, u0s + j, plant ? x : nullptr, stream);
    if (err != 0) return err;
  }
  return 0;
}

enum ModelId : int { kCartPoleShaped4 = 0, kFlagship4Diag4 = 1 };

// One warp per scenario: merge its nb rows by log-sum-exp, then the status
// ladder and zero fallback (mppi_pallas.py:1021-1036).
template <int N>
__global__ void __launch_bounds__(kThreads)
fleet_finalize_kernel(float lambda, int n_scen, int nb, const float* __restrict__ partials,
                      float* __restrict__ u_out, int* __restrict__ status) {
  const int lane = threadIdx.x & 31;
  const int sc = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (sc >= n_scen) return;  // the whole warp leaves together
  const float* rows = partials + (size_t)sc * nb * (N + 2);

  float m = kNegBig;
  for (int r = lane; r < nb; r += 32) m = fmaxf(m, rows[(size_t)r * (N + 2)]);
  const float m_all = warp_max(m);

  float acc[N + 1];
#pragma unroll
  for (int i = 0; i <= N; ++i) acc[i] = 0.0f;
  for (int r = lane; r < nb; r += 32) {
    const float* row = rows + (size_t)r * (N + 2);
    // an all-masked row (m_b = neg_big, s_b = 0) contributes exactly 0
    const float scale = row[0] > kNoFiniteBelow ? expf((row[0] - m_all) / lambda) : 0.0f;
#pragma unroll
    for (int i = 0; i <= N; ++i) acc[i] += row[1 + i] * scale;
  }
#pragma unroll
  for (int i = 0; i <= N; ++i) acc[i] = warp_sum(acc[i]);
  if (lane != 0) return;
  status[sc] = status_ladder<N>(m_all, acc, u_out + (size_t)sc * N);
}

// The partials of n_scen scenario solves of one model: a grid (K-blocks,
// scenarios), scenario b keyed seeds[b] with counter word b.
template <bool Fast>
int launch_model(int model_id, const float* mc, const float* cc, int sampler,
                 const PartialsArgs& a, int n_scen, const float* x, const float* u_n,
                 const float* noise, const int* seeds, float* partials, float* noise_out,
                 cudaStream_t stream) {
  const dim3 grid((a.k + kThreads - 1) / kThreads, n_scen);
  if (model_id == kCartPoleShaped4) {
    return launch_partials_grid<Fast>(sampler, make_model<Fast>(mc), Shaped4{}, a, grid, x, u_n,
                                      noise, seeds, 0u, 0u, partials, noise_out, stream);
  }
  if (model_id == kFlagship4Diag4) {
    const Flagship4<Fast> m{Flagship4Consts{mc[0], mc[1], mc[2], mc[3], mc[4], mc[5], mc[6],
                                            mc[7], mc[8], mc[9], mc[10], mc[11], mc[12],
                                            mc[13], mc[14], mc[15], mc[16]}};
    return launch_partials_grid<Fast>(sampler, m, Diag4{cc[0], cc[1], cc[2], cc[3]}, a, grid, x,
                                      u_n, noise, seeds, 0u, 0u, partials, noise_out, stream);
  }
  return -3;
}

__global__ void fastmath_eval_kernel(int fn, int count, const float* __restrict__ a,
                                     const float* __restrict__ b, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const float x = a[i];
  float r;
  switch (fn) {
    case 0: r = fm::fsin(x); break;
    case 1: r = fm::fcos(x); break;
    case 2: r = fm::flog(x); break;
    case 3: r = fm::frsqrt(x); break;
    case 4: r = fm::fsqrt(x); break;
    case 5: r = fm::freciprocal(x); break;
    default: r = fm::fdiv(x, b[i]); break;
  }
  out[i] = r;
}

PartialsArgs partials_args(int k, float lambda, float inv, float lo, float hi, float std_dev,
                           const float* sc) {
  return PartialsArgs{k, lambda, inv, lo, hi, std_dev, sc[0], sc[1], sc[2], sc[3], sc[4], sc[5]};
}

// The estimator chain of one fleet model: n_sub must be the model's.
template <int N, int O, int NSUB, class Plant, class Hx>
int launch_estimator_chain(const Plant& plant, const Hx& hx, const float* cc, int n_scen,
                           const float* x, const float* ex, const float* p, const float* u0,
                           int u_stride, const float* t, const float* noise, float* x_out,
                           float* ex_out, float* p_out, cudaStream_t stream) {
  ChainConsts<N, O> k;
  k.hc = cc[0];
  k.wm1 = cc[1];
  k.wc1 = cc[2];
  k.sum_wc = cc[3];
  k.dt_sub = cc[4];
  k.control_start = cc[5];
  k.pulse_t0 = cc[6];
  k.pulse_t1 = cc[7];
  k.pulse_f = cc[8];
  k.has_pulse = cc[9] != 0.0f;
  k.has_guard = cc[10] != 0.0f;
  const float* m = cc + 11;
  for (int i = 0; i < N * N; ++i) k.q[i / N][i % N] = *m++;
  for (int i = 0; i < O * O; ++i) k.r[i / O][i % O] = *m++;
  for (int i = 0; i < O; ++i) k.sig[i] = *m++;
  for (int i = 0; i < N * N; ++i) k.p_reset[i / N][i % N] = *m++;
  const int blocks = (n_scen + kChainThreads - 1) / kChainThreads;
  estimator_chain_kernel<N, O, NSUB, Plant, Hx><<<blocks, kChainThreads, 0, stream>>>(
      plant, hx, k, n_scen, x, ex, p, u0, u_stride, t, noise, x_out, ex_out, p_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// sampler_consts (6 host floats, each folded in double and rounded once):
// f32(_CLT_A σ), f32(_CLT_B σ), f32(σ/√2), f32(_TRI_A σ), f32(_TRI_B σ),
// f32(_TRI_C σ). sampler: 0 external noise, 1 box-muller, 2 clt4, 3 clt4a,
// 4 wallace, 5 clt2q, 6 box-muller-a.

// One solve (K2). model_consts: 9 host floats (CartPoleNonlinearT order);
// fast selects the tier. Device pointers: x (4), u_n (N), noise (K, N) or
// null (then the sampler draws), seeds (>= seed_index+1) or null,
// partials (ceil(K/256), N+2) scratch, u_out (N), status (1).
int mpc_mppi_solve(const float* model_consts, int fast, int sampler, const float* sampler_consts,
                   int n, int k, float lambda, float inv, float lo, float hi, float std_dev,
                   const float* x, const float* u_n, const float* noise, const int* seeds,
                   int seed_index, unsigned int base_seed, unsigned int solve_word,
                   float* partials, float* u_out, int* status, void* stream) {
  if (n != kN) return -1;
  const PartialsArgs a = partials_args(k, lambda, inv, lo, hi, std_dev, sampler_consts);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fast ? launch_solve<kN, true>(make_model<true>(model_consts), sampler, a, x, u_n, noise,
                                       seeds, seed_index, base_seed, solve_word, partials, u_out,
                                       status, nullptr, nullptr, s)
              : launch_solve<kN, false>(make_model<false>(model_consts), sampler, a, x, u_n, noise,
                                        seeds, seed_index, base_seed, solve_word, partials, u_out,
                                        status, nullptr, nullptr, s);
}

// J warm-started solves (K1). x (4) and u_n (N) are updated in place, the
// plant stepped by the model of the tier; noise (J, K, N) or null; seeds
// (J) or null (then base_seed with j in the counter); u0s (J), statuses (J).
int mpc_mppi_chain(const float* model_consts, int fast, int sampler, const float* sampler_consts,
                   int n, int k, float lambda, float inv, float lo, float hi, float std_dev,
                   float* x, float* u_n, const float* noise, const int* seeds,
                   unsigned int base_seed, int n_solves, int plant, float* partials, float* u0s,
                   int* statuses, void* stream) {
  if (n != kN) return -1;
  const PartialsArgs a = partials_args(k, lambda, inv, lo, hi, std_dev, sampler_consts);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fast ? launch_chain<kN, true>(make_model<true>(model_consts), sampler, a, x, u_n, noise,
                                       seeds, base_seed, n_solves, plant, partials, u0s, statuses, s)
              : launch_chain<kN, false>(make_model<false>(model_consts), sampler, a, x, u_n, noise,
                                        seeds, base_seed, n_solves, plant, partials, u0s, statuses,
                                        s);
}

// Partials of B scenario solves. model: 0 cart-pole + shaped4 (9 model
// constants, CartPoleNonlinearT order), 1 flagship4 + diag4 (17 constants,
// Flagship4Consts order, and 4 cost coefficients). Device pointers:
// x (B, 4), u_n (B, N), noise (B, K, N) or null, seeds (B) or null, partials
// (B, ceil(K/256), N+2), noise_out (B, K, N) or null (then the sampled noise
// is not written).
int mpc_fleet_partials(int model, int fast, int sampler, const float* model_consts,
                       const float* cost_consts, const float* sampler_consts, int n, int n_scen,
                       int k, float lambda, float inv, float lo, float hi, float std_dev,
                       const float* x, const float* u_n, const float* noise, const int* seeds,
                       float* partials, float* noise_out, void* stream) {
  if (n != kN) return -1;
  if (n_scen < 1 || n_scen > 65535) return -4;
  const PartialsArgs a = partials_args(k, lambda, inv, lo, hi, std_dev, sampler_consts);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fast ? launch_model<true>(model, model_consts, cost_consts, sampler, a, n_scen, x, u_n,
                                   noise, seeds, partials, noise_out, s)
              : launch_model<false>(model, model_consts, cost_consts, sampler, a, n_scen, x,
                                    u_n, noise, seeds, partials, noise_out, s);
}

// The fused estimator chain (K7) of B scenarios, one tick. model: 0
// cartpole4 (S = n = 4, o = 3, 5 substeps; plant_consts: 9 floats,
// CartPoleNonlinearT order at the substep dt; obs_consts: k, 180/π),
// 1 flagship6 (6, 6, 5, 1 substep; plant_consts: 17 Flagship4Consts floats
// and mll_j2; obs_consts: k, −k, 180/π, g, l). chain_consts: hc, wm1, wc1,
// sum_wc, dt_sub, control_start, pulse t0, t1, f, has_pulse, has_guard, then
// q (n²), r (o²), sig (o), p_reset (n²), row-major. n_sub must be the
// model's. Device pointers: x (B, S), ex (B, n), p (n², B), u0 (B, strided
// by u_stride floats), t (B), noise (n_sub·o, B), and the outputs x_out,
// ex_out, p_out in the same layouts.
int mpc_estimator_chain(int model, int n_sub, const float* plant_consts, const float* obs_consts,
                        const float* chain_consts, int n_scen, const float* x, const float* ex,
                        const float* p, const float* u0, int u_stride, const float* t,
                        const float* noise, float* x_out, float* ex_out, float* p_out,
                        void* stream) {
  if (n_scen < 1) return -4;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pc = plant_consts;
  const float* oc = obs_consts;
  if (model == kCartPoleShaped4 && n_sub == 5) {
    const CartPole4Plant plant{make_model<false>(pc)};
    const HxRpmGyro4 hx{oc[0], oc[1]};
    return launch_estimator_chain<4, 3, 5>(plant, hx, chain_consts, n_scen, x, ex, p, u0,
                                           u_stride, t, noise, x_out, ex_out, p_out, s);
  }
  if (model == kFlagship4Diag4 && n_sub == 1) {
    const Flagship6Plant plant{Flagship4Consts{pc[0], pc[1], pc[2], pc[3], pc[4], pc[5], pc[6],
                                               pc[7], pc[8], pc[9], pc[10], pc[11], pc[12],
                                               pc[13], pc[14], pc[15], pc[16]},
                               pc[17]};
    const HxImu6 hx{oc[0], oc[1], oc[2], oc[3], oc[4]};
    return launch_estimator_chain<6, 5, 1>(plant, hx, chain_consts, n_scen, x, ex, p, u0,
                                           u_stride, t, noise, x_out, ex_out, p_out, s);
  }
  return -3;
}

// Merge (B, nb, N+2) partials per scenario; writes u_out (B, N), status (B).
int mpc_fleet_finalize(int n, int n_scen, int nb, float lambda, const float* partials,
                       float* u_out, int* status, void* stream) {
  if (n != kN) return -1;
  const int blocks = (n_scen + kWarps - 1) / kWarps;
  fleet_finalize_kernel<kN><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      lambda, n_scen, nb, partials, u_out, status);
  return (int)cudaGetLastError();
}

// out[i] = f(a[i]) for fn 0 fsin, 1 fcos, 2 flog, 3 frsqrt, 4 fsqrt,
// 5 freciprocal; fn 6 fdiv(a[i], b[i]).
int mpc_fastmath_eval(int fn, int count, const float* a, const float* b, float* out,
                      void* stream) {
  if (fn < 0 || fn > 6) return -3;
  if (count < 1) return 0;
  fastmath_eval_kernel<<<(count + kThreads - 1) / kThreads, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(fn, count, a, b, out);
  return (int)cudaGetLastError();
}

// D1: n_solves warm-started solves of the fast-tier cart-pole with shaped4,
// x (4) held, u_n (N) updated in place, u0s (n_solves) written; mode is a
// MixMode, model_consts the 9 CartPoleNonlinearT floats, sampler_consts as
// above; key seed, solve j in the counter. partials: (ceil(K/256), N+2).
int mpc_kernel_mix_chain(int mode, const float* model_consts, const float* sampler_consts, int n,
                         int k, float inv_lambda, float inv, float lo, float hi, float std_dev,
                         float cltf_mu, float cltf_inv_sig, int ramp_block, const float* x,
                         float* u_n, unsigned int seed, int n_solves, float* partials, float* u0s,
                         void* stream) {
  if (n != kN) return -1;
  if (ramp_block < 1 || k < 1 || n_solves < 1) return -3;
  const MixArgs a{partials_args(k, 0.0f, inv, lo, hi, std_dev, sampler_consts), inv_lambda,
                  cltf_mu, cltf_inv_sig, ramp_block};
  const CartPoleNonlinearT<true> model = make_model<true>(model_consts);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MPC_MIX_LAUNCH(M) \
  return launch_kernel_mix<M>(model, a, x, u_n, seed, n_solves, partials, u0s, s)
  switch (mode) {
    case kMixFull: MPC_MIX_LAUNCH(kMixFull);
    case kMixNosample: MPC_MIX_LAUNCH(kMixNosample);
    case kMixNoroll: MPC_MIX_LAUNCH(kMixNoroll);
    case kMixBitsonly: MPC_MIX_LAUNCH(kMixBitsonly);
    case kMixClt: MPC_MIX_LAUNCH(kMixClt);
    case kMixCltf: MPC_MIX_LAUNCH(kMixCltf);
    case kMixCvtonly: MPC_MIX_LAUNCH(kMixCvtonly);
    case kMixClt2q: MPC_MIX_LAUNCH(kMixClt2q);
    default: return -3;
  }
#undef MPC_MIX_LAUNCH
}

// D2: `steps` CTAs, each `inner` dependent updates x = x*a + x0/2 of the
// tile x into o. dtype 0: float, count floats; 1: bf16, count bf16 pairs.
int mpc_fma_chain(int dtype, int count, int inner, int steps, float a, const void* x, void* o,
                  void* stream) {
  if (steps < 1 || inner < 0) return -3;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fma_chain<float>(count, inner, steps, a, x, o, s);
  if (dtype == 1) return launch_fma_chain<__nv_bfloat162>(count, inner, steps, a, x, o, s);
  return -3;
}

}  // extern "C"
