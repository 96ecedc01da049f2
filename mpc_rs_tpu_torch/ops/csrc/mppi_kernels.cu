// Fused kernels for Hopper (sm_90a): one MPPI solve (K2), the
// receding-horizon chain of solves (K1), the scenario batch of the fleet
// (K5 + K6), the fleet's fused estimator chain (K7, estimator_chain.cuh), an
// elementwise probe of the fast-math device functions (K4), and the two
// diagnostic probes, the kernel op-mix chain (D1) and the mul-add chain (D2)
// (diag_kernels.cuh, whose notes say what they replace and what bounds them).
//
// Replaces the Pallas TPU kernels of mpc_rs_tpu/ops/mppi_pallas.py. Every
// solve is one launch of one kernel, mppi_partials_kernel (mppi_common.cuh),
// on a grid (ceil(K/(256 R)), P) of P problems, R rollouts a thread; the
// last block of each problem to finish merges the problem's rows and
// finishes the solve inside the launch:
//   - K2 (mppi_pallas_partials / _make_kernel + finalize_partials): P = 1,
//     the solve index in the Philox counter word, either tier, any sampler
//     or external noise: one launch a solve;
//   - K1 (mppi_pallas_chain / _make_chain_kernel): J such launches issued
//     from a C loop on one stream, the merging block also writing u0 and,
//     optionally, stepping the plant on the device;
//   - K5 and K6 (mppi_pallas_batch_partials: _make_fleet_kernel, one
//     (bs, 128) block per scenario with 8 scenarios unrolled per grid step,
//     and _make_batched_kernel, a scenario's K-blocks streamed through
//     carried accumulators): P = B scenarios, with the six branches of
//     _fill_vbuf (K3) and the fast tier of ops/fastmath.py (K4) inlined,
//     one launch a fleet tick. The TPU needed two kernels only for its
//     layout; here one grid covers both shapes. Blocks run in no order, so
//     instead of K6's carried accumulators each block writes one row of a
//     (B, nb, N+2) streaming log-sum-exp, which its scenario's last block
//     merges (at K = 1 024 and R = 4 a scenario is one block, which
//     finishes from its own sums). fleet_finalize_kernel (one warp a
//     scenario, the same merge) is kept for rows merged outside the launch:
//     the rows-only entry (mppi_batch_partials_fused) and the multi-GPU
//     merge, where it finishes the all-reduced row of each problem (nb = 1);
//   - the rank's share of a multi-GPU solve (mpc_rs_tpu/parallel/
//     sharded_mppi.py and scenario.py's rollouts axis, whose Pallas kernel
//     returns the device's (m, s, uw)): P problems as above, the merging
//     block writing each problem's merged row (m_all, s, uw) in place of
//     the solve (mpc_partials_merged); the collectives merge those rows
//     across ranks.
//
// What bounds it on the card: the FP32 issue rate and the transcendentals,
// not bytes (48 bytes of state and nominals a problem; the rows stay in
// L2). A thread runs its R rollouts one after another in a loop that is not
// unrolled, folding each into a running log-sum-exp (lse_fold): the
// registers and the code of one rollout, whose N samples, controls and
// state stay in registers (N is a template parameter, so the steps unroll;
// ptxas's register and spill report is in the build log). Unrolling the R
// rollouts, interleaved step by step or one after another, with the R
// scores and R·N controls held for one block reduction, took 64-110
// registers, spilled in some instantiations and ran the exact tier slower
// than R = 1 (PERF.md §6). Device memory sees the states, the nominals
// and the partials rows (plus the (P, K, N) noise in external-noise mode).
// Per rollout and step the exact tier pays an accurate sinf/cosf and IEEE
// divisions; the fast tier pays the polynomials
// of fastmath.cuh and one rcp.approx. Box-muller pays a log, a sqrt and a
// sincos per pair (box-muller-a half of that, the two lanes of a rollout
// pair splitting the calls); clt4/clt4a integer ops and a cubic, a quarter
// of a Philox call per sample (clt4a half of that); clt2q a quintic and an
// eighth of a call; wallace one exact Box-Muller pair per window of 8
// steps. Tensor cores and TMA have nothing to do here: a rollout is a scalar
// 8-step recurrence, with no matrix product and no tile to stream.
//
// Per block the kernel pays one block_max (5 shuffles a warp, two barriers)
// and one block_sums<N+1> (45 shuffles, one barrier): at R = 4 that is once
// per 1 024 rollouts, not per 256. The wrapper picks R with
// rollouts_per_thread (ops/mppi_cuda.py): 4 where the grid keeps at least 4
// blocks an SM (528), else 1 (K1 at K = 10 240: 40 blocks at R = 1, where
// R = 4 would leave most SMs idle). What bounds it now is the rollout: on
// an H100 (PERF.md §6) the flagship6 launch takes 356 µs against
// 192 µs for its counted operations at one instruction each (the build
// fuses no mul-add), and the exact tier's accurate sinf/cosf and divisions
// are tens of instructions for one counted operation; the merge inside the
// launch costs 0.7-3.4 µs (the merged call less the rows-only call).
//
// Why a ticket and not a thread-block cluster: a cluster merging through
// distributed shared memory covers at most 8 blocks (16 non-portable), and
// K1/K2 at K = 819 200 have 800 blocks a problem, so it would need a second
// mechanism there; the ticket (a row write, then one acquire-release atomic
// add a block) covers every grid. The tickets are an int32 (P,) buffer the
// wrapper keeps per (device, stream, P), zeroed once; the merging block
// resets its problem's ticket, so every launch leaves them at zero.
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
// The chain updates the caller's u_n and x buffers in place: the merging
// block of solve j writes u_n (the verbatim warm start of solve j+1) and,
// in plant mode, steps x. All launches go to the caller's stream, with no
// host synchronisation between them.
//
// The partials kernel is instantiated for each (model, N) pair a path
// runs, each at the seven noise sources (external noise and the six
// samplers) and R = 1 and 4, but where a path draws fewer. Here, at the main
// paths' N = kN = 8 (mpc_rs_tpu/apps/mppi_examples.py:49, apps/fleet.py),
// for the two models of the fleets and of mppi4-non-liner(-s/-ukf)
// (cart-pole + shaped4, flagship4 + diag4) in both tiers: 56
// instantiations, each model's serving K1/K2 and the fleet alike. The MPPI
// application family has one source a model, the exact tier only (the JAX
// apps run no fast tier), 14 instantiations each (mppi_launch.cuh): the
// double integrator + quad2 at N = 40 (mppi2), the linear cart-pole +
// shaped4 at N = 8 (mppi4), commu4 + commu4 at N = 20 (the HW flagship).
// serve's plan-streaming horizons, the cart-pole + shaped4 at N = 9-40,
// box-muller alone (serve's only sampler), at R = 1 and, at N = 40 only,
// R = 4: 33 instantiations over the horizons_*.cu sources
// (horizons.cuh). The estimator chain is instantiated once per fleet
// model, and for flagship6 once more on the observations scaled by 1/σ
// (obs_normalize, HxScaled); K4's probe once per function at 4 and at 1
// elements a thread (14); D1's kernel (partials_body with D1's policy) once
// per MixMode at R = 1 and 4 (16), D2's chain for float and bf16 pairs at
// 16 and 32 values a thread. Outside this source: fleet_finalize_kernel at
// each horizon of launch_model's pairs, N = 8-40 (33), in the horizons_*.cu
// sources (horizons.cuh); tune's sweep, one kernel for every horizon, in
// sweep.cu (sweep.cuh, with its C entries).
//
// C interface (loaded with ctypes): every function returns the
// cudaGetLastError() value after its last launch (0 on success), -1 when no
// kernel is built for the (model, N, tier) asked for (the pairs in
// launch_model; D1: N = kN only; the rows' merge:
// the horizons of those pairs, N = 8-40), -2 for an unknown sampler or one the
// pair is not built for, -3 for an unknown model or function or an R the
// pair is not built for, -4 for a batch the grid cannot hold.

#include <array>
#include <utility>

#include "diag_kernels.cuh"
#include "estimator_chain.cuh"
#include "mppi_launch.cuh"

namespace {

using namespace mpc;

template <bool Fast>
CartPoleNonlinearT<Fast> make_model(const float* c) {
  return CartPoleNonlinearT<Fast>{c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8]};
}

Flagship4Consts flagship_consts(const float* m) {
  return Flagship4Consts{m[0], m[1], m[2],  m[3],  m[4],  m[5],  m[6],  m[7], m[8],
                         m[9], m[10], m[11], m[12], m[13], m[14], m[15], m[16]};
}

// Model IDs (ops/mppi_cuda.py: each model class's model_id).
enum ModelId : int {
  kCartPoleShaped4 = 0, kFlagship4Diag4 = 1, kDoubleIntegratorQuad2 = 2, kCartPoleLinearShaped4 = 3,
  kCommu4Cost4 = 4
};

// Tables indexed by N - first of the instantiations that horizons.cuh
// defines and the horizons_*.cu sources instantiate:
// serve's cart-pole at N = kServeFirst..kServeLast, the rows' finalize at
// every horizon of launch_model's pairs, N = kN..kServeLast.
template <int... I>
constexpr std::array<int (*)(const SolveCall&), sizeof...(I)> serve_table(std::integer_sequence<int, I...>) {
  return {&launch_cartpole_shaped4<kServeFirst + I>...};
}

using Finalizer = int (*)(int, int, float, const float*, float*, int*, cudaStream_t);
template <int... I>
constexpr std::array<Finalizer, sizeof...(I)> finalize_table(std::integer_sequence<int, I...>) {
  return {&launch_finalize<kN + I>...};
}

constexpr auto kServeLaunchers = serve_table(std::make_integer_sequence<int, kServeLast - kServeFirst + 1>{});
constexpr auto kFinalizers = finalize_table(std::make_integer_sequence<int, kServeLast - kN + 1>{});

// A call of model model_id at horizon n in tier fast, on the instantiations
// built for it: the N = kN models in both tiers here, each family model at
// its own N in the exact tier (its source), and the cart-pole at serve's
// N = 9-40 in the exact tier (kServeLaunchers); -1 for any other
// (model, N, tier), -3 for an unknown model.
template <bool Fast>
int launch_model_tier(int model_id, int n, const SolveCall& c) {
  const float* mc = c.model_consts;
  const float* cc = c.cost_consts;
  if (model_id == kCartPoleShaped4) {
    if (n == kN) return launch_call<kN, Fast>(make_model<Fast>(mc), Shaped4{}, c);
    if (Fast || n < kServeFirst || n > kServeLast) return -1;
    return kServeLaunchers[n - kServeFirst](c);  // serve's plan streaming
  }
  if (model_id == kFlagship4Diag4) {
    return n == kN ? launch_call<kN, Fast>(Flagship4<Fast>{flagship_consts(mc)},
                                           Diag4{cc[0], cc[1], cc[2], cc[3]}, c)
                   : -1;
  }
  if (model_id < kDoubleIntegratorQuad2 || model_id > kCommu4Cost4) return -3;
  if (Fast) return -1;
  if (model_id == kDoubleIntegratorQuad2) return n == 40 ? launch_double_integrator_quad2(c) : -1;
  if (model_id == kCartPoleLinearShaped4) return n == kN ? launch_cartpole_linear_shaped4(c) : -1;
  return n == 20 ? launch_commu4(c) : -1;
}

int launch_model(int model_id, int fast, int n, const SolveCall& c) {
  return fast ? launch_model_tier<true>(model_id, n, c) : launch_model_tier<false>(model_id, n, c);
}

enum FastmathFn : int { kFsin, kFcos, kFlog, kFrsqrt, kFsqrt, kFreciprocal, kFdiv };

template <int Fn>
__device__ __forceinline__ float fastmath_apply(float x, float y) {
  if constexpr (Fn == kFsin) return fm::fsin(x);
  if constexpr (Fn == kFcos) return fm::fcos(x);
  if constexpr (Fn == kFlog) return fm::flog(x);
  if constexpr (Fn == kFrsqrt) return fm::frsqrt(x);
  if constexpr (Fn == kFsqrt) return fm::fsqrt(x);
  if constexpr (Fn == kFreciprocal) return fm::freciprocal(x);
  return fm::fdiv(x, y);
}

// K4's probe, one instantiation a function: thread i takes the four
// elements 4i..4i+3 with one 16-byte load (of a, and of b for fdiv) and one
// 16-byte store (Width 4, a count of float4s), or element i (Width 1: the
// count % 4 tail, or the whole vector where a pointer is not 16-byte
// aligned). The bytes bound it: 8 a point (12 for fdiv) against some 15-30
// operations.
template <int Fn, int Width>
__global__ void __launch_bounds__(kThreads)
fastmath_eval_kernel(int count, const float* __restrict__ a, const float* __restrict__ b,
                     float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  if constexpr (Width == 4) {
    const float4 x = reinterpret_cast<const float4*>(a)[i];
    const float4 y = Fn == kFdiv ? reinterpret_cast<const float4*>(b)[i] : x;
    reinterpret_cast<float4*>(out)[i] =
        make_float4(fastmath_apply<Fn>(x.x, y.x), fastmath_apply<Fn>(x.y, y.y),
                    fastmath_apply<Fn>(x.z, y.z), fastmath_apply<Fn>(x.w, y.w));
  } else {
    out[i] = fastmath_apply<Fn>(a[i], Fn == kFdiv ? b[i] : 0.0f);
  }
}

// The vector instantiation over the aligned float4s, then the scalar one
// over the rest; a pointer off 16 bytes sends the whole vector to the scalar
// one.
template <int Fn>
int launch_fastmath(int count, const float* a, const float* b, float* out, cudaStream_t stream) {
  const uintptr_t addr = (uintptr_t)a | (uintptr_t)out | (Fn == kFdiv ? (uintptr_t)b : 0u);
  const int n_vec = addr % 16 == 0 ? count / 4 : 0;
  if (n_vec > 0) {
    fastmath_eval_kernel<Fn, 4><<<(n_vec + kThreads - 1) / kThreads, kThreads, 0, stream>>>(n_vec, a, b, out);
  }
  const int done = 4 * n_vec, rest = count - done;
  if (rest > 0) {
    fastmath_eval_kernel<Fn, 1><<<(rest + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        rest, a + done, Fn == kFdiv ? b + done : nullptr, out + done);
  }
  return (int)cudaGetLastError();
}

PartialsArgs partials_args(int k, float inv_lambda, float inv, float lo, float hi, float std_dev,
                           const float* sc) {
  return PartialsArgs{k, inv_lambda, inv, lo, hi, std_dev, sc[0], sc[1], sc[2], sc[3], sc[4], sc[5]};
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
  const int blocks = (n_scen + kChainScenarios - 1) / kChainScenarios;
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

// inv_lambda: f32(1/lambda), folded in double on the host (+inf for
// lambda = 0). rpt: rollouts a thread R, 1 or 4. tickets: int32 device
// zeros, one a problem, which every launch leaves at zero; a stream's
// launches may share them, concurrent streams may not.

// model: 0 cart-pole + shaped4 (9 constants, CartPoleNonlinearT order;
// N = 8, either tier; N = 9-40, the exact tier, box-muller at R = 1, and
// at N = 40 also R = 4), 1 flagship4 + diag4 (17 constants, Flagship4Consts
// order, and 4 cost coefficients; N = 8, either tier), 2 double integrator
// + quad2 (dt; N = 40, two states), 3 linear cart-pole + shaped4 (5
// constants, CartPoleLinear order; N = 8), 4 commu4 + commu4 (11
// constants, Commu4 order; N = 20); models 2-4 in the exact tier only.
// cost_consts: the 4 diag4 coefficients, else unused. S below is the
// model's state count (2 for model 2, else 4).

// One solve (K2), one launch; fast selects the tier. Device pointers: x
// (S), u_n (N), noise (K, N) or null (then the sampler draws), seeds
// (>= seed_index+1) or null, partials (ceil(K/(256 R)), N+2) scratch,
// tickets (1), u_out (N), status (1).
int mpc_mppi_solve(int model, const float* model_consts, const float* cost_consts, int fast,
                   int sampler, const float* sampler_consts, int n, int k, float inv_lambda,
                   float inv, float lo, float hi, float std_dev, int rpt, const float* x,
                   const float* u_n, const float* noise, const int* seeds, int seed_index,
                   unsigned int base_seed, unsigned int solve_word, float* partials, int* tickets,
                   float* u_out, int* status, void* stream) {
  const PartialsIO io{x, u_n, noise, seeds != nullptr ? seeds + seed_index : nullptr, base_seed,
                      solve_word, partials, nullptr, u_out, status, tickets, nullptr, nullptr};
  const SolveCall c{model_consts, cost_consts, sampler, rpt,
                    partials_args(k, inv_lambda, inv, lo, hi, std_dev, sampler_consts), io, 1, 0,
                    static_cast<cudaStream_t>(stream)};
  return launch_model(model, fast, n, c);
}

// J warm-started solves (K1), J launches. x (S) and u_n (N) are updated in
// place, the plant stepped by the solve's model (of its tier); noise
// (J, K, N) or null; seeds (J) or null (then base_seed with j in the
// counter); tickets (1); u0s (J), statuses (J).
int mpc_mppi_chain(int model, const float* model_consts, const float* cost_consts, int fast,
                   int sampler, const float* sampler_consts, int n, int k, float inv_lambda,
                   float inv, float lo, float hi, float std_dev, int rpt, float* x, float* u_n,
                   const float* noise, const int* seeds, unsigned int base_seed, int n_solves,
                   int plant, float* partials, int* tickets, float* u0s, int* statuses,
                   void* stream) {
  if (n_solves < 1) return 0;
  const PartialsIO io{x, u_n, noise, seeds, base_seed, 0u, partials, nullptr, u_n, statuses,
                      tickets, u0s, plant ? x : nullptr};
  const SolveCall c{model_consts, cost_consts, sampler, rpt,
                    partials_args(k, inv_lambda, inv, lo, hi, std_dev, sampler_consts), io, 1,
                    n_solves, static_cast<cudaStream_t>(stream)};
  return launch_model(model, fast, n, c);
}

// B scenario solves, one launch (the fleets: model 0 or 1 at N = 8). Device
// pointers: x (B, S), u_n (B, N), noise (B, K, N) or null, seeds (B) or
// null, partials (B, ceil(K/(256 R)), N+2), noise_out (B, K, N) or null
// (then the sampled noise is not written); u_out (B, N), or null to write
// the partials rows only (then tickets and status are not used), status
// (B), tickets (B).
int mpc_fleet_partials(int model, int fast, int sampler, const float* model_consts,
                       const float* cost_consts, const float* sampler_consts, int n, int n_scen,
                       int k, float inv_lambda, float inv, float lo, float hi, float std_dev,
                       int rpt, const float* x, const float* u_n, const float* noise,
                       const int* seeds, float* partials, float* noise_out, int* tickets,
                       float* u_out, int* status, void* stream) {
  if (n_scen < 1 || n_scen > 65535) return -4;
  const PartialsIO io{x, u_n, noise, seeds, 0u, 0u, partials, noise_out, u_out, status, tickets,
                      nullptr, nullptr};
  const SolveCall c{model_consts, cost_consts, sampler, rpt,
                    partials_args(k, inv_lambda, inv, lo, hi, std_dev, sampler_consts), io, n_scen,
                    0, static_cast<cudaStream_t>(stream)};
  return launch_model(model, fast, n, c);
}

// The partials of P problems merged per problem inside the launch, with no
// ladder: row_out (P, N+2) receives each problem's (m_all, s, uw), the
// rank's share of a multi-GPU solve. Problem b samples with key seeds[b]
// (base_seed when seeds is null) and counter word word0 + b: a K2 solve's
// draw is P = 1, base_seed = its seed, word0 = its solve index; a fleet
// tick's is seeds (B) with word0 = 0. Device pointers as mpc_fleet_partials;
// tickets (P).
int mpc_partials_merged(int model, int fast, int sampler, const float* model_consts,
                        const float* cost_consts, const float* sampler_consts, int n, int n_scen,
                        int k, float inv_lambda, float inv, float lo, float hi, float std_dev,
                        int rpt, const float* x, const float* u_n, const float* noise,
                        const int* seeds, unsigned int base_seed, unsigned int word0,
                        float* partials, float* noise_out, int* tickets, float* row_out,
                        void* stream) {
  if (n_scen < 1 || n_scen > 65535) return -4;
  PartialsIO io{x, u_n, noise, seeds, base_seed, word0, partials, noise_out, nullptr, nullptr,
                tickets, nullptr, nullptr};
  io.row_out = row_out;
  const SolveCall c{model_consts, cost_consts, sampler, rpt,
                    partials_args(k, inv_lambda, inv, lo, hi, std_dev, sampler_consts), io, n_scen,
                    0, static_cast<cudaStream_t>(stream)};
  return launch_model(model, fast, n, c);
}

// The fused estimator chain (K7) of B scenarios, one tick. model: 0
// cartpole4 (S = n = 4, o = 3, 5 substeps; plant_consts: 9 floats,
// CartPoleNonlinearT order at the substep dt; obs_consts: k, 180/π),
// 1 flagship6 (6, 6, 5, 1 substep; plant_consts: 17 Flagship4Consts floats
// and mll_j2; obs_consts: k, −k, 180/π, g, l, then with obs_scaled the five
// channels' σ, by which the sensor model is divided: HxScaled, the fleet's
// obs_normalize; cartpole4 has no such instantiation). chain_consts: hc, wm1, wc1,
// sum_wc, dt_sub, control_start, pulse t0, t1, f, has_pulse, has_guard, then
// q (n²), r (o²), sig (o), p_reset (n²), row-major. n_sub must be the
// model's. Device pointers: x (B, S), ex (B, n), p (n², B), u0 (B, strided
// by u_stride floats), t (B), noise (n_sub·o, B), and the outputs x_out,
// ex_out, p_out in the same layouts.
int mpc_estimator_chain(int model, int n_sub, int obs_scaled, const float* plant_consts,
                        const float* obs_consts, const float* chain_consts, int n_scen,
                        const float* x, const float* ex,
                        const float* p, const float* u0, int u_stride, const float* t,
                        const float* noise, float* x_out, float* ex_out, float* p_out,
                        void* stream) {
  if (n_scen < 1) return -4;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pc = plant_consts;
  const float* oc = obs_consts;
  if (model == kCartPoleShaped4 && n_sub == 5 && !obs_scaled) {
    const CartPole4Plant plant{make_model<false>(pc)};
    const HxRpmGyro4 hx{oc[0], oc[1]};
    return launch_estimator_chain<4, 3, 5>(plant, hx, chain_consts, n_scen, x, ex, p, u0,
                                           u_stride, t, noise, x_out, ex_out, p_out, s);
  }
  if (model == kFlagship4Diag4 && n_sub == 1) {
    const Flagship6Plant plant{flagship_consts(pc), pc[17]};
    const HxImu6 hx{oc[0], oc[1], oc[2], oc[3], oc[4]};
    if (obs_scaled) {
      const HxScaled<HxImu6> scaled{hx, {oc[5], oc[6], oc[7], oc[8], oc[9]}};
      return launch_estimator_chain<6, 5, 1>(plant, scaled, chain_consts, n_scen, x, ex, p, u0,
                                             u_stride, t, noise, x_out, ex_out, p_out, s);
    }
    return launch_estimator_chain<6, 5, 1>(plant, hx, chain_consts, n_scen, x, ex, p, u0,
                                           u_stride, t, noise, x_out, ex_out, p_out, s);
  }
  return -3;
}

// Merge (B, nb, N+2) partials per scenario; writes u_out (B, N), status (B).
// N: a horizon of launch_model's pairs, 8-40 (kFinalizers).
int mpc_fleet_finalize(int n, int n_scen, int nb, float inv_lambda, const float* partials,
                       float* u_out, int* status, void* stream) {
  if (n < kN || n > kServeLast) return -1;
  if (n_scen < 1 || nb < 1) return -4;
  return kFinalizers[n - kN](n_scen, nb, inv_lambda, partials, u_out, status,
                             static_cast<cudaStream_t>(stream));
}

// out[i] = f(a[i]) for fn 0 fsin, 1 fcos, 2 flog, 3 frsqrt, 4 fsqrt,
// 5 freciprocal; fn 6 fdiv(a[i], b[i]). One or two launches: 16-byte
// vectors where a, b and out are 16-byte aligned, single floats for the
// count % 4 tail and for a pointer that is not.
int mpc_fastmath_eval(int fn, int count, const float* a, const float* b, float* out,
                      void* stream) {
  if (count < 1) return fn < 0 || fn > 6 ? -3 : 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fn) {
    case kFsin: return launch_fastmath<kFsin>(count, a, b, out, s);
    case kFcos: return launch_fastmath<kFcos>(count, a, b, out, s);
    case kFlog: return launch_fastmath<kFlog>(count, a, b, out, s);
    case kFrsqrt: return launch_fastmath<kFrsqrt>(count, a, b, out, s);
    case kFsqrt: return launch_fastmath<kFsqrt>(count, a, b, out, s);
    case kFreciprocal: return launch_fastmath<kFreciprocal>(count, a, b, out, s);
    case kFdiv: return launch_fastmath<kFdiv>(count, a, b, out, s);
    default: return -3;
  }
}

// D1: n_solves warm-started solves of the fast-tier cart-pole with shaped4,
// x (4) held, u_n (N) updated in place, u0s (n_solves) written; mode is a
// MixMode, model_consts the 9 CartPoleNonlinearT floats, sampler_consts as
// above; key seed[0] (a device int32), solve j in the counter; rpt:
// rollouts a thread R, 1 or 4. One launch a solve. partials:
// (ceil(K/(256 R)), N+2) scratch; tickets (1).
int mpc_kernel_mix_chain(int mode, const float* model_consts, const float* sampler_consts, int n,
                         int k, float inv_lambda, float inv, float lo, float hi, float std_dev,
                         float cltf_mu, float cltf_inv_sig, int ramp_block, int rpt, const float* x,
                         float* u_n, const int* seed, int n_solves, float* partials, int* tickets,
                         float* u0s, void* stream) {
  if (n != kN) return -1;
  if (ramp_block < 1 || k < 1 || n_solves < 1 || (rpt != 1 && rpt != 4)) return -3;
  const PartialsArgs a = partials_args(k, inv_lambda, inv, lo, hi, std_dev, sampler_consts);
  const MixArgs m{cltf_mu, cltf_inv_sig, ramp_block};
  const CartPoleNonlinearT<true> model = make_model<true>(model_consts);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MPC_MIX_LAUNCH(M)                                                                         \
  return rpt == 1 ? launch_kernel_mix<M, 1>(model, a, m, x, u_n, seed, n_solves, partials, tickets, \
                                            u0s, s)                                                 \
                  : launch_kernel_mix<M, 4>(model, a, m, x, u_n, seed, n_solves, partials, tickets, \
                                            u0s, s)
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
