// Fused MPPI kernels for Hopper (sm_90a): one solve (K2) and the
// receding-horizon chain of solves (K1).
//
// Replaces the Pallas TPU kernels of mpc_rs_tpu/ops/mppi_pallas.py:
//   - mppi_partials_kernel + mppi_finalize_kernel replace
//     mppi_pallas_partials (_make_kernel) and finalize_partials: one MPPI
//     solve, with the box-muller branch of _fill_vbuf or external noise;
//   - mpc_mppi_chain replaces mppi_pallas_chain (_make_chain_kernel): J
//     warm-started solves, optionally stepping the plant on the device.
//
// What bounds it on the card: transcendentals and the FP32 issue rate, not
// bytes. Each rollout draws N normals (a log, a sqrt and a sincos per pair,
// plus ten Philox rounds per four normals) and runs N model steps (a sincos
// and two IEEE divisions each). The K*N*4 bytes of samples never leave
// registers; device memory sees only the (K/256, N+2) partials rows, and the
// (K, N) noise in external-noise mode.
//
// What the design does about it: one thread per rollout, 256 threads per
// block, the N clamped samples and the state in registers (N is a template
// parameter, so every loop unrolls). ptxas reports a 56-byte stack frame
// with 24 bytes of spill stores for the N=8 partials kernel; whether that
// frame is the accurate sinf/cosf's large-argument reduction or the sample
// array, and what it costs, is not measured yet.
// Each block reduces its rollouts with warp shuffles to one row
// (m_b, s_b, uw_b[N]) of a streaming log-sum-exp; a one-block finalize
// kernel merges the rows, applies the status ladder of finalize_partials
// and writes the new warm start on the device. The exact tier is built
// without --use_fast_math: sinf/cosf/logf/expf and '/' are the accurate
// forms, as jnp.sin/cos/log/exp and true division are in the JAX package;
// and with -fmad=false, so that no product is fused into a sum and the
// rounding is that of the plain version (ops/build.py).
//
// The chain updates the caller's u_n and x buffers in place: the finalize
// kernel of solve j writes u_n (the verbatim warm start of solve j+1) and,
// in plant mode, steps x. All launches go to the caller's stream, with no
// host synchronisation between them.
//
// The kernels are instantiated for one horizon, N = kN = 8, the main
// path's (mpc_rs_tpu/apps/mppi_examples.py:49).
//
// C interface (loaded with ctypes): every function returns the
// cudaGetLastError() value after its last launch (0 on success), or -1 for
// a horizon other than kN.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN = 8;  // the horizon the kernels are built for
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegBig = -3.4e38f;        // mppi_pallas.py:302
constexpr float kNoFiniteBelow = -3.3e38f;  // mppi_pallas.py:898,1022
constexpr float kTwoPi = 6.283185307179586f;

enum Status : int { kOk = 0, kNoFinite = 1, kSumZero = 2, kInvalidU = 3 };

// NaN-propagating clamp, as jnp.clip / torch.clamp (fminf/fmaxf would
// drop a NaN and turn a non-finite rollout into a finite one).
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Nonlinear cart-pole, exact tier (mpc_rs_tpu/models/dynamics.py:57-103).
// Products of parameters are folded in double on the host and rounded to
// float once, as the JAX trace folds Python floats; the remaining operation
// order is the JAX one, including (term1 - term2) / d * dt.
struct CartPoleNonlinear {
  float d0;       // p.d0
  float mlml;     // ml * ml
  float ml;       // p.m2 * p.l
  float kt;       // p.kt
  float r_w;      // p.r_w
  float c_term1;  // p.mass_line * p.m2 * p.g * p.l
  float c_term3;  // p.j2 + p.m2 * p.l * p.l
  float c_term4;  // p.m2 * p.g * p.l * p.l
  float dt;

  __device__ __forceinline__ void step(float& x0, float& x1, float& x2, float& x3,
                                       float u) const {
    const float s = sinf(x2);
    const float c = cosf(x2);
    const float d = d0 - mlml * c * c;
    const float thrust = kt * u / r_w + ml * x3 * x3 * s;
    const float term1 = c_term1 * s;
    const float term2 = thrust * ml * c;
    const float term3 = c_term3 * thrust;
    const float term4 = c_term4 * s * c;
    const float n3 = x3 + (term1 - term2) / d * dt;
    const float n1 = x1 + (term3 + term4) / d * dt;
    const float n2 = x2 + x3 * dt;
    const float n0 = x0 + x1 * dt;
    x0 = n0;
    x1 = n1;
    x2 = n2;
    x3 = n3;
  }
};

// Shaped cart-pole cost (mpc_rs_tpu/models/costs.py:16-27).
struct Shaped4 {
  __device__ __forceinline__ float operator()(float x0, float x1, float x2,
                                              float x3) const {
    const float xc = clampf(x0, -2.0f, 2.0f);
    const float t1 = 2.0f * xc * xc;
    const float a = clampf(x1 + 2.0f * xc, -5.0f, 5.0f);
    const float t2 = 3.0f * (a * a);
    const float b = x2 + 0.35f * clampf(x0, -0.75f, 0.75f);
    const float t3 = 5.0f * (b * b);
    const float t4 = 1.2f * x3 * x3;
    return t1 + t2 + t3 + t4;
  }
};

struct SolverArgs {
  int k;          // rollouts K
  float lambda;   // softmax temperature (0 gives INVALID_U, as mppi_solve)
  float inv;      // control-term coefficient (sigma^-2 or control_inv)
  float lo, hi;   // control box
  float std_dev;  // sampling sigma
};

// Philox4x32-10 (Salmon et al., SC'11); the plain version is
// mpc_rs_tpu_torch/ops/philox.py, which documents the layout contract.
__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]);
    const uint32_t lo0 = 0xD2511F53u * c[0];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]);
    const uint32_t lo1 = 0xCD9E8D57u * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0;
    const uint32_t n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

// Box-Muller pair from two words (mppi_pallas.py:67-70,194-207).
__device__ __forceinline__ void box_muller(uint32_t a, uint32_t b, float std_dev,
                                           float& z_cos, float& z_sin) {
  const float u1 = 2.0f - __uint_as_float((a >> 9) | 0x3F800000u);  // (0, 1]
  const float u2 = __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;   // [0, 1)
  const float r = std_dev * sqrtf(-2.0f * logf(u1));
  const float ang = kTwoPi * u2;
  z_cos = r * cosf(ang);
  z_sin = r * sinf(ang);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide max; every thread gets the result.
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
  __syncthreads();  // red may be reused by the caller
  return m;
}

// Block-wide sums of L values; thread i < L gets sum i in its return value.
template <int L>
__device__ __forceinline__ float block_sums(float (&acc)[L], float (*red)[L]) {
#pragma unroll
  for (int i = 0; i < L; ++i) acc[i] = warp_sum(acc[i]);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < L; ++i) red[threadIdx.x >> 5][i] = acc[i];
  }
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x < L) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
  }
  return s;
}

// One block of rollouts: sample (or read) and clamp, roll out N steps,
// score, and reduce to the row (m_b, s_b, uw_b[0..N-1]) of partials.
// Rollouts k >= K count as non-finite (exact-K masking, mppi_pallas.py:349-353).
template <int N, class Model, class Cost>
__global__ void __launch_bounds__(kThreads)
mppi_partials_kernel(Model model, Cost cost, SolverArgs a, const float* __restrict__ x,
                     const float* __restrict__ u_n, const float* __restrict__ noise,
                     const int* __restrict__ seeds, int seed_index, uint32_t base_seed,
                     uint32_t solve_word, float* __restrict__ partials) {
  __shared__ float red_max[kWarps];
  __shared__ float red_sum[kWarps][N + 1];

  const int k = blockIdx.x * kThreads + threadIdx.x;
  const bool in_range = k < a.k;

  float un[N];
  float v[N];
#pragma unroll
  for (int t = 0; t < N; ++t) {
    un[t] = u_n[t];
    v[t] = 0.0f;  // rollouts past K weigh 0 and carry 0
  }

  float score = 0.0f;
  bool finite = false;
  if (in_range) {
    if (noise != nullptr) {
#pragma unroll
      for (int t = 0; t < N; ++t) v[t] = noise[(size_t)k * N + t];
    } else {
      const uint32_t key = seeds != nullptr ? (uint32_t)seeds[seed_index] : base_seed;
#pragma unroll
      for (int c = 0; c < (N + 3) / 4; ++c) {
        uint32_t w[4] = {(uint32_t)k, (uint32_t)c, solve_word, 0u};
        philox4x32_10(w, key, 0u);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int t = 4 * c + 2 * p;
          if (t < N) {
            float z0, z1;
            box_muller(w[2 * p], w[2 * p + 1], a.std_dev, z0, z1);
            v[t] = z0;
            if (t + 1 < N) v[t + 1] = z1;
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < N; ++t) v[t] = clampf(un[t] + v[t], a.lo, a.hi);

    float x0 = x[0], x1 = x[1], x2 = x[2], x3 = x[3];
    float c_acc = 0.0f, ct = 0.0f;
#pragma unroll
    for (int t = 0; t < N; ++t) {
      model.step(x0, x1, x2, x3, v[t]);
      c_acc = c_acc + cost(x0, x1, x2, x3);
      ct = ct + un[t] * a.inv * v[t];
    }
    score = -c_acc - ct;
    finite = isfinite(score);
  }

  const float m_b = block_max(finite ? score : kNegBig, red_max);
  const float e = finite ? expf((score - m_b) / a.lambda) : 0.0f;
  float acc[N + 1];
  acc[0] = e;
#pragma unroll
  for (int t = 0; t < N; ++t) acc[t + 1] = e * v[t];
  const float s = block_sums<N + 1>(acc, red_sum);

  float* row = partials + (size_t)blockIdx.x * (N + 2);
  if (threadIdx.x == 0) row[0] = m_b;
  if (threadIdx.x < N + 1) row[1 + threadIdx.x] = s;
}

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

  const float s_all = tot_s[0];
  const bool no_finite = m_all <= kNoFiniteBelow;
  const bool sum_zero = s_all == 0.0f;
  const float denom = sum_zero ? 1.0f : s_all;
  float u[N];
#pragma unroll
  for (int t = 0; t < N; ++t) u[t] = tot_s[1 + t] / denom;
  const int st = no_finite ? kNoFinite : sum_zero ? kSumZero : !isfinite(u[0]) ? kInvalidU : kOk;
#pragma unroll
  for (int t = 0; t < N; ++t) u_out[t] = st == kOk ? u[t] : 0.0f;
  const float u_first = st == kOk ? u[0] : 0.0f;
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

CartPoleNonlinear make_model(const float* c) {
  return CartPoleNonlinear{c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8]};
}

template <int N>
int launch_solve(const CartPoleNonlinear& model, const SolverArgs& a, const float* x,
                 const float* u_n, const float* noise, const int* seeds, int seed_index,
                 uint32_t base_seed, uint32_t solve_word, float* partials, float* u_out,
                 int* status, float* u0, float* x_plant, cudaStream_t stream) {
  const int nb = (a.k + kThreads - 1) / kThreads;
  mppi_partials_kernel<N, CartPoleNonlinear, Shaped4><<<nb, kThreads, 0, stream>>>(
      model, Shaped4{}, a, x, u_n, noise, seeds, seed_index, base_seed, solve_word, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mppi_finalize_kernel<N, CartPoleNonlinear><<<1, kThreads, 0, stream>>>(
      model, a.lambda, nb, partials, u_out, status, u0, x_plant);
  return (int)cudaGetLastError();
}

template <int N>
int launch_chain(const CartPoleNonlinear& model, const SolverArgs& a, float* x, float* u_n,
                 const float* noise, const int* seeds, uint32_t base_seed, int n_solves,
                 int plant, float* partials, float* u0s, int* statuses, cudaStream_t stream) {
  for (int j = 0; j < n_solves; ++j) {
    const float* noise_j = noise != nullptr ? noise + (size_t)j * a.k * N : nullptr;
    // per-solve seeds: key seeds[j], solve word 0 (a single solve with
    // seed seeds[j] draws the same noise); scalar seed: key base_seed, word j
    const int err = launch_solve<N>(model, a, x, u_n, noise_j, seeds, j, base_seed,
                                    seeds != nullptr ? 0u : (uint32_t)j, partials, u_n,
                                    statuses + j, u0s + j, plant ? x : nullptr, stream);
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace

extern "C" {

// One solve (K2). model_consts: 9 host floats (CartPoleNonlinear order).
// Device pointers: x (4), u_n (N), noise (K, N) or null, seeds (>= seed_index+1)
// or null, partials (ceil(K/256), N+2) scratch, u_out (N), status (1).
int mpc_mppi_solve(const float* model_consts, int n, int k, float lambda, float inv, float lo,
                   float hi, float std_dev, const float* x, const float* u_n,
                   const float* noise, const int* seeds, int seed_index,
                   unsigned int base_seed, unsigned int solve_word, float* partials,
                   float* u_out, int* status, void* stream) {
  if (n != kN) return -1;
  return launch_solve<kN>(make_model(model_consts), SolverArgs{k, lambda, inv, lo, hi, std_dev},
                          x, u_n, noise, seeds, seed_index, base_seed, solve_word, partials,
                          u_out, status, nullptr, nullptr, static_cast<cudaStream_t>(stream));
}

// J warm-started solves (K1). x (4) and u_n (N) are updated in place;
// noise (J, K, N) or null; seeds (J) or null (then base_seed with j in the
// counter); u0s (J), statuses (J).
int mpc_mppi_chain(const float* model_consts, int n, int k, float lambda, float inv, float lo,
                   float hi, float std_dev, float* x, float* u_n, const float* noise,
                   const int* seeds, unsigned int base_seed, int n_solves, int plant,
                   float* partials, float* u0s, int* statuses, void* stream) {
  if (n != kN) return -1;
  return launch_chain<kN>(make_model(model_consts), SolverArgs{k, lambda, inv, lo, hi, std_dev},
                          x, u_n, noise, seeds, base_seed, n_solves, plant, partials, u0s,
                          statuses, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
