// Device code of the MPPI kernels (mppi_kernels.cu): constants, the
// NaN-propagating clamp, Philox4x32-10, the samplers, warp and block
// reductions, the model and cost functors, the log-sum-exp merge of
// partials rows, and the one kernel that every MPPI solve runs
// (mppi_partials_kernel, at the end).
//
// The functors carry the models of mpc_rs_tpu/models/{dynamics,costs}.py.
// Products of parameters are folded in double on the host and rounded to
// float once, as the JAX trace folds Python floats; the remaining operation
// order is the JAX one (the plain PyTorch versions are
// mpc_rs_tpu_torch/models/{dynamics,costs}.py, which keep the same order).

#pragma once

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "fastmath.cuh"

namespace mpc {

constexpr int kN = 8;  // the main paths' horizon (the fleets, mppi4-non-liner, D1)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegBig = -3.4e38f;        // mppi_pallas.py:302
constexpr float kNoFiniteBelow = -3.3e38f;  // mppi_pallas.py:898,1022
constexpr float kTwoPi = 6.283185307179586f;
constexpr unsigned kFullMask = 0xffffffffu;

enum Status : int { kOk = 0, kNoFinite = 1, kSumZero = 2, kInvalidU = 3 };

// NaN-propagating clamp, as jnp.clip / torch.clamp (fminf/fmaxf would
// drop a NaN and turn a non-finite rollout into a finite one).
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Nonlinear cart-pole (mpc_rs_tpu/models/dynamics.py:57-103), exact or fast
// tier; the fast tier divides once, by the hardware approximate reciprocal.
template <bool Fast>
struct CartPoleNonlinearT {
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
    float s, c;
    sincos_tier<Fast>(x2, s, c);
    const float d = d0 - mlml * c * c;
    const float thrust = kt * u / r_w + ml * x3 * x3 * s;
    const float term1 = c_term1 * s;
    const float term2 = thrust * ml * c;
    const float term3 = c_term3 * thrust;
    const float term4 = c_term4 * s * c;
    float n3, n1;
    if constexpr (Fast) {
      const float inv_d_dt = fm::fdiv(dt, d);
      n3 = x3 + (term1 - term2) * inv_d_dt;
      n1 = x1 + (term3 + term4) * inv_d_dt;
    } else {
      n3 = x3 + (term1 - term2) / d * dt;
      n1 = x1 + (term3 + term4) / d * dt;
    }
    const float n2 = x2 + x3 * dt;
    const float n0 = x0 + x1 * dt;
    x0 = n0;
    x1 = n1;
    x2 = n2;
    x3 = n3;
  }
};

using CartPoleNonlinear = CartPoleNonlinearT<false>;

// Flagship two-wheel controller model (dynamics.py:110-194: make_ddot with
// f ≡ 0, make_flagship4), exact or fast tier. Semi-implicit: theta from the
// new dtheta, x from the new dx. Host folding (ml = m2·l, mll_j2 = m2·l² + j2):
struct Flagship4Consts {
  float d1;   // p.d1_two
  float ml;   // ml
  float k1;   // mll_j2 * ml
  float k2;   // -(ml**2) * g
  float k3;   // 2 * mll_j2
  float r_w;  // p.r_w
  float kt;   // p.kt
  float k4;   // -(ml**2)
  float k5;   // m2 * g
  float l;    // p.l
  float mlt;  // p.mass_line_two
  float k6;   // -2 * ml
  float k7;   // (ml**2) * g
  float k8;   // (2 * mll_j2 / r_w) * kt
  float k9;   // l * mass_line_two
  float k10;  // (2 * ml / r_w) * kt
  float dt;
};

// make_ddot's exact tier (dynamics.py:126-157): (ddot_x, ddot_theta) from
// (theta, dtheta, u). WithForce adds the terms of a disturbance force f
// (the flagship6 plant, with mll_j2 = m2·l² + j2); without it f ≡ 0 is
// specialised away, as the JAX trace does for a literal 0.0 (the controller
// rollout and the UKF process model).
template <bool WithForce>
__device__ __forceinline__ void flagship_ddot_exact(const Flagship4Consts& k, float mll_j2,
                                                    float theta, float dtheta, float u, float f,
                                                    float& ddx, float& ddth) {
  float s, c;
  sincos_tier<false>(theta, s, c);
  const float mc = k.ml * c;
  const float d = k.d1 - mc * mc;
  const float term1 = k.k1 / d * dtheta * dtheta * s;
  const float term2 = k.k2 / d * s * c;
  const float term3 = k.k3 / (d * k.r_w) * k.kt * u;
  ddx = term1 + term2 + term3;
  float cdt = 0.0f;
  if constexpr (WithForce) {
    cdt = cosf(dtheta);
    ddx = ddx + mll_j2 / d * f * cdt;
  }
  const float t1 = k.k4 / d * dtheta * dtheta * s * c;
  float fs = k.k5 * s;
  if constexpr (WithForce) fs = fs - 2.0f * f;
  const float t2 = fs * k.l * k.mlt / d;
  const float t3 = k.k6 / (d * k.r_w) * k.kt * u * c;
  ddth = t1 + t2 + t3;
  if constexpr (WithForce) ddth = ddth - k.ml * f * (cdt * cdt) / d;
}

template <bool Fast>
struct Flagship4 {
  Flagship4Consts k;

  __device__ __forceinline__ void step(float& x0, float& x1, float& x2, float& x3,
                                       float u) const {
    float ddx, ddth;
    if constexpr (Fast) {
      float s, c;
      sincos_tier<Fast>(x2, s, c);
      const float mc = k.ml * c;
      const float d = k.d1 - mc * mc;
      const float inv_d = fm::freciprocal(d);
      const float num_x = k.k1 * x3 * x3 * s - k.k7 * s * c + k.k8 * u;
      const float fs = k.k5 * s;
      const float num_th = k.k4 * x3 * x3 * s * c + fs * k.k9 - k.k10 * u * c;
      ddx = inv_d * num_x;
      ddth = inv_d * num_th;
    } else {
      flagship_ddot_exact<false>(k, 0.0f, x2, x3, u, 0.0f, ddx, ddth);
    }
    const float n3 = x3 + ddth * k.dt;
    const float n2 = x2 + n3 * k.dt;
    const float n1 = x1 + ddx * k.dt;
    const float n0 = x0 + n1 * k.dt;
    x0 = n0;
    x1 = n1;
    x2 = n2;
    x3 = n3;
  }
};

// The state count S of a model: Model::kS where it declares one, else 4
// (the four-state models, whose step takes x0..x3 one by one; a model of
// another S steps a float (&)[S] and its cost reads one).
template <class M, class = void>
struct StateCount : std::integral_constant<int, 4> {};
template <class M>
struct StateCount<M, std::void_t<decltype(M::kS)>> : std::integral_constant<int, M::kS> {};
template <class M>
constexpr int kStates = StateCount<M>::value;

// Double integrator of mppi2 (mpc_rs_tpu/models/dynamics.py:22-31):
// explicit, x0 from the old x1.
struct DoubleIntegrator {
  static constexpr int kS = 2;
  float dt;

  __device__ __forceinline__ void step(float (&x)[2], float u) const {
    const float n0 = x[0] + x[1] * dt;
    const float n1 = x[1] + u * dt;
    x[0] = n0;
    x[1] = n1;
  }
};

// Linear cart-pole of mppi4 (dynamics.py:34-54), sequential as the Rust
// crate mutates in place: x3 from the old x2, x2 from the new x3, x1 from
// the new x2, x0 from the new x1. Host folding (d = p.d_lin):
struct CartPoleLinear {
  float a32;  // p.mass_line / d * p.m2 * p.g * p.l
  float b3;   // -p.m2 * p.l / d / p.r_w * p.kt
  float a12;  // -p.m2 * p.m2 * p.g * p.l * p.l / d
  float b1;   // (p.m2 * p.l * p.l + p.j2) / d / p.r_w * p.kt
  float dt;

  __device__ __forceinline__ void step(float& x0, float& x1, float& x2, float& x3,
                                       float u) const {
    x3 = x3 + (a32 * x2 + b3 * u) * dt;
    x2 = x2 + x3 * dt;
    x1 = x1 + (a12 * x2 + b1 * u) * dt;
    x0 = x0 + x1 * dt;
  }
};

// Controller model of the HW flagship (dynamics.py:270-294, make_commu4):
// fully explicit, every component from the old state. Host folding
// (ml = m2·l, mll_j2 = m2·l² + j2):
struct Commu4 {
  float d1;   // p.d1_two
  float ml;   // ml
  float k1;   // mll_j2 * ml
  float k2;   // -(ml**2) * g
  float k3;   // 2 * mll_j2
  float r_w;  // p.r_w
  float kt;   // p.kt
  float k4;   // -(ml**2)
  float k5;   // m2 * g * l * mass_line_two
  float k6;   // -2 * ml
  float dt;

  __device__ __forceinline__ void step(float& x0, float& x1, float& x2, float& x3,
                                       float u) const {
    float s, c;
    sincos_tier<false>(x2, s, c);
    const float mc = ml * c;
    const float d = d1 - mc * mc;
    const float n0 = x0 + x1 * dt;
    const float term1 = k1 / d * x3 * x3 * s;
    const float term2 = k2 / d * s * c;
    const float term3 = k3 / (d * r_w) * kt * u;
    const float n1 = x1 + (term1 + term2 + term3) * dt;
    const float n2 = x2 + x3 * dt;
    const float t1 = k4 / d * x3 * x3 * s * c;
    const float t2 = k5 / d * s;
    const float t3 = k6 / (d * r_w) * kt * u * c;
    const float n3 = x3 + (t1 + t2 + t3) * dt;
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

// Diagonal quadratic Σ cᵢ xᵢ² (costs.py:30-37).
struct Diag4 {
  float c0, c1, c2, c3;
  __device__ __forceinline__ float operator()(float x0, float x1, float x2,
                                              float x3) const {
    return c0 * x0 * x0 + c1 * x1 * x1 + c2 * x2 * x2 + c3 * x3 * x3;
  }
};

// mppi2's cost x0² + x1² (costs.py:11-13).
struct Quad2 {
  __device__ __forceinline__ float operator()(const float (&x)[2]) const {
    return x[0] * x[0] + x[1] * x[1];
  }
};

// The HW flagship's cost 1.2 + 3θ² + 3θ̇² (costs.py:40-44; the 1.2 is the
// reference's, kept).
struct Commu4Cost {
  __device__ __forceinline__ float operator()(float x0, float x1, float x2, float x3) const {
    return 1.2f + 3.0f * x2 * x2 + 3.0f * x3 * x3;
  }
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

__device__ __forceinline__ float unit_open(uint32_t a) {  // (0, 1]
  return 2.0f - __uint_as_float((a >> 9) | 0x3F800000u);
}

__device__ __forceinline__ float unit_closed_open(uint32_t b) {  // [0, 1)
  return __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
}

template <bool Fast>
__device__ __forceinline__ float log_tier(float x) {
  if constexpr (Fast) return fm::flog(x); else return logf(x);
}

template <bool Fast>
__device__ __forceinline__ float sqrt_tier(float x) {
  if constexpr (Fast) return fm::fsqrt(x); else return sqrtf(x);
}

// Box-Muller pair from two words (mppi_pallas.py:67-70,194-207), with the
// transcendentals of the tier (_sampling_math).
template <bool Fast = false>
__device__ __forceinline__ void box_muller(uint32_t a, uint32_t b, float std_dev,
                                           float& z_cos, float& z_sin) {
  const float u1 = unit_open(a);
  const float u2 = unit_closed_open(b);
  const float r = std_dev * sqrt_tier<Fast>(-2.0f * log_tier<Fast>(u1));
  const float ang = kTwoPi * u2;
  float s, c;
  sincos_tier<Fast>(ang, s, c);
  z_cos = r * c;
  z_sin = r * s;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
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

// The status ladder and zero fallback of finalize_partials
// (mppi_pallas.py:1021-1036) on merged totals (s, uw[0..N-1]); returns the
// status and writes u (zeros unless kOk).
template <int N>
__device__ __forceinline__ int status_ladder(float m_all, const float* tot, float* u_out) {
  const float s_all = tot[0];
  const bool no_finite = m_all <= kNoFiniteBelow;
  const bool sum_zero = s_all == 0.0f;
  const float denom = sum_zero ? 1.0f : s_all;
  float u[N];
#pragma unroll
  for (int t = 0; t < N; ++t) u[t] = tot[1 + t] / denom;
  const int st = no_finite ? kNoFinite : sum_zero ? kSumZero : !isfinite(u[0]) ? kInvalidU : kOk;
#pragma unroll
  for (int t = 0; t < N; ++t) u_out[t] = st == kOk ? u[t] : 0.0f;
  return st;
}

// Appended in order: a sampler keeps its ID (ops/mppi_cuda.py _SAMPLER_IDS).
enum Sampler : int {
  kExternal = 0, kBoxMuller = 1, kClt4 = 2, kClt4a = 3, kWallace = 4, kClt2q = 5, kBoxMullerA = 6
};

constexpr float kCltInvSig = 0x1.bb688cp-8f;  // f32(1/sqrt(4 (256² − 1)/12))
constexpr float kTriInvSig = 0x1.39897ep-7f;  // f32(1/sqrt(2 (256² − 1)/12))
constexpr int kWallacePeriod = 8;

struct PartialsArgs {
  int k;             // rollouts K per problem
  float inv_lambda;  // f32(1/lambda), folded in double (mppi_pallas.py:348); +inf for
                     // lambda = 0, whose best rollout then weighs 0*inf = NaN: INVALID_U
  float inv;         // control-term coefficient (sigma^-2 or control_inv)
  float lo, hi;   // control box
  float std_dev;  // sampling sigma
  float clt_a;    // f32(_CLT_A * sigma), clt4/clt4a
  float clt_b;    // f32(_CLT_B * sigma), clt4/clt4a
  float mix;      // f32(sigma / sqrt 2), wallace
  float tri_a;    // f32(_TRI_A * sigma), clt2q
  float tri_b;    // f32(_TRI_B * sigma), clt2q
  float tri_c;    // f32(_TRI_C * sigma), clt2q
};

// clt4: the sum of four 8-bit uniforms of one word, then the cubic
// (mppi_pallas.py:140-149).
__device__ __forceinline__ float clt4(uint32_t w, float ca, float cb) {
  const uint32_t x2 = (w & 0x00FF00FFu) + ((w >> 8) & 0x00FF00FFu);
  const uint32_t s4 = (x2 & 0xFFFFu) + (x2 >> 16);
  const float z = ((float)(int)s4 - 510.0f) * kCltInvSig;
  return z * (ca + cb * (z * z));
}

// clt2q: the sum of two 8-bit uniforms (a 16-bit half h of x2), then the
// quintic (mppi_pallas.py:179-193).
__device__ __forceinline__ float clt2q(uint32_t h, const PartialsArgs& a) {
  const float z = ((float)(int)h - 255.0f) * kTriInvSig;
  const float s = z * z;
  return z * (a.tri_a + s * (a.tri_b + a.tri_c * s));
}

// The noise e[0..N-1] of rollout k (before u_n and the clamp): Philox key
// `key`, counter (rollout or pair, call, word, 0), the branches of _fill_vbuf
// (mppi_pallas.py:125-284).
template <int N, bool Fast, int S>
__device__ __forceinline__ void sample(float (&e)[N], uint32_t k, uint32_t key, uint32_t word,
                                       const PartialsArgs& a) {
  constexpr int kCalls = (N + 3) / 4;
  if constexpr (S == kBoxMuller) {
#pragma unroll
    for (int c = 0; c < kCalls; ++c) {
      uint32_t w[4] = {k, (uint32_t)c, word, 0u};
      philox4x32_10(w, key, 0u);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int t = 4 * c + 2 * p;
        if (t < N) {
          float z0, z1;
          box_muller<Fast>(w[2 * p], w[2 * p + 1], a.std_dev, z0, z1);
          e[t] = z0;
          if (t + 1 < N) e[t + 1] = z1;
        }
      }
    }
  } else if constexpr (S == kClt2q) {
    // two normals per word, steps 8c + 2i and 8c + 2i + 1 from word i
#pragma unroll
    for (int c = 0; c < (N + 7) / 8; ++c) {
      uint32_t w[4] = {k, (uint32_t)c, word, 0u};
      philox4x32_10(w, key, 0u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 8 * c + 2 * i;
        const uint32_t x2 = (w[i] & 0x00FF00FFu) + ((w[i] >> 8) & 0x00FF00FFu);
        if (t < N) e[t] = clt2q(x2 & 0xFFFFu, a);
        if (t + 1 < N) e[t + 1] = clt2q(x2 >> 16, a);
      }
    }
  } else if constexpr (S == kBoxMullerA) {
    // rollouts 2j (+eps) and 2j+1 (-eps) share pair j's box-muller normals;
    // as in clt4a, each lane of the pair makes the calls of its own parity
    // (one log, sqrt and sincos per two steps) and they swap halves
    const uint32_t parity = k & 1u;
    float own[N];
#pragma unroll
    for (int t = 0; t < N; ++t) own[t] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCalls; ++c) {
      if ((uint32_t)(c & 1) == parity) {
        uint32_t w[4] = {k >> 1, (uint32_t)c, word, 0u};
        philox4x32_10(w, key, 0u);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int t = 4 * c + 2 * p;
          if (t < N) {
            float z0, z1;
            box_muller<Fast>(w[2 * p], w[2 * p + 1], a.std_dev, z0, z1);
            own[t] = z0;
            if (t + 1 < N) own[t + 1] = z1;
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < N; ++t) {
      const float other = __shfl_xor_sync(kFullMask, own[t], 1);
      const float eps = (uint32_t)((t / 4) & 1) == parity ? own[t] : other;
      e[t] = parity ? -eps : eps;
    }
  } else if constexpr (S == kClt4) {
#pragma unroll
    for (int c = 0; c < kCalls; ++c) {
      uint32_t w[4] = {k, (uint32_t)c, word, 0u};
      philox4x32_10(w, key, 0u);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (4 * c + i < N) e[4 * c + i] = clt4(w[i], a.clt_a, a.clt_b);
    }
  } else if constexpr (S == kClt4a) {
    // rollouts 2j (+eps) and 2j+1 (-eps) share pair j's normals; each lane
    // of the pair makes the calls of its own parity and they swap halves
    const uint32_t parity = k & 1u;
    float own[N];
#pragma unroll
    for (int t = 0; t < N; ++t) own[t] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCalls; ++c) {
      if ((uint32_t)(c & 1) == parity) {
        uint32_t w[4] = {k >> 1, (uint32_t)c, word, 0u};
        philox4x32_10(w, key, 0u);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (4 * c + i < N) own[4 * c + i] = clt4(w[i], a.clt_a, a.clt_b);
      }
    }
#pragma unroll
    for (int t = 0; t < N; ++t) {
      const float other = __shfl_xor_sync(kFullMask, own[t], 1);
      const float eps = (uint32_t)((t / 4) & 1) == parity ? own[t] : other;
      e[t] = parity ? -eps : eps;
    }
  } else if constexpr (S == kWallace) {
    // one exact Box-Muller pool per window of 8 steps; the other steps mix
    // fresh sign bits of the pool's a with a warp-rotated partner's b
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int c = 0; c * kWallacePeriod < N; ++c) {
      uint32_t w[4] = {k, (uint32_t)c, word, 0u};
      philox4x32_10(w, key, 0u);
      const float r = sqrt_tier<Fast>(-2.0f * log_tier<Fast>(unit_open(w[0])));
      const float ang = kTwoPi * unit_closed_open(w[1]);
      float s, co;
      sincos_tier<Fast>(ang, s, co);
      const float pa = r * co;
      const float pb = r * s;
#pragma unroll
      for (int ph = 0; ph < kWallacePeriod; ++ph) {
        const int t = c * kWallacePeriod + ph;
        if (t < N) {
          if (ph == 0) {
            e[t] = a.std_dev * pa;
          } else if (ph == 1) {
            e[t] = a.std_dev * pb;
          } else {
            const int shift = (29 * ph + 13) % 32;
            const float b_rot = __shfl_sync(kFullMask, pb, (lane - shift) & 31);
            const float sa = ((w[2] << (ph - 2)) & 0x80000000u) ? -pa : pa;
            e[t] = a.mix * (sa + b_rot);
          }
        }
      }
    }
  }
}

// Fold one entry of max m_e and weights vals into a running log-sum-exp
// (m, acc), with one exp: the first entry (m = neg_big, acc = 0) is taken
// as it is; a new maximum rescales acc by exp((m - m_e) f32(1/lambda)) and
// adds vals; otherwise vals is added with weight exp((m_e - m) f32(1/lambda)).
// The roundings are those of a rescale followed by a weighted add.
template <int L>
__device__ __forceinline__ void lse_fold(float& m, float (&acc)[L], float m_e,
                                         const float (&vals)[L], float inv_lambda) {
  if (m == kNegBig) {
#pragma unroll
    for (int i = 0; i < L; ++i) acc[i] += vals[i];
    m = m_e;
    return;
  }
  const float d = m_e - m;
  const bool new_max = d > 0.0f;
  const float e = expf(-fabsf(d) * inv_lambda);
  const float keep = new_max ? e : 1.0f, w = new_max ? 1.0f : e;  // a product by 1 is exact
#pragma unroll
  for (int i = 0; i < L; ++i) acc[i] = acc[i] * keep + vals[i] * w;
  if (new_max) m = m_e;
}

// The thread's share of a merge: rows first, first + stride, ... < nb of
// (m_b, s_b, uw_b[0..N-1]), each read once, folded into (returned m, tot). The rows were written by other blocks of the
// launch (or an earlier launch): read them from L2 (__ldcg), past this SM's
// L1. An all-masked row (m_b = neg_big, s_b = 0) contributes exactly 0.
template <int N>
__device__ __forceinline__ float fold_rows(const float* rows, int nb, int first, int stride,
                                           float inv_lambda, float (&tot)[N + 1]) {
  constexpr int L = N + 1;
  float m = kNegBig;
#pragma unroll
  for (int i = 0; i < L; ++i) tot[i] = 0.0f;
  for (int r = first; r < nb; r += stride) {
    const float* row = rows + (size_t)r * (L + 1);
    const float m_r = __ldcg(row);
    float vals[L];
#pragma unroll
    for (int i = 0; i < L; ++i) vals[i] = __ldcg(row + 1 + i);
    if (m_r > kNoFiniteBelow) lse_fold<L>(m, tot, m_r, vals, inv_lambda);
  }
  return m;
}

// Merge the nb rows of one problem by log-sum-exp in one warp (the rows of
// a few blocks; fleet_finalize_kernel's merge): every lane gets m_all and
// tot[0..N] = (s, uw[0..N-1]). Up to 32 rows a lane holds one, and the
// result is the bits of the two-pass merge (each row scaled by
// exp((m_b - m_all) f32(1/lambda)), then summed).
template <int N>
__device__ __forceinline__ float merge_rows_warp(const float* rows, int nb, float inv_lambda,
                                                 float (&tot)[N + 1]) {
  const float m = fold_rows<N>(rows, nb, threadIdx.x & 31, 32, inv_lambda, tot);
  const float m_all = warp_max(m);
  const float scale = m > kNoFiniteBelow ? expf((m - m_all) * inv_lambda) : 0.0f;
#pragma unroll
  for (int i = 0; i <= N; ++i) tot[i] = warp_sum(tot[i] * scale);
  return m_all;
}

// The same merge by the whole block, for the rows of many blocks (K1/K2 at
// large K): every thread gets m_all; tot[0..N] (shared) is filled after the
// final barrier.
template <int N>
__device__ __forceinline__ float merge_rows_block(const float* rows, int nb, float inv_lambda,
                                                  float* red_max, float (*red_sum)[N + 1], float* tot) {
  constexpr int L = N + 1;
  float acc[L];
  const float m = fold_rows<N>(rows, nb, threadIdx.x, kThreads, inv_lambda, acc);
  const float m_all = block_max(m, red_max);
  const float scale = m > kNoFiniteBelow ? expf((m - m_all) * inv_lambda) : 0.0f;
#pragma unroll
  for (int i = 0; i <= N; ++i) acc[i] *= scale;
  const float s = block_sums<L>(acc, red_sum);
  if (threadIdx.x < L) tot[threadIdx.x] = s;
  __syncthreads();
  return m_all;
}

// Roll one control sequence v out N steps from xb and score it: the
// negated sum of the stage costs and of the control term u_n·inv·v. A
// four-state model steps x0..x3 one by one; another S steps an array.
template <int N, class Model, class Cost>
__device__ __forceinline__ float rollout_score(const Model& model, const Cost& cost,
                                               const PartialsArgs& a,
                                               const float (&xb)[kStates<Model>],
                                               const float (&un)[N], const float (&v)[N]) {
  if constexpr (kStates<Model> == 4) {
  float x0 = xb[0], x1 = xb[1], x2 = xb[2], x3 = xb[3];
  float c_acc = 0.0f, ct = 0.0f;
#pragma unroll
  for (int t = 0; t < N; ++t) {
    model.step(x0, x1, x2, x3, v[t]);
    c_acc = c_acc + cost(x0, x1, x2, x3);
    ct = ct + un[t] * a.inv * v[t];
  }
  return -c_acc - ct;
  } else {
    float x[kStates<Model>];
#pragma unroll
    for (int i = 0; i < kStates<Model>; ++i) x[i] = xb[i];
    float c_acc = 0.0f, ct = 0.0f;
#pragma unroll
    for (int t = 0; t < N; ++t) {
      model.step(x, v[t]);
      c_acc = c_acc + cost(x);
      ct = ct + un[t] * a.inv * v[t];
    }
    return -c_acc - ct;
  }
}

// What a partials launch reads and writes besides the model and the cost.
// Problem b starts from x[b] with nominal u_n[b], reads noise[b] or samples
// with key seeds[b] (base_seed when seeds is null) and counter word
// word0 + b, and writes its rows to partials[b]. With u_out, the launch also
// merges each problem's rows (the last of its blocks to finish does) and
// writes u_out[b], status[b] and, for K1, u0 and the stepped plant x_plant.
// With row_out instead, the merge writes the problem's merged row
// (m_all, s, uw) to row_out[b] and applies no ladder: the rank's partials of
// a multi-GPU solve, which the collectives merge across ranks
// (mpc_rs_tpu/parallel/sharded_mppi.py:73-80). A problem with no finite
// rollout writes m_all = kNegBig and zeros, as its rows.
// u_out may alias u_n, and x_plant is x (K1 updates both in place): every
// block reads them before it draws its ticket, and the merge writes them
// after the last ticket.
struct PartialsIO {
  const float* x;        // (P, S) start states
  const float* u_n;      // (P, N) nominals
  const float* noise;    // (P, K, N) external noise (already scaled by sigma), or null
  const int* seeds;      // (P) Philox keys, or null
  uint32_t base_seed;    // the key when seeds is null
  uint32_t word0;        // the counter word of problem 0
  float* partials;       // (P, nb, N+2) rows
  float* noise_out;      // (P, K, N), or null: receives the noise used
  float* u_out;          // (P, N) u_n', or null: write the rows only
  int* status;           // (P) MppiStatus
  int* tickets;          // (P) zeros; the merging block resets its problem's to 0
  float* u0;             // (1) or null: u_out[0][0], K1's u0 of the solve
  float* x_plant;        // (S) or null: x itself (P = 1), K1's plant, stepped with u0
  float* row_out = nullptr;  // (P, N+2), or null: the merged rows, in place of u_out's solve

  // whether the last block of a problem merges its rows (into u_out or row_out)
  __device__ __forceinline__ bool merges() const { return u_out != nullptr || row_out != nullptr; }
};

// The end of problem b's solve, by one thread, on the merged totals: the
// status ladder and zero fallback (mppi_pallas.py:1021-1036) into u_out[b]
// and status[b]; for K1, u0 and one plant step with it from the solve's
// start state xb (x_plant is x: the step needs no second read of it). With
// row_out, the merged row (m_all, tot[0..N]) goes there instead.
template <int N, class Model>
__device__ __forceinline__ void finish_solve(const Model& model, float m_all, const float* tot,
                                             const float (&xb)[kStates<Model>],
                                             const PartialsIO& io, int b) {
  if (io.row_out != nullptr) {
    float* row = io.row_out + (size_t)b * (N + 2);
    row[0] = m_all;
#pragma unroll
    for (int i = 0; i <= N; ++i) row[1 + i] = tot[i];
    return;
  }
  float* u = io.u_out + (size_t)b * N;
  io.status[b] = status_ladder<N>(m_all, tot, u);
  if (io.u0 != nullptr) *io.u0 = u[0];
  if (io.x_plant != nullptr) {
    if constexpr (kStates<Model> == 4) {
    float x0 = xb[0], x1 = xb[1], x2 = xb[2], x3 = xb[3];
    model.step(x0, x1, x2, x3, u[0]);
    io.x_plant[0] = x0;
    io.x_plant[1] = x1;
    io.x_plant[2] = x2;
    io.x_plant[3] = x3;
    } else {
      float x[kStates<Model>];
#pragma unroll
      for (int i = 0; i < kStates<Model>; ++i) x[i] = xb[i];
      model.step(x, u[0]);
#pragma unroll
      for (int i = 0; i < kStates<Model>; ++i) io.x_plant[i] = x[i];
    }
  }
}

// partials_body's policy for every MPPI solve: sample sampler S's noise in
// tier Fast (or read the external noise) and clamp, and finish with the
// status ladder (finish_solve). It is written out in partials_body itself,
// which calls another policy's hooks only when Pol is not MppiSolve (D1's
// MixSolve, diag_kernels.cuh): controls(v, un, k, key, word, a) and
// finish<N>(m_all, tot, io, b). So the solves' instantiations
// compile from the very statements they always had, to the same registers.
// Every policy rolls out and scores with rollout_score on its Model and Cost.
struct MppiSolve {};

// Problems of at most this many blocks are merged by one warp of their last
// block (the other warps leave after the reductions); more, by the block.
constexpr int kWarpMergeRows = 128;

// The end of partials_body for a row whose L = N + 1 sums (s, uw) span more
// than warp 0 (L > 32: the solves from N = 32, mppi2's N = 40): block_sums
// leaves sum i in thread i, so they are gathered in
// shared memory (tot) first, and lane 0 writes the row from there.
// Otherwise the steps of partials_body's own end: the only block finishes
// from its sums; a block writes its row and draws the problem's ticket, and
// the last merges the rows (one warp up to kWarpMergeRows rows, else the
// block) and finishes the solve (finish_solve, or Pol's finish).
template <int N, class Model, class Pol>
__device__ __forceinline__ void partials_end_wide(const Model& model, const PartialsArgs& a,
                                                  const PartialsIO& io, int nb, float m_b, float s,
                                                  const float (&xb)[kStates<Model>],
                                                  float* red_max, float (*red_sum)[N + 1],
                                                  float* tot, const Pol& pol) {
  constexpr bool kSolve = std::is_same_v<Pol, MppiSolve>;
  constexpr int L = N + 1;
  const int b = blockIdx.y;
  if (threadIdx.x < L) tot[threadIdx.x] = s;
  __syncthreads();
  if (io.merges() && nb == 1) {  // the problem's only block: no row, no ticket
    if (threadIdx.x == 0) {
      if constexpr (!kSolve) {
        pol.template finish<N>(m_b, tot, io, b);
      } else {
        finish_solve<N>(model, m_b, tot, xb, io, b);
      }
    }
    return;
  }
  const bool block_merge = io.merges() && nb > kWarpMergeRows;
  if (threadIdx.x >= 32 && !block_merge) return;
  float* rows = io.partials + (size_t)b * nb * (L + 1);
  __shared__ int ticket;
  if (threadIdx.x == 0) {
    float* row = rows + (size_t)blockIdx.x * (L + 1);
    row[0] = m_b;
    for (int i = 0; i < L; ++i) row[1 + i] = tot[i];
    if (io.merges()) {
      ticket = cuda::atomic_ref<int, cuda::thread_scope_device>(io.tickets[b])
                   .fetch_add(1, cuda::memory_order_acq_rel);
    }
  }
  if (!io.merges()) return;
  if (block_merge) {
    __syncthreads();
    if (ticket != nb - 1) return;
    const float m_all = merge_rows_block<N>(rows, nb, a.inv_lambda, red_max, red_sum, tot);
    if (threadIdx.x == 0) {
      if constexpr (!kSolve) {
        pol.template finish<N>(m_all, tot, io, b);
      } else {
        finish_solve<N>(model, m_all, tot, xb, io, b);
      }
      io.tickets[b] = 0;
    }
    return;
  }
  __syncwarp();
  if (ticket != nb - 1) return;
  float wtot[L];
  const float m_all = merge_rows_warp<N>(rows, nb, a.inv_lambda, wtot);
  if (threadIdx.x == 0) {
    if constexpr (!kSolve) {
      pol.template finish<N>(m_all, wtot, io, b);
    } else {
      finish_solve<N>(model, m_all, wtot, xb, io, b);
    }
    io.tickets[b] = 0;
  }
}

// One block of one problem's rollouts: sample (or read) and clamp (or Pol's
// controls), roll out N steps, score, and reduce to the row (m_b, s_b,
// uw_b[0..N-1]) of that problem's partials; then, with io.u_out, the merge.
// Grid (ceil(K/(256 R)),
// P): thread i of block g runs rollouts k = (g R + r) 256 + i, r < R, one
// after another, so each group of 256 rollouts is one warp-aligned range as
// at R = 1, and the Philox counters, the lane pairs of clt4a and
// box-muller-a and wallace's warp rotation draw every rollout's noise as at
// R = 1. Each thread keeps a running log-sum-exp of its rollouts
// (lse_fold), so the block pays one block_max and one block_sums<N+1> per
// 256 R rollouts, with the registers and the code of one rollout. The fleet
// runs P = B scenarios with word0 = 0; a K2 solve is P = 1 with its solve
// index in word0. Every thread samples (the warp shuffles of clt4a and
// wallace need whole warps); rollouts k >= K count as non-finite and carry
// v = 0 (exact-K masking, mppi_pallas.py:349-353).
//
// The merge: a problem of one block finishes from its own sums. Otherwise
// lane 0 writes the block's row and draws the problem's ticket (an
// acquire-release atomic add); the block that draws nb - 1 has every row of
// the problem in L2. It merges them (one warp for up to kWarpMergeRows
// rows, else the block), finishes the solve (finish_solve, or Pol's finish;
// with io.row_out, finish_solve writes the merged row instead) and resets
// the ticket for the next launch.
template <int N, class Model, class Cost, bool Fast, int S, int R, class Pol = MppiSolve>
__device__ __forceinline__ void partials_body(const Model& model, const Cost& cost,
                                              const PartialsArgs& a, const PartialsIO& io,
                                              const Pol& pol = Pol{}) {
  constexpr bool kSolve = std::is_same_v<Pol, MppiSolve>;
  constexpr int L = N + 1;  // sums a row carries after m_b
  __shared__ float red_max[kWarps];
  __shared__ float red_sum[kWarps][L];

  const int b = blockIdx.y;
  const uint32_t key = io.seeds != nullptr ? (uint32_t)io.seeds[b] : io.base_seed;
  constexpr int kX = kStates<Model>;  // (S is the sampler)
  float un[N], xb[kX];
#pragma unroll
  for (int t = 0; t < N; ++t) un[t] = io.u_n[(size_t)b * N + t];
#pragma unroll
  for (int i = 0; i < kX; ++i) xb[i] = io.x[(size_t)b * kX + i];

  // the thread's rollouts one after another, in a loop that is not unrolled
  // (the code of one rollout, not R), each folded into the thread's running
  // log-sum-exp (m_t, acc)
  float m_t = kNegBig;
  float acc[L];
#pragma unroll
  for (int i = 0; i < L; ++i) acc[i] = 0.0f;
#pragma unroll 1
  for (int r = 0; r < R; ++r) {
    const uint32_t k = ((uint32_t)blockIdx.x * R + r) * kThreads + threadIdx.x;
    const bool in_range = k < (uint32_t)a.k;  // rollouts past K weigh 0
    float e[N], v[N];
    if constexpr (!kSolve) {
      pol.controls(v, un, k, key, io.word0 + (uint32_t)b, a);  // every thread, as sample<>
      if (!in_range) continue;
    } else {
#pragma unroll
    for (int t = 0; t < N; ++t) e[t] = 0.0f;
    if constexpr (S == kExternal) {
      if (in_range) {
#pragma unroll
        for (int t = 0; t < N; ++t) e[t] = io.noise[((size_t)b * a.k + k) * N + t];
      }
    } else {
      sample<N, Fast, S>(e, k, key, io.word0 + (uint32_t)b, a);
    }
    if (!in_range) continue;
    if (io.noise_out != nullptr) {
#pragma unroll
      for (int t = 0; t < N; ++t) io.noise_out[((size_t)b * a.k + k) * N + t] = e[t];
    }
#pragma unroll
    for (int t = 0; t < N; ++t) v[t] = clampf(un[t] + e[t], a.lo, a.hi);
    }
    const float score = rollout_score<N>(model, cost, a, xb, un, v);
    if (!isfinite(score)) continue;
    float vals[L];
    vals[0] = 1.0f;
#pragma unroll
    for (int t = 0; t < N; ++t) vals[t + 1] = v[t];
    lse_fold<L>(m_t, acc, score, vals, a.inv_lambda);
  }

  // one block_max and one block_sums per 256 R rollouts; at R = 1 these are
  // the bits of exp((score - m_b) f32(1/lambda)) (1, v)
  const float m_b = block_max(m_t, red_max);
  const float scale = m_t > kNoFiniteBelow ? expf((m_t - m_b) * a.inv_lambda) : 0.0f;
#pragma unroll
  for (int i = 0; i <= N; ++i) acc[i] *= scale;
  const float s = block_sums<L>(acc, red_sum);  // sum i in thread i < L (warp 0)

  const int nb = gridDim.x;
  __shared__ float tot[L];
  if constexpr (L > 32) {  // the sums span two warps
    partials_end_wide<N>(model, a, io, nb, m_b, s, xb, red_max, red_sum, tot, pol);
    return;
  }
  if (io.merges() && nb == 1) {  // the problem's only block: no row, no ticket
    if (threadIdx.x < L) tot[threadIdx.x] = s;
    __syncwarp();
    if (threadIdx.x == 0) {
      if constexpr (!kSolve) {
        pol.template finish<N>(m_b, tot, io, b);
      } else {
        finish_solve<N>(model, m_b, tot, xb, io, b);
      }
    }
    return;
  }
  const bool block_merge = io.merges() && nb > kWarpMergeRows;
  if (threadIdx.x >= 32 && !block_merge) return;
  float* rows = io.partials + (size_t)b * nb * (L + 1);
  float* row = rows + (size_t)blockIdx.x * (L + 1);
  if (!io.merges()) {
    if (threadIdx.x == 0) row[0] = m_b;
    if (threadIdx.x < L) row[1 + threadIdx.x] = s;
    return;
  }

  // lane 0 writes the row and announces it: the release of its ticket makes
  // the row visible device-wide first, and the acquire of the block that
  // draws nb - 1 sees every row of the problem
  __shared__ int ticket;
  if (threadIdx.x < 32) {
    float sums[L];
#pragma unroll
    for (int i = 0; i < L; ++i) sums[i] = __shfl_sync(kFullMask, s, i);
    if (threadIdx.x == 0) {
      row[0] = m_b;
#pragma unroll
      for (int i = 0; i < L; ++i) row[1 + i] = sums[i];
      ticket = cuda::atomic_ref<int, cuda::thread_scope_device>(io.tickets[b])
                   .fetch_add(1, cuda::memory_order_acq_rel);
    }
  }
  if (block_merge) {
    __syncthreads();
    if (ticket != nb - 1) return;
    const float m_all = merge_rows_block<N>(rows, nb, a.inv_lambda, red_max, red_sum, tot);
    if (threadIdx.x == 0) {
      if constexpr (!kSolve) {
        pol.template finish<N>(m_all, tot, io, b);
      } else {
        finish_solve<N>(model, m_all, tot, xb, io, b);
      }
      io.tickets[b] = 0;
    }
    return;
  }
  __syncwarp();
  if (ticket != nb - 1) return;
  float wtot[L];
  const float m_all = merge_rows_warp<N>(rows, nb, a.inv_lambda, wtot);
  if (threadIdx.x == 0) {
    if constexpr (!kSolve) {
      pol.template finish<N>(m_all, wtot, io, b);
    } else {
      finish_solve<N>(model, m_all, wtot, xb, io, b);
    }
    io.tickets[b] = 0;
  }
}

// Blocks an SM that the kernel at R = 1 asks ptxas for: 5 at the main
// paths' N = 8 (at most 48 registers a thread). A longer horizon holds
// N nominals, N controls and N + 1 running sums in registers (some 3N + 10
// floats), which 48 registers cannot, so there ptxas takes what it needs
// (71-80 registers at N = 20, 128-167 at N = 40).
template <int N>
constexpr int kMinBlocksR1 = N <= kN ? 5 : 1;

// Blocks an SM that the kernel at R = 4 asks for past N = 8: 2 at N = 20
// (at most 128 registers; left to itself ptxas took 123-128 for six noise
// sources and 80 with 80 bytes of spill for box-muller), 1 at N = 40 (254).
template <int N>
constexpr int kMinBlocksWide = N <= 20 ? 2 : 1;

// The kernel, partials_body at R rollouts a thread. Its definitions differ
// only in their launch bounds. At R = 1 (small grids, where the wrapper's
// rule takes it) they ask for kMinBlocksR1 blocks an SM: at N = 8 5, at most
// 48 registers a thread: left to itself ptxas holds the exact tier to 40 (6
// blocks) and spills around sinf's slow path. At R = 4 and N = 8 ptxas
// takes what it needs (64-80 registers, 3-4 blocks an SM), as a minimum of
// one block an SM would let it take far more; past N = 8, kMinBlocksWide.
template <int N, class Model, class Cost, bool Fast, int S, int R,
          std::enable_if_t<R == 1, int> = 0>
__global__ void __launch_bounds__(kThreads, kMinBlocksR1<N>)
mppi_partials_kernel(Model model, Cost cost, PartialsArgs a, PartialsIO io) {
  partials_body<N, Model, Cost, Fast, S, R>(model, cost, a, io);
}

template <int N, class Model, class Cost, bool Fast, int S, int R,
          std::enable_if_t<(R > 1 && N <= kN), int> = 0>
__global__ void __launch_bounds__(kThreads)
mppi_partials_kernel(Model model, Cost cost, PartialsArgs a, PartialsIO io) {
  partials_body<N, Model, Cost, Fast, S, R>(model, cost, a, io);
}

template <int N, class Model, class Cost, bool Fast, int S, int R,
          std::enable_if_t<(R > 1 && N > kN), int> = 0>
__global__ void __launch_bounds__(kThreads, kMinBlocksWide<N>)
mppi_partials_kernel(Model model, Cost cost, PartialsArgs a, PartialsIO io) {
  partials_body<N, Model, Cost, Fast, S, R>(model, cost, a, io);
}

}  // namespace mpc
