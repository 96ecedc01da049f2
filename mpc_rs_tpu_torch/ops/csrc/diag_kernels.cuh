// Device code of the two diagnostic probes, included into mppi_kernels.cu
// (one nvcc, one library; the C entries are there).
//
// D1, the kernel op-mix probe (replaces scripts/diag_kernel_mix.py:283,
// make_chain :36): J warm-started solves of the fast-tier cart-pole with
// shaped4, the state held, with parts of the partials kernel switched off
// or swapped (MixMode). Each solve is kernel_mix_partials_kernel on a grid
// (ceil(K/256)), one thread per rollout, writing (nb, N+2) log-sum-exp rows
// as mppi_partials_kernel does, then kernel_mix_finalize_kernel (one block):
// u_n <- sum(uw) * (1/s) (s = 0 counts as 1), u0s[j] = u_n[0]; no status
// ladder and no shift (diag_kernel_mix.py:255-260). The J pairs are issued
// from a C loop on one stream. The TPU kernel streamed its blocks through
// carried (m, s, uw) accumulators on one core; here the blocks run in
// parallel and the finalize merges their rows. D1 scales by f32(1/lambda)
// (:41,243-244), not by a division, and so do these kernels.
//
// What bounds D1 on the card: the FP32 issue rate and, in box-muller, the
// transcendentals, as for mppi_partials_kernel; the probe exists to split a
// launch's time between sampling (Philox and the transform), the rollout
// (fast-tier dynamics and cost) and the log-sum-exp. Device memory sees the
// state, u_n and the partials rows only.
//
// D2, the mul-add probe (replaces scripts/diag_bf16_vpu.py:38, make_chain
// :25): a launch of `steps` CTAs; each loads the (rows, 128) tile x, sets
// b = x/2, runs `inner` dependent updates x = x*a + b and stores the tile
// into o. Every CTA stores the same values, so the compiler cannot drop the
// work. float calls __fmaf_rn (one rounding, which the -fmad=false build
// would not otherwise contract to); __nv_bfloat162 (bf16 pairs, the packed
// form) rounds after each op, __hmul2 then __hadd2, two instructions per
// update. Each thread owns E independent elements (pairs), so E chains hide
// the FMA latency. Bound: the FMA pipes (the bytes are two tiles per CTA,
// from L2).

#pragma once

#include <cuda_bf16.h>

#include "mppi_common.cuh"

namespace mpc {

// The kernel's modes. The probe's eleven names map onto these
// (ops/diag_cuda.py): cltone, cltbig and cltreg compute clt's values from
// clt's words, because their TPU distinctions (the shape of the PRNG call,
// a VMEM noise buffer or registers) do not exist here.
enum MixMode : int {
  kMixFull = 0, kMixNosample = 1, kMixNoroll = 2, kMixBitsonly = 3, kMixClt = 4, kMixCltf = 5,
  kMixCvtonly = 6, kMixClt2q = 7
};

struct MixArgs {
  PartialsArgs p;      // K, inv, lo, hi, sigma and the sampler constants (p.inv_lambda unused)
  float inv_lambda;    // f32(1/lambda)
  float cltf_mu;       // f32(4 + 510/256), the mean of four [1, 2) floats
  float cltf_inv_sig;  // f32(256/sqrt(4 (256^2 - 1)/12))
  int ramp_block;      // rollouts of a TPU block (bs*128): nosample's offset step
};

// cltf: four bytes of one word as [1, 2) floats by a mantissa bitcast (no
// int-to-float convert), then clt4's cubic (diag_kernel_mix.py:94-114).
__device__ __forceinline__ float cltf(uint32_t w, const MixArgs& a) {
  constexpr uint32_t kMant = 0x007F8000u;
  constexpr uint32_t kOne = 0x3F800000u;
  const float f0 = __uint_as_float(((w << 15) & kMant) | kOne);
  const float f1 = __uint_as_float(((w << 7) & kMant) | kOne);
  const float f2 = __uint_as_float(((w >> 1) & kMant) | kOne);
  const float f3 = __uint_as_float(((w >> 9) & kMant) | kOne);
  const float z = ((f0 + f1) + (f2 + f3) - a.cltf_mu) * a.cltf_inv_sig;
  return z * (a.p.clt_a + a.p.clt_b * (z * z));
}

// The controls v[0..N-1] of rollout k in solve `solve`: the mode's noise
// on u_n, clamped. Philox key (seed, 0), counter (k, call, solve, 0); word
// w of the rollout is word w % 4 of call w / 4 (ops/diag_cuda.py).
template <int Mode>
__device__ __forceinline__ void mix_controls(float (&v)[kN], const float (&un)[kN], uint32_t k,
                                             uint32_t key, uint32_t solve, const MixArgs& a) {
  if constexpr (Mode == kMixNosample) {
    // the ramp of the TPU block: lane k % 128, block k / (bs*128) (:213-219)
    const float ramp = (float)(int)(k & 127u) * 1e-3f;
    const float off = 1e-4f * (float)(int)(k / (uint32_t)a.ramp_block);
#pragma unroll
    for (int t = 0; t < kN; ++t) v[t] = clampf((un[t] + ramp) + off, a.p.lo, a.p.hi);
    return;
  }
  float e[kN];
  if constexpr (Mode == kMixFull || Mode == kMixNoroll) {
    sample<kN, true, kBoxMuller>(e, k, key, solve, a.p);
  } else if constexpr (Mode == kMixClt) {
    sample<kN, true, kClt4>(e, k, key, solve, a.p);
  } else if constexpr (Mode == kMixClt2q) {
    sample<kN, true, kClt2q>(e, k, key, solve, a.p);
  } else if constexpr (Mode == kMixCvtonly) {
    // one word, XORed with a per-step constant to defeat CSE (:151-165)
    uint32_t w[4] = {k, 0u, solve, 0u};
    philox4x32_10(w, key, 0u);
#pragma unroll
    for (int t = 0; t < kN; ++t) e[t] = clt4(w[0] ^ (0x9E3779B9u * (uint32_t)(t + 1)), a.p.clt_a, a.p.clt_b);
  } else {  // bitsonly, cltf: one word per step, word t of the rollout
#pragma unroll
    for (int c = 0; c < kN / 4; ++c) {
      uint32_t w[4] = {k, (uint32_t)c, solve, 0u};
      philox4x32_10(w, key, 0u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (Mode == kMixBitsonly) {
          e[4 * c + i] = (float)(int)(w[i] >> 9) * 1e-7f;  // (:57-63)
        } else {
          e[4 * c + i] = cltf(w[i], a);
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kN; ++t) v[t] = clampf(un[t] + e[t], a.p.lo, a.p.hi);
}

// One block of rollouts of one solve: controls, rollout (or noroll's
// c += v*v), score, and the block's row (m_b, s_b, uw_b[0..N-1]) of the
// partials. Rollouts k >= K count as non-finite.
template <int Mode>
__global__ void __launch_bounds__(kThreads)
kernel_mix_partials_kernel(CartPoleNonlinearT<true> model, MixArgs a, const float* __restrict__ x,
                           const float* __restrict__ u_n, uint32_t key, uint32_t solve,
                           float* __restrict__ partials) {
  __shared__ float red_max[kWarps];
  __shared__ float red_sum[kWarps][kN + 1];

  const int k = blockIdx.x * kThreads + threadIdx.x;
  float un[kN], v[kN];
#pragma unroll
  for (int t = 0; t < kN; ++t) un[t] = u_n[t];

  float score = 0.0f;
  bool finite = false;
  if (k < a.p.k) {
    mix_controls<Mode>(v, un, (uint32_t)k, key, solve, a);
    float c_acc = 0.0f, ct = 0.0f;
    if constexpr (Mode == kMixNoroll) {
#pragma unroll
      for (int t = 0; t < kN; ++t) {
        c_acc = c_acc + v[t] * v[t];
        ct = ct + un[t] * a.p.inv * v[t];
      }
    } else {
      float x0 = x[0], x1 = x[1], x2 = x[2], x3 = x[3];
#pragma unroll
      for (int t = 0; t < kN; ++t) {
        model.step(x0, x1, x2, x3, v[t]);
        c_acc = c_acc + Shaped4{}(x0, x1, x2, x3);
        ct = ct + un[t] * a.p.inv * v[t];
      }
    }
    score = -c_acc - ct;
    finite = isfinite(score);
  } else {
#pragma unroll
    for (int t = 0; t < kN; ++t) v[t] = 0.0f;
  }

  const float m_b = block_max(finite ? score : kNegBig, red_max);
  const float ew = finite ? expf((score - m_b) * a.inv_lambda) : 0.0f;
  float acc[kN + 1];
  acc[0] = ew;
#pragma unroll
  for (int t = 0; t < kN; ++t) acc[t + 1] = ew * v[t];
  const float s = block_sums<kN + 1>(acc, red_sum);

  float* row = partials + (size_t)blockIdx.x * (kN + 2);
  if (threadIdx.x == 0) row[0] = m_b;
  if (threadIdx.x < kN + 1) row[1 + threadIdx.x] = s;
}

// One block: merge the nb rows by log-sum-exp, write u_n (read by the next
// solve's partials launch, stream-ordered) and u0.
__global__ void __launch_bounds__(kThreads)
kernel_mix_finalize_kernel(float inv_lambda, int nb, const float* __restrict__ partials,
                           float* __restrict__ u_n, float* __restrict__ u0) {
  __shared__ float red_max[kWarps];
  __shared__ float red_sum[kWarps][kN + 1];

  float m = kNegBig;
  for (int b = threadIdx.x; b < nb; b += kThreads) m = fmaxf(m, partials[(size_t)b * (kN + 2)]);
  const float m_all = block_max(m, red_max);

  float acc[kN + 1];
#pragma unroll
  for (int i = 0; i <= kN; ++i) acc[i] = 0.0f;
  for (int b = threadIdx.x; b < nb; b += kThreads) {
    const float* row = partials + (size_t)b * (kN + 2);
    const float scale = row[0] > kNoFiniteBelow ? expf((row[0] - m_all) * inv_lambda) : 0.0f;
#pragma unroll
    for (int i = 0; i <= kN; ++i) acc[i] += row[1 + i] * scale;
  }
  const float tot = block_sums<kN + 1>(acc, red_sum);

  __shared__ float tot_s[kN + 1];
  if (threadIdx.x < kN + 1) tot_s[threadIdx.x] = tot;
  __syncthreads();
  if (threadIdx.x != 0) return;
  const float inv_s = 1.0f / (tot_s[0] == 0.0f ? 1.0f : tot_s[0]);
#pragma unroll
  for (int t = 0; t < kN; ++t) u_n[t] = tot_s[1 + t] * inv_s;
  *u0 = u_n[0];
}

template <int Mode>
int launch_kernel_mix(const CartPoleNonlinearT<true>& model, const MixArgs& a, const float* x,
                      float* u_n, uint32_t seed, int n_solves, float* partials, float* u0s,
                      cudaStream_t stream) {
  const int nb = (a.p.k + kThreads - 1) / kThreads;
  for (int j = 0; j < n_solves; ++j) {
    kernel_mix_partials_kernel<Mode><<<nb, kThreads, 0, stream>>>(model, a, x, u_n, seed, (uint32_t)j,
                                                                  partials);
    kernel_mix_finalize_kernel<<<1, kThreads, 0, stream>>>(a.inv_lambda, nb, partials, u_n, u0s + j);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  return 0;
}

template <class T>
struct FmaOps;

template <>
struct FmaOps<float> {
  static __device__ __forceinline__ float from_float(float a) { return a; }
  static __device__ __forceinline__ float half(float x) { return x * 0.5f; }
  static __device__ __forceinline__ float update(float x, float a, float b) {
    return __fmaf_rn(x, a, b);
  }
};

template <>
struct FmaOps<__nv_bfloat162> {
  static __device__ __forceinline__ __nv_bfloat162 from_float(float a) {
    return __float2bfloat162_rn(a);
  }
  static __device__ __forceinline__ __nv_bfloat162 half(__nv_bfloat162 x) {
    return __hmul2(x, __float2bfloat162_rn(0.5f));
  }
  static __device__ __forceinline__ __nv_bfloat162 update(__nv_bfloat162 x, __nv_bfloat162 a,
                                                          __nv_bfloat162 b) {
    return __hadd2(__hmul2(x, a), b);
  }
};

// Thread i owns the tile's elements i + 256 e, e < E (coalesced loads).
template <class T, int E>
__global__ void __launch_bounds__(kThreads)
fma_chain_kernel(const T* __restrict__ x, T* __restrict__ o, float a_f32, int inner) {
  const T a = FmaOps<T>::from_float(a_f32);
  T v[E], b[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    v[e] = x[threadIdx.x + e * kThreads];
    b[e] = FmaOps<T>::half(v[e]);
  }
  for (int i = 0; i < inner; ++i) {
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = FmaOps<T>::update(v[e], a, b[e]);
  }
#pragma unroll
  for (int e = 0; e < E; ++e) o[threadIdx.x + e * kThreads] = v[e];
}

// `count` values of T per tile: 16 or 32 per thread (f32 rows 32/64, bf16
// rows 64/128); -3 for another tile.
template <class T>
int launch_fma_chain(int count, int inner, int steps, float a, const void* x, void* o,
                     cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(o);
  if (count % kThreads != 0) return -3;
  switch (count / kThreads) {
    case 16: fma_chain_kernel<T, 16><<<steps, kThreads, 0, stream>>>(xt, ot, a, inner); break;
    case 32: fma_chain_kernel<T, 32><<<steps, kThreads, 0, stream>>>(xt, ot, a, inner); break;
    default: return -3;
  }
  return (int)cudaGetLastError();
}

}  // namespace mpc
