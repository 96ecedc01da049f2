// Device code of the two diagnostic probes, included into mppi_kernels.cu
// (one nvcc, one library; the C entries are there).
//
// D1, the kernel op-mix probe (replaces scripts/diag_kernel_mix.py:283,
// make_chain :36): J warm-started solves of the fast-tier cart-pole with
// shaped4, the state held, with parts of the partials kernel switched off
// or swapped (MixMode). A solve is one launch of kernel_mix_partials_kernel,
// which is the main path's partials_body (mppi_common.cuh) with D1's policy
// (MixSolve): R rollouts a thread, each folded into a running log-sum-exp,
// one block reduction per 256 R rollouts, and the merge inside the launch
// by the problem's ticket, whose last block writes u_n <- sum(uw) * (1/s)
// (s = 0 counts as 1) and u0s[j] = u_n[0]: D1's own finalize
// (diag_kernel_mix.py:255-260), no status ladder and no shift. So the probe
// splits the kernel every solve of the port runs, not a copy of an older
// one. The J launches are issued from a C loop on one stream, which
// ops/diag_cuda.py captures once into a CUDA graph and replays. The TPU
// kernel streamed its blocks through carried (m, s, uw) accumulators on one
// core. D1 scales by f32(1/lambda) (:41,243-244), not by a division, as
// the partials kernel does.
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
  float cltf_mu;       // f32(4 + 510/256), the mean of four [1, 2) floats
  float cltf_inv_sig;  // f32(256/sqrt(4 (256^2 - 1)/12))
  int ramp_block;      // rollouts of a TPU block (bs*128): nosample's offset step
};

// cltf: four bytes of one word as [1, 2) floats by a mantissa bitcast (no
// int-to-float convert), then clt4's cubic (diag_kernel_mix.py:94-114).
__device__ __forceinline__ float cltf(uint32_t w, const PartialsArgs& a, const MixArgs& m) {
  constexpr uint32_t kMant = 0x007F8000u;
  constexpr uint32_t kOne = 0x3F800000u;
  const float f0 = __uint_as_float(((w << 15) & kMant) | kOne);
  const float f1 = __uint_as_float(((w << 7) & kMant) | kOne);
  const float f2 = __uint_as_float(((w >> 1) & kMant) | kOne);
  const float f3 = __uint_as_float(((w >> 9) & kMant) | kOne);
  const float z = ((f0 + f1) + (f2 + f3) - m.cltf_mu) * m.cltf_inv_sig;
  return z * (a.clt_a + a.clt_b * (z * z));
}

// The controls v[0..N-1] of rollout k in solve `solve`: the mode's noise
// on u_n, clamped. Philox key (seed, 0), counter (k, call, solve, 0); word
// w of the rollout is word w % 4 of call w / 4 (ops/diag_cuda.py).
template <int Mode>
__device__ __forceinline__ void mix_controls(float (&v)[kN], const float (&un)[kN], uint32_t k,
                                             uint32_t key, uint32_t solve, const PartialsArgs& a,
                                             const MixArgs& m) {
  if constexpr (Mode == kMixNosample) {
    // the ramp of the TPU block: lane k % 128, block k / (bs*128) (:213-219)
    const float ramp = (float)(int)(k & 127u) * 1e-3f;
    const float off = 1e-4f * (float)(int)(k / (uint32_t)m.ramp_block);
#pragma unroll
    for (int t = 0; t < kN; ++t) v[t] = clampf((un[t] + ramp) + off, a.lo, a.hi);
    return;
  }
  float e[kN];
  if constexpr (Mode == kMixFull || Mode == kMixNoroll) {
    sample<kN, true, kBoxMuller>(e, k, key, solve, a);
  } else if constexpr (Mode == kMixClt) {
    sample<kN, true, kClt4>(e, k, key, solve, a);
  } else if constexpr (Mode == kMixClt2q) {
    sample<kN, true, kClt2q>(e, k, key, solve, a);
  } else if constexpr (Mode == kMixCvtonly) {
    // one word, XORed with a per-step constant to defeat CSE (:151-165)
    uint32_t w[4] = {k, 0u, solve, 0u};
    philox4x32_10(w, key, 0u);
#pragma unroll
    for (int t = 0; t < kN; ++t) e[t] = clt4(w[0] ^ (0x9E3779B9u * (uint32_t)(t + 1)), a.clt_a, a.clt_b);
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
          e[4 * c + i] = cltf(w[i], a, m);
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kN; ++t) v[t] = clampf(un[t] + e[t], a.lo, a.hi);
}

// D1's policy for partials_body (mppi_common.cuh), in place of MppiSolve:
// the mode's controls (mix_controls, drawn by every thread, so clt2q's and
// box-muller's calls see whole warps; partials_body drops rollouts past K
// after it), and D1's end of a solve (diag_kernel_mix.py:255-260):
// u_n <- sum(uw) * (1/s), s = 0 counting as 1, and u0s[j] = u_n[0]; no
// status ladder, no shift.
template <int Mode>
struct MixSolve {
  MixArgs m;

  __device__ __forceinline__ void controls(float (&v)[kN], const float (&un)[kN], uint32_t k,
                                           uint32_t key, uint32_t solve,
                                           const PartialsArgs& a) const {
    mix_controls<Mode>(v, un, k, key, solve, a, m);
  }

  template <int N>
  __device__ __forceinline__ void finish(float, const float* tot, const PartialsIO& io,
                                         int b) const {
    static_assert(N == kN, "D1 runs at N = kN");
    const float inv_s = 1.0f / (tot[0] == 0.0f ? 1.0f : tot[0]);
    float* u = io.u_out + (size_t)b * kN;
#pragma unroll
    for (int t = 0; t < kN; ++t) u[t] = tot[1 + t] * inv_s;
    *io.u0 = u[0];
  }
};

// noroll's "rollout" for rollout_score: the state takes the control
// (x0 = v) and the stage cost is its square, so the score is
// -(sum v*v) - (sum u_n inv v), the bits of c += v*v (diag_kernel_mix.py).
struct NoRollModel {
  __device__ __forceinline__ void step(float& x0, float&, float&, float&, float u) const { x0 = u; }
};

struct SquareOfX0 {
  __device__ __forceinline__ float operator()(float x0, float, float, float) const { return x0 * x0; }
};

// One solve of the chain: partials_body at R rollouts a thread with D1's
// policy, on a grid (ceil(K/(256 R)), 1), the fast-tier cart-pole and
// shaped4 (noroll: NoRollModel and SquareOfX0); the launch bounds of
// mppi_partials_kernel at the same R. (Fast and S select MppiSolve's
// sampler; MixSolve draws the mode's own noise.)
template <int Mode, int R, class Model, class Cost, std::enable_if_t<R == 1, int> = 0>
__global__ void __launch_bounds__(kThreads, 5)
kernel_mix_partials_kernel(Model model, Cost cost, PartialsArgs a, PartialsIO io,
                           MixSolve<Mode> pol) {
  partials_body<kN, Model, Cost, true, kBoxMuller, R>(model, cost, a, io, pol);
}

template <int Mode, int R, class Model, class Cost, std::enable_if_t<(R > 1), int> = 0>
__global__ void __launch_bounds__(kThreads)
kernel_mix_partials_kernel(Model model, Cost cost, PartialsArgs a, PartialsIO io,
                           MixSolve<Mode> pol) {
  partials_body<kN, Model, Cost, true, kBoxMuller, R>(model, cost, a, io, pol);
}

// J solves, one launch each on one stream: solve j's merging block writes
// u_n in place (the verbatim warm start of solve j+1; every block of
// solve j+1 reads it after the launch of solve j ends) and u0s[j], and
// resets the ticket. The key is read from device memory (seed[0]), so a
// CUDA graph of the J launches serves every seed.
template <int Mode, int R>
int launch_kernel_mix(const CartPoleNonlinearT<true>& model, const PartialsArgs& a,
                      const MixArgs& m, const float* x, float* u_n, const int* seed, int n_solves,
                      float* partials, int* tickets, float* u0s, cudaStream_t stream) {
  const dim3 grid((a.k + kThreads * R - 1) / (kThreads * R), 1);
  for (int j = 0; j < n_solves; ++j) {
    const PartialsIO io{x, u_n, nullptr, seed, 0u, (uint32_t)j, partials, nullptr,
                        u_n, nullptr, tickets, u0s + j, nullptr};
    if constexpr (Mode == kMixNoroll) {
      kernel_mix_partials_kernel<Mode, R><<<grid, kThreads, 0, stream>>>(NoRollModel{}, SquareOfX0{}, a, io,
                                                                         MixSolve<Mode>{m});
    } else {
      kernel_mix_partials_kernel<Mode, R><<<grid, kThreads, 0, stream>>>(model, Shaped4{}, a, io,
                                                                         MixSolve<Mode>{m});
    }
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
