// Fast float32 transcendentals of the fast tier, as __device__ functions.
//
// Replaces mpc_rs_tpu/ops/fastmath.py (fsin, fcos, fsincos, flog, frsqrt,
// fsqrt, freciprocal, fdiv), which the Pallas kernels inline when fast=True.
// The same polynomials, constants and operation order as the JAX package;
// the plain PyTorch versions are mpc_rs_tpu_torch/ops/fastmath.py. The
// constants are hex literals of the float32 values np.float32 gives the JAX
// package's Python constants, so no decimal rounding can differ.
//
// Traps the port keeps: jnp.round rounds half to even, so the reduction uses
// rintf (not roundf); flog bit-casts with __float_as_int; the clamps
// propagate NaN as jnp.clip / jnp.maximum do. Inside the kernel freciprocal
// and fdiv use the hardware approximate reciprocal rcp.approx.f32 (at most
// 1 ulp on sm_90; the TPU's measured 1.6e-5); everything else is built
// without --use_fast_math and with -fmad=false (ops/build.py).

#pragma once

#include <cuda_runtime.h>

namespace mpc {
namespace fm {

constexpr float kInvTwoPi = 0x1.45f306p-3f;  // f32(1/(2π))
constexpr float kTwoPiHi = 6.28125f;
constexpr float kTwoPiLo = 0x1.fb5444p-10f;  // f32(2π − 6.28125)
constexpr float kPi = 0x1.921fb6p+1f;
constexpr float kHalfPi = 0x1.921fb6p+0f;
constexpr float kS3 = -0x1.555556p-3f;  // −1/6
constexpr float kS5 = 0x1.111112p-7f;   // 1/120
constexpr float kS7 = -0x1.a01a02p-13f;  // −1/5040
constexpr float kS9 = 0x1.71de3ap-19f;  // 1/362880
constexpr float kSqrt2 = 0x1.6a09e6p+0f;
constexpr float kLog2 = 0x1.62e43p-1f;
constexpr float kTiny = 0x1.b38fb8p-127f;  // f32(1e-38)
// cephes logf minimax polynomial (fastmath.py:96-100)
constexpr float kL0 = 0x1.555554p-2f, kL1 = -0x1.fffff8p-3f, kL2 = 0x1.999d58p-3f,
                kL3 = -0x1.555ca0p-3f, kL4 = 0x1.23d37ep-3f, kL5 = -0x1.fcba9ep-4f,
                kL6 = 0x1.de4a34p-4f, kL7 = -0x1.d7a370p-4f, kL8 = 0x1.204376p-4f;

// x − 2π·round(x/2π), clamped to [−π, π] (NaN passes through).
__device__ __forceinline__ float reduce_pi(float x) {
  const float k = rintf(x * kInvTwoPi);
  const float r = (x - k * kTwoPiHi) - k * kTwoPiLo;
  return r < -kPi ? -kPi : (r > kPi ? kPi : r);
}

__device__ __forceinline__ float sin_folded(float r) {
  r = r > kHalfPi ? kPi - r : (r < -kHalfPi ? -kPi - r : r);
  const float r2 = r * r;
  return r + r * r2 * (kS3 + r2 * (kS5 + r2 * (kS7 + r2 * kS9)));
}

__device__ __forceinline__ float fsin(float x) { return sin_folded(reduce_pi(x)); }

__device__ __forceinline__ float fcos(float x) { return sin_folded(reduce_pi(x + kHalfPi)); }

__device__ __forceinline__ float flog(float x) {
  const int xi = __float_as_int(x);
  const int e = ((xi >> 23) & 0xFF) - 127;
  float m = __int_as_float((xi & 0x007FFFFF) | 0x3F800000);
  const bool big = m > kSqrt2;
  m = big ? m * 0.5f : m;
  const float ef = (float)(e + (big ? 1 : 0));
  const float t = m - 1.0f;
  const float z = t * t;
  const float p =
      kL0 + t * (kL1 + t * (kL2 + t * (kL3 + t * (kL4 + t * (kL5 + t * (kL6 + t * (kL7 + t * kL8)))))));
  const float y = t - 0.5f * z + t * z * p;
  return y + ef * kLog2;
}

// rsqrtf is the hardware approximation (as jax.lax.rsqrt is on the TPU),
// refined by one Newton step.
__device__ __forceinline__ float frsqrt(float x) {
  const float y = rsqrtf(x);
  return y * (1.5f - 0.5f * x * y * y);
}

__device__ __forceinline__ float fsqrt(float x) { return x * frsqrt(x < kTiny ? kTiny : x); }

__device__ __forceinline__ float freciprocal(float x) {
  float r;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float fdiv(float num, float den) { return num * freciprocal(den); }

}  // namespace fm

// (sin, cos) of the tier: the accurate sinf/cosf, or the polynomials.
template <bool Fast>
__device__ __forceinline__ void sincos_tier(float x, float& s, float& c) {
  if constexpr (Fast) {
    s = fm::fsin(x);
    c = fm::fcos(x);
  } else {
    s = sinf(x);
    c = cosf(x);
  }
}

}  // namespace mpc
