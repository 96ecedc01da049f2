// The fused plant -> sensor -> UKF estimator chain of the scenario fleets
// (K7), one thread per scenario. Included by mppi_kernels.cu, so the build
// stays one nvcc over one translation unit.
//
// Replaces mpc_rs_tpu/ops/estimator_pallas.py::make_estimator_chain (the
// pallas_call at :211), which traces estimators/ukf_soa.py's soa_predict,
// soa_update(unroll_sum=True) and soa_guard(mode="entry") on (bs, 128)
// tiles. For each scenario and each of NSUB substeps, with u0 held (gated
// to 0 before control_start):
//   1. one plant step with the force f = pulse(t + i·dt_sub), or 0;
//   2. the sensor z_j = hx(x)_j + sig_j · noise[i·O + j, b];
//   3. the UKF predict (Jacobi sigma root, cancellation-free unscented
//      transform with the mean's pair sums added one after another) and
//      update (equilibrated Cholesky gain with one refinement step,
//      symmetrised covariance);
//   4. the guard: a non-finite estimate entry becomes 0, and a filter with
//      any non-finite entry gets P = p_reset.
// The plain PyTorch version is ops/estimator_cuda.py::estimator_chain_plain;
// every sum here runs in its order (mpc_rs_tpu_torch/estimators/ukf_soa.py,
// the JAX package's): the k-sums over sigma points sequential in k, the sums
// over observation components in the order of Python's sum, P written for
// i <= j and mirrored. The Jacobi rotation is smallalg.jacobi_entries':
// the same (p, q) order and 4 sweeps, small = |apq| < 1e-30, and
// t = sign(θ)/(|θ| + sqrt(θ² + 1)) with sign(0) = 0 (copysignf would give
// ±1 there), rows, then columns, then V.
//
// What bounds it on the card: neither bytes (a scenario reads about 0.25 KB
// and writes 0.2 KB) nor the FP32 rate. Each thread runs one dependent
// chain of some 10^4 scalar operations per substep with its state, P, the
// sigma points and the gain held in registers (ptxas spills the rest to
// local memory, which stays in L1); at B = 1 024 and 64 threads a block the
// launch fills 16 of the 132 SMs, two warps each, so the time is the chain's
// latency. The design trades speed for a simple, exact port: one launch per
// tick in place of thousands of torch launches.
//
// Built without fast math and with -fmad=false (ops/build.py): sinf/cosf,
// sqrtf and '/' are the accurate forms, and isfinite keeps its meaning.

#pragma once

#include "mppi_common.cuh"

namespace mpc {

constexpr int kChainThreads = 64;
constexpr float kEps = 1e-30f;  // the equilibrated solve's clamps (ukf_soa.py:212)

// max(x, lo) that propagates NaN, as torch.maximum / jnp.maximum
__device__ __forceinline__ float max_nan(float x, float lo) { return x < lo ? lo : x; }

// The filter's constants, folded on the host (ops/estimator_cuda.py).
template <int N, int O>
struct ChainConsts {
  float hc;             // 0.5 · c: the sigma scaling of the symmetrised P
  float wm1, wc1;       // Merwe weights of the non-centre points
  float sum_wc;         // 1 + (wc0 − wm0) = Σ wc, cancellation-free
  float dt_sub;         // the substep, for the pulse's clock t + i·dt_sub
  float control_start;  // u0 is 0 while t < control_start (no gating at 0)
  float pulse_t0, pulse_t1, pulse_f;  // f = pulse_f on (t0, t1), else 0
  int has_pulse;        // 0: f = 0
  int has_guard;        // 0: no p_reset
  float q[N][N];        // additive process noise
  float r[O][O];        // additive measurement noise
  float sig[O];         // sensor noise standard deviations
  float p_reset[N][N];  // the guard's covariance
};

// cartpole4: make_cartpole_nonlinear at the substep dt is both the plant
// and the UKF process model; the plant takes no force.
struct CartPole4Plant {
  static constexpr int kS = 4;
  CartPoleNonlinearT<false> m;

  __device__ __forceinline__ void fx(float (&x)[4], float u) const {
    m.step(x[0], x[1], x[2], x[3], u);
  }
  __device__ __forceinline__ void plant(float (&x)[4], float u, float) const { fx(x, u); }
};

// flagship6: make_flagship6 (dynamics.py:197-213) at dt, the sequential
// cascade on the new values. The plant carries the force terms; the UKF
// process model is the f ≡ 0 trace, as make_flagship6(..., 0.0).
struct Flagship6Plant {
  static constexpr int kS = 6;
  Flagship4Consts k;  // k.dt is the model dt
  float mll_j2;       // m2·l² + j2

  template <bool WithForce>
  __device__ __forceinline__ void step(float (&x)[6], float u, float f) const {
    float ddx, ddth;
    flagship_ddot_exact<WithForce>(k, mll_j2, x[3], x[4], u, f, ddx, ddth);
    const float n5 = ddth;
    const float n4 = x[4] + n5 * k.dt;
    const float n3 = x[3] + n4 * k.dt;
    const float n2 = ddx;
    const float n1 = x[1] + n2 * k.dt;
    const float n0 = x[0] + n1 * k.dt;
    x[0] = n0;
    x[1] = n1;
    x[2] = n2;
    x[3] = n3;
    x[4] = n4;
    x[5] = n5;
  }
  __device__ __forceinline__ void fx(float (&x)[6], float u) const { step<false>(x, u, 0.0f); }
  __device__ __forceinline__ void plant(float (&x)[6], float u, float f) const {
    step<true>(x, u, f);
  }
};

// make_hx_rpm_gyro4 (observation.py:19-33): [k·dx, k·dx, dθ·180/π].
struct HxRpmGyro4 {
  static constexpr int kO = 3;
  float k;        // 60 / (2π r_w)
  float rad2deg;  // 180 / π

  __device__ __forceinline__ void operator()(const float (&x)[4], float (&z)[3]) const {
    const float rpm = k * x[1];
    z[0] = rpm;
    z[1] = rpm;
    z[2] = x[3] * rad2deg;
  }
};

// make_hx_imu6 (observation.py:46-64): [k·dx, −k·dx, dθ·180/π, az/g, ax/g],
// ax = g sinθ + ẍ cosθ + l θ̈, az = g cosθ − ẍ sinθ + l θ̇².
struct HxImu6 {
  static constexpr int kO = 5;
  float k;        // gear · 60 / (2π r_w)
  float neg_k;    // −k
  float rad2deg;  // 180 / π
  float g, l;

  __device__ __forceinline__ void operator()(const float (&x)[6], float (&z)[5]) const {
    const float s = sinf(x[3]), c = cosf(x[3]);
    const float ax = g * s + x[2] * c + l * x[5];
    const float az = g * c - x[2] * s + l * x[4] * x[4];
    z[0] = k * x[1];
    z[1] = neg_k * x[1];
    z[2] = x[4] * rad2deg;
    z[3] = az / g;
    z[4] = ax / g;
  }
};

// Cyclic Jacobi on the symmetric a (smallalg.jacobi_entries): on return the
// diagonal of a holds the eigenvalues and the columns of v the eigenvectors.
template <int N>
__device__ __forceinline__ void jacobi(float (&a)[N][N], float (&v)[N][N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) v[i][j] = i == j ? 1.0f : 0.0f;
  }
#pragma unroll
  for (int sweep = 0; sweep < 4; ++sweep) {
#pragma unroll
    for (int p = 0; p < N - 1; ++p) {
#pragma unroll
      for (int q = p + 1; q < N; ++q) {
        const float app = a[p][p], aqq = a[q][q], apq = a[p][q];
        const bool small = fabsf(apq) < 1e-30f;
        const float theta = (aqq - app) / (small ? 1.0f : 2.0f * apq);
        const float sgn = theta > 0.0f ? 1.0f : (theta < 0.0f ? -1.0f : 0.0f);
        float t = sgn / (fabsf(theta) + sqrtf(theta * theta + 1.0f));
        t = small ? 0.0f : t;
        const float c = 1.0f / sqrtf(t * t + 1.0f);
        const float s = t * c;
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float rp = a[p][j], rq = a[q][j];
          a[p][j] = c * rp - s * rq;
          a[q][j] = s * rp + c * rq;
        }
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float cp = a[i][p], cq = a[i][q];
          a[i][p] = c * cp - s * cq;
          a[i][q] = s * cp + c * cq;
        }
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float vp = v[i][p], vq = v[i][q];
          v[i][p] = c * vp - s * vq;
          v[i][q] = s * vp + c * vq;
        }
      }
    }
  }
}

// The unscented transform (ukf_soa.py::_ut) of the 2N+1 sigma values fm
// (D components each) plus the additive cov: the mean, the shift pieces
// e = mean − fm[0] and sd = wc1 Σ_k d_k (d_k = fm[k+1] − fm[0]), and P.
template <int N, int D, int O>
__device__ __forceinline__ void unscented(const ChainConsts<N, O>& k,
                                          const float (&fm)[2 * N + 1][D],
                                          const float (&cov)[D][D], float (&mean)[D],
                                          float (&e)[D], float (&sd)[D], float (&pm)[D][D]) {
#pragma unroll
  for (int j = 0; j < D; ++j) {
    float acc = (fm[1][j] - fm[0][j]) + (fm[1 + N][j] - fm[0][j]);
#pragma unroll
    for (int i = 1; i < N; ++i) acc = acc + ((fm[1 + i][j] - fm[0][j]) + (fm[1 + N + i][j] - fm[0][j]));
    mean[j] = fm[0][j] + k.wm1 * acc;
    e[j] = mean[j] - fm[0][j];
    float s = fm[1][j] - fm[0][j];
#pragma unroll
    for (int kk = 1; kk < 2 * N; ++kk) s = s + (fm[kk + 1][j] - fm[0][j]);
    sd[j] = k.wc1 * s;
  }
#pragma unroll
  for (int a = 0; a < D; ++a) {
#pragma unroll
    for (int b = 0; b < D; ++b) {
      float core = (fm[1][a] - fm[0][a]) * (fm[1][b] - fm[0][b]);
#pragma unroll
      for (int kk = 1; kk < 2 * N; ++kk) core = core + (fm[kk + 1][a] - fm[0][a]) * (fm[kk + 1][b] - fm[0][b]);
      core = k.wc1 * core;
      pm[a][b] = core - sd[a] * e[b] - e[a] * sd[b] + k.sum_wc * (e[a] * e[b]) + cov[a][b];
    }
  }
}

// Forward L y = b, then back Lᵀ z = y (ukf_soa.py:226-240).
template <int O>
__device__ __forceinline__ void tri_solve(const float (&l)[O][O], const float (&b)[O],
                                          float (&z)[O]) {
  float y[O];
#pragma unroll
  for (int i = 0; i < O; ++i) {
    float acc = b[i];
#pragma unroll
    for (int kk = 0; kk < i; ++kk) acc = acc - l[i][kk] * y[kk];
    y[i] = acc / l[i][i];
  }
#pragma unroll
  for (int i = O - 1; i >= 0; --i) {
    float acc = y[i];
#pragma unroll
    for (int kk = i + 1; kk < O; ++kk) acc = acc - l[kk][i] * z[kk];
    z[i] = acc / l[i][i];
  }
}

// One UKF predict and update of one scenario (soa_predict, soa_update).
template <int N, int O, class Plant, class Hx>
__device__ __forceinline__ void ukf_predict_update(const Plant& plant, const Hx& hx,
                                                   const ChainConsts<N, O>& k, float u,
                                                   const float (&z)[O], float (&ex)[N],
                                                   float (&p)[N][N]) {
  constexpr int M = 2 * N + 1;
  // sigma points x, x ± L_i, L_i = eigenvector_i · sqrt(max(λ_i, 0)), through fx
  float fm[M][N];
  {
    float a[N][N], v[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) a[i][j] = k.hc * (p[i][j] + p[j][i]);
    }
    jacobi<N>(a, v);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float sq = sqrtf(a[i][i] < 0.0f ? 0.0f : a[i][i]);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float delta = v[j][i] * sq;
        fm[1 + i][j] = ex[j] + delta;
        fm[1 + N + i][j] = ex[j] - delta;
      }
    }
#pragma unroll
    for (int j = 0; j < N; ++j) fm[0][j] = ex[j];
#pragma unroll
    for (int m = 0; m < M; ++m) plant.fx(fm[m], u);
  }
  float e[N], sd[N];
  unscented<N, N, O>(k, fm, k.q, ex, e, sd, p);  // ex, p: the prediction

  // update: the UT of hx(sigma_f), the cross-covariance in the shifted form
  float hm[M][O];
#pragma unroll
  for (int m = 0; m < M; ++m) hx(fm[m], hm[m]);
  float zp[O], eh[O], sdh[O], pz[O][O];
  unscented<N, O, O>(k, hm, k.r, zp, eh, sdh, pz);
  float gain[N][O];
  {
    float pxz[N][O];
    float sdf[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float s = fm[1][i] - fm[0][i];
#pragma unroll
      for (int kk = 1; kk < 2 * N; ++kk) s = s + (fm[kk + 1][i] - fm[0][i]);
      sdf[i] = k.wc1 * s;
    }
#pragma unroll
    for (int a = 0; a < N; ++a) {
      const float ef = ex[a] - fm[0][a];
#pragma unroll
      for (int b = 0; b < O; ++b) {
        float acc = (fm[1][a] - fm[0][a]) * (hm[1][b] - hm[0][b]);
#pragma unroll
        for (int kk = 1; kk < 2 * N; ++kk) acc = acc + (fm[kk + 1][a] - fm[0][a]) * (hm[kk + 1][b] - hm[0][b]);
        pxz[a][b] = k.wc1 * acc - sdf[a] * eh[b] - ef * sdh[b] + k.sum_wc * (ef * eh[b]);
      }
    }
    // K = Pxz Pz⁻¹: Pz Kᵀ = Pxzᵀ by the equilibrated Cholesky solve
    // (ukf_soa.py:204-255), D = diag(Pz)^½, one refinement step
    float dinv[O], aeq[O][O], l[O][O];
#pragma unroll
    for (int i = 0; i < O; ++i) dinv[i] = 1.0f / sqrtf(max_nan(pz[i][i], kEps));
#pragma unroll
    for (int i = 0; i < O; ++i) {
#pragma unroll
      for (int j = 0; j < O; ++j) aeq[i][j] = pz[i][j] * dinv[i] * dinv[j];
    }
#pragma unroll
    for (int i = 0; i < O; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        float acc = aeq[i][j];
#pragma unroll
        for (int kk = 0; kk < j; ++kk) acc = acc - l[i][kk] * l[j][kk];
        l[i][j] = i == j ? sqrtf(max_nan(acc, kEps)) : acc / l[j][j];
      }
    }
#pragma unroll
    for (int r = 0; r < N; ++r) {
      float b[O], zz[O], resid[O], dz[O];
#pragma unroll
      for (int i = 0; i < O; ++i) b[i] = pxz[r][i] * dinv[i];
      tri_solve<O>(l, b, zz);
#pragma unroll
      for (int i = 0; i < O; ++i) {
        float acc = aeq[i][0] * zz[0];
#pragma unroll
        for (int kk = 1; kk < O; ++kk) acc = acc + aeq[i][kk] * zz[kk];
        resid[i] = b[i] - acc;
      }
      tri_solve<O>(l, resid, dz);
#pragma unroll
      for (int i = 0; i < O; ++i) gain[r][i] = (zz[i] + dz[i]) * dinv[i];
    }
  }
  // x += K (z − ẑ); P ← sym(P) − K Pz Kᵀ, written for i <= j and mirrored
  float innov[O];
#pragma unroll
  for (int j = 0; j < O; ++j) innov[j] = z[j] - zp[j];
  float kpz[N][O];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float dx = gain[i][0] * innov[0];
#pragma unroll
    for (int kk = 1; kk < O; ++kk) dx = dx + gain[i][kk] * innov[kk];
    ex[i] = ex[i] + dx;
#pragma unroll
    for (int j = 0; j < O; ++j) {
      float acc = gain[i][0] * pz[0][j];
#pragma unroll
      for (int kk = 1; kk < O; ++kk) acc = acc + gain[i][kk] * pz[kk][j];
      kpz[i][j] = acc;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = i; j < N; ++j) {
      float dec = kpz[i][0] * gain[j][0];
#pragma unroll
      for (int kk = 1; kk < O; ++kk) dec = dec + kpz[i][kk] * gain[j][kk];
      const float val = 0.5f * (p[i][j] + p[j][i]) - dec;
      p[i][j] = val;
      p[j][i] = val;
    }
  }
}

// Grid (ceil(B / 64)), one thread per scenario b, any B (the tail threads
// leave). Reads the carry's tensors where they lie: x (B, S), the estimate
// ex (B, N), P packed batch-minor (N², B), u0 at u0[b · u_stride] (a column
// of the (B, horizon) nominals), t (B), the standard normals of the sensor
// (NSUB·O, B); writes x', ex' and P' in the same layouts.
template <int N, int O, int NSUB, class Plant, class Hx>
__global__ void __launch_bounds__(kChainThreads)
estimator_chain_kernel(Plant plant, Hx hx, ChainConsts<N, O> k, int n_scen,
                       const float* __restrict__ x_in, const float* __restrict__ ex_in,
                       const float* __restrict__ p_in, const float* __restrict__ u0,
                       int u_stride, const float* __restrict__ t_in,
                       const float* __restrict__ noise, float* __restrict__ x_out,
                       float* __restrict__ ex_out, float* __restrict__ p_out) {
  constexpr int S = Plant::kS;
  static_assert(S == N, "the fleets' UKF estimates the plant's own state");
  const int b = blockIdx.x * kChainThreads + threadIdx.x;
  if (b >= n_scen) return;
  float x[S], ex[N], p[N][N];
#pragma unroll
  for (int i = 0; i < S; ++i) x[i] = x_in[(size_t)b * S + i];
#pragma unroll
  for (int i = 0; i < N; ++i) ex[i] = ex_in[(size_t)b * N + i];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) p[i][j] = p_in[(size_t)(i * N + j) * n_scen + b];
  }
  const float t = t_in[b];
  float u = u0[(size_t)b * u_stride];
  if (k.control_start > 0.0f) u = t >= k.control_start ? u : 0.0f;

#pragma unroll 1
  for (int i = 0; i < NSUB; ++i) {
    float f = 0.0f;
    if (k.has_pulse) {
      const float tau = t + (float)i * k.dt_sub;
      f = (tau > k.pulse_t0 && tau < k.pulse_t1) ? k.pulse_f : 0.0f;
    }
    plant.plant(x, u, f);
    float z[O];
    hx(x, z);
#pragma unroll
    for (int j = 0; j < O; ++j) z[j] = z[j] + k.sig[j] * noise[(size_t)(i * O + j) * n_scen + b];
    ukf_predict_update<N, O>(plant, hx, k, u, z, ex, p);
    if (k.has_guard) {
      bool bad = false;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        bad = bad || !isfinite(ex[j]);
        ex[j] = isfinite(ex[j]) ? ex[j] : 0.0f;
      }
#pragma unroll
      for (int a = 0; a < N; ++a) {
#pragma unroll
        for (int c = 0; c < N; ++c) bad = bad || !isfinite(p[a][c]);
      }
#pragma unroll
      for (int a = 0; a < N; ++a) {
#pragma unroll
        for (int c = 0; c < N; ++c) p[a][c] = bad ? k.p_reset[a][c] : p[a][c];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < S; ++i) x_out[(size_t)b * S + i] = x[i];
#pragma unroll
  for (int i = 0; i < N; ++i) ex_out[(size_t)b * N + i] = ex[i];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) p_out[(size_t)(i * N + j) * n_scen + b] = p[i][j];
  }
}

}  // namespace mpc
