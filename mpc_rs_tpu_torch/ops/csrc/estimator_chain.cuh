// The fused plant -> sensor -> UKF estimator chain of the scenario fleets
// (K7), a group of 16 lanes per scenario. Included by mppi_kernels.cu, so
// the build stays one nvcc over one translation unit.
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
// and writes 0.2 KB) nor the FP32 rate (14-22 M counted operations a launch
// at B = 1 024), but the latency of each scenario's dependent chain. One
// thread a scenario ran some 10^4 dependent scalar operations a substep on
// 16 of the 132 SMs. Most of that chain is independent work, so a scenario
// now has a group of G = 16 lanes of one warp (two scenarios a warp), with
// its working set in shared memory (P, the Jacobi a and V, the 2N+1 sigma
// rows [fx | hx], the column means, the joint covariance [P⁻ Pxz; · Pz],
// the gain and K·Pz: 1.9 KB at flagship6), and the lanes split it by index:
//   - lane m < 2N+1 builds sigma point m, runs fx and then hx on it;
//   - lane c < N+O takes the mean and the shift pieces of sigma column c;
//     every lane takes entries (c1 <= c2) of the joint k-sums (each one
//     lane's sequential sum; (c2, c1) is the same product sum), then entries
//     of the joint covariance; a block-shared table lists the triangle;
//   - every lane factors Pz (O <= 5) in its own registers; lane r < N solves
//     gain row r and its rows of x̂ and K·Pz; the lanes share out the P
//     update's entries i <= j;
//   - the Jacobi rotations stay in their cyclic order (a parallel order would
//     change the numbers): every lane computes (c, s) from the same three
//     entries, lane j < N updates rows p and q at column j while lane N + i
//     updates V's row i, then lane i < N columns p and q at row i, a
//     __syncwarp after each step;
//   - the guard is a ballot over the warp, each group reading its own half.
// The plant step and the sensor run on every lane of the group alike (the
// same bits, so no broadcast). Every sum keeps its order, so the results
// are those of the one-thread kernel bit for bit. G = 16 holds the 13
// sigma points of flagship6 (9 of cartpole4); blocks of 64 threads (4
// scenarios) give 256 blocks at B = 1 024, on every SM; launch bounds of one
// block an SM let ptxas take the 80-91 registers it needs without a spill.
// The floor is now the Jacobi's serial chain of rotations, each three IEEE
// divisions and two square roots before the updates: 60 a substep at
// flagship6 (one substep a tick), 24 at cartpole4 (five a tick), about two
// thirds of the launch on an H100 (PERF.md §6). Doing the row and column
// steps in one (each lane its four entries from the old ones, a
// double-buffered copy of the pivots) measured slower, with its stores
// branch-free or not. A group's shared stride is 16 words past a multiple
// of 32, so the two groups of a warp read other banks. A tail group
// (b >= B) computes the last scenario again, takes part in every warp
// barrier and ballot, and stores nothing.
//
// Built without fast math and with -fmad=false (ops/build.py): sinf/cosf,
// sqrtf and '/' are the accurate forms, and isfinite keeps its meaning.

#pragma once

#include "mppi_common.cuh"

namespace mpc {

constexpr int kChainLanes = 16;                               // G: lanes a scenario
constexpr int kChainThreads = 64;                             // two warps a block
constexpr int kChainScenarios = kChainThreads / kChainLanes;  // four scenarios a block
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

// An observation model divided channel by channel by the sensor's standard
// deviations: the flagship6 fleet's obs_normalize (mpc_rs_tpu/apps/fleet.py:
// 139-146, hx(x) / σ with z's injected noise and R scaled to match, which the
// chain's runtime constants carry). IEEE divisions, as the plain version's
// hx(x) / σ; the raw model's instantiation is left as it was.
template <class Hx>
struct HxScaled {
  static constexpr int kO = Hx::kO;
  Hx hx;
  float sig[kO];  // σ, the raw channels' standard deviations

  template <int S>
  __device__ __forceinline__ void operator()(const float (&x)[S], float (&z)[kO]) const {
    hx(x, z);
#pragma unroll
    for (int j = 0; j < kO; ++j) z[j] = z[j] / sig[j];
  }
};

// One scenario's shared working set, in floats from the group's base.
template <int N, int O>
struct ChainLayout {
  static constexpr int M = 2 * N + 1;           // sigma points
  static constexpr int W = N + O;               // a sigma row: fx(σ) then hx(fx(σ))
  static constexpr int kP = 0;                  // P (N, N)
  static constexpr int kA = kP + N * N;         // the Jacobi's a, then its eigenvalues
  static constexpr int kV = kA + N * N;         // the Jacobi's V
  static constexpr int kSig = kV + N * N;       // the sigma rows (M, W)
  static constexpr int kMean = kSig + M * W;    // column means: x̂⁻ (N), ẑ (O)
  static constexpr int kE = kMean + W;          // mean − row 0
  static constexpr int kSd = kE + W;            // wc1 · Σ_k (row k+1 − row 0)
  static constexpr int kJ = kSd + W;            // the joint covariance (W, W): P⁻, Pxz, Pz
  static constexpr int kGain = kJ + W * W;      // K (N, O)
  static constexpr int kKpz = kGain + N * O;    // K·Pz (N, O)
  static constexpr int kEx = kKpz + N * O;      // the estimate (N)
  static constexpr int kUsed = kEx + N;
  static constexpr int kFloats = (kUsed + 15) / 32 * 32 + 16;  // ≡ 16 mod 32: the warp's other group on other banks
};

// The upper triangle (c1 <= c2) of a D × D matrix, row by row, as
// (c1, c2) byte pairs: lanes share out its entries by index.
template <int D>
__device__ __forceinline__ void fill_triangle(unsigned char* pairs) {
  int idx = 0;
#pragma unroll
  for (int c1 = 0; c1 < D; ++c1) {
#pragma unroll
    for (int c2 = c1; c2 < D; ++c2, ++idx) {
      pairs[2 * idx] = (unsigned char)c1;
      pairs[2 * idx + 1] = (unsigned char)c2;
    }
  }
}

// (x, y) <- (c x − s y, s x + c y): a row pair, a column pair or a V pair
// of one Jacobi rotation.
__device__ __forceinline__ void rotate_pair(float* x, float* y, float c, float s) {
  const float xv = *x, yv = *y;
  *x = c * xv - s * yv;
  *y = s * xv + c * yv;
}

// Cyclic Jacobi on the symmetric a (smallalg.jacobi_entries) by the group's
// lanes: on return the diagonal of a holds the eigenvalues and the columns
// of v the eigenvectors. Each rotation: every lane computes (c, s) from the
// same a_pp, a_qq, a_pq; then lane j < N rotates rows p and q at column j
// while lane N + i rotates V's row i; then lane i < N rotates columns p and
// q at row i. Enter and leave after a __syncwarp.
template <int N>
__device__ __forceinline__ void jacobi_group(float* a, float* v, int lane) {
  constexpr int kRounds = (N * N + kChainLanes - 1) / kChainLanes;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int idx = r * kChainLanes + lane;
    if (idx < N * N) v[idx] = idx / N == idx % N ? 1.0f : 0.0f;
  }
  __syncwarp();
#pragma unroll 1
  for (int sweep = 0; sweep < 4; ++sweep) {
#pragma unroll
    for (int p = 0; p < N - 1; ++p) {
#pragma unroll
      for (int q = p + 1; q < N; ++q) {
        const float app = a[p * N + p], aqq = a[q * N + q], apq = a[p * N + q];
        const bool small = fabsf(apq) < 1e-30f;
        const float theta = (aqq - app) / (small ? 1.0f : 2.0f * apq);
        const float sgn = theta > 0.0f ? 1.0f : (theta < 0.0f ? -1.0f : 0.0f);
        float t = sgn / (fabsf(theta) + sqrtf(theta * theta + 1.0f));
        t = small ? 0.0f : t;
        const float c = 1.0f / sqrtf(t * t + 1.0f);
        const float s = t * c;
        __syncwarp();  // every lane has read a_pp, a_qq, a_pq before rows p and q change
        const bool row = lane < N;
        const int vi = lane - N;
        if (lane < 2 * N) {
          rotate_pair(row ? a + p * N + lane : v + vi * N + p, row ? a + q * N + lane : v + vi * N + q, c, s);
        }
        __syncwarp();
        if (row) rotate_pair(a + lane * N + p, a + lane * N + q, c, s);
        __syncwarp();
      }
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

// One UKF predict and update of the group's scenario (soa_predict,
// soa_update) on its shared working set g; z and u are the same on every
// lane, cov holds q and r on the diagonal blocks of the joint covariance;
// joint and upd: the (c1, c2) byte pairs of the upper triangles of the
// joint covariance (W × W) and of P (N × N). Enter and leave after a
// __syncwarp.
template <int N, int O, class Plant, class Hx>
__device__ __forceinline__ void ukf_group(const Plant& plant, const Hx& hx, const ChainConsts<N, O>& k,
                                          const float* cov, const unsigned char* joint,
                                          const unsigned char* upd, float u, const float (&z)[O],
                                          float* g, int lane) {
  using L = ChainLayout<N, O>;
  constexpr int M = L::M, W = L::W;
  constexpr int kPairs = W * (W + 1) / 2;
  constexpr int R = (kPairs + kChainLanes - 1) / kChainLanes;
  float* const pp = g + L::kP;
  float* const a = g + L::kA;
  float* const v = g + L::kV;
  float* const sig = g + L::kSig;
  float* const mean = g + L::kMean;
  float* const e = g + L::kE;
  float* const sd = g + L::kSd;
  float* const jc = g + L::kJ;
  float* const gain = g + L::kGain;
  float* const kpz = g + L::kKpz;
  float* const ex = g + L::kEx;

  // the sigma root: a = c/2 (P + Pᵀ), its Jacobi eigenpairs
  constexpr int kNNRounds = (N * N + kChainLanes - 1) / kChainLanes;
#pragma unroll
  for (int r = 0; r < kNNRounds; ++r) {
    const int idx = r * kChainLanes + lane;
    if (idx < N * N) {
      const int i = idx / N, j = idx % N;
      a[idx] = k.hc * (pp[i * N + j] + pp[j * N + i]);
    }
  }
  __syncwarp();
  jacobi_group<N>(a, v, lane);

  // sigma point m = lane: x̂, x̂ + L_i, x̂ − L_i (L_i = eigenvector_i ·
  // sqrt(max(λ_i, 0))), through fx, then hx: one sigma row
  if (lane < M) {
    const int col = lane == 0 ? 0 : (lane - 1) % N;
    const float aii = a[col * N + col];
    const float sq = sqrtf(aii < 0.0f ? 0.0f : aii);
    float row[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float x0 = ex[j];
      const float delta = v[j * N + col] * sq;
      row[j] = lane == 0 ? x0 : (lane <= N ? x0 + delta : x0 - delta);
    }
    plant.fx(row, u);
    float zr[O];
    hx(row, zr);
    float* const out = sig + lane * W;
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = row[j];
#pragma unroll
    for (int j = 0; j < O; ++j) out[N + j] = zr[j];
  }
  __syncwarp();

  // the unscented transform (ukf_soa.py::_ut) of every sigma column c: its
  // mean, e = mean − row 0 and sd = wc1 Σ_k d_k (d_k = row k+1 − row 0);
  // and the k-sums Σ_k d_k[c1] d_k[c2] of the lane's entries c1 <= c2
  float core[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int idx = r * kChainLanes + lane;
    if (idx < kPairs) {
      const int c1 = joint[2 * idx], c2 = joint[2 * idx + 1];
      const float a0 = sig[c1], b0 = sig[c2];
      float acc = (sig[W + c1] - a0) * (sig[W + c2] - b0);
#pragma unroll
      for (int kk = 1; kk < 2 * N; ++kk) acc = acc + (sig[(kk + 1) * W + c1] - a0) * (sig[(kk + 1) * W + c2] - b0);
      core[r] = acc;
    }
  }
  if (lane < W) {
    const int c = lane;
    const float s0 = sig[c];
    float acc = (sig[W + c] - s0) + (sig[(1 + N) * W + c] - s0);
#pragma unroll
    for (int i = 1; i < N; ++i) acc = acc + ((sig[(1 + i) * W + c] - s0) + (sig[(1 + N + i) * W + c] - s0));
    const float mu = s0 + k.wm1 * acc;
    mean[c] = mu;
    e[c] = mu - s0;
    float s = sig[W + c] - s0;
#pragma unroll
    for (int kk = 1; kk < 2 * N; ++kk) s = s + (sig[(kk + 1) * W + c] - s0);
    sd[c] = k.wc1 * s;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int idx = r * kChainLanes + lane;
    if (idx < kPairs) {
      const int c1 = joint[2 * idx], c2 = joint[2 * idx + 1];
      jc[c1 * W + c2] = core[r];
      jc[c2 * W + c1] = core[r];
    }
  }
  __syncwarp();
  // the joint covariance: P⁻ = UT + q, Pz = UT + r and the shifted Pxz
  constexpr int kJRounds = (W * W + kChainLanes - 1) / kChainLanes;
#pragma unroll
  for (int r = 0; r < kJRounds; ++r) {
    const int idx = r * kChainLanes + lane;
    if (idx < W * W) {
      const int c1 = idx / W, c2 = idx % W;
      float val = k.wc1 * jc[idx];
      val = val - sd[c1] * e[c2] - e[c1] * sd[c2] + k.sum_wc * (e[c1] * e[c2]);
      jc[idx] = (c1 < N) == (c2 < N) ? val + cov[idx] : val;
    }
  }
  __syncwarp();

  // K = Pxz Pz⁻¹: Pz Kᵀ = Pxzᵀ by the equilibrated Cholesky solve
  // (ukf_soa.py:204-255), D = diag(Pz)^½, one refinement step. Every lane
  // factors Pz; lane r < N solves row r (the others row N − 1 again).
  float dinv[O], aeq[O][O], l[O][O];
#pragma unroll
  for (int i = 0; i < O; ++i) dinv[i] = 1.0f / sqrtf(max_nan(jc[(N + i) * W + N + i], kEps));
#pragma unroll
  for (int i = 0; i < O; ++i) {
#pragma unroll
    for (int j = 0; j < O; ++j) aeq[i][j] = jc[(N + i) * W + N + j] * dinv[i] * dinv[j];
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
  const int r = lane < N ? lane : N - 1;
  float b[O], zz[O], resid[O], dz[O], gr[O];
#pragma unroll
  for (int i = 0; i < O; ++i) b[i] = jc[r * W + N + i] * dinv[i];
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
  for (int i = 0; i < O; ++i) gr[i] = (zz[i] + dz[i]) * dinv[i];
  // x̂_r += K_r (z − ẑ); row r of K·Pz
  float dx = gr[0] * (z[0] - mean[N]);
#pragma unroll
  for (int kk = 1; kk < O; ++kk) dx = dx + gr[kk] * (z[kk] - mean[N + kk]);
  if (lane < N) {
    ex[r] = mean[r] + dx;
#pragma unroll
    for (int j = 0; j < O; ++j) {
      float acc = gr[0] * jc[N * W + N + j];
#pragma unroll
      for (int kk = 1; kk < O; ++kk) acc = acc + gr[kk] * jc[(N + kk) * W + N + j];
      kpz[r * O + j] = acc;
      gain[r * O + j] = gr[j];
    }
  }
  __syncwarp();
  // P ← sym(P⁻) − K Pz Kᵀ, written for i <= j and mirrored
  constexpr int kUpd = N * (N + 1) / 2;
  constexpr int kUpdRounds = (kUpd + kChainLanes - 1) / kChainLanes;
#pragma unroll
  for (int rr = 0; rr < kUpdRounds; ++rr) {
    const int idx = rr * kChainLanes + lane;
    if (idx < kUpd) {
      const int i = upd[2 * idx], j = upd[2 * idx + 1];
      float dec = kpz[i * O] * gain[j * O];
#pragma unroll
      for (int kk = 1; kk < O; ++kk) dec = dec + kpz[i * O + kk] * gain[j * O + kk];
      const float val = 0.5f * (jc[i * W + j] + jc[j * W + i]) - dec;
      pp[i * N + j] = val;
      pp[j * N + i] = val;
    }
  }
  __syncwarp();
}

// Grid (ceil(B / 4)), 64 threads: scenario b = 4·block + threadIdx / 16 on
// the 16 lanes of its group, any B. Reads the carry's tensors where they
// lie: x (B, S), the estimate ex (B, N), P packed batch-minor (N², B), u0
// at u0[b · u_stride] (a column of the (B, horizon) nominals), t (B), the
// standard normals of the sensor (NSUB·O, B); writes x', ex' and P' in the
// same layouts.
template <int N, int O, int NSUB, class Plant, class Hx>
__global__ void __launch_bounds__(kChainThreads, 1)
estimator_chain_kernel(Plant plant, Hx hx, ChainConsts<N, O> k, int n_scen,
                       const float* __restrict__ x_in, const float* __restrict__ ex_in,
                       const float* __restrict__ p_in, const float* __restrict__ u0,
                       int u_stride, const float* __restrict__ t_in,
                       const float* __restrict__ noise, float* __restrict__ x_out,
                       float* __restrict__ ex_out, float* __restrict__ p_out) {
  using L = ChainLayout<N, O>;
  constexpr int S = Plant::kS, W = L::W;
  static_assert(S == N, "the fleets' UKF estimates the plant's own state");
  static_assert(L::M <= kChainLanes, "a lane per sigma point");
  __shared__ float cov[W * W];      // q and r on the joint covariance's diagonal blocks
  __shared__ float p_reset[N * N];
  __shared__ unsigned char joint[W * (W + 1)], upd[N * (N + 1)];  // the triangles' (c1, c2)
  __shared__ float groups[kChainScenarios * L::kFloats];
  if (threadIdx.x == 0) {  // compile-time indices into the parameter struct
#pragma unroll
    for (int i = 0; i < W * W; ++i) cov[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        cov[i * W + j] = k.q[i][j];
        p_reset[i * N + j] = k.p_reset[i][j];
      }
    }
#pragma unroll
    for (int i = 0; i < O; ++i) {
#pragma unroll
      for (int j = 0; j < O; ++j) cov[(N + i) * W + N + j] = k.r[i][j];
    }
    fill_triangle<W>(joint);
    fill_triangle<N>(upd);
  }
  __syncthreads();

  const int lane = threadIdx.x % kChainLanes;
  const int half = threadIdx.x / kChainLanes % (32 / kChainLanes);  // the group's half of its warp
  const int b = blockIdx.x * kChainScenarios + threadIdx.x / kChainLanes;
  const bool live = b < n_scen;
  const int bl = live ? b : n_scen - 1;
  float* const g = groups + threadIdx.x / kChainLanes * L::kFloats;
  float* const pp = g + L::kP;
  float* const ex = g + L::kEx;

  constexpr int kNNRounds = (N * N + kChainLanes - 1) / kChainLanes;
  float x[S];
#pragma unroll
  for (int i = 0; i < S; ++i) x[i] = x_in[(size_t)bl * S + i];
  if (lane < N) ex[lane] = ex_in[(size_t)bl * N + lane];
#pragma unroll
  for (int r = 0; r < kNNRounds; ++r) {
    const int idx = r * kChainLanes + lane;
    if (idx < N * N) pp[idx] = p_in[(size_t)idx * n_scen + bl];
  }
  const float t = t_in[bl];
  float u = u0[(size_t)bl * u_stride];
  if (k.control_start > 0.0f) u = t >= k.control_start ? u : 0.0f;
  __syncwarp();

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
    for (int j = 0; j < O; ++j) z[j] = z[j] + k.sig[j] * noise[(size_t)(i * O + j) * n_scen + bl];
    ukf_group<N, O>(plant, hx, k, cov, joint, upd, u, z, g, lane);
    if (k.has_guard) {
      bool bad = false;
      if (lane < N) {
        const float e = ex[lane];
        bad = !isfinite(e);
        ex[lane] = isfinite(e) ? e : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < kNNRounds; ++r) {
        const int idx = r * kChainLanes + lane;
        if (idx < N * N) bad = bad || !isfinite(pp[idx]);
      }
      const unsigned votes = __ballot_sync(kFullMask, bad);
      const bool reset = ((votes >> (kChainLanes * half)) & ((1u << kChainLanes) - 1u)) != 0u;
#pragma unroll
      for (int r = 0; r < kNNRounds; ++r) {
        const int idx = r * kChainLanes + lane;
        if (idx < N * N && reset) pp[idx] = p_reset[idx];
      }
      __syncwarp();
    }
  }
  if (live) {
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < S; ++i) x_out[(size_t)b * S + i] = x[i];
    }
    if (lane < N) ex_out[(size_t)b * N + lane] = ex[lane];
#pragma unroll
    for (int r = 0; r < kNNRounds; ++r) {
      const int idx = r * kChainLanes + lane;
      if (idx < N * N) p_out[(size_t)idx * n_scen + b] = pp[idx];
    }
  }
}

}  // namespace mpc
