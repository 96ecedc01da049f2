// tune's sweep (mpc_rs_tpu/apps/tune.py:40-81, a vmap of mppi_solve over
// per-episode (lambda, sigma); the JAX package has no Pallas kernel of its
// own for it, so it stands for the batch kernel's work, mppi_pallas.py:692):
// B MPPI solves of the exact cart-pole with shaped4, problem b at its own
// f32(1/lambda_b), sigma_b and f32(sigma_b^-2), in one launch, at any
// horizon N from 1 to the largest whose shared memory fits one block
// (SWEEP_MAX_HORIZON in ops/mppi_cuda.py, sweep_shared_bytes below).
//
// One kernel for every N. The partials kernel (mppi_common.cuh) fixes N at
// compile time and keeps a rollout's N nominals, N controls and N + 1
// running sums in registers: its registers, and so its blocks an SM, fall
// as N grows (one block of 256 threads an SM past 128 registers), and each
// N is one more instantiation to build. Here no array of N floats lives in
// a register:
//
//   - the problem's nominal u_n sits in shared memory, loaded once a block;
//   - a thread streams its rollout's steps: each Philox call gives the four
//     normals of steps 4c..4c+3 (box-muller keyed seeds[b], counter (k, c,
//     tick, 0): the words of sweep_noise), or it reads them from the
//     external (B, K, N) noise; it clamps each control with u_n[t], writes
//     it to the block's tile of controls v[t][column] (a column a rollout,
//     so a warp's stores and loads touch 32 banks), steps the exact
//     cart-pole and adds the shaped4 stage cost and the control term;
//   - a tile holds 256 R rollouts, R a thread one after another (the
//     wrapper picks R, sweep_rollouts_a_thread in ops/mppi_cuda.py, and
//     passes it in SweepArgs), and then reduces from shared memory: the
//     tile's max of the scores (warp maxima, one barrier); each weight
//     w_k = exp((score_k - m) f32(1/lambda_b)) (0 for a non-finite score or
//     k >= K), written over its score; s and the sum of w^2 (warp sums, one
//     barrier); uw[t] = sum_k w_k v[t][k], split
//     over the warps by t, the lanes striding the tile's columns, then a
//     warp sum; a last barrier before the next tile rewrites the tile;
//   - a block runs `tiles` tiles of 256 rollouts (the wrapper picks the
//     count at run time, sweep_tiles in ops/mppi_cuda.py) and folds each of
//     its tiles' (m, s, uw, sum w^2) into running sums in shared memory by
//     lse_fold's rescale rule (the sum of w^2 takes the squared factors). So
//     the row, the ticket and the last block's merge are paid once a block,
//     and the tile's reductions once per 256 R rollouts.
//
// The design asked for a tile of 256 rollouts, one a thread; measured on an
// H100 at tune's grid (N = 8, B = 96, K = 800 000) it ran slower than the
// partials kernel it replaces at R = 4, whose block reduces once per 1 024
// rollouts: R rollouts a thread a tile brought the reductions to the same
// count and the time level with it (PERF.md §6). R N is held to 40, so
// that the tile's controls take at most 40 KB and shared memory keeps five
// blocks an SM.
//
// The merge is the partials kernel's: each block writes its row (m, s,
// uw[0..N-1], sum w^2) and draws its problem's ticket; the block that draws
// nb - 1 merges the problem's nb rows (the two-pass log-sum-exp of the plain
// finalize_sweep_plain: the largest m, then each row scaled by exp((m_r -
// m) f32(1/lambda_b)), its sum of w^2 by the square) with the L = N + 2 sums
// split over its warps, writes u_n' under the status ladder with the zero
// fallback, the status and ESS_b = s^2 / max(sum w^2, 1e-30)
// (mpc_rs_tpu/controllers/mppi.py:145), and resets the ticket. A problem of
// one block finishes from its own sums.
//
// What bounds it: the FP32 issue rate, as for every solve (a step pays an
// accurate sincosf and two IEEE divisions, a pair of normals a logf, a sqrtf
// and a sincosf); bytes are the states, nominals and rows. Shared memory is
// 4 (256 R (N + 1) + 2 N + 26) bytes a block (sweep_shared_bytes): at the
// wrapper's R at most 45 240 up to N = 40, so that it holds five blocks an
// SM there; the launch bounds ask ptxas for kSweepMinBlocks blocks an SM by
// registers at every N. Past N = 40 shared memory sets the count (3 at N =
// 64, 1 at N = 224).

#pragma once

#include "mppi_common.cuh"

namespace mpc {

// Blocks an SM the launch bounds ask for: at most 48 registers a thread,
// whatever N (registers hold the state, two running sums, one Philox call's
// words and four normals).
constexpr int kSweepMinBlocks = 5;

// Floats of the reductions' scratch after the tile's weights: the tile's
// max's kWarps partials, the two block sums' (s, sum w^2) per warp, the
// ticket (and one float of padding).
constexpr int kSweepRed = 3 * kWarps + 2;

// The dynamic shared memory of a block at horizon n with R = r rollouts a
// thread a tile: the tile's controls (256 R n floats), u_n and the running
// uw (n each), the tile's scores and weights (256 R) and the scratch
// (kSweepRed). The kernel has no static shared memory.
__host__ __device__ constexpr size_t sweep_shared_bytes(int n, int r) {
  return sizeof(float) * ((size_t)kThreads * r * (n + 1) + 2 * (size_t)n + kSweepRed);
}

// What a sweep launch reads and writes. Grid (ceil(ceil(K/256) / tiles), B):
// block g of problem b runs rollouts 256 g tiles .. 256 (g + 1) tiles - 1,
// R a thread in each tile of 256 R (rollouts past K weigh nothing).
struct SweepArgs {
  int n;                     // horizon N
  int k;                     // rollouts K a problem
  int tiles;                 // tiles of 256 rollouts a block
  int r;                     // rollouts a thread a tile, R (R divides tiles)
  float lo, hi;              // control box
  const float* x;            // (B, 4) start states
  const float* u_n;          // (B, N) nominals
  const float* noise;        // (B, K, N) external noise, already scaled by sigma_b, or null
  const int* seeds;          // (B) Philox keys (box-muller), or null with noise
  uint32_t tick;             // the Philox counter word of every problem
  const float* inv_lambdas;  // (B) f32(1/lambda_b), folded in double (+inf for lambda_b = 0)
  const float* sigmas;       // (B) sigma_b
  const float* invs;         // (B) f32(sigma_b^-2), the control-term coefficient
  float* partials;           // (B, nb, N + 3) rows (m, s, uw, sum w^2)
  int* tickets;              // (B) zeros; the merging block resets its problem's to 0
  float* u_out;              // (B, N) u_n'
  int* status;               // (B) MppiStatus
  float* ess;                // (B) ESS
};

// Rollout k of problem blockIdx.y from (x0..x3): its controls go to the
// tile's column vcol (v[t] at vcol[width t], width = 256 R), its score is
// returned: the negated sum of the stage costs and of the control term
// u_n[t] inv v[t], in the order of rollout_score (mppi_common.cuh).
__device__ __forceinline__ float sweep_rollout(const CartPoleNonlinearT<false>& model, const SweepArgs& a,
                                               uint32_t k, uint32_t key, float sigma, float inv,
                                               const float* un, float* vcol, int width, float x0, float x1,
                                               float x2, float x3) {
  const int n = a.n;
  const Shaped4 cost{};
  const float* nz = a.noise != nullptr ? a.noise + ((size_t)blockIdx.y * a.k + k) * n : nullptr;
  float c_acc = 0.0f, ct = 0.0f;
#pragma unroll 1
  for (int c = 0; 4 * c < n; ++c) {
    float e[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (nz == nullptr) {
      uint32_t w[4] = {k, (uint32_t)c, a.tick, 0u};
      philox4x32_10(w, key, 0u);
      box_muller<false>(w[0], w[1], sigma, e[0], e[1]);
      if (4 * c + 2 < n) box_muller<false>(w[2], w[3], sigma, e[2], e[3]);  // at odd N the last pair is half used
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * c + j < n) e[j] = nz[4 * c + j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = 4 * c + j;
      if (t < n) {
        const float u = un[t];
        const float v = clampf(u + e[j], a.lo, a.hi);
        vcol[(size_t)t * width] = v;
        model.step(x0, x1, x2, x3, v);
        c_acc = c_acc + cost(x0, x1, x2, x3);
        ct = ct + u * inv * v;
      }
    }
  }
  return -c_acc - ct;
}

// The end of problem b's solve on its merged sums (m_all, s, uw[0..N-1] in
// shared memory, q = sum w^2), by the whole block: the status ladder and
// zero fallback of status_ladder into u_out[b], status[b], and the ESS.
__device__ __forceinline__ void sweep_finish(const SweepArgs& a, int b, float m_all, float s, const float* uw,
                                             float q) {
  const bool no_finite = m_all <= kNoFiniteBelow;
  const bool sum_zero = s == 0.0f;
  const float denom = sum_zero ? 1.0f : s;
  const float u0 = uw[0] / denom;
  const int st = no_finite ? kNoFinite : sum_zero ? kSumZero : !isfinite(u0) ? kInvalidU : kOk;
  for (int t = threadIdx.x; t < a.n; t += kThreads) a.u_out[(size_t)b * a.n + t] = st == kOk ? uw[t] / denom : 0.0f;
  if (threadIdx.x == 0) {
    a.status[b] = st;
    a.ess[b] = s * s / (q < 1e-30f ? 1e-30f : q);  // a NaN q stays NaN, as jnp.maximum
  }
}

__global__ void __launch_bounds__(kThreads, kSweepMinBlocks)
mppi_sweep_kernel(CartPoleNonlinearT<false> model, SweepArgs a) {
  extern __shared__ float sm[];
  const int n = a.n, b = blockIdx.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = a.r, width = kThreads * r;  // rollouts a tile
  float* vt = sm;                          // [n][width] the tile's controls
  float* wv = vt + (size_t)width * n;      // [width] the tile's scores, then weights
  float* un = wv + width;                  // [n] u_n
  float* uw = un + n;                      // [n] the block's running sum of w v
  float* red = uw + n;                     // [kSweepRed]
  int* ticket = reinterpret_cast<int*>(red + 3 * kWarps);

  const float inv_lambda = a.inv_lambdas[b], sigma = a.sigmas[b], inv = a.invs[b];
  const uint32_t key = a.seeds != nullptr ? (uint32_t)a.seeds[b] : 0u;
  for (int t = tid; t < n; t += kThreads) {
    un[t] = a.u_n[(size_t)b * n + t];
    uw[t] = 0.0f;
  }
  const float x0 = a.x[(size_t)b * 4], x1 = a.x[(size_t)b * 4 + 1], x2 = a.x[(size_t)b * 4 + 2],
              x3 = a.x[(size_t)b * 4 + 3];
  __syncthreads();

  // the block's running log-sum-exp (m_run, s_run, uw[], q_run): the same
  // values in every thread (uw in shared memory)
  float m_run = kNegBig, s_run = 0.0f, q_run = 0.0f;
  const uint32_t first = (uint32_t)blockIdx.x * a.tiles * kThreads;  // the block's first rollout
  for (int g = 0; g < a.tiles / r; ++g) {
    const uint32_t base = first + (uint32_t)g * width;
    if (base >= (uint32_t)a.k) break;  // the problem's last block may hold fewer tiles
    // the thread's R rollouts, column p 256 + tid each; a score is kept in
    // wv (-inf for a non-finite score or k >= K, which carries v = 0)
    float m = -INFINITY;
#pragma unroll 1
    for (int p = 0; p < r; ++p) {
      const int col = p * kThreads + tid;
      const uint32_t k = base + (uint32_t)col;
      float score = -INFINITY;
      if (k < (uint32_t)a.k) {
        score = sweep_rollout(model, a, k, key, sigma, inv, un, vt + col, width, x0, x1, x2, x3);
        if (!isfinite(score)) score = -INFINITY;
      } else {
        for (int t = 0; t < n; ++t) vt[(size_t)t * width + col] = 0.0f;
      }
      wv[col] = score;
      m = fmaxf(m, score);
    }
    // the tile's max (every thread reads the kWarps partials)
    m = warp_max(m);
    if (lane == 0) red[warp] = m;
    __syncthreads();
    float m_tile = red[0];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) m_tile = fmaxf(m_tile, red[i]);
    if (!(m_tile > kNoFiniteBelow)) {  // no finite rollout in the tile: it adds nothing
      __syncthreads();  // the next tile rewrites vt, wv and red
      continue;
    }
    // the weights, in place of the thread's own scores, and s, sum w^2
    float s_w = 0.0f, q_w = 0.0f;
    for (int p = 0; p < r; ++p) {
      const int col = p * kThreads + tid;
      const float sc = wv[col];
      const float w = sc > -INFINITY ? expf((sc - m_tile) * inv_lambda) : 0.0f;
      wv[col] = w;
      s_w += w;
      q_w += w * w;
    }
    s_w = warp_sum(s_w);
    q_w = warp_sum(q_w);
    if (lane == 0) {
      red[kWarps + 2 * warp] = s_w;
      red[kWarps + 2 * warp + 1] = q_w;
    }
    __syncthreads();
    float s_tile = 0.0f, q_tile = 0.0f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      s_tile += red[kWarps + 2 * i];
      q_tile += red[kWarps + 2 * i + 1];
    }
    // lse_fold's rule: the first tile is taken as it is; a new maximum
    // rescales the running sums by exp((m_run - m_tile) f32(1/lambda)),
    // else the tile's sums take exp((m_tile - m_run) f32(1/lambda))
    float keep = 1.0f, wt = 1.0f;
    if (m_run != kNegBig) {
      const float d = m_tile - m_run;
      const bool new_max = d > 0.0f;
      const float e = expf(-fabsf(d) * inv_lambda);
      keep = new_max ? e : 1.0f;
      wt = new_max ? 1.0f : e;
    }
    m_run = fmaxf(m_run, m_tile);
    s_run = s_run * keep + s_tile * wt;
    q_run = q_run * (keep * keep) + q_tile * (wt * wt);
    for (int t = warp; t < n; t += kWarps) {
      const float* row = vt + (size_t)t * width;
      float acc = 0.0f;
      for (int c = lane; c < width; c += 32) acc += wv[c] * row[c];
      acc = warp_sum(acc);
      if (lane == 0) uw[t] = uw[t] * keep + acc * wt;
    }
    __syncthreads();  // the next tile rewrites vt, wv and red
  }

  const int nb = gridDim.x;
  if (nb == 1) {  // the problem's only block: no row, no ticket
    sweep_finish(a, b, m_run, s_run, uw, q_run);
    return;
  }
  const int row_len = n + 3;
  const float* rows = a.partials + (size_t)b * nb * row_len;
  float* row = a.partials + ((size_t)b * nb + blockIdx.x) * row_len;
  for (int i = tid; i < row_len; i += kThreads)
    row[i] = i == 0 ? m_run : i == 1 ? s_run : i == n + 2 ? q_run : uw[i - 2];
  // every thread's row entries are visible device-wide before lane 0 of
  // warp 0 announces the row (a release at device scope); the block that
  // draws nb - 1 acquires every row of the problem
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    *ticket = cuda::atomic_ref<int, cuda::thread_scope_device>(a.tickets[b])
                  .fetch_add(1, cuda::memory_order_acq_rel);
  }
  __syncthreads();
  if (*ticket != nb - 1) return;

  // the merge, two passes: the largest m, then the L = N + 2 sums, a warp a
  // sum, its lanes striding the rows (read from L2, past this SM's L1)
  float m = kNegBig;
  for (int r = tid; r < nb; r += kThreads) m = fmaxf(m, __ldcg(rows + (size_t)r * row_len));
  const float m_all = block_max(m, red);
  float* tot = vt;  // [N + 2]: s, uw, sum w^2
  const int sums = n + 2;
  for (int i = warp; i < sums; i += kWarps) {
    float acc = 0.0f;
    for (int r = lane; r < nb; r += 32) {
      const float* rr = rows + (size_t)r * row_len;
      const float m_r = __ldcg(rr);
      if (m_r > kNoFiniteBelow) {  // a row with no finite rollout holds zeros
        float scale = expf((m_r - m_all) * inv_lambda);
        if (i == sums - 1) scale = scale * scale;
        acc += __ldcg(rr + 1 + i) * scale;
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) tot[i] = acc;
  }
  __syncthreads();
  sweep_finish(a, b, m_all, tot[0], tot + 1, tot[sums - 1]);
  if (tid == 0) a.tickets[b] = 0;
}

}  // namespace mpc
