// The sweep kernel's rollout, one problem at a time, with every step's
// state kept (tests/sweep_f32_witness.py): the statements of tile_rollout
// (ops/csrc/tile_solve.cuh), box-muller keyed `key` with counter word `tick`,
// the stage costs and the control term summed one after another, or with
// Kahan's compensation (`kahan`), to set the two orders side by side.
#include "sweep.cuh"

using namespace mpc;

__global__ void rollout_trace_kernel(CartPoleNonlinearT<false> model, int n, int k, uint32_t key, uint32_t tick,
                                     float sigma, float inv, float lo, float hi, const float* x, const float* un,
                                     float* out_e, float* out_x, float* out_score, int kahan) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= k) return;
  float x0 = x[0], x1 = x[1], x2 = x[2], x3 = x[3];
  const Shaped4 cost{};
  float c_acc = 0.0f, ct = 0.0f, cc = 0.0f, ctc = 0.0f;
  for (int c = 0; 4 * c < n; ++c) {
    float e[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    uint32_t w[4] = {(uint32_t)r, (uint32_t)c, tick, 0u};
    philox4x32_10(w, key, 0u);
    box_muller<false>(w[0], w[1], sigma, e[0], e[1]);
    if (4 * c + 2 < n) box_muller<false>(w[2], w[3], sigma, e[2], e[3]);
    for (int j = 0; j < 4; ++j) {
      const int t = 4 * c + j;
      if (t >= n) break;
      const float u = un[t];
      const float v = clampf(u + e[j], lo, hi);
      model.step(x0, x1, x2, x3, v);
      const float stage = cost(x0, x1, x2, x3);
      const float term = u * inv * v;
      if (kahan) {
        float y = stage - cc, s = c_acc + y;
        cc = (s - c_acc) - y;
        c_acc = s;
        y = term - ctc;
        s = ct + y;
        ctc = (s - ct) - y;
        ct = s;
      } else {
        c_acc = c_acc + stage;
        ct = ct + term;
      }
      const size_t i = (size_t)r * n + t;
      out_e[i] = e[j];
      out_x[4 * i] = x0;
      out_x[4 * i + 1] = x1;
      out_x[4 * i + 2] = x2;
      out_x[4 * i + 3] = x3;
    }
  }
  out_score[r] = -c_acc - ct;
}

__global__ void sincos_kernel(int m, const float* a, float* s, float* c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < m) sincosf(a[i], &s[i], &c[i]);
}

extern "C" {

// mc: the 9 CartPoleNonlinearT floats; device pointers x (4), un (n); out:
// e (k, n) normals, xs (k, n, 4) states after each step, score (k).
int rollout_trace(const float* mc, int n, int k, unsigned key, unsigned tick, float sigma, float inv, float lo,
                  float hi, const float* x, const float* un, float* e, float* xs, float* score, int kahan) {
  const CartPoleNonlinearT<false> model{mc[0], mc[1], mc[2], mc[3], mc[4], mc[5], mc[6], mc[7], mc[8]};
  rollout_trace_kernel<<<(k + 255) / 256, 256>>>(model, n, k, key, tick, sigma, inv, lo, hi, x, un, e, xs, score,
                                                  kahan);
  return (int)cudaDeviceSynchronize();
}

// sincosf of m device floats a into s and c.
int sincos_eval(int m, const float* a, float* s, float* c) {
  sincos_kernel<<<(m + 255) / 256, 256>>>(m, a, s, c);
  return (int)cudaDeviceSynchronize();
}

}  // extern "C"
