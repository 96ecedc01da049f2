// tune's sweep kernel (sweep.cuh) and its C entries: one instantiation, for
// every horizon and both noise sources, in a source of its own so that nvcc
// builds it beside the others (ops/build.py).

#include "sweep.cuh"

namespace {

using namespace mpc;

// A launch past the default 48 KB of dynamic shared memory first raises the
// kernel's limit on the current device (a host call of a microsecond or so,
// against milliseconds of launch there).
int allow_shared(size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(mppi_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// -1 when one block at horizon n (with R = r rollouts a thread a tile)
// needs more shared memory than a block of the current device may take.
int check_horizon(int n, int r) {
  if (n < 1) return -1;
  int device = 0, optin = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess)
    return (int)cudaGetLastError();
  return sweep_shared_bytes(n, r) > (size_t)optin ? -1 : 0;
}

}  // namespace

extern "C" {

// tune's sweep, B episodes of the exact cart-pole with shaped4 at horizon n
// in one launch (mppi_sweep_kernel): problem b at its own lambda and sigma.
// model_consts: the 9 CartPoleNonlinearT floats. noise (B, K, N), already
// scaled, or null with seeds (B): box-muller keyed seeds[b] with counter
// word tick for every problem. tiles: tiles of 256 rollouts a block, at
// least 1; r: rollouts a thread a tile, at least 1, dividing tiles (the
// tile's shared memory, sweep_shared_bytes, grows with it). Device pointers: x (B, 4), u_n (B, N), inv_lambdas (B)
// f32(1/lambda_b), sigmas (B), invs (B) f32(sigma_b^-2), partials (B,
// ceil(ceil(K/256)/tiles), N+3) scratch, tickets (B); out: u_out (B, N),
// status (B), ess (B). Returns cudaGetLastError() after the launch, -1 for a
// horizon whose block does not fit the device's shared memory, -2 for
// neither noise nor seeds, -4 for a batch the grid cannot hold, K or tiles
// below 1, or an r that does not divide tiles.
int mpc_mppi_sweep(const float* model_consts, int n, int n_scen, int k, int tiles, int r, float lo, float hi,
                   const float* x, const float* u_n, const float* noise, const int* seeds, unsigned int tick,
                   const float* inv_lambdas, const float* sigmas, const float* invs, float* partials,
                   int* tickets, float* u_out, int* status, float* ess, void* stream) {
  if (n_scen < 1 || n_scen > 65535 || k < 1 || tiles < 1 || r < 1 || tiles % r != 0) return -4;
  if (int err = check_horizon(n, r)) return err;
  if (noise == nullptr && seeds == nullptr) return -2;
  const size_t bytes = sweep_shared_bytes(n, r);
  if (int err = allow_shared(bytes)) return err;
  const float* m = model_consts;
  const CartPoleNonlinearT<false> model{m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7], m[8]};
  const SweepArgs a{n, k, tiles, r, lo, hi, x, u_n, noise, noise != nullptr ? nullptr : seeds, tick,
                    inv_lambdas, sigmas, invs, partials, tickets, u_out, status, ess};
  const int tiles_total = (k + kThreads - 1) / kThreads;
  const dim3 grid((tiles_total + tiles - 1) / tiles, n_scen);
  mppi_sweep_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(model, a);
  return (int)cudaGetLastError();
}

// The blocks of the sweep's kernel an SM holds at horizon n with R = r
// rollouts a thread a tile (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// at the launch's dynamic shared memory), into *blocks; registers a thread
// and local bytes (cudaFuncGetAttributes) into *regs and *local_bytes; the
// launch's dynamic shared bytes into *shared_bytes. Same returns as
// mpc_mppi_sweep's.
int mpc_sweep_occupancy(int n, int r, int* blocks, int* regs, int* local_bytes, int* shared_bytes) {
  if (r < 1) return -4;
  if (int err = check_horizon(n, r)) return err;
  const size_t bytes = sweep_shared_bytes(n, r);
  *shared_bytes = (int)bytes;
  if (int err = allow_shared(bytes)) return err;
  cudaFuncAttributes attr{};
  cudaError_t err = cudaFuncGetAttributes(&attr, mppi_sweep_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, mppi_sweep_kernel, kThreads, bytes);
}

}  // extern "C"
