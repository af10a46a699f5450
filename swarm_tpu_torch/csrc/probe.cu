// The rate at which the card executes int32 add and min, measured by a
// loop of independent chains, for chip_smoke.py. The bounds of the
// integer DP kernels are stated against the data sheet's float32 rate,
// which has no int32 row; this puts the int32 rate beside it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChains = 8;

// Each thread runs kChains independent chains of `iters` steps; a step
// is two adds and one min (x += y; y = min(y, x + salt): both stay
// alive and data dependent, so neither folds into a closed form).
__global__ void int32_rate_kernel(int iters, int salt, int *__restrict__ out) {
  int x[kChains], y[kChains];
#pragma unroll
  for (int j = 0; j < kChains; ++j) {
    x[j] = threadIdx.x + j;
    y[j] = blockIdx.x - j;
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < kChains; ++j) {
      x[j] += y[j];
      y[j] = min(y[j], x[j] + salt);
    }
  }
  int acc = 0;
#pragma unroll
  for (int j = 0; j < kChains; ++j) acc ^= x[j] ^ y[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

}  // namespace

// int32 operations (adds plus mins/add-mins as written: 3 a step) one
// launch of `blocks` x 256 threads performs over `iters` steps.
extern "C" int64_t swarm_probe_int32_ops(int blocks, int iters) {
  return (int64_t)blocks * 256 * kChains * 3 * iters;
}

// out: blocks * 256 ints; returns cudaGetLastError() after the launch.
extern "C" int swarm_probe_int32_rate(int blocks, int iters, int salt,
                                      void *out, void *stream) {
  int32_rate_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(iters, salt,
                                                              (int *)out);
  return (int)cudaGetLastError();
}
