// The card's ceiling for the tile of mma_bf16.cuh: a kernel of nothing but
// mma.sync m16n8k16 bf16 products on registers, eight independent
// accumulators a warp, no memory traffic. tools/mma_peak.py times it; K4's
// and K6's tensor-core kernels cannot run faster than this, whatever the
// card's wgmma peak is.

#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kAcc = 8;

__global__ void mma_peak_kernel(int iters, float* __restrict__ sink) {
  float acc[kAcc][4];
#pragma unroll
  for (int i = 0; i < kAcc; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  // any bit patterns will do: the products are never looked at
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  const uint32_t b0 = threadIdx.x, b1 = 5u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) mma::mma_16816(acc[i], a, b0, b1);
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kAcc; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) s += acc[i][e];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = s;  // keeps the loop alive
}

}  // namespace

// Each warp of blocks x threads makes iters * 8 products; sink holds
// blocks * threads floats.
extern "C" int desenet_mma_peak(int blocks, int threads, int iters,
                                void* sink, void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (blocks <= 0 || threads <= 0 || threads % 32 || iters <= 0)
    return cudaErrorInvalidValue;
  mma_peak_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      iters, static_cast<float*>(sink));
  return cudaGetLastError();
}
