// The card's ceiling for the tile of mma_bf16.cuh: a kernel of nothing but
// mma.sync m16n8k16 bf16 products on registers, eight independent
// accumulators a warp, no memory traffic. tools/mma_peak.py times it; K4's
// and K6's tensor-core kernels cannot run faster than this, whatever the
// card's wgmma peak is. Beside it, the same for the special-function unit
// (sfu_peak_kernel), whose rate bounds the SiLU epilogues.

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

// The special-function unit alone: eight independent chains a thread of one
// operation, for the SiLU epilogues of K5 and K6. kOp: 0 ex2.approx.ftz.f32,
// 1 rcp.approx.ftz.f32, 2 tanh.approx.f32, 3 tanh.approx.bf16x2 (two values
// an operation), 4 ex2.approx.ftz.bf16x2 (two values).
template <int kOp>
__device__ __forceinline__ uint32_t sfu_op(uint32_t x) {
  uint32_t y;
  if constexpr (kOp == 0) {
    asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=r"(y) : "r"(x));
  } else if constexpr (kOp == 1) {
    // a flipped bit between two reciprocals, or the pair is folded away
    asm volatile("rcp.approx.ftz.f32 %0, %1;" : "=r"(y) : "r"(x ^ 0x00400000u));
  } else if constexpr (kOp == 2) {
    asm volatile("tanh.approx.f32 %0, %1;" : "=r"(y) : "r"(x));
  } else if constexpr (kOp == 3) {
    asm volatile("tanh.approx.bf16x2 %0, %1;" : "=r"(y) : "r"(x));
  } else {
    asm volatile("ex2.approx.ftz.bf16x2 %0, %1;" : "=r"(y) : "r"(x));
  }
  return y;
}

template <int kOp>
__global__ void sfu_peak_kernel(int iters, float* __restrict__ sink) {
  uint32_t v[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i)
    v[i] = __float_as_uint(0.25f + 0.001f * (threadIdx.x + i));
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) v[i] = sfu_op<kOp>(v[i]);
  }
  uint32_t s = 0u;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) s ^= v[i];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = __uint_as_float(s);
}

}  // namespace

// Each thread of blocks x threads makes iters * 8 operations of kind op (see
// sfu_op); sink holds blocks * threads floats.
extern "C" int desenet_sfu_peak(int blocks, int threads, int iters, int op,
                                void* sink, void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (blocks <= 0 || threads <= 0 || threads % 32 || iters <= 0)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto out = static_cast<float*>(sink);
  switch (op) {
    case 0: sfu_peak_kernel<0><<<blocks, threads, 0, st>>>(iters, out); break;
    case 1: sfu_peak_kernel<1><<<blocks, threads, 0, st>>>(iters, out); break;
    case 2: sfu_peak_kernel<2><<<blocks, threads, 0, st>>>(iters, out); break;
    case 3: sfu_peak_kernel<3><<<blocks, threads, 0, st>>>(iters, out); break;
    case 4: sfu_peak_kernel<4><<<blocks, threads, 0, st>>>(iters, out); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

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
