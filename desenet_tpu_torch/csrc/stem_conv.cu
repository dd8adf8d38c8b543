// K5: the FusedFocus stem, a 6x6/s2 pad-2 conv from 3 channels to CO, plus
// bias and an optional SiLU, BN folded into the weights.
//
// Replaces: desenet_tpu/ops/stem_pallas.py, _kernel (called through
// stem_conv), a Pallas TPU kernel over phase planes that an XLA prepass
// (_plane_split) cuts out of the image, because the TPU kernel cannot
// deinterleave NHWC rows itself.
//
// What bounds it on the H100: operations on the CUDA cores. Each output
// pixel is 108 * CO multiply-adds over 12 bytes of input (f32) and writes CO
// values, so at b128 / 640 px and CO 32 it is 45 G multiply-adds against
// about 1.2 GB of device memory traffic in bf16.
//
// What the design does about it (simple and right first; tensor cores and a
// wider tile are a later change):
// - The NHWC image is read directly: a block of 8 x 32 output pixels stages
//   its (2 * 8 + 4) x (2 * 32 + 4) x 3 input window, zero padded, in shared
//   memory with coalesced loads (an image row segment is contiguous), so the
//   prepass of the TPU design has no counterpart.
// - The (108, CO) tap matrix and the bias live in shared memory as f32 and
//   are read as broadcast float4 loads.
// - One thread per output pixel walks its CO outputs eight at a time (f32
//   accumulators in registers; CO is any multiple of 8 up to 64) and sums
//   the 108 products of each in tap order (kk = (dy*3+dx)*12 + sy*6 + sx*3
//   + c, the JAX tap matrix's order); bias, then SiLU in f32 (no contracted
//   multiply-add), one rounding to the output type, 16-byte stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTH = 8;   // output rows of a block
constexpr int kTW = 32;  // output columns of a block
constexpr int kThreads = kTH * kTW;
constexpr int kInRows = 2 * kTH + 4;
constexpr int kInVals = (2 * kTW + 4) * 3;  // values of one staged input row
constexpr int kTaps = 108;
constexpr int kCoMax = 64;  // widest stem taken (yolov5l_seg's)

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float silu(float x) {
  return __fmul_rn(x, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x))));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    stem_conv_kernel(const T* __restrict__ x, const T* __restrict__ wm,
                     const float* __restrict__ bias, int H, int W, int CO,
                     int silu_on, T* __restrict__ out) {
  __shared__ float xs[kInRows][kInVals + 1];
  __shared__ __align__(16) float ws[kTaps * kCoMax];
  __shared__ float bs[kCoMax];
  const int Ho = H / 2;
  const int Wo = W / 2;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * kTH;
  const int ox0 = blockIdx.x * kTW;
  const int tid = threadIdx.x;

  for (int e = tid; e < kTaps * CO; e += kThreads) ws[e] = ld(wm + e);
  for (int e = tid; e < CO; e += kThreads) bs[e] = bias[e];
  const T* xb = x + static_cast<size_t>(b) * H * W * 3;
  const int iy0 = 2 * oy0 - 2;
  const int ix0 = 2 * ox0 - 2;
  for (int e = tid; e < kInRows * kInVals; e += kThreads) {
    const int r = e / kInVals;
    const int j = e - r * kInVals;
    const int iy = iy0 + r;
    const int ix = ix0 + j / 3;
    float v = 0.f;
    if (iy >= 0 && iy < H && ix >= 0 && ix < W)
      v = ld(xb + (static_cast<size_t>(iy) * W + ix) * 3 + j % 3);
    xs[r][j] = v;
  }
  __syncthreads();

  const int ty = tid / kTW;
  const int tx = tid % kTW;
  const int oy = oy0 + ty;
  const int ox = ox0 + tx;
  const bool live = oy < Ho && ox < Wo;
  T* dst = out + ((static_cast<size_t>(b) * Ho + oy) * Wo + ox) * CO;
  // eight output channels at a time, the 108 taps of each in tap order
  for (int c0 = 0; c0 < CO; c0 += 8) {
    float acc[8];
#pragma unroll
    for (int o = 0; o < 8; ++o) acc[o] = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
        for (int sy = 0; sy < 2; ++sy) {
#pragma unroll
          for (int sx = 0; sx < 2; ++sx) {
            const int kk = (dy * 3 + dx) * 12 + sy * 6 + sx * 3;
            const float* xr = &xs[2 * ty + 2 * dy + sy][(2 * tx + 2 * dx + sx) * 3];
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const float v = xr[c];
              const float4* wr = reinterpret_cast<const float4*>(ws + (kk + c) * CO + c0);
              const float4 w0 = wr[0];
              const float4 w1 = wr[1];
              acc[0] = fmaf(v, w0.x, acc[0]);
              acc[1] = fmaf(v, w0.y, acc[1]);
              acc[2] = fmaf(v, w0.z, acc[2]);
              acc[3] = fmaf(v, w0.w, acc[3]);
              acc[4] = fmaf(v, w1.x, acc[4]);
              acc[5] = fmaf(v, w1.y, acc[5]);
              acc[6] = fmaf(v, w1.z, acc[6]);
              acc[7] = fmaf(v, w1.w, acc[7]);
            }
          }
        }
      }
    }
    if (!live) continue;
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const float v = __fadd_rn(acc[o], bs[c0 + o]);
      acc[o] = silu_on ? silu(v) : v;
    }
    if constexpr (std::is_same<T, float>::value) {
      reinterpret_cast<float4*>(dst + c0)[0] =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
      reinterpret_cast<float4*>(dst + c0)[1] =
          make_float4(acc[4], acc[5], acc[6], acc[7]);
    } else {
      uint4 u;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        h[j] = __floats2bfloat162_rn(acc[2 * j], acc[2 * j + 1]);
      *reinterpret_cast<uint4*>(dst + c0) = u;
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* wm, const void* bias, int B,
                   int H, int W, int CO, int silu_on, void* out,
                   cudaStream_t st) {
  if (CO <= 0 || CO % 8 || CO > kCoMax || B > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((W / 2 + kTW - 1) / kTW, (H / 2 + kTH - 1) / kTH, B);
  stem_conv_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(wm),
      static_cast<const float*>(bias), H, W, CO, silu_on,
      static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" int desenet_stem_conv(const void* x, const void* wm,
                                 const void* bias, int B, int H, int W, int CO,
                                 int silu_on, int is_bf16, void* out,
                                 void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (B == 0 || H == 0 || W == 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<bf16>(x, wm, bias, B, H, W, CO, silu_on, out, st)
                 : launch<float>(x, wm, bias, B, H, W, CO, silu_on, out, st);
}
