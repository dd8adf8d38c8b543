// The served ConvBnAct's epilogue: eval BatchNorm's per-channel affine, the
// SiLU and the Bottleneck shortcut in one pass over the conv's output, in
// place: out = silu(y * scale[c] + shift[c]) + residual, in f32, rounded to
// the output's type once on the store.
//
// Replaces no TPU kernel. XLA folds eval BN into each convolution and fuses
// the activation and the shortcut into its output, so the JAX package never
// writes them. cuDNN's convolution as PyTorch calls it adds no bias and no
// activation (ATen adds a conv bias as a separate pass), so folding BN into
// the weights would trade the BN pass for a bias pass of the same bytes;
// this kernel applies the affine inside the one pass that has to run anyway.
// Wrapper and plain version: ops/conv_epilogue.py.
//
// What bounds it on the H100: bytes. It reads the conv's output (and the
// shortcut's input) and writes the output once: 4 bytes an element in bf16,
// 6 with a shortcut, against a few f32 operations and two special-function
// ones (ex2 and rcp) an element, far under the card's rate of either.
//
// What the design does about it: full 16-byte transactions and enough bytes
// in flight. The tensor is NCHW in the channels_last memory format, so NHWC
// in memory, and an element's channel is its linear index mod C. Where C is
// a multiple of the vector width (8 bf16 or 4 f32) and both pointers are
// 16-byte aligned, each thread moves 16-byte vectors whose channels are
// C-contiguous; otherwise the scalar kernel moves one element at a time.
// The grid is the SM count times the blocks of 256 threads an SM holds (8),
// the SM count read once a device, walking the tensor in a grid-stride
// loop, so the small stride-32 and stride-64 maps cost no block scheduling;
// one vector a thread in flight is enough (a bare in-place read and write
// of the same bytes runs no faster, and two or four gained nothing on the
// card). Each block stages scale and shift (f32, 2C
// floats) in shared memory, read there as float4. A thread carries its
// channel from one trip to the next by adding the stride mod C: no
// division in the loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <bool kAct, bool kRes>
__device__ __forceinline__ float epilogue(float x, float s, float b, float r) {
  float v = fmaf(x, s, b);
  if (kAct) v = __fdividef(v, 1.0f + __expf(-v));
  if (kRes) v += r;
  return v;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 16 bytes as 16 / sizeof(T) floats, and back (rounded once)
__device__ __forceinline__ void unpack(const uint4& d, float (&f)[4]) {
  f[0] = __uint_as_float(d.x);
  f[1] = __uint_as_float(d.y);
  f[2] = __uint_as_float(d.z);
  f[3] = __uint_as_float(d.w);
}
__device__ __forceinline__ void unpack(const uint4& d, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 p = __bfloat1622float2(h[k]);
    f[2 * k] = p.x;
    f[2 * k + 1] = p.y;
  }
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint4 d;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&d);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
  return d;
}

// scale then shift, C floats each, into dynamic shared memory
__device__ __forceinline__ float* stage(const float* scale, const float* shift,
                                        int C) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    s[i] = scale[i];
    s[C + i] = shift[i];
  }
  __syncthreads();
  return s;
}

template <typename T, bool kAct, bool kRes>
__global__ void __launch_bounds__(kThreads)
    epilogue_vec_kernel(T* __restrict__ y, const T* __restrict__ res,
                        const float* __restrict__ scale,
                        const float* __restrict__ shift, long long nv, int C) {
  constexpr int V = 16 / sizeof(T);
  const float* s = stage(scale, shift, C);
  uint4* yv = reinterpret_cast<uint4*>(y);
  const uint4* rv = reinterpret_cast<const uint4*>(res);
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  int c = static_cast<int>((v * V) % C);
  const int dc = static_cast<int>((step * V) % C);
  for (; v < nv; v += step) {
    float f[V], g[V], sc[V], sh[V];
    unpack(yv[v], f);
    if (kRes) unpack(__ldg(rv + v), g);
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      const float4 a = *reinterpret_cast<const float4*>(s + c + k);
      const float4 b = *reinterpret_cast<const float4*>(s + C + c + k);
      sc[k] = a.x, sc[k + 1] = a.y, sc[k + 2] = a.z, sc[k + 3] = a.w;
      sh[k] = b.x, sh[k + 1] = b.y, sh[k + 2] = b.z, sh[k + 3] = b.w;
    }
#pragma unroll
    for (int k = 0; k < V; ++k)
      f[k] = epilogue<kAct, kRes>(f[k], sc[k], sh[k], kRes ? g[k] : 0.0f);
    yv[v] = pack(f);
    c += dc;
    if (c >= C) c -= C;
  }
}

template <typename T, bool kAct, bool kRes>
__global__ void __launch_bounds__(kThreads)
    epilogue_scalar_kernel(T* __restrict__ y, const T* __restrict__ res,
                           const float* __restrict__ scale,
                           const float* __restrict__ shift, long long n,
                           int C) {
  const float* s = stage(scale, shift, C);
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  int c = static_cast<int>(i % C);
  const int dc = static_cast<int>(step % C);
  for (; i < n; i += step) {
    const float r = kRes ? to_float(res[i]) : 0.0f;
    y[i] = from_float<T>(epilogue<kAct, kRes>(to_float(y[i]), s[c], s[C + c],
                                              r));
    c += dc;
    if (c >= C) c -= C;
  }
}

constexpr int kBlocksPerSm = 2048 / kThreads;  // the threads an SM holds
constexpr int kMaxDevices = 64;

// blocks for ``items`` threads' work: at most the SM count times
// kBlocksPerSm, the SM count read once a device
cudaError_t grid_for(long long items, int device, int* grid) {
  static int sms[kMaxDevices];
  int n = device >= 0 && device < kMaxDevices ? sms[device] : 0;
  if (n == 0) {
    const cudaError_t e =
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
    if (device >= 0 && device < kMaxDevices) sms[device] = n;
  }
  const long long full = static_cast<long long>(n) * kBlocksPerSm;
  const long long need = (items + kThreads - 1) / kThreads;
  *grid = static_cast<int>(need < full ? need : full);
  return cudaSuccess;
}

template <typename T, bool kAct, bool kRes>
cudaError_t launch(void* y, const void* res, const float* scale,
                   const float* shift, long long n, int C, bool vec,
                   cudaStream_t st, int device) {
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(C);
  int grid = 0;
  cudaError_t e;
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    e = grid_for(n / V, device, &grid);
    if (e != cudaSuccess) return e;
    epilogue_vec_kernel<T, kAct, kRes><<<grid, kThreads, smem, st>>>(
        static_cast<T*>(y), static_cast<const T*>(res), scale, shift, n / V,
        C);
  } else {
    e = grid_for(n, device, &grid);
    if (e != cudaSuccess) return e;
    epilogue_scalar_kernel<T, kAct, kRes><<<grid, kThreads, smem, st>>>(
        static_cast<T*>(y), static_cast<const T*>(res), scale, shift, n, C);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(void* y, const void* res, const float* scale,
                     const float* shift, long long n, int C, int act, bool vec,
                     cudaStream_t st, int device) {
  if (act)
    return res ? launch<T, true, true>(y, res, scale, shift, n, C, vec, st,
                                       device)
               : launch<T, true, false>(y, res, scale, shift, n, C, vec, st,
                                        device);
  return res ? launch<T, false, true>(y, res, scale, shift, n, C, vec, st,
                                      device)
             : launch<T, false, false>(y, res, scale, shift, n, C, vec, st,
                                       device);
}

}  // namespace

// y: P pixels of C channels, channels innermost (NHWC in memory), float32
// or bfloat16, written in place; res: the same layout and type, or null;
// scale, shift: C float32. vec: the 16-byte kernel (C a multiple of 16 /
// element size, y and res 16-byte aligned; the wrapper checks), else the
// scalar one.
extern "C" int desenet_conv_epilogue(void* y, const void* res,
                                     const void* scale, const void* shift,
                                     int P, int C, int act, int is_bf16,
                                     int vec, void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (P <= 0 || C <= 0) return cudaSuccess;
  const long long n = static_cast<long long>(P) * C;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  return is_bf16 ? dispatch<__nv_bfloat16>(y, res, sc, sh, n, C, act, vec != 0,
                                           st, device)
                 : dispatch<float>(y, res, sc, sh, n, C, act, vec != 0, st,
                                   device);
}
