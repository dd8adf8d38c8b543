// K4: the SegMaskPSP2 seg head at 1/8 resolution, eval BN folded, as a
// sequence of kernels over the batch.
//
// Replaces: desenet_tpu/ops/seg_head_pallas.py, the kernel of
// _make_psp2_kernel (called through fused_psp2_eval), a Pallas TPU kernel
// that runs the whole head per image in VMEM: m8 stem, ACSP (1x1, 3x3 at
// dilation 1, 2, 3, global branch), context 1x1 and pyramid pools k = 1, 2,
// 3, 6 as kron'd matrices, FFM 3x3 over [spatial | ctx] with channel
// attention, class conv.
//
// What bounds it on the H100: operations. The 3x3 convs are 9-tap products
// with K = 9 * 64 (ACSP) and 9 * 148 (FFM) at s width; the head is about
// 4.5 GFLOP per image at 640 px. Its intermediates are a few MB per image,
// which do not fit the 227 KB of shared memory a block has, so the TPU's one
// kernel per image becomes a few kernels launched in turn over the batch,
// with intermediates in global memory (they stay mostly in the 50 MB L2 at
// small batch).
//
// What the design does about it (simple and right first, tensor cores in a
// later change):
// - conv_gemm: one tiled f32 GEMM (64 pixels x 64 output channels per block,
//   K in steps of 16 through shared memory, 4 x 4 outputs per thread) for
//   every 1x1 and 3x3 conv. A 3x3 conv is an implicit im2col: the k index
//   runs over (tap, channel), taps read the zero-padded neighbour at the
//   given dilation, and channels past c1 come from a second input (the
//   FFM's [spatial | ctx] without a concat). Epilogue: + added plane, +
//   per-image row, + bias, then SiLU rounded to the model type, or f32.
// - reduce_pixels: per-image channel means (global branch, pyramid k = 1,
//   attention) and the k = 2, 3, 6 pools (weighted sums with the kron'd
//   pool matrix).
// - small_gemm: the per-image vectors and the k*k pooled rows through their
//   1x1 convs (SiLU or sigmoid).
// - unpool: the kron'd bilinear upsample of the pooled branches (and the
//   k = 1 broadcast) into their channel slice of ctx.
// - gate: feat * gate + feat, rounded after each operation.
// Everything accumulates in f32 and rounds to the model type exactly where
// the JAX kernel's act / .astype(dt) does; the f32 arithmetic outside the
// GEMM sums uses the _rn intrinsics so that nvcc fuses no multiply-add.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kGemmThreads = 256;
constexpr int kThreads = 256;

enum ConvMode { kConvSilu = 0, kConvLinearF32 = 1 };
enum SmallMode { kSmallNone = 0, kSmallSilu = 1, kSmallSigmoid = 2 };

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ T cvt(float x);
template <>
__device__ __forceinline__ float cvt<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 cvt<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to the model type T, as a float
template <typename T>
__device__ __forceinline__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float rnd<bf16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

__device__ __forceinline__ float silu(float x) {
  return __fmul_rn(x, sigmoid(x));
}

template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
    conv_gemm_kernel(const T* __restrict__ in1, int ld1, int c1,
                     const T* __restrict__ in2, int ld2, int c2,
                     const T* __restrict__ w, const float* __restrict__ bias,
                     const float* __restrict__ rowbias,
                     const T* __restrict__ add, int add_ld, void* out,
                     int out_ld, int H, int W, int taps, int dil, int O,
                     int mode) {
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Bs[kBK][kBN + 4];
  const int P = H * W;
  const int b = blockIdx.z;
  const int p0 = blockIdx.x * kBM;
  const int o0 = blockIdx.y * kBN;
  const int ct = c1 + c2;
  const int K = taps * taps * ct;
  const int half = taps / 2;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  in1 += static_cast<size_t>(b) * P * ld1;
  if (in2 != nullptr) in2 += static_cast<size_t>(b) * P * ld2;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int e = tid; e < kBM * kBK; e += kGemmThreads) {
      const int m = e / kBK;
      const int kk = e % kBK;
      const int p = p0 + m;
      const int k = k0 + kk;
      float v = 0.f;
      if (p < P && k < K) {
        const int tap = k / ct;
        const int c = k - tap * ct;
        const int y = p / W + (tap / taps - half) * dil;
        const int x = p % W + (tap % taps - half) * dil;
        if (y >= 0 && y < H && x >= 0 && x < W) {
          const size_t q = static_cast<size_t>(y) * W + x;
          v = c < c1 ? ld(in1 + q * ld1 + c) : ld(in2 + q * ld2 + (c - c1));
        }
      }
      As[kk][m] = v;
    }
    for (int e = tid; e < kBK * kBN; e += kGemmThreads) {
      const int kk = e / kBN;
      const int n = e % kBN;
      const int k = k0 + kk;
      const int o = o0 + n;
      Bs[kk][n] = (k < K && o < O) ? ld(w + static_cast<size_t>(k) * O + o)
                                   : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty * 4 + i;
    if (p >= P) continue;
    const size_t row = static_cast<size_t>(b) * P + p;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + tx * 4 + j;
      if (o >= O) continue;
      float v = acc[i][j];
      if (add != nullptr) v = __fadd_rn(v, ld(add + row * add_ld + o));
      if (rowbias != nullptr) v = __fadd_rn(v, rowbias[b * O + o]);
      v = __fadd_rn(v, bias[o]);
      if (mode == kConvSilu) {
        static_cast<T*>(out)[row * out_ld + o] = cvt<T>(silu(v));
      } else {
        static_cast<float*>(out)[row * out_ld + o] = v;
      }
    }
  }
}

// out[(b * KK + q) * C + c]: with weights, the sum over pixels of
// weights[q, p] * in[b, p, c] rounded to T; without, the f32 mean over
// pixels (KK = 1). Grid (B * KK, ceil(C / 32)), block (32, 8).
template <typename T>
__global__ void reduce_pixels_kernel(const T* __restrict__ in, int ldi, int C,
                                     int P, const T* __restrict__ weights,
                                     int KK, float* __restrict__ out) {
  __shared__ float part[8][33];
  const int b = blockIdx.x / KK;
  const int q = blockIdx.x % KK;
  const int c = blockIdx.y * 32 + threadIdx.x;
  float s = 0.f;
  if (c < C) {
    const T* src = in + static_cast<size_t>(b) * P * ldi + c;
    if (weights != nullptr) {
      const T* wq = weights + static_cast<size_t>(q) * P;
      for (int p = threadIdx.y; p < P; p += 8)
        s = fmaf(ld(wq + p), ld(src + static_cast<size_t>(p) * ldi), s);
    } else {
      for (int p = threadIdx.y; p < P; p += 8)
        s = __fadd_rn(s, ld(src + static_cast<size_t>(p) * ldi));
    }
  }
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float t = 0.f;
    for (int r = 0; r < 8; ++r) t = __fadd_rn(t, part[r][threadIdx.x]);
    out[static_cast<size_t>(blockIdx.x) * C + c] =
        weights != nullptr ? rnd<T>(t) : __fdiv_rn(t, static_cast<float>(P));
  }
}

// out[r, o] = post(sum_c rnd<T>(in[r, c]) * w[c, o] + bias[o]) over N rows.
template <typename T>
__global__ void small_gemm_kernel(const float* __restrict__ in, int N, int Cin,
                                  const T* __restrict__ w,
                                  const float* __restrict__ bias, int Cout,
                                  int mode, float* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= N * Cout) return;
  const int r = idx / Cout;
  const int o = idx % Cout;
  float v = 0.f;
  for (int c = 0; c < Cin; ++c)
    v = fmaf(rnd<T>(in[static_cast<size_t>(r) * Cin + c]),
             ld(w + static_cast<size_t>(c) * Cout + o), v);
  if (bias != nullptr) v = __fadd_rn(v, bias[o]);
  if (mode == kSmallSilu) v = rnd<T>(silu(v));
  if (mode == kSmallSigmoid) v = rnd<T>(sigmoid(v));
  out[idx] = v;
}

// out[b, p, c] (row stride ldo) = T(sum_q up[p, q] * ck[b, q, c]).
template <typename T>
__global__ void unpool_kernel(const T* __restrict__ up,
                              const float* __restrict__ ck, int C, int P,
                              int KK, int B, T* __restrict__ out, int ldo) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(B) * P * C) return;
  const int c = static_cast<int>(idx % C);
  const size_t bp = idx / C;
  const int p = static_cast<int>(bp % P);
  const int b = static_cast<int>(bp / P);
  float v = 0.f;
  for (int q = 0; q < KK; ++q)
    v = fmaf(ld(up + static_cast<size_t>(p) * KK + q),
             ck[(static_cast<size_t>(b) * KK + q) * C + c], v);
  out[bp * ldo + c] = cvt<T>(v);
}

// feat = feat * gate + feat in place, rounded to T after each operation.
template <typename T>
__global__ void gate_kernel(T* __restrict__ feat,
                            const float* __restrict__ gate, int C, int P,
                            int B) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(B) * P * C) return;
  const int c = static_cast<int>(idx % C);
  const int b = static_cast<int>(idx / (static_cast<size_t>(P) * C));
  const float f = ld(feat + idx);
  const float t = rnd<T>(__fmul_rn(f, gate[b * C + c]));
  feat[idx] = cvt<T>(__fadd_rn(t, f));
}

unsigned blocks_for(size_t n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

template <typename T>
void launch_conv(const void* in1, int ld1, int c1, const void* in2, int ld2,
                 int c2, const void* w, const void* bias, const void* rowbias,
                 const void* add, int add_ld, void* out, int out_ld, int B,
                 int H, int W, int taps, int dil, int O, int mode,
                 cudaStream_t st) {
  const dim3 grid((H * W + kBM - 1) / kBM, (O + kBN - 1) / kBN, B);
  conv_gemm_kernel<T><<<grid, kGemmThreads, 0, st>>>(
      static_cast<const T*>(in1), ld1, c1, static_cast<const T*>(in2), ld2,
      c2, static_cast<const T*>(w), static_cast<const float*>(bias),
      static_cast<const float*>(rowbias), static_cast<const T*>(add), add_ld,
      out, out_ld, H, W, taps, dil, O, mode);
}

template <typename T>
void launch_reduce(const void* in, int ldi, int C, int P, const void* weights,
                   int KK, int B, void* out, cudaStream_t st) {
  const dim3 grid(B * KK, (C + 31) / 32);
  reduce_pixels_kernel<T><<<grid, dim3(32, 8), 0, st>>>(
      static_cast<const T*>(in), ldi, C, P, static_cast<const T*>(weights),
      KK, static_cast<float*>(out));
}

template <typename T>
void launch_small(const void* in, int N, int Cin, const void* w,
                  const void* bias, int Cout, int mode, void* out,
                  cudaStream_t st) {
  small_gemm_kernel<T><<<blocks_for(static_cast<size_t>(N) * Cout, kThreads),
                         kThreads, 0, st>>>(
      static_cast<const float*>(in), N, Cin, static_cast<const T*>(w),
      static_cast<const float*>(bias), Cout, mode, static_cast<float*>(out));
}

template <typename T>
void launch_unpool(const void* up, const void* ck, int C, int P, int KK,
                   int B, void* out, int ldo, cudaStream_t st) {
  unpool_kernel<T><<<blocks_for(static_cast<size_t>(B) * P * C, kThreads),
                     kThreads, 0, st>>>(
      static_cast<const T*>(up), static_cast<const float*>(ck), C, P, KK, B,
      static_cast<T*>(out), ldo);
}

template <typename T>
void launch_gate(void* feat, const void* gate, int C, int P, int B,
                 cudaStream_t st) {
  gate_kernel<T><<<blocks_for(static_cast<size_t>(B) * P * C, kThreads),
                   kThreads, 0, st>>>(static_cast<T*>(feat),
                                      static_cast<const float*>(gate), C, P,
                                      B);
}

}  // namespace

extern "C" int desenet_psp2_conv(const void* in1, int ld1, int c1,
                                 const void* in2, int ld2, int c2,
                                 const void* w, const void* bias,
                                 const void* rowbias, const void* add,
                                 int add_ld, void* out, int out_ld, int B,
                                 int H, int W, int taps, int dil, int O,
                                 int mode, int is_bf16, void* stream,
                                 int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (B == 0 || H * W == 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    launch_conv<bf16>(in1, ld1, c1, in2, ld2, c2, w, bias, rowbias, add,
                      add_ld, out, out_ld, B, H, W, taps, dil, O, mode, st);
  } else {
    launch_conv<float>(in1, ld1, c1, in2, ld2, c2, w, bias, rowbias, add,
                       add_ld, out, out_ld, B, H, W, taps, dil, O, mode, st);
  }
  return cudaGetLastError();
}

extern "C" int desenet_psp2_reduce(const void* in, int ldi, int C, int P,
                                   const void* weights, int KK, int B,
                                   void* out, int is_bf16, void* stream,
                                   int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (B == 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    launch_reduce<bf16>(in, ldi, C, P, weights, KK, B, out, st);
  } else {
    launch_reduce<float>(in, ldi, C, P, weights, KK, B, out, st);
  }
  return cudaGetLastError();
}

extern "C" int desenet_psp2_small(const void* in, int N, int Cin,
                                  const void* w, const void* bias, int Cout,
                                  int mode, int is_bf16, void* out,
                                  void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (N == 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    launch_small<bf16>(in, N, Cin, w, bias, Cout, mode, out, st);
  } else {
    launch_small<float>(in, N, Cin, w, bias, Cout, mode, out, st);
  }
  return cudaGetLastError();
}

extern "C" int desenet_psp2_unpool(const void* up, const void* ck, int C,
                                   int P, int KK, int B, void* out, int ldo,
                                   int is_bf16, void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (B == 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    launch_unpool<bf16>(up, ck, C, P, KK, B, out, ldo, st);
  } else {
    launch_unpool<float>(up, ck, C, P, KK, B, out, ldo, st);
  }
  return cudaGetLastError();
}

extern "C" int desenet_psp2_gate(void* feat, const void* gate, int C, int P,
                                 int B, int is_bf16, void* stream,
                                 int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (B == 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    launch_gate<bf16>(feat, gate, C, P, B, st);
  } else {
    launch_gate<float>(feat, gate, C, P, B, st);
  }
  return cudaGetLastError();
}
