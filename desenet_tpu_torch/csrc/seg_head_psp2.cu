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
// What the design does about it:
// - conv_gemm: one tiled GEMM for every 1x1 and 3x3 conv. A 3x3 conv is an
//   implicit im2col: the k index runs over (tap, channel), taps read the
//   zero-padded neighbour at the given dilation, and channels past c1 come
//   from a second input (the FFM's [spatial | ctx] without a concat).
//   Epilogue: + added plane, + per-image row, + bias, then SiLU rounded to
//   the model type, or f32. Three kernels, chosen by the wrapper:
//   conv_gemm_mma_kernel (bfloat16, O a multiple of 64, c1 and c2 multiples
//   of 16) runs on the tensor cores with the tile of mma_bf16.cuh: a block
//   owns 128 pixels x 64 output channels, eight warps of 32 x 32; channels
//   are contiguous in NHWC, so a K-chunk (one tap, 32 channels) is 16-byte
//   cp.async copies, zero-filled for taps outside the image, into a
//   three-stage ring; a pixel's coordinates are worked out once per
//   thread and a tap's shift once per chunk. conv1x1_narrow_kernel (a 1x1
//   conv onto at most 32 channels: context_red and the class conv) gives a
//   thread one pixel and all its outputs. conv_gemm_kernel (float32 and
//   whatever else is left) is a 64 x 64 f32 tile on the CUDA cores, K in
//   steps of 16 through shared memory, 4 x 4 outputs a thread; the last two
//   sum in the same order and keep float32 parity with the plain version.
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

#include "mma_bf16.cuh"

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
// the same under a name that a parameter called ld does not hide
template <typename T>
__device__ __forceinline__ float ld_(const T* p) {
  return ld(p);
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

// The same conv on the tensor cores (bf16 in, f32 sums): grid (ceil(P / 128),
// O / 64, B), 256 threads. Needs O % 64 == 0, c1 % 16 == 0, c2 % 16 == 0,
// ld1 % 8 == 0, ld2 % 8 == 0, out_ld % 2 == 0 and 16-byte aligned inputs.
constexpr int kTM = 128;
constexpr int kTN = 64;
constexpr int kTK = 32;
constexpr int kTStages = 3;  // ring stages: two chunks in flight

__global__ void __launch_bounds__(kGemmThreads)
    conv_gemm_mma_kernel(const bf16* __restrict__ in1, int ld1, int c1,
                         const bf16* __restrict__ in2, int ld2, int c2,
                         const bf16* __restrict__ w,
                         const float* __restrict__ bias,
                         const float* __restrict__ rowbias,
                         const bf16* __restrict__ add, int add_ld, void* out,
                         int out_ld, int H, int W, int taps, int dil, int O,
                         int mode) {
  __shared__ __align__(16) bf16 As[kTStages][kTM][kTK + mma::kPad];
  __shared__ __align__(16) bf16 Ws[kTStages][kTK][kTN + mma::kPad];
  const int P = H * W;
  const int b = blockIdx.z;
  const int p0 = blockIdx.x * kTM;
  const int o0 = blockIdx.y * kTN;
  const int ct = c1 + c2;
  const int half = taps / 2;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = (warp & 3) * 32;   // the warp's rows in the block tile
  const int wn = (warp >> 2) * 32;  // and its columns
  in1 += static_cast<size_t>(b) * P * ld1;
  if (in2 != nullptr) in2 += static_cast<size_t>(b) * P * ld2;

  // the two pixels whose 16-byte pieces this thread copies, and its piece
  const int seg = (tid & 3) * 8;
  int py[2], px[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int p = p0 + (tid >> 2) + 64 * j;
    py[j] = p < P ? p / W : -(1 << 20);  // past the map: never inside
    px[j] = p % W;
  }
  const int cpt = (ct + kTK - 1) / kTK;  // chunks per tap
  const int nchunks = taps * taps * cpt;

  // chunks are loaded in order: the next chunk's tap and first channel
  int ld_tap = 0, ld_ty = 0, ld_tx = 0, ld_c0 = 0;
  auto load = [&](int ch) {
    const int buf = ch % kTStages;
    const int tap = ld_tap;
    const int c0 = ld_c0;
    const int kn = min(kTK, ct - c0);
    const int dy = (ld_ty - half) * dil;
    const int dx = (ld_tx - half) * dil;
    const int c = c0 + seg;
    ld_c0 += kTK;
    if (ld_c0 >= ct) {
      ld_c0 = 0;
      ++ld_tap;
      if (++ld_tx == taps) {
        ld_tx = 0;
        ++ld_ty;
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int y = py[j] + dy;
      const int x = px[j] + dx;
      const bool ok = seg < kn && y >= 0 && y < H && x >= 0 && x < W;
      const size_t q = ok ? static_cast<size_t>(y) * W + x : 0;
      const bf16* src = c < c1 ? in1 + q * ld1 + c : in2 + q * ld2 + (c - c1);
      mma::cp_async16(mma::smem_addr(&As[buf][(tid >> 2) + 64 * j][seg]),
                      ok ? src : w, ok);
    }
    {
      const int r = tid >> 3;
      const int sg = (tid & 7) * 8;
      const bool ok = r < kn;
      mma::cp_async16(
          mma::smem_addr(&Ws[buf][r][sg]),
          ok ? w + (static_cast<size_t>(tap) * ct + c0 + r) * O + o0 + sg : w,
          ok);
    }
    mma::cp_async_commit();
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // this lane's ldmatrix addresses in stage 0
  const int lrow = lane & 15;
  const int lcol = (lane >> 4) * 8;
  constexpr int kAStageBytes = kTM * (kTK + mma::kPad) * 2;
  constexpr int kWRowBytes = (kTN + mma::kPad) * 2;
  constexpr int kWStageBytes = kTK * kWRowBytes;
  const uint32_t a_addr[2] = {mma::smem_addr(&As[0][wm + lrow][lcol]),
                              mma::smem_addr(&As[0][wm + 16 + lrow][lcol])};
  const uint32_t w_addr = mma::smem_addr(&Ws[0][lrow][wn + lcol]);
  // kTStages - 1 chunks in flight; one barrier a chunk: after it chunk ch
  // has landed for every thread and every warp is done with chunk ch - 1,
  // whose stage the next load takes
#pragma unroll
  for (int c0 = 0; c0 < kTStages - 1; ++c0) {
    if (c0 < nchunks) {
      load(c0);
    } else {
      mma::cp_async_commit();
    }
  }
  int cc0 = 0;  // first channel of the chunk being computed
  for (int ch = 0; ch < nchunks; ++ch) {
    mma::cp_async_wait<kTStages - 2>();
    __syncthreads();
    if (ch + kTStages - 1 < nchunks) {
      load(ch + kTStages - 1);
    } else {
      mma::cp_async_commit();
    }
    const int buf = ch % kTStages;
    const int kn = min(kTK, ct - cc0);
    cc0 = cc0 + kTK >= ct ? 0 : cc0 + kTK;
    // one or two k16 steps; between them only the addresses move
    uint32_t aa[2] = {a_addr[0] + buf * kAStageBytes,
                      a_addr[1] + buf * kAStageBytes};
    const uint32_t wb = w_addr + buf * kWStageBytes;
    mma::warp_mma_k16<2, 4>(acc, aa, wb, 2, 4);
    if (kn > 16) {
      aa[0] += 32;
      aa[1] += 32;
      mma::warp_mma_k16<2, 4>(acc, aa, wb + 16 * kWRowBytes, 2, 4);
    }
  }

  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + wm + mt * 16 + g + 8 * h;
      if (p >= P) continue;
      const size_t row = static_cast<size_t>(b) * P + p;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = o0 + wn + j * 8 + t2;
        float v[2] = {acc[mt][j][2 * h], acc[mt][j][2 * h + 1]};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (add != nullptr)
            v[e] = __fadd_rn(v[e], ld(add + row * add_ld + o + e));
          if (rowbias != nullptr)
            v[e] = __fadd_rn(v[e], rowbias[b * O + o + e]);
          v[e] = __fadd_rn(v[e], bias[o + e]);
        }
        if (mode == kConvSilu) {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) +
                                             row * out_ld + o) =
              __floats2bfloat162_rn(silu(v[0]), silu(v[1]));
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + row * out_ld +
                                     o) = make_float2(v[0], v[1]);
        }
      }
    }
  }
}

// A 1x1 conv onto at most 32 output channels (context_red's c_hid / 6, the
// class conv's 3), where the 64-wide tiles above would idle: one thread per
// pixel and all its outputs, the weights as f32 in shared memory (every
// thread reads the same one: a broadcast), the pixel's channels in 16-byte
// loads. Sums over k in order with fused multiply-adds and the epilogue in
// the same order as conv_gemm_kernel, so the two give equal results.
constexpr int kNarrowO = 32;
constexpr int kNarrowThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kNarrowThreads)
    conv1x1_narrow_kernel(const T* __restrict__ in, int ld, int C,
                          const T* __restrict__ w,
                          const float* __restrict__ bias,
                          const float* __restrict__ rowbias,
                          const T* __restrict__ add, int add_ld, void* out,
                          int out_ld, int P, int O, int mode) {
  extern __shared__ float ws[];  // (C, kNarrowO), zeros past O
  for (int e = threadIdx.x; e < C * kNarrowO; e += kNarrowThreads) {
    const int k = e / kNarrowO;
    const int o = e % kNarrowO;
    ws[e] = o < O ? ld_(w + static_cast<size_t>(k) * O + o) : 0.f;
  }
  __syncthreads();
  const int b = blockIdx.y;
  const int p = blockIdx.x * kNarrowThreads + threadIdx.x;
  if (p >= P) return;
  const size_t row = static_cast<size_t>(b) * P + p;
  const T* src = in + row * ld;
  constexpr int kVec = 16 / sizeof(T);  // values in a 16-byte load
  float acc[kNarrowO];
#pragma unroll
  for (int o = 0; o < kNarrowO; ++o) acc[o] = 0.f;
  for (int k0 = 0; k0 < C; k0 += kVec) {
    const uint4 u = *reinterpret_cast<const uint4*>(src + k0);
    const T* v = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float a = ld_(v + j);
      const float* wk = ws + (k0 + j) * kNarrowO;
#pragma unroll
      for (int o = 0; o < kNarrowO; ++o) acc[o] = fmaf(a, wk[o], acc[o]);
    }
  }
#pragma unroll
  for (int o = 0; o < kNarrowO; ++o) {
    if (o >= O) continue;
    float v = acc[o];
    if (add != nullptr) v = __fadd_rn(v, ld_(add + row * add_ld + o));
    if (rowbias != nullptr) v = __fadd_rn(v, rowbias[b * O + o]);
    v = __fadd_rn(v, bias[o]);
    if (mode == kConvSilu) {
      static_cast<T*>(out)[row * out_ld + o] = cvt<T>(silu(v));
    } else {
      static_cast<float*>(out)[row * out_ld + o] = v;
    }
  }
}

// out[(b * KK + q) * C + c]: with weights, the sum over pixels of
// weights[q, p] * in[b, p, c] rounded to T; without, the f32 mean over
// pixels (KK = 1). Grid (B * KK, ceil(C / 32)), block (32, kRows): a
// column's pixels are dealt to kRows threads, whose partial sums are added in
// order. Eight rows in float32, as ever (the order of the sums is part of its
// parity with the plain version); 32 in bfloat16, where the result is
// rounded to 8 bits anyway and a chain of 800 dependent loads a thread at
// 80 x 80 positions was most of the kernel's time.
template <typename T>
struct ReduceRows {
  static constexpr int value = 8;
};
template <>
struct ReduceRows<bf16> {
  static constexpr int value = 32;
};

template <typename T>
__global__ void reduce_pixels_kernel(const T* __restrict__ in, int ldi, int C,
                                     int P, const T* __restrict__ weights,
                                     int KK, float* __restrict__ out) {
  constexpr int kRows = ReduceRows<T>::value;
  __shared__ float part[kRows][33];
  const int b = blockIdx.x / KK;
  const int q = blockIdx.x % KK;
  const int c = blockIdx.y * 32 + threadIdx.x;
  float s = 0.f;
  if (c < C) {
    const T* src = in + static_cast<size_t>(b) * P * ldi + c;
    if (weights != nullptr) {
      const T* wq = weights + static_cast<size_t>(q) * P;
      for (int p = threadIdx.y; p < P; p += kRows)
        s = fmaf(ld(wq + p), ld(src + static_cast<size_t>(p) * ldi), s);
    } else {
      for (int p = threadIdx.y; p < P; p += kRows)
        s = __fadd_rn(s, ld(src + static_cast<size_t>(p) * ldi));
    }
  }
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float t = 0.f;
    for (int r = 0; r < kRows; ++r) t = __fadd_rn(t, part[r][threadIdx.x]);
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

void launch_conv_mma(const void* in1, int ld1, int c1, const void* in2,
                     int ld2, int c2, const void* w, const void* bias,
                     const void* rowbias, const void* add, int add_ld,
                     void* out, int out_ld, int B, int H, int W, int taps,
                     int dil, int O, int mode, cudaStream_t st) {
  const dim3 grid((H * W + kTM - 1) / kTM, O / kTN, B);
  conv_gemm_mma_kernel<<<grid, kGemmThreads, 0, st>>>(
      static_cast<const bf16*>(in1), ld1, c1, static_cast<const bf16*>(in2),
      ld2, c2, static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<const float*>(rowbias), static_cast<const bf16*>(add),
      add_ld, out, out_ld, H, W, taps, dil, O, mode);
}

template <typename T>
cudaError_t launch_conv_narrow(const void* in, int ld, int C, const void* w,
                               const void* bias, const void* rowbias,
                               const void* add, int add_ld, void* out,
                               int out_ld, int B, int P, int O, int mode,
                               cudaStream_t st) {
  const size_t smem = static_cast<size_t>(C) * kNarrowO * sizeof(float);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const dim3 grid((P + kNarrowThreads - 1) / kNarrowThreads, B);
  conv1x1_narrow_kernel<T><<<grid, kNarrowThreads, smem, st>>>(
      static_cast<const T*>(in), ld, C, static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(rowbias),
      static_cast<const T*>(add), add_ld, out, out_ld, P, O, mode);
  return cudaGetLastError();
}

template <typename T>
void launch_reduce(const void* in, int ldi, int C, int P, const void* weights,
                   int KK, int B, void* out, cudaStream_t st) {
  const dim3 grid(B * KK, (C + 31) / 32);
  reduce_pixels_kernel<T><<<grid, dim3(32, ReduceRows<T>::value), 0, st>>>(
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
                                 int mode, int variant, int is_bf16,
                                 void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (B == 0 || H * W == 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  if (variant == 2) {  // a 1x1 conv onto at most 32 channels
    if (taps != 1 || c2 != 0 || O > kNarrowO || c1 % 8 || ld1 % 8 ||
        reinterpret_cast<uintptr_t>(in1) % 16 != 0 || B > 65535)
      return cudaErrorInvalidValue;
    return is_bf16 ? launch_conv_narrow<bf16>(in1, ld1, c1, w, bias, rowbias,
                                              add, add_ld, out, out_ld, B,
                                              H * W, O, mode, st)
                   : launch_conv_narrow<float>(in1, ld1, c1, w, bias, rowbias,
                                               add, add_ld, out, out_ld, B,
                                               H * W, O, mode, st);
  }
  if (variant == 1) {  // tensor cores
    const auto misaligned = [](const void* p) {
      return reinterpret_cast<uintptr_t>(p) % 16 != 0;
    };
    if (!is_bf16 || O % kTN || c1 % 16 || c2 % 16 || ld1 % 8 || ld2 % 8 ||
        out_ld % 2 || misaligned(in1) || misaligned(in2) || misaligned(w) ||
        reinterpret_cast<uintptr_t>(out) % 8 != 0 || B > 65535)
      return cudaErrorInvalidValue;
    launch_conv_mma(in1, ld1, c1, in2, ld2, c2, w, bias, rowbias, add, add_ld,
                    out, out_ld, B, H, W, taps, dil, O, mode, st);
  } else if (is_bf16) {
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
