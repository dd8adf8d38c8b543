// K5: the FusedFocus stem, a 6x6/s2 pad-2 conv from 3 channels to CO, plus
// bias and an optional SiLU, BN folded into the weights.
//
// Replaces: desenet_tpu/ops/stem_pallas.py, _kernel (called through
// stem_conv), a Pallas TPU kernel over phase planes that an XLA prepass
// (_plane_split) cuts out of the image, because the TPU kernel cannot
// deinterleave NHWC rows itself.
//
// What bounds it on the H100: the bytes of its output (at b128 / 640 px and
// CO 32 in bf16, 839 MB of the 1.0 GB it moves) once the 45 G multiply-adds
// run on the tensor cores; between the two stands the SiLU, one or two
// special-function operations for each of 4.2 G values at 16 an SM a clock.
//
// Two kernels. In float32 stem_conv_kernel (the CUDA cores, f32 sums in tap
// order, the exact SiLU): one thread per output pixel, eight channels at a
// time, from an f32 window and the f32 tap matrix in shared memory.
//
// In bfloat16 stem_mma_kernel, an implicit GEMM on mma.sync m16n8k16
// (mma_bf16.cuh): M = output pixels, N = CO (CO / 8 n-tiles), K = 108 padded
// to 112 (7 k16 steps).
// - K is ordered (ky, kx * 3 + c) inside the kernel: a pixel's taps on one
//   input row are 18 contiguous bf16 of the NHWC row, starting at byte
//   12 * ox of the staged row. That is 4-byte but not 16-byte aligned, so
//   ldmatrix cannot fetch it; 18 is even, so a fragment's pair (k, k + 1), k
//   even, never straddles a row and each A register is one 32-bit shared
//   load at a constant offset from the lane's pixel.
// - A block gathers the public tap matrix (the JAX order) once into shared
//   memory, its rows in that K order and laid out by B fragment (7 KB at CO
//   32; ops/stem_pallas.py's stem_weight_fragments states the layout); a lane
//   reads its two registers of a (k16 step, n-tile) with one 8-byte load,
//   used for the two m16 tiles of a tile's row. (Held in registers instead,
//   56 of them, the kernel spilled and ran slower: 0.86 against 0.79 ms at
//   b128 / 640 px on an NVIDIA H100 80GB HBM3 at 700 W.)
// - The output channels are dealt over the B columns so that the columns a
//   lane's C fragments hold (2t, 2t + 1 of each n-tile of a pass of four)
//   are 8 neighbouring channels of one pixel: a lane stores 16 bytes, a quad
//   a pixel's 64, a warp 512 contiguous bytes, with no exchange between
//   lanes. Stores are 839 MB of the 1.0 GB the kernel moves at b128.
// - Persistent blocks (two an SM) walk 16 x 32 pixel tiles; the next tile's
//   bf16 window (36 rows of 74 pixels, zero filled outside the image)
//   arrives by cp.async into the other buffer while this one is multiplied:
//   16-byte copies where W is a multiple of 8 (a row starts 8 pixels left
//   of the tile, on a 16-byte boundary), else 4-byte ones.
// - The sums start from the bias. The SiLU is x * sigmoid(x) = h + h *
//   tanh(h), h = x / 2, with tanh.approx.f32: one special-function operation
//   a value (the card runs 16 a clock an SM; ex2 and a reciprocal are two,
//   and the bf16x2 forms run at half the rate, so they save nothing), about
//   2^-11 relative error in tanh before the one rounding of the output.
//   tools/profile_stem_phases.py switches the kernel's parts off one by one
//   (a -DK5_PROF build).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <type_traits>

#include "mma_bf16.cuh"

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
  if (B > 65535) return cudaErrorInvalidValue;
  const dim3 grid((W / 2 + kTW - 1) / kTW, (H / 2 + kTH - 1) / kTH, B);
  stem_conv_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(wm),
      static_cast<const float*>(bias), H, W, CO, silu_on,
      static_cast<T*>(out));
  return cudaGetLastError();
}

// ---- the tensor-core kernel (bf16) ----------------------------------------

namespace tc {

constexpr int kTH = 16;  // output rows of a tile
constexpr int kTW = 32;  // output columns of a tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWinRows = 2 * kTH + 4;
// A window row starts kLead pixels left of the tile's first input column
// (2 of them the conv's padding), so that it starts on a 16-byte boundary of
// the image row wherever W is a multiple of 8, and is rounded up to 16 bytes.
constexpr int kLead = 8;
constexpr int kPitch = ((2 * kTW + 2 + kLead) * 6 + 15) / 16 * 16;  // bytes
constexpr int kKSteps = 7;                        // k16 steps: 108 -> 112
constexpr int kRowTaps = 18;                      // 6 columns x 3 channels
constexpr int kNT = 4;                            // n8 tiles of a pass
constexpr int kBlocksPerSM = 2;
constexpr int kMT = kTW / 16;                     // m16 tiles of a tile's row

#ifdef K5_PROF
// parts switched off by tools/profile_stem_phases.py: 1 the window loads, 2
// the A loads and products, 4 the SiLU, 8 the stores
__device__ int k5_skip;
#define K5_ON(bit) (!(skip & (bit)))
#else
#define K5_ON(bit) true
#endif

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float tanh_f32(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two values through the SiLU (or not), rounded once to bf16 and packed.
template <bool kSilu>
__device__ __forceinline__ uint32_t finish2(float y0, float y1) {
  if constexpr (kSilu) {
    const float h0 = 0.5f * y0, h1 = 0.5f * y1;
    return pack2(fmaf(h0, tanh_f32(h0), h0), fmaf(h1, tanh_f32(h1), h1));
  } else {
    return pack2(y0, y1);
  }
}

// The tap matrix's element for row k of the kernel's K order, k = ky * 18 +
// kx * 3 + c: row (dy * 3 + dx) * 12 + sy * 6 + sx * 3 + c of the public
// matrix, ky = 2 dy + sy, kx = 2 dx + sx; zero in the padding, k >= 108.
__device__ __forceinline__ unsigned short tap(const unsigned short* wm, int CO,
                                              int k, int ch) {
  if (k >= 6 * kRowTaps) return 0;
  const int ky = k / kRowTaps, el = k % kRowTaps;
  const int kx = el / 3, c = el % 3;
  const int kk = ((ky >> 1) * 3 + (kx >> 1)) * 12 + (ky & 1) * 6 + (kx & 1) * 3 + c;
  return wm[kk * CO + ch];
}

__device__ __forceinline__ uint32_t a_offset(int k0, int t) {
  const int row = k0 / kRowTaps, el = k0 % kRowTaps;
  const uint32_t off = row * kPitch + el * 2;
  if (el + 6 < kRowTaps || k0 + 8 > 6 * kRowTaps) return off;  // no lane steps
  return off + (el + 2 * t >= kRowTaps ? kPitch - 2 * kRowTaps : 0);
}

// A tile's window into shared memory at dst, kBytes a copy, zero filled
// outside the image: rows iy0.., from element e0 of each image row of xb. e0
// and 3 W are multiples of kBytes / 2 elements, so no copy straddles the
// image's edge.
template <int kBytes>
__device__ __forceinline__ void stage_rows(uint32_t dst, const bf16* xb, int iy0,
                                           int e0, int H, int W) {
  constexpr int kPerRow = kPitch / kBytes;
  for (int e = threadIdx.x; e < kWinRows * kPerRow; e += kThreads) {
    const int r = e / kPerRow;
    const int iy = iy0 + r;
    const int el = e0 + (kBytes / 2) * (e - r * kPerRow);
    const bool ok = iy >= 0 && iy < H && el >= 0 && el < 3 * W;
    const bf16* src = ok ? xb + static_cast<size_t>(iy) * W * 3 + el : xb;
    if constexpr (kBytes == 16)
      mma::cp_async16(dst + e * 16, src, ok);
    else
      mma::cp_async4(dst + e * 4, src, ok);
  }
}

// wm: the public (112, CO) tap matrix, as bf16 bit patterns.
template <bool kSilu>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    stem_mma_kernel(const bf16* __restrict__ x,
                    const unsigned short* __restrict__ wm,
                    const float* __restrict__ bias, int H, int W, int Ho, int Wo,
                    int NT, int CO, int tiles_x, int tiles_y, int ntiles,
                    bf16* __restrict__ out) {
  // the sizes derived from H, W and NT come as arguments: read from the
  // constant bank where they are used, they hold no register
  __shared__ __align__(16) uint32_t win[2][kWinRows * kPitch / 4];
  __shared__ __align__(8) float bs[kCoMax];
  // the B fragments: lane 4g + t of (k16 step, n8 tile) holds b0, b1, the
  // rows 2t, 2t + 1 and 2t + 8, 2t + 9 of the step at the tile's column g
  __shared__ uint2 wsm[kKSteps * (kCoMax / 8) * 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
#ifdef K5_PROF
  const int skip = k5_skip;
#endif

  if (tid < kCoMax) bs[tid] = tid < CO ? bias[tid] : 0.f;

  // The next tile's window: 16-byte copies where every row of the image
  // starts on a 16-byte boundary (W a multiple of 8), else 4-byte ones.
  auto stage = [&](int tile, int buf) {
    const int tx = tile % tiles_x;
    const int rest = tile / tiles_x;
    const int ty = rest % tiles_y;
    const int b = rest / tiles_y;
    const bf16* xb = x + static_cast<size_t>(b) * H * W * 3;
    const int iy0 = 2 * ty * kTH - 2;
    const int e0 = (2 * tx * kTW - kLead) * 3;  // first element, in the image row
    const uint32_t dst = mma::smem_addr(win[buf]);
    if (W % 8 == 0)
      stage_rows<16>(dst, xb, iy0, e0, H, W);
    else
      stage_rows<4>(dst, xb, iy0, e0, H, W);
  };

  const int npass = (NT + kNT - 1) / kNT;
  // The output channels are dealt over the B columns so that the columns
  // 2t, 2t + 1 of a pass's nj n-tiles, which a lane's C fragments hold, are
  // the 2 nj neighbouring channels from 32 pass + 2 nj t on: column g of
  // n-tile 4 pass + j is channel 32 pass + 2 nj (g / 2) + 2 j + g % 2.
  for (int e = tid; e < kKSteps * NT * 32; e += kThreads) {
    const int l = e & 31, nt = (e >> 5) % NT, ks = (e >> 5) / NT;
    const int gg = l >> 2, k = 16 * ks + 2 * (l & 3);
    const int pass = nt / kNT, j = nt % kNT, nj = min(kNT, NT - pass * kNT);
    const int ch = pass * kNT * 8 + 2 * nj * (gg >> 1) + 2 * j + (gg & 1);
    wsm[e] = make_uint2(
        tap(wm, CO, k, ch) | static_cast<uint32_t>(tap(wm, CO, k + 1, ch)) << 16,
        tap(wm, CO, k + 8, ch) | static_cast<uint32_t>(tap(wm, CO, k + 9, ch)) << 16);
  }

  int tile = blockIdx.x;
  if (tile < ntiles && K5_ON(1)) stage(tile, 0);
  mma::cp_async_commit();
  for (int it = 0; tile < ntiles; tile += gridDim.x, ++it) {
    const int buf = it & 1;
    if (tile + gridDim.x < ntiles && K5_ON(1)) stage(tile + gridDim.x, buf ^ 1);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();

    const int tx = tile % tiles_x;
    const int rest = tile / tiles_x;
    const int ty = rest % tiles_y;
    const int b = rest / tiles_y;
    const unsigned char* wbytes = reinterpret_cast<const unsigned char*>(win[buf]);
    // a warp takes a whole output row of the tile at a time: kMT m16 tiles
    // (16 neighbouring pixels each) that share every B fragment it loads
    for (int oyl = warp; oyl < kTH; oyl += kWarps) {
      const int oy = ty * kTH + oyl;
      const int ox = tx * kTW + g;  // this lane's first pixel; + 8, 16, 24 the others
      if (oy >= Ho) continue;  // uniform over the warp
      // this lane's pixel g of the row, at its pair 2t of a k16 step
      const unsigned char* pa =
          wbytes + 2 * oyl * kPitch + (kLead - 2) * 6 + g * 12 + t * 4;
      bf16* orow = out + (static_cast<size_t>(b) * Ho + oy) * Wo * CO;
      for (int pass = 0; pass < npass; ++pass) {
        // This lane's columns 2t, 2t + 1 of the pass's nj n-tiles are the
        // 2 nj neighbouring channels from ch0 on (see wsm above): its C
        // fragments are ready to store, with no exchange between lanes.
        const int nj = min(kNT, NT - pass * kNT);
        const int ch0 = pass * kNT * 8 + 2 * nj * t;
        float acc[kMT][kNT][4];
#pragma unroll
        for (int j = 0; j < kNT; ++j) {  // sums start from the bias
          const float2 bb = *reinterpret_cast<const float2*>(
              bs + ((ch0 + 2 * j) & (kCoMax - 2)));
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            acc[mt][j][0] = acc[mt][j][2] = bb.x;
            acc[mt][j][1] = acc[mt][j][3] = bb.y;
          }
        }
        if (K5_ON(2)) {
#pragma unroll
          for (int ks = 0; ks < kKSteps; ++ks) {
            // The lane's pairs are k = k0 + 2t, k0 = 16 ks (+ 8): row k / 18
            // of the pixel's window, element k % 18 of its 18. k0's row and
            // element are known here, so the offset is a constant, plus the
            // step to the next row for the lanes whose 2t carries over 18.
            // (k0 = 104 never steps: its lanes t >= 2 are the padding, k >=
            // 108, which is zero and not loaded: it lies behind the window.)
            uint32_t a[kMT][4];
            const uint32_t o0 = a_offset(16 * ks, t), o1 = a_offset(16 * ks + 8, t);
            const bool pad = ks == kKSteps - 1 && t >= 2;
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) {  // 16 pixels on: 192 bytes
              a[mt][0] = *reinterpret_cast<const uint32_t*>(pa + mt * 192 + o0);
              a[mt][1] = *reinterpret_cast<const uint32_t*>(pa + mt * 192 + 96 + o0);
              a[mt][2] = a[mt][3] = 0u;
              if (!pad) {
                a[mt][2] = *reinterpret_cast<const uint32_t*>(pa + mt * 192 + o1);
                a[mt][3] = *reinterpret_cast<const uint32_t*>(pa + mt * 192 + 96 + o1);
              }
            }
#pragma unroll
            for (int j = 0; j < kNT; ++j) {
              if (j < nj) {
                const uint2 bq = wsm[(ks * NT + pass * kNT + j) * 32 + lane];
#pragma unroll
                for (int mt = 0; mt < kMT; ++mt)
                  mma::mma_16816(acc[mt][j], a[mt], bq.x, bq.y);
              }
            }
          }
        }
#pragma unroll
        for (int mh = 0; mh < 2 * kMT; ++mh) {  // rows g, g + 8 of each m16 tile
          const int mt = mh >> 1, h = mh & 1;
          uint32_t v[kNT];
#pragma unroll
          for (int j = 0; j < kNT; ++j)
            v[j] = K5_ON(4) ? finish2<kSilu>(acc[mt][j][2 * h], acc[mt][j][2 * h + 1])
                            : pack2(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
          const int oxh = ox + 8 * mh;
          if (oxh < Wo && K5_ON(8)) {
            bf16* dst = orow + static_cast<size_t>(oxh) * CO + ch0;
            if (nj == kNT) {  // 16 bytes a lane, 64 a quad, 512 a warp
              __stcs(reinterpret_cast<uint4*>(dst),
                     make_uint4(v[0], v[1], v[2], v[3]));
            } else {  // the last pass of a CO that is no multiple of 32
#pragma unroll
              for (int j = 0; j < kNT; ++j)
                if (j < nj) reinterpret_cast<uint32_t*>(dst)[j] = v[j];
            }
          }
        }
      }
    }
    __syncthreads();  // the next round's loads overwrite this buffer
  }
}

template <bool kSilu>
cudaError_t launch_mma(const void* x, const void* wm, const void* bias,
                       int B, int H, int W, int CO, void* out, int device,
                       cudaStream_t st) {
  int sms = 0;
  cudaError_t e =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const int tiles_x = (W / 2 + kTW - 1) / kTW;
  const int tiles_y = (H / 2 + kTH - 1) / kTH;
  const long long ntiles = static_cast<long long>(B) * tiles_y * tiles_x;
  if (ntiles > INT_MAX) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(
      ntiles < kBlocksPerSM * sms ? ntiles : kBlocksPerSM * sms);
  stem_mma_kernel<kSilu><<<grid, kThreads, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const unsigned short*>(wm),
      static_cast<const float*>(bias), H, W, H / 2, W / 2, CO / 8, CO, tiles_x,
      tiles_y, static_cast<int>(ntiles), static_cast<bf16*>(out));
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// x (B, H, W, 3), the (112, CO) tap matrix wm in x's type, f32 bias. Variant
// 0: the CUDA-core kernel, float32 or bfloat16; 1: the tensor-core kernel,
// bfloat16 only.
extern "C" int desenet_stem_conv(const void* x, const void* wm,
                                 const void* bias, int B, int H, int W, int CO,
                                 int silu_on, int is_bf16, int variant,
                                 void* out, void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (CO <= 0 || CO % 8 || CO > kCoMax) return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  if (variant == 0)
    return is_bf16 ? launch<bf16>(x, wm, bias, B, H, W, CO, silu_on, out, st)
                   : launch<float>(x, wm, bias, B, H, W, CO, silu_on, out, st);
  if (variant != 1 || !is_bf16) return cudaErrorInvalidValue;
  return silu_on ? tc::launch_mma<true>(x, wm, bias, B, H, W, CO, out, device, st)
                 : tc::launch_mma<false>(x, wm, bias, B, H, W, CO, out, device, st);
}

// Which parts of the tensor-core kernel run (a -DK5_PROF build only; see
// tc::k5_skip). Without -DK5_PROF it does nothing.
extern "C" int desenet_stem_prof(int skip) {
#ifdef K5_PROF
  return cudaMemcpyToSymbol(tc::k5_skip, &skip, sizeof(int));
#else
  (void)skip;
  return cudaSuccess;
#endif
}
