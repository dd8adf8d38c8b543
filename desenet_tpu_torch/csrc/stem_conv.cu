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
//
// A third kernel, stem_u8_kernel, is the served stem (desenet_stem_u8): row 0
// of a fuse()'d bf16 model on the card, straight from the uploaded (B, H, W,
// 3) uint8 batch. It replaces three passes of the served program: the widen
// x.to(bf16) / 255, cuDNN's stem conv and the stem's conv_epilogue pass. Per
// value: bf16(float(u8) * (1 / 255)), bit for bit the widen (PyTorch's CUDA
// division by a scalar multiplies by its f32 reciprocal); the products of
// the unfolded bf16 weights summed in f32; eval BN's affine in f32 (one
// multiply-add); the SiLU; one rounding to bf16. Bound by the bytes of its
// output (at b128 / 640 px and CO 32, 839 MB of the 996 MB it moves; the
// uint8 input is 157 MB). CO is any multiple of 8 up to 80 (yolov5x6_seg's),
// one instantiation each. Design:
// - The tile walk and the window are tc's, on 32 x 32 pixel tiles. Each
//   tile's uint8 window arrives by 16-byte cp.async into one of two raw
//   buffers (a row starts 16 bytes left of the tile's first input byte, so
//   on a 16-byte boundary wherever W is a multiple of 16; plain byte loads
//   otherwise) while the tile before is multiplied, and is widened once into
//   the bf16 window that the A loads read.
// - The products run on Hopper's warpgroup MMA (wgmma, m64 x CO x k16, seven
//   k steps): a job is 64 pixels, two rows of 32, and all CO channels at
//   once, as up to three wgmma widths (64, 32, 16, 8). A comes from
//   registers, loaded as tc's A fragments (one 32-bit shared load a
//   register, K ordered (ky, kx * 3 + c)), once a pixel whatever CO is; B,
//   the tap matrix, lies in shared memory in wgmma's K-major layout, read by
//   the tensor cores through a descriptor. (mma.sync, tc's design, loads A
//   again for every four n8 tiles and B for every 32 pixels: 38-46% of the
//   byte bound on an NVIDIA H100 80GB HBM3 at 700 W.) Up to CO 32 a
//   warpgroup's next job runs under this job's epilogue.
// - B's columns are dealt so that each lane's D fragment holds neighbouring
//   channels of its pixels; a warp writes its 16 pixels' CO channels into
//   shared memory as they lie in global memory, and one lane hands them to
//   the bulk copy unit (cp.async.bulk): the 839 MB of stores leave no store
//   instruction in the warps' stream.
// - The SiLU is x sigmoid(x) = h + h tanh(h), h = x / 2, with tanh.approx.f32
//   (K5's form): one special-function operation a value, about 2^-11
//   relative error in tanh before the one rounding, a quarter of a bf16
//   half ulp. conv_epilogue.cu's v / (1 + exp(-v)) takes two (ex2, rcp):
//   at b128 / 640 px it reached 55-59% of the byte bound at CO 32 against
//   61-62% (65% against 74% at CO 64, 65% against 79% at CO 80).
// Dynamic shared memory: the window, the two raw buffers, B, the halved f32
// scale and shift, the warps' pixels (98 KB at CO 80: two blocks an SM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
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

// ---- the served stem: uint8 in, BN and SiLU inside (bf16) ------------------

namespace u8 {

using tc::kKSteps;
using tc::kPitch;
using tc::kThreads;
using tc::kTW;
using tc::kWarps;

constexpr int kTH = 32;  // output rows of a tile (tc's: 16)
constexpr int kWinRows = 2 * kTH + 4;
constexpr int kCoMax = 80;
// A raw row holds the image bytes from 16 before the tile's first input
// byte (the padding column 2 ox0 - 2's) on: kPitch / 2 of them, as many as
// the window row's bf16 values, which start at the same image byte.
constexpr int kLead = 16;
constexpr int kRawPitch = kPitch / 2;         // bytes of a raw row
constexpr int kWinBytes = kWinRows * kPitch;  // the bf16 window
constexpr int kRawBytes = kWinRows * kRawPitch;
constexpr int kFirst = 2 * (kLead - 6);  // window byte of column 2 ox0 - 2
constexpr int kJobs = kTH / 2 / (kWarps / 4);  // row pairs a warpgroup takes
// Up to this CO a warpgroup's next job runs on the tensor cores under this
// job's epilogue (two accumulator sets), and each lane keeps the scale and
// shift of its channels in registers; wider, both would spill.
constexpr int kPipeCoMax = 32;
constexpr float kInv255 = 1.0f / 255.0f;

// bytes: the window, two raw windows, B (7 k16 steps of 16 x CO bf16), the
// halved f32 scale and shift, each warp's 16 output pixels
inline size_t smem_bytes(int co) {
  return kWinBytes + 2 * kRawBytes + static_cast<size_t>(kKSteps) * 32 * co +
         8 * co + static_cast<size_t>(kWarps) * 32 * co;
}

// byte i of w as bf16(float(byte) * (1 / 255)): 2^23 + byte assembled as a
// float's bits, less 2^23, is the byte exactly
__device__ __forceinline__ float widen(uint32_t w, int i) {
  const float v = __fsub_rn(
      __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | i)), 8388608.0f);
  return __fmul_rn(v, kInv255);
}

// From the sum y and the halved constants: h = (y scale + shift) / 2 (one
// multiply-add, exactly half of the affine's), then v sigmoid(v) = h + h
// tanh(h), or 2 h = v without the SiLU.
__device__ __forceinline__ float finish(float y, float s2, float b2,
                                        bool silu) {
  const float h = fmaf(y, s2, b2);
  return silu ? fmaf(h, tc::tanh_f32(h), h) : h + h;
}

// D (64 x N, f32) += A (64 x 16 bf16, this warp's 16 rows in registers, as
// mma.sync's A fragment) * B (16 x N bf16 in shared memory, by descriptor);
// acc 0 overwrites D. One warpgroup, asynchronous: wgmma.fence before,
// commit and wait after.
template <int N>
struct Wg;

template <>
struct Wg<8> {
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
  }
};

template <>
struct Wg<16> {
  static __device__ __forceinline__ void mma(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
  }
};

template <>
struct Wg<32> {
  static __device__ __forceinline__ void mma(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
  }
};

template <>
struct Wg<64> {
  static __device__ __forceinline__ void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
  }
};

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void keep(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// B in shared memory for one k16 step and N columns, K-major without
// swizzle: core matrices of 8 columns x 8 k (16 bytes a column), the two k
// halves 128 bytes apart (LBO), consecutive 8-column groups 256 bytes apart
// (SBO)
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(128 >> 4) << 16 |
         static_cast<uint64_t>(256 >> 4) << 32;
}

// CO's columns as up to three wgmma widths (64, 32, 16, 8), widest first
template <int CO>
struct Split {
  static constexpr int w(int c) {
    return c >= 64 ? 64 : c >= 32 ? 32 : c >= 16 ? 16 : c >= 8 ? 8 : 0;
  }
  static constexpr int p0 = w(CO);
  static constexpr int p1 = w(CO - p0);
  static constexpr int p2 = w(CO - p0 - p1);
  static_assert(p0 + p1 + p2 == CO, "CO is no sum of three widths");
};

// A job's accumulators: D of each piece, N / 2 floats a thread
template <int CO>
struct Acc {
  using S = Split<CO>;
  float d0[S::p0 / 2], d1[S::p1 ? S::p1 / 2 : 1], d2[S::p2 ? S::p2 / 2 : 1];

  // the seven k16 steps of a job on A (this warp's registers) and B
  // (bdesc: its descriptor at step 0), issued and committed, not waited
  // for; step 0 overwrites D. Each step's and piece's descriptor is bdesc
  // plus its start address's offset (16-byte units in the low bits), made
  // here from a bdesc the compiler cannot see through, so that it does not
  // hoist the 14 of CO 80 (28 registers) out of the job loop.
  __device__ __forceinline__ void issue(const uint32_t (&a)[kKSteps][4],
                                        uint64_t bdesc) {
    asm volatile("" : "+l"(bdesc));
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      const uint64_t dk = bdesc + 2 * CO * ks;
      Wg<S::p0>::mma(d0, a[ks], dk, ks);
      if constexpr (S::p1 > 0) Wg<S::p1>::mma(d1, a[ks], dk + 2 * S::p0, ks);
      if constexpr (S::p2 > 0)
        Wg<S::p2>::mma(d2, a[ks], dk + 2 * (S::p0 + S::p1), ks);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  }

  // after the wait: the values are read from here on, not before
  __device__ __forceinline__ void keep() {
    u8::keep(d0);
    if constexpr (S::p1 > 0) u8::keep(d1);
    if constexpr (S::p2 > 0) u8::keep(d2);
  }
};

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Output channel of B column n (of CO) in the pieces of widths p0, p1, p2:
// column 8 j + c of the piece (n0, P) is channel n0 + 2 (P / 8) (c / 2) +
// 2 j + c % 2, so that lane 4 g + t, whose D fragment holds columns 8 j + 2 t
// and 8 j + 2 t + 1 of every block j, holds the 2 P / 8 neighbouring
// channels from n0 + P t / 4.
__device__ __forceinline__ int b_channel(int n, int p0, int p1, int p2) {
  const int n0 = n < p0 ? 0 : n < p0 + p1 ? p0 : p0 + p1;
  const int nb = (n < p0 ? p0 : n < p0 + p1 ? p1 : p2) / 8;
  const int j = (n - n0) / 8, c = (n - n0) % 8;
  return n0 + 2 * nb * (c >> 1) + 2 * j + (c & 1);
}

// The lane's 2 P / 8 channels of its pixels g and g + 8 (words v[0], v[1])
// into the staged pixels at px (pixel g's). A pixel's channels are 2 CO
// bytes apart; where that puts the two pixels of a quarter warp on the same
// banks (P 64), odd pixels store their 16-byte pieces in turned order.
template <int P>
__device__ __forceinline__ void stage_piece(const uint32_t (&v)[2][P / 8],
                                            unsigned char* px, int co,
                                            int c0, int g) {
  constexpr int kNB = P / 8;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    unsigned char* dst = px + 2 * (8 * h * co + c0);
    if constexpr (kNB == 8) {
      const uint4 lo = make_uint4(v[h][0], v[h][1], v[h][2], v[h][3]);
      const uint4 hi = make_uint4(v[h][4], v[h][5], v[h][6], v[h][7]);
      const bool odd = g & 1;
      *reinterpret_cast<uint4*>(dst + (odd ? 16 : 0)) = odd ? hi : lo;
      *reinterpret_cast<uint4*>(dst + (odd ? 0 : 16)) = odd ? lo : hi;
    } else if constexpr (kNB % 4 == 0) {
#pragma unroll
      for (int j = 0; j < kNB; j += 4)
        *reinterpret_cast<uint4*>(dst + 4 * j) =
            make_uint4(v[h][j], v[h][j + 1], v[h][j + 2], v[h][j + 3]);
    } else if constexpr (kNB % 2 == 0) {
#pragma unroll
      for (int j = 0; j < kNB; j += 2)
        *reinterpret_cast<uint2*>(dst + 4 * j) =
            make_uint2(v[h][j], v[h][j + 1]);
    } else {
#pragma unroll
      for (int j = 0; j < kNB; ++j)
        reinterpret_cast<uint32_t*>(dst)[j] = v[h][j];
    }
  }
}

// One piece of P columns from N0: the lane's 2 P / 8 channels of its two
// pixels through the epilogue, packed, into the warp's staged pixels (px:
// its pixel g). Each channel pair's halved scale and shift come once, from
// the lane's registers (rs, rb: its CO / 8 pairs, where kReg) or from
// shared memory.
template <int P, int N0, bool kReg, int NC>
__device__ __forceinline__ void finish_piece(const float (&d)[P / 2],
                                             const float* sc, const float* sh,
                                             const float2 (&rs)[NC],
                                             const float2 (&rb)[NC], bool silu,
                                             unsigned char* px, int co, int g,
                                             int t) {
  constexpr int kNB = P / 8;
  const int c0 = N0 + 2 * kNB * t;
  uint32_t v[2][kNB];
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    float2 s, b;
    if constexpr (kReg) {
      s = rs[N0 / 8 + j];
      b = rb[N0 / 8 + j];
    } else {
      s = *reinterpret_cast<const float2*>(sc + c0 + 2 * j);
      b = *reinterpret_cast<const float2*>(sh + c0 + 2 * j);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      v[h][j] = tc::pack2(finish(d[4 * j + 2 * h], s.x, b.x, silu),
                          finish(d[4 * j + 2 * h + 1], s.y, b.y, silu));
  }
  stage_piece<P>(v, px, co, c0, g);
}

// Hopper's bulk copy (the TMA unit) of ``bytes`` from shared memory to
// global memory, in this thread's bulk group; both addresses 16-byte
// aligned, ``bytes`` a multiple of 16.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// x: (B, H, W, 3) uint8; wm: the public (112, CO) tap matrix, bf16 bit
// patterns; scale, shift: CO f32; out (B, H/2, W/2, CO) bf16. vec: 16-byte
// copies of the window (W % 16 == 0, x 16-byte aligned), else byte loads.
// A block's two warpgroups take kJobs row pairs of each tile each; a job is
// one m64 product: warp w of the group takes 16 pixels of row 2 pair + w / 2
// (from pixel 16 (w % 2)).
template <int CO>
__global__ void __launch_bounds__(kThreads, 2)
    stem_u8_kernel(const uint8_t* __restrict__ x,
                   const unsigned short* __restrict__ wm,
                   const float* __restrict__ scale,
                   const float* __restrict__ shift, int H, int W, int Ho,
                   int Wo, int tiles_x, int tiles_y, int ntiles, int vec,
                   int silu_on, bf16* __restrict__ out) {
  using S = Split<CO>;
  // two accumulator sets where they fit in 128 registers with the A
  // fragments (28) and the epilogue's
  constexpr bool kPipe = CO <= kPipeCoMax;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* win = smem;
  unsigned char* raw = smem + kWinBytes;
  unsigned char* bsm = raw + 2 * kRawBytes;
  float* sc = reinterpret_cast<float*>(bsm + kKSteps * 32 * CO);
  float* sh = sc + CO;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int grp = warp >> 2, w = warp & 3;
  const bool silu = silu_on != 0;
  // this warp's 16 output pixels, as they lie in global memory
  unsigned char* px_s = reinterpret_cast<unsigned char*>(sh + CO) + warp * 32 * CO;

  for (int e = tid; e < CO; e += kThreads) {  // halved: h = v / 2 (finish)
    sc[e] = 0.5f * scale[e];
    sh[e] = 0.5f * shift[e];
  }
  // B: 16 bytes (8 k of one column) a thread at a time; region of k16 step
  // ks at 32 CO ks, piece from column n0 at + 32 n0, core (q, h) at + 256 q
  // + 128 h, column 8 q + i at + 16 i
  for (int e = tid; e < kKSteps * 2 * CO; e += kThreads) {
    const int ks = e / (2 * CO), r = e - ks * 2 * CO;
    const int h = r / CO, n = r - h * CO;  // k half, column
    const int ch = b_channel(n, S::p0, S::p1, S::p2);
    const int k0 = 16 * ks + 8 * h;
    uint32_t q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      q[i] = tc::tap(wm, CO, k0 + 2 * i, ch) |
             static_cast<uint32_t>(tc::tap(wm, CO, k0 + 2 * i + 1, ch)) << 16;
    *reinterpret_cast<uint4*>(bsm + 32 * CO * ks + 256 * (n >> 3) +
                              128 * h + 16 * (n & 7)) =
        make_uint4(q[0], q[1], q[2], q[3]);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  // the lane's CO / 8 channel pairs: pair j of piece (n0, P) is channels
  // n0 + 2 (P / 8) t + 2 j, + 1
  float2 rs[kPipe ? CO / 8 : 1], rb[kPipe ? CO / 8 : 1];
  if constexpr (kPipe) {
#pragma unroll
    for (int i = 0; i < CO / 8; ++i) {
      const int n0 = i < S::p0 / 8 ? 0 : i < (S::p0 + S::p1) / 8 ? S::p0
                                                                 : S::p0 + S::p1;
      const int P = i < S::p0 / 8 ? S::p0 : i < (S::p0 + S::p1) / 8 ? S::p1
                                                                    : S::p2;
      const int c = n0 + 2 * (P / 8) * t + 2 * (i - n0 / 8);
      rs[i] = make_float2(0.5f * scale[c], 0.5f * scale[c + 1]);
      rb[i] = make_float2(0.5f * shift[c], 0.5f * shift[c + 1]);
    }
  }

  // a tile's raw window into buffer buf, zero outside the image
  auto stage = [&](int tile, int buf) {
    const int tx = tile % tiles_x;
    const int rest = tile / tiles_x;
    const int ty = rest % tiles_y;
    const int b = rest / tiles_y;
    const uint8_t* xb = x + static_cast<size_t>(b) * H * W * 3;
    const int iy0 = 2 * ty * kTH - 2;
    const int e0 = 6 * tx * kTW - kLead;  // first byte, in the image row
    unsigned char* dst = raw + buf * kRawBytes;
    if (vec) {
      constexpr int kPerRow = kRawPitch / 16;
      for (int e = tid; e < kWinRows * kPerRow; e += kThreads) {
        const int r = e / kPerRow;
        const int iy = iy0 + r;
        const int el = e0 + 16 * (e - r * kPerRow);
        const bool ok = iy >= 0 && iy < H && el >= 0 && el < 3 * W;
        const uint8_t* src = ok ? xb + static_cast<size_t>(iy) * W * 3 + el : xb;
        mma::cp_async16(mma::smem_addr(dst + 16 * e), src, ok);
      }
    } else {
      for (int e = tid; e < kRawBytes; e += kThreads) {
        const int r = e / kRawPitch;
        const int iy = iy0 + r;
        const int el = e0 + (e - r * kRawPitch);
        const bool ok = iy >= 0 && iy < H && el >= 0 && el < 3 * W;
        dst[e] = ok ? xb[static_cast<size_t>(iy) * W * 3 + el] : 0;
      }
    }
  };

  const uint64_t bdesc = b_desc(mma::smem_addr(bsm));
  int tile = blockIdx.x;
  if (tile < ntiles) stage(tile, 0);
  mma::cp_async_commit();
  for (int it = 0; tile < ntiles; tile += gridDim.x, ++it) {
    const int buf = it & 1;
    mma::cp_async_wait<0>();
    __syncthreads();  // raw[buf] is in; the last tile is done with win
    {  // widen: 4 bytes -> 4 bf16 a step
      const uint32_t* src =
          reinterpret_cast<const uint32_t*>(raw + buf * kRawBytes);
      for (int e = tid; e < kRawBytes / 4; e += kThreads) {
        const int r = e / (kRawPitch / 4), q = e - r * (kRawPitch / 4);
        const uint32_t v = src[e];
        *reinterpret_cast<uint2*>(win + r * kPitch + 8 * q) =
            make_uint2(tc::pack2(widen(v, 0), widen(v, 1)),
                       tc::pack2(widen(v, 2), widen(v, 3)));
      }
    }
    // raw[buf ^ 1] was widened before the barrier above
    if (tile + gridDim.x < ntiles) stage(tile + gridDim.x, buf ^ 1);
    mma::cp_async_commit();
    __syncthreads();  // the window is widened

    const int tx = tile % tiles_x;
    const int rest = tile / tiles_x;
    const int ty = rest % tiles_y;
    const int b = rest / tiles_y;
    const int px0 = tx * kTW + 16 * (w & 1);  // this warp's first pixel
    const int npx = min(16, Wo - px0);         // of them in the map
    // row of job j for this warp, and its A fragments
    auto row = [&](int j) { return 2 * (grp * kJobs + j) + (w >> 1); };
    // job j's A fragments
    auto load_a = [&](uint32_t (&a)[kKSteps][4], int j) {
      // this lane's pixel g of the warp's 16, at its pair 2t of a k16 step
      const unsigned char* pa =
          win + 2 * row(j) * kPitch + kFirst + (16 * (w & 1) + g) * 12 + t * 4;
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        const uint32_t o0 = tc::a_offset(16 * ks, t);
        const uint32_t o1 = tc::a_offset(16 * ks + 8, t);
        a[ks][0] = *reinterpret_cast<const uint32_t*>(pa + o0);
        a[ks][1] = *reinterpret_cast<const uint32_t*>(pa + 96 + o0);
        // k >= 108 (the last step's lanes t >= 2) is the padding, zero
        const bool pad = ks == kKSteps - 1 && t >= 2;
        a[ks][2] = pad ? 0u : *reinterpret_cast<const uint32_t*>(pa + o1);
        a[ks][3] = pad ? 0u : *reinterpret_cast<const uint32_t*>(pa + 96 + o1);
      }
    };
    // job j's epilogue: its pixels through BN and SiLU into px_s, then to
    // global memory by the bulk copy unit
    auto finish_job = [&](const Acc<CO>& acc, int j) {
      const int oy = ty * kTH + row(j);
      if (oy >= Ho || npx <= 0) return;  // uniform over the warp
      // the warp's last bulk store has left px_s
      if (lane == 0)
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      __syncwarp();
      unsigned char* px = px_s + g * 2 * CO;  // pixels g and g + 8
      // the narrow pieces first: their registers are free before the
      // widest's 2 x 8 packed words are made (at CO 80 the other order
      // spills)
      if constexpr (S::p2 > 0)
        finish_piece<S::p2, S::p0 + S::p1, kPipe>(acc.d2, sc, sh, rs, rb,
                                                  silu, px, CO, g, t);
      if constexpr (S::p1 > 0)
        finish_piece<S::p1, S::p0, kPipe>(acc.d1, sc, sh, rs, rb, silu, px,
                                          CO, g, t);
      finish_piece<S::p0, 0, kPipe>(acc.d0, sc, sh, rs, rb, silu, px, CO, g,
                                    t);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0)
        bulk_store(out + ((static_cast<size_t>(b) * Ho + oy) * Wo + px0) * CO,
                   mma::smem_addr(px_s), npx * CO * 2);
    };
    uint32_t a[kKSteps][4];
    if constexpr (kPipe) {
      // job j + 1's products on the tensor cores under job j's epilogue
      Acc<CO> acc[2];
      load_a(a, 0);
      acc[0].issue(a, bdesc);
      wg_wait<0>();
      acc[0].keep();
#pragma unroll
      for (int j = 0; j < kJobs; ++j) {
        Acc<CO>& next = acc[(j + 1) & 1];
        if (j + 1 < kJobs) {
          load_a(a, j + 1);
          next.issue(a, bdesc);
        }
        finish_job(acc[j & 1], j);
        if (j + 1 < kJobs) {
          wg_wait<0>();
          next.keep();
        }
      }
    } else {
#pragma unroll 1
      for (int j = 0; j < kJobs; ++j) {
        Acc<CO> acc;
        load_a(a, j);
        acc.issue(a, bdesc);
        wg_wait<0>();
        acc.keep();
        finish_job(acc, j);
      }
    }
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int CO>
cudaError_t launch(const void* x, const void* wm, const void* scale,
                   const void* shift, int B, int H, int W, int vec, int silu,
                   void* out, int device, cudaStream_t st) {
  int sms = 0;
  cudaError_t e =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const size_t smem = smem_bytes(CO);
  auto kernel = stem_u8_kernel<CO>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles_x = (W / 2 + kTW - 1) / kTW;
  const int tiles_y = (H / 2 + kTH - 1) / kTH;
  const long long ntiles = static_cast<long long>(B) * tiles_y * tiles_x;
  if (ntiles > INT_MAX) return cudaErrorInvalidValue;
  const long long full = static_cast<long long>(per_sm) * sms;
  const int grid = static_cast<int>(ntiles < full ? ntiles : full);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const uint8_t*>(x), static_cast<const unsigned short*>(wm),
      static_cast<const float*>(scale), static_cast<const float*>(shift), H,
      W, H / 2, W / 2, tiles_x, tiles_y, static_cast<int>(ntiles), vec, silu,
      static_cast<bf16*>(out));
  return cudaGetLastError();
}

template <int CO = 8>
cudaError_t dispatch(int co, const void* x, const void* wm, const void* scale,
                     const void* shift, int B, int H, int W, int vec, int silu,
                     void* out, int device, cudaStream_t st) {
  if (co == CO)
    return launch<CO>(x, wm, scale, shift, B, H, W, vec, silu, out, device,
                      st);
  if constexpr (CO < kCoMax)
    return dispatch<CO + 8>(co, x, wm, scale, shift, B, H, W, vec, silu, out,
                            device, st);
  return cudaErrorInvalidValue;
}

}  // namespace u8

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

// The served stem: x (B, H, W, 3) uint8, H and W even; the (112, CO) tap
// matrix wm in bf16 of the conv's unfolded weights, CO a multiple of 8 up to
// 80; eval BN's scale and shift, CO f32 each; out (B, H/2, W/2, CO) bf16,
// 16-byte aligned. vec: 16-byte copies (W a multiple of 16, x 16-byte
// aligned; the wrapper checks), else byte loads.
extern "C" int desenet_stem_u8(const void* x, const void* wm,
                               const void* scale, const void* shift, int B,
                               int H, int W, int CO, int silu_on, int vec,
                               void* out, void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (CO <= 0 || CO % 8 || CO > u8::kCoMax || H % 2 || W % 2)
    return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return cudaSuccess;
  return u8::dispatch(CO, x, wm, scale, shift, B, H, W, vec, silu_on, out,
                      device, static_cast<cudaStream_t>(stream));
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
