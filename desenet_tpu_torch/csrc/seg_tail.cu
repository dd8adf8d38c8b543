// K2: the seg tail, argmax_c(bilinear_upsample(logits, 8x, align_corners)),
// writing only the uint8 class map.
//
// Replaces: desenet_tpu/ops/seg_pallas.py, _kernel (called through
// upsample_argmax), a Pallas TPU kernel that forms each channel's upsampled
// plane as two matrix products with the _linear_matrix interpolation
// matrices (row pass, then column pass) and keeps a running argmax, so the
// full-resolution logits never reach HBM.
//
// What bounds it on the H100: by the bytes it must move, memory: at B = 128
// the input is (128, 80, 80, 3) bf16, 4.9 MB, and the output (128, 640, 640)
// uint8 is 52.4 MB, about 17 us at 3.35 TB/s. In practice the instructions
// executed per output pixel bound it: the blend and the running argmax are
// six instructions a pixel and channel that nothing can fuse (the products
// and the sum stay apart so that every value is bit for bit the plain
// version's), half of them on the card's half-rate compare/select pipe, and
// whatever finds a pixel's taps comes on top. (The matrix formulation is a
// TPU matrix-unit artifact: with two non-zero taps per output row and column,
// a product over the whole input axis wastes all but two terms.)
//
// What the design does about it. The taps are the host's, from the same
// _linear_matrix numbers: per output row and column two source indices and
// two f32 weights. Two kernels, chosen by the wrapper from the shape alone:
//
// - seg_tail_span_kernel (variant "span"): one thread a source column k and
//   output row. The output pixels whose left tap is column k are a run
//   [seg[k], seg[k + 1]) of at most kSpanRun = 9 pixels (8 or 9 at scale 8
//   with align_corners), and all of them blend the same two source columns, k
//   and k + 1. So the thread blends those two columns' source rows once per
//   channel (the y pass), and a pixel is two products, a sum, a compare and
//   two selects per channel with every operand in a register at a fixed
//   place: no table look-up, no division and no select between columns per
//   pixel. The x weights of the run are loaded once and kept for the rows a
//   thread makes (rpt of them). Channels run in a loop, with kSpanRun
//   running maxima and arguments in registers, so any C up to 256 works. The
//   class bytes go to a shared-memory tile of whole output rows, which the
//   block then stores as uint4: a warp writes 512 contiguous bytes. A pixel
//   that sits exactly on column k has one tap: the table gives it column k
//   again with weight 0. The wrapper takes only taps where such a pixel is
//   the first of its run, and the first pixel takes column k in the place of
//   k + 1 when its second weight is 0
//   (one select a channel, not a pixel), and the last column is its own
//   neighbour: an infinite or NaN logit in column k + 1 then reaches no
//   pixel that the plain version keeps it from.
//   Takes: W a multiple of 16, w <= 512, runs of at most 9 pixels, every
//   second tap the next column, or of weight 0 on the first pixel of a run
//   or in the last column. Blocks of (w, G) threads make G * rpt whole
//   output rows: (80, 2) threads and 16 rows at the served shape.
// - seg_tail_pixel_kernel (variant "pixel"): one thread an output pixel, four
//   table reads and 4 C loads each, one byte stored. Takes every shape.
//
// Both do the y pass first, then x, in f32, with a strict > running argmax
// (the first channel wins ties, as jnp.argmax). The _rn intrinsics stop nvcc
// from fusing multiply-adds, so every value is bit for bit the plain PyTorch
// version's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;      // the pixel kernel's block
constexpr int kSpanThreads = 512;  // the span kernel's largest block
constexpr int kSpanRun = 9;        // and its longest run of pixels a column

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ float lerp2(const T* a, const T* b, float wa,
                                       float wb) {
  return __fadd_rn(__fmul_rn(load_f32(a), wa), __fmul_rn(load_f32(b), wb));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    seg_tail_pixel_kernel(const T* __restrict__ x,        // (B, h, w, C)
                          const int* __restrict__ ys,     // (H, 2) source rows
                          const float* __restrict__ wy,   // (H, 2) row weights
                          const int* __restrict__ xs,     // (W, 2) source columns
                          const float* __restrict__ wx,   // (W, 2) column weights
                          int B, int h, int w, int C, int H, int W,
                          uint8_t* __restrict__ out) {    // (B, H, W)
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<long long>(B) * H * W) return;
  const int ox = static_cast<int>(idx % W);
  const long long t = idx / W;
  const int oy = static_cast<int>(t % H);
  const int b = static_cast<int>(t / H);
  const int y0 = ys[2 * oy], y1 = ys[2 * oy + 1];
  const float wy0 = wy[2 * oy], wy1 = wy[2 * oy + 1];
  const int x0 = xs[2 * ox], x1 = xs[2 * ox + 1];
  const float wx0 = wx[2 * ox], wx1 = wx[2 * ox + 1];
  const T* img = x + static_cast<size_t>(b) * h * w * C;
  const T* p00 = img + (static_cast<size_t>(y0) * w + x0) * C;
  const T* p10 = img + (static_cast<size_t>(y1) * w + x0) * C;
  const T* p01 = img + (static_cast<size_t>(y0) * w + x1) * C;
  const T* p11 = img + (static_cast<size_t>(y1) * w + x1) * C;
  float best = 0.f;
  int arg = 0;
  for (int c = 0; c < C; ++c) {
    const float r0 = lerp2(p00 + c, p10 + c, wy0, wy1);  // row pass, column x0
    const float r1 = lerp2(p01 + c, p11 + c, wy0, wy1);  // row pass, column x1
    const float v = __fadd_rn(__fmul_rn(r0, wx0), __fmul_rn(r1, wx1));
    if (c == 0 || v > best) {
      best = v;
      arg = c;
    }
  }
  out[idx] = static_cast<uint8_t>(arg);
}

// blockDim = (w, G): thread (k, g) makes the run of source column k in the
// rows g, g + G, ... of a tile of G * rpt output rows; blockIdx.x = image *
// tiles + tile. Dynamic shared memory: G * rpt * W bytes.
template <typename T>
__global__ void __launch_bounds__(kSpanThreads)
    seg_tail_span_kernel(const T* __restrict__ x,          // (B, h, w, C)
                         const int2* __restrict__ ys,      // (H,) source rows
                         const float2* __restrict__ wy,    // (H,) row weights
                         const int* __restrict__ seg,      // (w + 1,) run starts
                         const float2* __restrict__ wx,    // (W,) column weights
                         int h, int w, int C, int H, int W, int rpt,
                         uint8_t* __restrict__ out) {      // (B, H, W)
  extern __shared__ __align__(16) uint8_t tile[];          // (G * rpt, W)
  const int k = threadIdx.x;
  const int g = threadIdx.y;
  const int G = blockDim.y;
  const int rows_tile = G * rpt;
  const int tiles = (H + rows_tile - 1) / rows_tile;
  const int b = blockIdx.x / tiles;
  const int oy0 = (blockIdx.x - b * tiles) * rows_tile;

  const int p0 = seg[k];
  const int cnt = seg[k + 1] - p0;
  float w0[kSpanRun], w1[kSpanRun];
#pragma unroll
  for (int p = 0; p < kSpanRun; ++p) {
    const float2 t = p < cnt ? wx[p0 + p] : make_float2(0.f, 0.f);
    w0[p] = t.x;
    w1[p] = t.y;
  }
  const bool one_tap = w1[0] == 0.f;       // the first pixel sits on column k
  const int wC = w * C;
  const int ck = k * C;                    // column k
  const int cq = min(k + 1, w - 1) * C;    // column k + 1
  const T* img = x + static_cast<size_t>(b) * h * wC;

  for (int i = 0; i < rpt; ++i) {
    const int r = i * G + g;
    const int oy = oy0 + r;
    if (oy >= H) break;
    const int2 yy = ys[oy];
    const float2 ww = wy[oy];
    const T* r0 = img + static_cast<size_t>(yy.x) * wC;  // the two source rows
    const T* r1 = img + static_cast<size_t>(yy.y) * wC;
    float best[kSpanRun];
    int arg[kSpanRun];
    {
      const float a = lerp2(r0 + ck, r1 + ck, ww.x, ww.y);  // row pass, column k
      const float q = lerp2(r0 + cq, r1 + cq, ww.x, ww.y);  // and column k + 1
      const float q0 = one_tap ? a : q;
#pragma unroll
      for (int p = 0; p < kSpanRun; ++p) {
        best[p] = __fadd_rn(__fmul_rn(a, w0[p]),
                            __fmul_rn(p == 0 ? q0 : q, w1[p]));
        arg[p] = 0;
      }
    }
    for (int c = 1; c < C; ++c) {
      const float a = lerp2(r0 + ck + c, r1 + ck + c, ww.x, ww.y);
      const float q = lerp2(r0 + cq + c, r1 + cq + c, ww.x, ww.y);
      const float q0 = one_tap ? a : q;
#pragma unroll
      for (int p = 0; p < kSpanRun; ++p) {
        const float v = __fadd_rn(__fmul_rn(a, w0[p]),
                                  __fmul_rn(p == 0 ? q0 : q, w1[p]));
        if (v > best[p]) {
          best[p] = v;
          arg[p] = c;
        }
      }
    }
    uint8_t* dst = tile + r * W + p0;
#pragma unroll
    for (int p = 0; p < kSpanRun; ++p)
      if (p < cnt) dst[p] = static_cast<uint8_t>(arg[p]);
  }
  __syncthreads();
  // the tile's rows are one contiguous range of the output
  const int rows = min(rows_tile, H - oy0);
  const int n16 = rows * (W / 16);
  uint4* o = reinterpret_cast<uint4*>(out + (static_cast<size_t>(b) * H + oy0) * W);
  const uint4* s = reinterpret_cast<const uint4*>(tile);
  for (int i = g * w + k; i < n16; i += w * G) o[i] = s[i];
}

template <typename T>
cudaError_t launch(const void* x, const void* ys, const void* wy,
                   const void* xs, const void* wx, const void* seg, int B,
                   int h, int w, int C, int H, int W, int variant, int G,
                   int rpt, uint8_t* out, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  if (variant == 0) {
    const long long total = static_cast<long long>(B) * H * W;
    const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
    seg_tail_pixel_kernel<T><<<blocks, kThreads, 0, s>>>(
        xt, static_cast<const int*>(ys), static_cast<const float*>(wy),
        static_cast<const int*>(xs), static_cast<const float*>(wx), B, h, w, C,
        H, W, out);
    return cudaGetLastError();
  }
  const int rows_tile = G * rpt;
  const size_t smem = static_cast<size_t>(rows_tile) * W;
  if (variant != 1 || W % 16 != 0 || G < 1 || rpt < 1 ||
      w * G > kSpanThreads || smem > 48 * 1024 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return cudaErrorInvalidValue;
  const int tiles = (H + rows_tile - 1) / rows_tile;
  const dim3 block(w, G);
  const unsigned blocks = static_cast<unsigned>(B) * tiles;
  const int2* iy = static_cast<const int2*>(ys);
  const float2* fy = static_cast<const float2*>(wy);
  const int* sg = static_cast<const int*>(seg);
  const float2* fx = static_cast<const float2*>(wx);
  seg_tail_span_kernel<T><<<blocks, block, smem, s>>>(
      xt, iy, fy, sg, fx, h, w, C, H, W, rpt, out);
  return cudaGetLastError();
}

}  // namespace

// variant: 0 the pixel kernel (seg, G and rpt unused); 1 the span kernel, with
// blocks of (w, G) threads that make G * rpt output rows each (the caller has
// checked the runs against kSpanRun).
extern "C" int desenet_seg_tail(const void* x, int is_bf16, const void* ys,
                                const void* wy, const void* xs, const void* wx,
                                const void* seg, int B, int h, int w, int C,
                                int H, int W, int variant, int G, int rpt,
                                void* out, void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (static_cast<long long>(B) * H * W == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* o = static_cast<uint8_t*>(out);
  return is_bf16 ? launch<__nv_bfloat16>(x, ys, wy, xs, wx, seg, B, h, w, C, H,
                                         W, variant, G, rpt, o, s)
                 : launch<float>(x, ys, wy, xs, wx, seg, B, h, w, C, H, W,
                                 variant, G, rpt, o, s);
}
