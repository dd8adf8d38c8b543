// K6: a whole C3 block in one launch, BN folded into the weights:
//   y = silu(x @ w12 + b12), y1 = y[:, :c_], y2 = y[:, c_:]
//   n times: t = silu(y1 @ wb1[i] + bb1[i]); t2 = silu(conv3x3(t) + bb2[i]);
//            y1 = shortcut ? y1 + t2 : t2
//   out = silu([y1 | y2] @ w3 + b3)
// in NHWC, float32 or bfloat16, products summed in f32, and a rounding to the
// input type exactly where the TPU kernel rounds: y1 and y2 after the first
// SiLU, t after the bottleneck's 1x1, y1 after the residual add, the output.
//
// Replaces: tools/proto_c3_kernel.py, _c3_kernel (called through
// c3_pallas), a Pallas TPU kernel that keeps one image's whole chain in VMEM
// (grid over the batch, a 100 MB VMEM limit).
//
// What bounds it on the H100: operations. At 640 px one image's chain is
// megabytes at P2/P3, far above the 227 KB of shared memory a block has, and
// the block is a chain of matrix products (K = C, c_, 9 c_, 2 c_ up to
// 2304): 644 G multiply-adds over yolov5s_seg's eight C3 rows at b128.
//
// What the design does about it, common to both kernels below:
// - One block per (image, output tile of th x tw pixels). A tile's
//   receptive field widens by one pixel for each 3x3, so the block works on
//   a frame of (th + 2n) x (tw + 2n) pixels and recomputes that halo: y1 on
//   the whole frame, the i-th bottleneck's t on the frame less i pixels at
//   each side and its 3x3 output on the frame less i + 1, y2 and the output
//   on the tile only. Every intermediate stays in shared memory: two frame
//   buffers of c_ channels in the input type (y1; t, then y2), so x is read
//   from device memory and the output written to it, and nothing else.
// - The 3x3 pads t, not y1: frame positions outside the image get t = 0
//   after the 1x1 and its SiLU, which is the TPU kernel's zero ring.
// - SiLU in f32 with correctly rounded operations (no contracted
//   multiply-add), one rounding to the output type.
// The wrapper picks the tile and the kernel (ops/c3_fused.py).
//
// c3_mma_kernel (bfloat16 with C, c_, C2 multiples of 16): every stage is a
// warp-tiled mma.sync product on the tensor cores (mma_bf16.cuh). Sixteen
// warps in eight pairs; a pair owns an item of 32 pixels x 64 output
// channels, each of its warps 32 of the channels (32 f32 accumulators a
// thread, so sixteen warps fit the registers and hide each other's
// latencies), and the block walks the stage's (pixel tile, channel tile)
// items eight at a time. A fragments come by ldmatrix straight from the frame
// buffers (rows padded by 16 bytes), a 3x3 tap or the [y1 | y2] split being
// an offset on the row address; for the two halves of cv12 each pair stages
// its 32 pixels of x, 32 channels at a time, by cp.async with zero fill
// outside the image. The weights of the channel tiles a pass needs are
// staged K-chunk by K-chunk into a double-buffered ring by cp.async (beside
// x's two stages; twice as deep, over x's stages too, where x is not
// staged), so a weight byte is read from L2 once per pass and not once per
// thread. The
// tile may be rectangular and is as large as the block's 227 KB allow next
// to the ring, one block an SM, which cuts the halo.
//
// c3_kernel (float32, and bfloat16 at other channel counts): every stage is
// one small GEMM on the CUDA cores: a thread owns 4 pixels x 8 output
// channels (32 f32 accumulators) and walks K in chunks of 8, one 16-byte
// load of activations per pixel (shared memory, or x in device memory for
// the two halves of cv12) and eight 16-byte loads of weights per chunk,
// read through L1/L2. It keeps float32 parity at 1e-6 with the plain
// version, which TF32 tensor cores would not; its tile is square and its two
// buffers take at most 110 KB, two blocks per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kPM = 4;  // pixels a thread owns in a stage's GEMM
constexpr int kCN = 8;  // output channels a thread owns
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float silu(float x) {
  return __fmul_rn(x, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x))));
}

// eight consecutive values as f32
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}
// the same through the read-only path (weights)
__device__ __forceinline__ void ldg8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void ldg8(const bf16* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}
// eight values rounded to the storage type
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// One stage: acc[p][c] = sum_k A[p][k] * w[k * ldw + c] for pixels p < P and
// channels c < N (N % 8 == 0, K % 8 == 0). A's row of pixel p is
// base(p) + koff(k0) for the chunk k0..k0+7, or zeros where base(p) is null.
// epi(p, c0, acc) receives the sums of pixel p, channels c0..c0+7.
template <typename T, class Base, class KOff, class Epi>
__device__ __forceinline__ void gemm(int P, int K, int N,
                                     const T* __restrict__ w, int ldw,
                                     Base base, KOff koff, Epi epi) {
  const int ng = N / kCN;
  const int items = (P + kPM - 1) / kPM * ng;
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int c0 = (it % ng) * kCN;
    const int p0 = (it / ng) * kPM;
    const T* src[kPM];
#pragma unroll
    for (int j = 0; j < kPM; ++j) src[j] = p0 + j < P ? base(p0 + j) : nullptr;
    float acc[kPM][kCN];
#pragma unroll
    for (int j = 0; j < kPM; ++j)
#pragma unroll
      for (int c = 0; c < kCN; ++c) acc[j][c] = 0.f;
    for (int k0 = 0; k0 < K; k0 += 8) {
      const int off = koff(k0);
      float a[kPM][8];
#pragma unroll
      for (int j = 0; j < kPM; ++j) {
        if (src[j] != nullptr) {
          load8(src[j] + off, a[j]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) a[j][e] = 0.f;
        }
      }
      const T* wk = w + static_cast<size_t>(k0) * ldw + c0;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        float wv[kCN];
        ldg8(wk + static_cast<size_t>(kk) * ldw, wv);
#pragma unroll
        for (int j = 0; j < kPM; ++j)
#pragma unroll
          for (int c = 0; c < kCN; ++c) acc[j][c] = fmaf(a[j][kk], wv[c], acc[j][c]);
      }
    }
#pragma unroll
    for (int j = 0; j < kPM; ++j)
      if (p0 + j < P) epi(p0 + j, c0, acc[j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    c3_kernel(const T* __restrict__ x, const T* __restrict__ w12,
              const float* __restrict__ b12, const T* __restrict__ wb1,
              const float* __restrict__ bb1, const T* __restrict__ wb2,
              const float* __restrict__ bb2, const T* __restrict__ w3,
              const float* __restrict__ b3, int H, int W, int C, int c_,
              int C2, int n, int shortcut, int tile, int tiles_x,
              T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int R = tile + 2 * n;  // frame side
  const int frame = R * R * c_;
  T* y1 = reinterpret_cast<T*>(smem_raw);  // y1 over the frame
  T* tb = y1 + frame;                      // t over the frame, then y2
  const int b = blockIdx.y;
  const int fy = (blockIdx.x / tiles_x) * tile - n;  // image row of frame row 0
  const int fx = (blockIdx.x % tiles_x) * tile - n;
  const T* xb = x + static_cast<size_t>(b) * H * W * C;
  auto inside = [&](int ry, int rx) {
    return fy + ry >= 0 && fy + ry < H && fx + rx >= 0 && fx + rx < W;
  };
  auto x_row = [&](int ry, int rx) -> const T* {
    return inside(ry, rx)
               ? xb + (static_cast<size_t>(fy + ry) * W + fx + rx) * C
               : nullptr;
  };
  auto plain_k = [](int k0) { return k0; };

  // y1 = T(silu(x @ w12[:, :c_] + b12[:c_])) on the whole frame
  gemm<T>(R * R, C, c_, w12, 2 * c_,
          [&](int p) { return x_row(p / R, p % R); }, plain_k,
          [&](int p, int c0, const float(&acc)[kCN]) {
            float v[kCN];
#pragma unroll
            for (int c = 0; c < kCN; ++c) v[c] = silu(acc[c] + __ldg(b12 + c0 + c));
            store8(y1 + static_cast<size_t>(p) * c_ + c0, v);
          });
  __syncthreads();

  for (int i = 0; i < n; ++i) {
    // t = T(silu(y1 @ wb1[i] + bb1[i])) on [i, R - i)^2, 0 outside the image
    const int o = i;
    const int rw = R - 2 * i;
    const float* bi1 = bb1 + static_cast<size_t>(i) * c_;
    gemm<T>(rw * rw, c_, c_, wb1 + static_cast<size_t>(i) * c_ * c_, c_,
            [&](int p) -> const T* {
              return y1 + (static_cast<size_t>(o + p / rw) * R + o + p % rw) * c_;
            },
            plain_k,
            [&](int p, int c0, const float(&acc)[kCN]) {
              const int ry = o + p / rw;
              const int rx = o + p % rw;
              const bool in = inside(ry, rx);
              float v[kCN];
#pragma unroll
              for (int c = 0; c < kCN; ++c)
                v[c] = in ? silu(acc[c] + __ldg(bi1 + c0 + c)) : 0.f;
              store8(tb + (static_cast<size_t>(ry) * R + rx) * c_ + c0, v);
            });
    __syncthreads();

    // t2 = silu(conv3x3(t) + bb2[i]) on [i + 1, R - i - 1)^2;
    // y1 = T(y1 + t2) with the shortcut, else T(t2)
    const int o2 = i + 1;
    const int rw2 = rw - 2;
    const float* bi2 = bb2 + static_cast<size_t>(i) * c_;
    gemm<T>(rw2 * rw2, 9 * c_, c_, wb2 + static_cast<size_t>(i) * 9 * c_ * c_,
            c_,
            [&](int p) -> const T* {
              return tb + (static_cast<size_t>(o2 + p / rw2) * R + o2 + p % rw2) * c_;
            },
            [&](int k0) {
              const int tap = k0 / c_;
              return ((tap / 3 - 1) * R + tap % 3 - 1) * c_ + k0 - tap * c_;
            },
            [&](int p, int c0, const float(&acc)[kCN]) {
              T* dst = y1 + (static_cast<size_t>(o2 + p / rw2) * R + o2 + p % rw2) * c_ + c0;
              float v[kCN];
#pragma unroll
              for (int c = 0; c < kCN; ++c) v[c] = silu(acc[c] + __ldg(bi2 + c0 + c));
              if (shortcut) {
                float r[kCN];
                load8(dst, r);
#pragma unroll
                for (int c = 0; c < kCN; ++c) v[c] = __fadd_rn(r[c], v[c]);
              }
              store8(dst, v);
            });
    __syncthreads();
  }

  // y2 = T(silu(x @ w12[:, c_:] + b12[c_:])) on the tile, into tb at frame
  // positions, so that [y1 | y2] of a pixel is one base and two offsets
  gemm<T>(tile * tile, C, c_, w12 + c_, 2 * c_,
          [&](int p) { return x_row(n + p / tile, n + p % tile); }, plain_k,
          [&](int p, int c0, const float(&acc)[kCN]) {
            float v[kCN];
#pragma unroll
            for (int c = 0; c < kCN; ++c) v[c] = silu(acc[c] + __ldg(b12 + c_ + c0 + c));
            store8(tb + (static_cast<size_t>(n + p / tile) * R + n + p % tile) * c_ + c0, v);
          });
  __syncthreads();

  // out = T(silu([y1 | y2] @ w3 + b3)) on the tile's pixels inside the image
  gemm<T>(tile * tile, 2 * c_, C2, w3, C2,
          [&](int p) -> const T* {
            return y1 + (static_cast<size_t>(n + p / tile) * R + n + p % tile) * c_;
          },
          [&](int k0) { return k0 < c_ ? k0 : frame + k0 - c_; },
          [&](int p, int c0, const float(&acc)[kCN]) {
            const int ry = n + p / tile;
            const int rx = n + p % tile;
            if (!inside(ry, rx)) return;
            float v[kCN];
#pragma unroll
            for (int c = 0; c < kCN; ++c) v[c] = silu(acc[c] + __ldg(b3 + c0 + c));
            store8(out + ((static_cast<size_t>(b) * H + fy + ry) * W + fx + rx) * C2 + c0, v);
          });
}

// ---- the tensor-core kernel (bf16) ----------------------------------------

constexpr int kMmaThreads = 512;
constexpr int kItems = 8;  // items of a pass: 32 pixels x 64 channels each
constexpr int kMT = 2;     // 16-pixel slabs of a warp tile
constexpr int kNT = 4;     // n8 tiles of a warp tile: 32 channels; the two
                           // warps of a pair split an item's channels
constexpr int kNBlock = 256;  // channels of the widest weight stage
constexpr int kWStage = 32 * (kNBlock + mma::kPad);  // elements, one stage
constexpr int kAK = 32;  // channels of x a pair stages at a time
constexpr int kALd = kAK + mma::kPad;
constexpr int kAStage = kItems * 32 * kALd;  // elements, one stage
constexpr int kRingBytes = 2 * (kWStage + kAStage) * 2;  // 74,752

// Built with -DK6_PROF (tools/profile_c3_phases.py), thread 0 of block (0, 0)
// adds up the clock cycles it spends in each phase of mma_stage: 0 a pass's
// set-up and first loads, 1 waiting for a chunk, the barrier and the next
// load, 2 the products, 3 the barrier at the end of a pass, 4 the epilogue.
constexpr int kPhases = 5;
__device__ long long g_prof[kPhases];
#ifdef K6_PROF
#define PROF_T(i)                \
  {                              \
    const long long t_ = clock64(); \
    prof[i] += t_ - tprev;       \
    tprev = t_;                  \
  }
#else
#define PROF_T(i)
#endif

// SiLU for the tensor-core kernel, whose every result is rounded to bf16 (8
// significant bits): the special-function unit's ex2 and reciprocal, a few
// f32 ulps from silu() above at a fraction of its instructions (with silu(),
// whose division is a subroutine, the stages' epilogues took up to 60% of
// the kernel's time). Large -x: 1 + inf = inf and x / inf = -0.
__device__ __forceinline__ float silu_bf16(float x) {
  return __fdividef(x, 1.f + __expf(-x));
}

// One stage on the tensor cores: for pixels p < M and channels c < N (both
// K and N multiples of 16), v = silu(sum_k A[p][k] * w[k * ldw + c] +
// bias[c]), handed to put(row(p), c, v0, v1) for channels c and c + 1; row(p)
// is worked out once per pixel (a null row(p).dst skips the pixel). A's row
// of pixel p is either in shared memory, or, with kFromX, the global row
// xrow(p) (null: zeros), staged through the ring. In shared memory K is cut into segments
// of kper values (a multiple of 16), and value k of pixel p lies at element
// frames + pix(p) + seg(k / kper) + k % kper: a 3x3 tap or the [y1 | y2]
// split is one segment each.
template <bool kFromX, class Pix, class Seg, class XRow, class Row, class Put>
__device__ __forceinline__ void mma_stage(bf16* frames, bf16* wring,
                                          bf16* aring, int M, int K, int N,
                                          const bf16* __restrict__ w, int ldw,
                                          const float* __restrict__ bias,
                                          Pix pix, int kper, Seg seg,
                                          XRow xrow, Row row, Put put) {
  const int warp = threadIdx.x >> 6;       // the pair: one item a pass
  const int half = (threadIdx.x >> 5) & 1;  // this warp in its pair
  const int lane = threadIdx.x & 31;
  const int lrow = lane & 15;        // this lane's row in an ldmatrix tile
  const int lcol = (lane >> 4) * 8;  // and its column offset
  const uint32_t frames_a = mma::smem_addr(frames);
  const uint32_t wring_a = mma::smem_addr(wring);
  const uint32_t aring_a = mma::smem_addr(aring);
  // two weight stages: in the ring beside x's; when x is not staged, of
  // twice the size, the second where x's stages would lie, so that a chunk
  // is twice as deep and the barriers half as many
  constexpr int kWCap = kFromX ? kWStage : 2 * kWStage;  // elements a stage
  static_assert(2 * kWStage <= 2 * kAStage, "a deep weight stage fits x's ring");
  auto wstage = [&](int st) {
    return kFromX ? wring_a + st * kWStage * 2 : (st ? aring_a : wring_a);
  };
  const int n_mt = (M + 31) / 32;
#ifdef K6_PROF
  long long prof[kPhases] = {};
  long long tprev = clock64();
#endif
  for (int nb = 0; nb < N; nb += kNBlock) {
    const int nbw = min(kNBlock, N - nb);
    const int items = n_mt * ((nbw + 63) / 64);
    for (int it0 = 0; it0 < items; it0 += kItems) {
      // this pass: items it0 .. it0 + 7, item = (pixel tile, channel tile),
      // pixel tiles fastest, one item a pair of warps
      const int my = it0 + warp;
      const bool active = my < items;
      const int p0 = active ? (my % n_mt) * 32 : 0;
      const int item_n0 = nb + (active ? my / n_mt : 0) * 64;
      const int item_nnt = active ? min(8, (nb + nbw - item_n0) / 8) : 0;
      // the item's n8 tiles split between the pair, in twos: 8 -> 4 + 4,
      // 6 -> 4 + 2, 4 -> 2 + 2, 2 -> 2 + 0
      const int split = (item_nnt / 2 + 1) & ~1;
      const int n0 = item_n0 + half * split * 8;
      const int nnt = max(0, min(split, item_nnt - half * split));
      const int nmt = nnt > 0 ? (M - p0 > 16 ? 2 : 1) : 0;
      // the weight columns the pass needs
      const int last = min(items, it0 + kItems) - 1;
      const int c_lo = nb + (it0 / n_mt) * 64;
      const int ncols = min(nb + nbw, nb + (last / n_mt + 1) * 64) - c_lo;
      const int ldb = ncols + mma::kPad;
      // the weight loader's lanes: 16-byte piece sg0 of rows r0, r0 + rstep,
      // ... (the pieces of a row rounded up to a power of two, so that row
      // and piece are a shift and a mask of the thread index)
      const int segs = ncols / 8;
      const int lsegs = segs <= 8 ? 3 : segs <= 16 ? 4 : 5;
      const int r0 = threadIdx.x >> lsegs;
      const int sg0 = threadIdx.x & ((1 << lsegs) - 1);
      const int rstep = kMmaThreads >> lsegs;
      const bool loads_w = sg0 < segs;
      const bf16* wsrc = w + c_lo + sg0 * 8;
      int kc = (kWCap / ldb) & ~15;
      if (kFromX) kc = min(kc, kAK);
      kc = min(kc, K);
      const int nchunks = (K + kc - 1) / kc;

      uint32_t a_base[kMT];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        if (kFromX) {
          a_base[mt] =
              aring_a + ((warp * 32 + mt * 16 + lrow) * kALd + lcol) * 2;
        } else {
          const int p = min(p0 + mt * 16 + lrow, M - 1);
          a_base[mt] = frames_a + (pix(p) + lcol) * 2;
        }
      }
      // with kFromX: the two pixels (of the item's 32, sixteen a warp)
      // whose 16-byte pieces this lane copies
      const bf16* xsrc[2];
      if (kFromX) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int p = p0 + half * 16 + (lane >> 2) + 8 * j;
          xsrc[j] = active && p < M ? xrow(p) : nullptr;
        }
      }

      auto load = [&](int ch) {
        const int buf = ch & 1;
        const int k0 = ch * kc;
        const int kn = min(kc, K - k0);
        const uint32_t wb = wstage(buf);
        if (loads_w) {
          for (int r = r0; r < kn; r += rstep)
            mma::cp_async16(wb + (r * ldb + sg0 * 8) * 2,
                            wsrc + static_cast<size_t>(k0 + r) * ldw, true);
        }
        if (kFromX) {
          const int kk = (lane & 3) * 8;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int r = warp * 32 + half * 16 + (lane >> 2) + 8 * j;
            const bool ok = xsrc[j] != nullptr && kk < kn;
            mma::cp_async16(
                aring_a + (buf * kAStage + r * kALd + kk) * 2,
                ok ? static_cast<const void*>(xsrc[j] + k0 + kk) : w, ok);
          }
        }
        mma::cp_async_commit();
      };

      float acc[kMT][kNT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

      // one chunk in flight; one barrier a chunk: after it chunk ch has
      // landed for every thread and every warp is done with chunk ch - 1,
      // whose stage the next load takes
      load(0);
      PROF_T(0)
      for (int ch = 0; ch < nchunks; ++ch) {
        mma::cp_async_wait<0>();
        __syncthreads();
        if (ch + 1 < nchunks) load(ch + 1);
        PROF_T(1)
        if (nnt > 0) {
          const int buf = ch & 1;
          const int k0 = ch * kc;
          const int kn = min(kc, K - k0);
          // the k16 steps of the chunk: between two steps only the three
          // addresses move (without this the loop's own arithmetic, not
          // the tensor cores, set the pace)
          uint32_t wb = wstage(buf) + (lrow * ldb + n0 - c_lo + lcol) * 2;
          const uint32_t wstep = 32 * ldb;  // 16 rows of the weight stage
          uint32_t aa[kMT];
          if (kFromX) {
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt)
              aa[mt] = a_base[mt] + buf * kAStage * 2;
#pragma unroll 2
            for (int kk = 0; kk < kn; kk += 16) {
              mma::warp_mma_k16<kMT, kNT>(acc, aa, wb, nmt, nnt);
#pragma unroll
              for (int mt = 0; mt < kMT; ++mt) aa[mt] += 32;
              wb += wstep;
            }
          } else {
            int sg = k0 / kper;
            int within = k0 - sg * kper;
            for (int kk = 0; kk < kn;) {
              // the part of the chunk that lies in segment sg
              const int run = min(kper - within, kn - kk);
              const int off = (seg(sg) + within) * 2;
#pragma unroll
              for (int mt = 0; mt < kMT; ++mt) aa[mt] = a_base[mt] + off;
#pragma unroll 2
              for (int j = 0; j < run; j += 16) {
                mma::warp_mma_k16<kMT, kNT>(acc, aa, wb, nmt, nnt);
#pragma unroll
                for (int mt = 0; mt < kMT; ++mt) aa[mt] += 32;
                wb += wstep;
              }
              kk += run;
              within = 0;  // the segment ended here, or the chunk did
              ++sg;
            }
          }
        }
        PROF_T(2)
      }
      __syncthreads();  // the next pass's first loads overwrite the stages
      PROF_T(3)

      const int g = lane >> 2;
      const int cb = n0 + (lane & 3) * 2;  // this lane's first channel
      float2 bv[kNT];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        if (j < nnt)
          bv[j] = __ldg(reinterpret_cast<const float2*>(bias + cb + j * 8));
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = p0 + mt * 16 + g + 8 * h;
          if (mt < nmt && p < M) {
            const auto r = row(p);
            if (r.dst != nullptr) {
#pragma unroll
              for (int j = 0; j < kNT; ++j)
                if (j < nnt)
                  put(r, cb + j * 8, silu_bf16(acc[mt][j][2 * h] + bv[j].x),
                      silu_bf16(acc[mt][j][2 * h + 1] + bv[j].y));
            }
          }
        }
      }
      PROF_T(4)
    }
  }
#ifdef K6_PROF
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)
    for (int i = 0; i < kPhases; ++i) g_prof[i] += prof[i];
#endif
}

__global__ void __launch_bounds__(kMmaThreads, 1)
    c3_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w12,
                  const float* __restrict__ b12, const bf16* __restrict__ wb1,
                  const float* __restrict__ bb1, const bf16* __restrict__ wb2,
                  const float* __restrict__ bb2, const bf16* __restrict__ w3,
                  const float* __restrict__ b3, int H, int W, int C, int c_,
                  int C2, int n, int shortcut, int th, int tw, int tiles_x,
                  bf16* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int RH = th + 2 * n;  // frame
  const int RW = tw + 2 * n;
  const int ldf = c_ + mma::kPad;  // frame row pitch, elements
  const int frame = RH * RW * ldf;
  bf16* y1 = reinterpret_cast<bf16*>(smem_raw);  // y1 over the frame
  bf16* tb = y1 + frame;                         // t over the frame, then y2
  bf16* wring = tb + frame;
  bf16* aring = wring + 2 * kWStage;
  const int b = blockIdx.y;
  const int fy = (blockIdx.x / tiles_x) * th - n;  // image row of frame row 0
  const int fx = (blockIdx.x % tiles_x) * tw - n;
  const bf16* xb = x + static_cast<size_t>(b) * H * W * C;
  auto inside = [&](int ry, int rx) {
    return fy + ry >= 0 && fy + ry < H && fx + rx >= 0 && fx + rx < W;
  };
  auto x_row = [&](int ry, int rx) -> const bf16* {
    return inside(ry, rx)
               ? xb + (static_cast<size_t>(fy + ry) * W + fx + rx) * C
               : nullptr;
  };
  auto no_pix = [](int) { return 0; };
  auto one_seg = [](int) { return 0; };
  auto no_x = [](int) -> const bf16* { return nullptr; };
  struct RowDst {
    bf16* dst;   // the pixel's first channel
    bool in;     // inside the image
  };
  auto put2 = [](bf16* dst, float v0, float v1) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
  };
  auto store = [&](const RowDst& r, int c, float v0, float v1) {
    put2(r.dst + c, v0, v1);
  };

  // y1 = bf16(silu(x @ w12[:, :c_] + b12[:c_])) on the whole frame
  mma_stage<true>(
      y1, wring, aring, RH * RW, C, c_, w12, 2 * c_, b12, no_pix, C, one_seg,
      [&](int p) { return x_row(p / RW, p % RW); },
      [&](int p) { return RowDst{y1 + p * ldf, true}; }, store);
  __syncthreads();

  for (int i = 0; i < n; ++i) {
    // t = bf16(silu(y1 @ wb1[i] + bb1[i])) on the frame less i, 0 outside
    // the image
    const int o = i;
    const int rw = RW - 2 * i;
    const int rh = RH - 2 * i;
    mma_stage<false>(
        y1, wring, aring, rh * rw, c_, c_,
        wb1 + static_cast<size_t>(i) * c_ * c_, c_,
        bb1 + static_cast<size_t>(i) * c_,
        [&](int p) { return ((o + p / rw) * RW + o + p % rw) * ldf; }, c_,
        one_seg, no_x,
        [&](int p) {
          const int ry = o + p / rw;
          const int rx = o + p % rw;
          return RowDst{tb + (ry * RW + rx) * ldf, inside(ry, rx)};
        },
        [&](const RowDst& r, int c, float v0, float v1) {
          put2(r.dst + c, r.in ? v0 : 0.f, r.in ? v1 : 0.f);
        });
    __syncthreads();

    // t2 = silu(conv3x3(t) + bb2[i]) on the frame less i + 1;
    // y1 = bf16(y1 + t2) with the shortcut, else bf16(t2)
    const int o2 = i + 1;
    const int rw2 = rw - 2;
    const int rh2 = rh - 2;
    mma_stage<false>(
        y1, wring, aring, rh2 * rw2, 9 * c_, c_,
        wb2 + static_cast<size_t>(i) * 9 * c_ * c_, c_,
        bb2 + static_cast<size_t>(i) * c_,
        [&](int p) {
          return frame + ((o2 + p / rw2) * RW + o2 + p % rw2) * ldf;
        },
        c_, [&](int tap) { return ((tap / 3 - 1) * RW + tap % 3 - 1) * ldf; },
        no_x,
        [&](int p) {
          return RowDst{y1 + ((o2 + p / rw2) * RW + o2 + p % rw2) * ldf, true};
        },
        [&](const RowDst& r, int c, float v0, float v1) {
          if (shortcut) {
            const float2 y = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(r.dst + c));
            v0 = __fadd_rn(y.x, v0);
            v1 = __fadd_rn(y.y, v1);
          }
          put2(r.dst + c, v0, v1);
        });
    __syncthreads();
  }

  // y2 = bf16(silu(x @ w12[:, c_:] + b12[c_:])) on the tile, into tb at frame
  // positions, so that [y1 | y2] of a pixel is one row and two offsets
  mma_stage<true>(
      y1, wring, aring, th * tw, C, c_, w12 + c_, 2 * c_, b12 + c_, no_pix, C,
      one_seg, [&](int p) { return x_row(n + p / tw, n + p % tw); },
      [&](int p) {
        return RowDst{tb + ((n + p / tw) * RW + n + p % tw) * ldf, true};
      },
      store);
  __syncthreads();

  // out = bf16(silu([y1 | y2] @ w3 + b3)) on the tile's pixels inside the
  // image
  mma_stage<false>(
      y1, wring, aring, th * tw, 2 * c_, C2, w3, C2, b3,
      [&](int p) { return ((n + p / tw) * RW + n + p % tw) * ldf; }, c_,
      [&](int half) { return half * frame; }, no_x,
      [&](int p) {
        const int ry = n + p / tw;
        const int rx = n + p % tw;
        return RowDst{
            inside(ry, rx)
                ? out + ((static_cast<size_t>(b) * H + fy + ry) * W + fx + rx) *
                            C2
                : nullptr,
            true};
      },
      store);
}

cudaError_t launch_mma(const void* x, const void* w12, const void* b12,
                       const void* wb1, const void* bb1, const void* wb2,
                       const void* bb2, const void* w3, const void* b3, int B,
                       int H, int W, int C, int c_, int C2, int n,
                       int shortcut, int th, int tw, void* out,
                       cudaStream_t st) {
  if (C % 16 || c_ % 16 || C2 % 16) return cudaErrorInvalidValue;
  const size_t fp = static_cast<size_t>(th + 2 * n) * (tw + 2 * n);
  const size_t smem = 2 * fp * (c_ + mma::kPad) * sizeof(bf16) + kRingBytes;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      c3_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int tiles_x = (W + tw - 1) / tw;
  const int tiles_y = (H + th - 1) / th;
  const dim3 grid(tiles_x * tiles_y, B);
  c3_mma_kernel<<<grid, kMmaThreads, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w12),
      static_cast<const float*>(b12), static_cast<const bf16*>(wb1),
      static_cast<const float*>(bb1), static_cast<const bf16*>(wb2),
      static_cast<const float*>(bb2), static_cast<const bf16*>(w3),
      static_cast<const float*>(b3), H, W, C, c_, C2, n, shortcut, th, tw,
      tiles_x, static_cast<bf16*>(out));
  return cudaGetLastError();
}

// ---- launch ---------------------------------------------------------------

template <typename T>
cudaError_t launch(const void* x, const void* w12, const void* b12,
                   const void* wb1, const void* bb1, const void* wb2,
                   const void* bb2, const void* w3, const void* b3, int B,
                   int H, int W, int C, int c_, int C2, int n, int shortcut,
                   int tile, void* out, cudaStream_t st) {
  const size_t R = static_cast<size_t>(tile) + 2 * n;
  const size_t smem = 2 * R * R * c_ * sizeof(T);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      c3_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int tiles_x = (W + tile - 1) / tile;
  const int tiles_y = (H + tile - 1) / tile;
  const dim3 grid(tiles_x * tiles_y, B);
  c3_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w12),
      static_cast<const float*>(b12), static_cast<const T*>(wb1),
      static_cast<const float*>(bb1), static_cast<const T*>(wb2),
      static_cast<const float*>(bb2), static_cast<const T*>(w3),
      static_cast<const float*>(b3), H, W, C, c_, C2, n, shortcut, tile,
      tiles_x, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// variant 0: c3_kernel on the CUDA cores (square tile th == tw); 1:
// c3_mma_kernel on the tensor cores (bf16, channel counts multiples of 16).
extern "C" int desenet_c3_fused(const void* x, const void* w12,
                                const void* b12, const void* wb1,
                                const void* bb1, const void* wb2,
                                const void* bb2, const void* w3,
                                const void* b3, int B, int H, int W, int C,
                                int c_, int C2, int n, int shortcut, int th,
                                int tw, int variant, int is_bf16, void* out,
                                void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (C % 8 || c_ % 8 || C2 % 8 || c_ <= 0 || n < 0 || th <= 0 || tw <= 0 ||
      B > 65535 || variant < 0 || variant > 1)
    return cudaErrorInvalidValue;
  if (variant == 1 ? !is_bf16 : th != tw) return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  if (variant == 1)
    return launch_mma(x, w12, b12, wb1, bb1, wb2, bb2, w3, b3, B, H, W, C, c_,
                      C2, n, shortcut, th, tw, out, st);
  return is_bf16
             ? launch<bf16>(x, w12, b12, wb1, bb1, wb2, bb2, w3, b3, B, H, W,
                            C, c_, C2, n, shortcut, th, out, st)
             : launch<float>(x, w12, b12, wb1, bb1, wb2, bb2, w3, b3, B, H, W,
                             C, c_, C2, n, shortcut, th, out, st);
}

// The phase cycles since the last reset into out[0..4] (reset != 0: zero
// them instead); synchronises the device. All zero unless built with
// -DK6_PROF.
extern "C" int desenet_c3_prof(long long* out, int reset) {
  if (reset) {
    const long long zeros[kPhases] = {};
    return cudaMemcpyToSymbol(g_prof, zeros, sizeof(zeros));
  }
  return cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
}
