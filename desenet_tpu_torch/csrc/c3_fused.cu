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
// What bounds it on the H100: at 640 px one image's chain is megabytes at
// P2/P3, far above the 227 KB of shared memory a block has, and the block
// is a chain of small matrix products (K = C, c_, 9 c_, 2 c_ up to 2304),
// so without tensor cores it is bound by the CUDA cores' f32 multiply-adds.
//
// What the design does about it (simple and right first; tensor cores are a
// later change):
// - One block per (image, output tile of tile x tile pixels). A tile's
//   receptive field widens by one pixel for each 3x3, so the block works on
//   a frame of (tile + 2n)^2 pixels and recomputes that halo: y1 on the
//   whole frame, the i-th bottleneck's t on the frame less i pixels at each
//   side and its 3x3 output on the frame less i + 1, y2 and the output on
//   the tile only. Every intermediate stays in shared memory: two frame
//   buffers of c_ channels in the input type (y1; t, then y2), so x is read
//   from device memory and the output written to it, and nothing else.
// - The 3x3 pads t, not y1: frame positions outside the image get t = 0
//   after the 1x1 and its SiLU, which is the TPU kernel's zero ring.
// - Every stage is one small GEMM on the CUDA cores: a thread owns 4 pixels
//   x 8 output channels (32 f32 accumulators) and walks K in chunks of 8,
//   one 16-byte load of activations per pixel (shared memory, or x in device
//   memory for the two halves of cv12) and eight 16-byte loads of weights
//   per chunk, read through L1/L2 (w12 alone is up to 512 KB).
// - SiLU in f32 with correctly rounded operations (no contracted
//   multiply-add), one rounding to the output type, 16-byte stores.
// The wrapper picks the tile (16, 8, 4, ...) so that the two buffers take at
// most 110 KB, two blocks per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

extern "C" int desenet_c3_fused(const void* x, const void* w12,
                                const void* b12, const void* wb1,
                                const void* bb1, const void* wb2,
                                const void* bb2, const void* w3,
                                const void* b3, int B, int H, int W, int C,
                                int c_, int C2, int n, int shortcut, int tile,
                                int is_bf16, void* out, void* stream,
                                int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (C % 8 || c_ % 8 || C2 % 8 || c_ <= 0 || n < 0 || tile <= 0 ||
      B > 65535)
    return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? launch<bf16>(x, w12, b12, wb1, bb1, wb2, bb2, w3, b3, B, H, W,
                            C, c_, C2, n, shortcut, tile, out, st)
             : launch<float>(x, w12, b12, wb1, bb1, wb2, bb2, w3, b3, B, H, W,
                             C, c_, C2, n, shortcut, tile, out, st);
}
