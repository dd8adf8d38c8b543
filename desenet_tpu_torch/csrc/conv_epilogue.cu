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

// ---- the phase store -------------------------------------------------------
//
// Proto's nearest 2x upsample and 3x3 conv run as one 2x2 conv over the
// small map, pad 1, with four output phases (ops/conv_epilogue.py
// fold_phases): y is (B, H+1, W+1, 4C) NHWC, its channel p C + c at
// (i + py, j + px), p = 2 py + px, is output channel c at (2i + py, 2j + px).
// This pass applies BN's affine and the SiLU and writes each phase into its
// place in the (B, 2H, 2W, C) NHWC output:
//   out[b, 2i+py, 2j+px, c] = silu(y[b, i+py, j+px, p C + c] * scale[c]
//                                  + shift[c])
// in f32, rounded once on the store. The arithmetic is the plain version's,
// op for op (a product and a sum each rounded, expf, an IEEE division), so
// the two agree bit for bit.
//
// Replaces no TPU kernel: XLA fuses the upsample into the conv's input, so
// the JAX package never writes the 2x map either. Bound by bytes: y read
// and the output written once, each about the size of the 2x map.
//
// Design: a block an output row at a time (grid-stride over the B 2H
// rows), its threads walking the row's W pixel pairs (2j, 2j + 1) of C
// channels in 16-byte groups (or one element each where C or a pointer does
// not allow them): a thread reads a group of each pixel's phase from y,
// two contiguous runs, and writes both, so a warp's stores are whole
// coalesced runs of the row and each thread has two loads in flight and
// reads its constants once for both. A thread carries its (pair, channel)
// from one trip to the next: no division in the loop. scale and shift are
// staged in shared memory as in the kernels above. On an H100 it reads
// 78-80% of its byte bound; the exact arithmetic costs about 2.5 points of
// that against the kernels' fast intrinsics above.

namespace {

__device__ __forceinline__ float phase_act(float x, float s, float b) {
  const float v = __fadd_rn(__fmul_rn(x, s), b);
  return __fdiv_rn(v, __fadd_rn(1.0f, expf(-v)));
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    phases_kernel(const T* __restrict__ y, T* __restrict__ out,
                  const float* __restrict__ scale,
                  const float* __restrict__ shift, int B, int H, int W,
                  int C) {
  constexpr int V = kVec ? 16 / sizeof(T) : 1;
  const float* s = stage(scale, shift, C);
  const int groups = C / V;        // a pixel's groups
  const int per_row = W * groups;  // an output row's pixel pairs' groups
  const int j0 = threadIdx.x / groups;
  const int c0 = (threadIdx.x % groups) * V;
  const int dj = blockDim.x / groups;
  const int dc = (blockDim.x % groups) * V;
  const long long pix = 4LL * C;  // elements of a y pixel
  const long long rows = 2LL * B * H;
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const long long b = r / (2 * H);
    const int Y = static_cast<int>(r - b * 2 * H);
    const int py = Y & 1;
    // phase 2 py at (i + py, j) is output pixel 2j, phase 2 py + 1 at
    // (i + py, j + 1) pixel 2j + 1
    const T* src = y + (b * (H + 1) + (Y >> 1) + py) * (W + 1) * pix +
                   2LL * py * C;
    T* dst = out + r * 2 * W * C;
    int j = j0, c = c0;
    for (int t = threadIdx.x; t < per_row; t += blockDim.x) {
      const T* p = src + j * pix + c;
      T* q = dst + 2LL * j * C + c;
      if constexpr (kVec) {
        float f[V], g[V];
        unpack(__ldg(reinterpret_cast<const uint4*>(p)), f);
        unpack(__ldg(reinterpret_cast<const uint4*>(p + pix + C)), g);
#pragma unroll
        for (int k = 0; k < V; k += 4) {
          const float4 a = *reinterpret_cast<const float4*>(s + c + k);
          const float4 h = *reinterpret_cast<const float4*>(s + C + c + k);
          f[k] = phase_act(f[k], a.x, h.x);
          f[k + 1] = phase_act(f[k + 1], a.y, h.y);
          f[k + 2] = phase_act(f[k + 2], a.z, h.z);
          f[k + 3] = phase_act(f[k + 3], a.w, h.w);
          g[k] = phase_act(g[k], a.x, h.x);
          g[k + 1] = phase_act(g[k + 1], a.y, h.y);
          g[k + 2] = phase_act(g[k + 2], a.z, h.z);
          g[k + 3] = phase_act(g[k + 3], a.w, h.w);
        }
        *reinterpret_cast<uint4*>(q) = pack(f);
        *reinterpret_cast<uint4*>(q + C) = pack(g);
      } else {
        q[0] = from_float<T>(phase_act(to_float(p[0]), s[c], s[C + c]));
        q[C] = from_float<T>(phase_act(to_float(p[pix + C]), s[c],
                                       s[C + c]));
      }
      j += dj;
      c += dc;
      if (c >= C) {
        c -= C;
        ++j;
      }
    }
  }
}

// one block a row, at most as many as the card holds at once: the kernel's
// registers leave fewer than kBlocksPerSm resident, and a second partial
// wave of blocks would each walk as many rows as the first
template <typename T, bool kVec>
cudaError_t launch_phases(const T* y, T* out, const float* scale,
                          const float* shift, int B, int H, int W, int C,
                          cudaStream_t st, int device) {
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(C);
  int per_sm = 0, sms = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, phases_kernel<T, kVec>, kThreads, smem);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const long long rows = 2LL * B * H;
  const long long full = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  const int grid = static_cast<int>(rows < full ? rows : full);
  phases_kernel<T, kVec><<<grid, kThreads, smem, st>>>(y, out, scale, shift,
                                                       B, H, W, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_phases(const void* y, void* out, const float* scale,
                            const float* shift, int B, int H, int W, int C,
                            bool vec, cudaStream_t st, int device) {
  const T* yt = static_cast<const T*>(y);
  T* ot = static_cast<T*>(out);
  return vec ? launch_phases<T, true>(yt, ot, scale, shift, B, H, W, C, st,
                                      device)
             : launch_phases<T, false>(yt, ot, scale, shift, B, H, W, C, st,
                                       device);
}

}  // namespace

// y: (B, H+1, W+1, 4C) NHWC, float32 or bfloat16 (the folded 2x2 conv's
// output over a (B, H, W) map); out: (B, 2H, 2W, C) NHWC of y's type;
// scale, shift: C float32. vec: 16-byte groups (C a multiple of 16 /
// element size, y and out 16-byte aligned; the wrapper checks), else one
// element a thread.
extern "C" int desenet_conv_epilogue_phases(const void* y, void* out,
                                            const void* scale,
                                            const void* shift, int B, int H,
                                            int W, int C, int is_bf16,
                                            int vec, void* stream,
                                            int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  return is_bf16 ? dispatch_phases<__nv_bfloat16>(y, out, sc, sh, B, H, W,
                                                  C, vec != 0, st, device)
                 : dispatch_phases<float>(y, out, sc, sh, B, H, W, C,
                                          vec != 0, st, device);
}
