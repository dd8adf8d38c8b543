// The fused int8 conv block: the port's counterpart of the XLA fusion that
// desenet_tpu/quant.py:int8_conv_block (int8 conv with int32 accumulation,
// then dequant -> BN fold -> SiLU -> residual -> requant) relies on. It
// replaces no Pallas kernel: PyTorch has no CUDA int8 convolution, and an
// im2col plus torch._int_mm would write a 9x copy of every 3x3 input and an
// int32 output to device memory, where the JAX design lets only int8 cross
// it.
//
// What it computes (ops/int8_conv.py:int8_conv_plain is the same function in
// PyTorch ops): an implicit-GEMM convolution over NHWC int8 input given as
// up to four parts (an implicit channel concat; part p has C_p channels,
// pixels ld_p elements apart, so a channel slice of a bigger map is read in
// place), stride, zero padding, dilation, groups. Rows of the GEMM are
// output pixels, columns output channels, depth the taps times the part's
// channels. A grouped conv (one part; the JAX package concatenates the parts
// first) is one GEMM a group: blockIdx.z is the group, whose N is its
// C_out / g output channels and whose depth its C_in / g channels times the
// taps, read at the group's channel offset of the input; its weights are
// packed per output channel over the group's channels, zero-padded to the
// 32-byte depth step like any part. A depthwise conv (C_in / g = 1) is a
// degenerate GEMM: on the tile it filled C_out / g of 64 columns and one
// depth step, and ran 2 to 3 times slower than PyTorch's float64 conv on
// the card (PERF.md), so it takes a CUDA-core kernel of its own,
// int8_dw_kernel: one thread an output element, the taps summed in int32,
// the same epilogue. Each part's int32 sum becomes f32 and is scaled by its
// per-output-channel factor g_p at the part's end; the scaled parts are
// added in f32 in order (JAX's per-part sum, quant.py:347-361). Then the
// epilogue in JAX's order (quant.py:362-376): + BN bias, + conv bias, - the
// bias-correction term, SiLU or identity, + the dequantized int8 residual,
// round half to even (__float2int_rn, as jnp.round), clip to +-127, int8
// out at a per-channel output scale (a per-tensor one comes as a constant
// vector); or f32 / bf16 with no output scale (the seg class conv); or the
// raw int32 sum over all parts (checks). Every f32 step is an IEEE
// operation of its own (__fmul_rn / __fadd_rn / __fdiv_rn), so no fused
// multiply-add changes a rounding against the plain version.
//
// Design (a simple kernel that is right; wgmma and TMA are later work):
// blocks of 64 pixels x 64 output channels, 4 warps of 32 x 32, depth steps
// of 32 bytes on mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32. Each
// thread fetches one 16-byte chunk of A (a pixel's 16 channels of one tap)
// and one of B (the packed weights) per step into registers one step ahead
// (the loads of step s+1 are in flight during step s's products), two
// shared-memory buffers, one barrier a step. Rows of 48 bytes make the
// fragment reads conflict-free. Channels past C_p are zero in shared memory
// (a part of 3 or 21 channels is read byte by byte, never padded in device
// memory); the packed weights are zero-padded per tap to a multiple of 32
// at prepare time.
//
// Bound on the card: 2 * M * O * K operations at the int8 tensor-core rate
// against int8 in, int8 out and the weights at 3.35 TB/s
// (tools/timing.py:int8_conv_bound); a 1x1 conv of 64 channels is
// bytes-bound, a 3x3 conv of 256 channels operations-bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

constexpr int kMaxParts = 4;
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kRow = kBK + 16;  // shared-memory row pitch in bytes
constexpr int kThreads = 128;
constexpr int kDwThreads = 256;

constexpr int kOutInt8 = 0;
constexpr int kOutF32 = 1;
constexpr int kOutBf16 = 2;
constexpr int kOutI32 = 3;

// ops/int8_conv.py:_Args, field for field
struct Int8ConvArgs {
  const int8_t* x[kMaxParts];
  const float* g[kMaxParts];
  int c[kMaxParts];
  int ld[kMaxParts];
  int kpad[kMaxParts];
  int koff[kMaxParts];
  int vec[kMaxParts];
  int kpack[kMaxParts];
  int nparts;
  const int8_t* w;
  int ktot;
  const float* bnb;
  const float* bias;
  const float* corr;
  const int8_t* res;
  int res_ld;
  const float* res_scale;
  const float* out_scale;
  void* out;
  int out_ld;
  int out_mode;
  int act;
  int B, H, W, Ho, Wo, O, KH, KW, stride, pad_h, pad_w, dil;
  int groups;
};

namespace {

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16 bytes of part channels [cc, cc + 16) at pixel px (zeros past C);
// vec: 16-byte aligned and C a multiple of 16
__device__ __forceinline__ int4 load_a(const int8_t* px, int cc, int C,
                                       bool vec) {
  if (vec) return __ldg(reinterpret_cast<const int4*>(px + cc));
  uint32_t wv[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (cc + j < C) {
      const uint32_t b = static_cast<uint8_t>(__ldg(px + cc + j));
      wv[j >> 2] |= b << (8 * (j & 3));
    }
  }
  return make_int4(static_cast<int>(wv[0]), static_cast<int>(wv[1]),
                   static_cast<int>(wv[2]), static_cast<int>(wv[3]));
}

// One output element's epilogue in JAX's order: v is the f32 sum of the
// scaled parts, isum the raw int32 sum over all of them (kOutI32)
__device__ __forceinline__ void store_out(const Int8ConvArgs& a, int m,
                                          int o, float v, int isum,
                                          float bnb, float bias, float corr,
                                          float rs, float os) {
  const size_t oi = static_cast<size_t>(m) * a.out_ld + o;
  if (a.out_mode == kOutI32) {
    static_cast<int*>(a.out)[oi] = isum;
    return;
  }
  v = __fadd_rn(v, bnb);
  v = __fadd_rn(v, bias);
  v = __fsub_rn(v, corr);
  if (a.act) {
    const float sg = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-v)));
    v = __fmul_rn(v, sg);
  }
  if (a.res != nullptr) {
    const int8_t r = a.res[static_cast<size_t>(m) * a.res_ld + o];
    v = __fadd_rn(v, __fmul_rn(__int2float_rn(r), rs));
  }
  if (a.out_mode == kOutF32) {
    static_cast<float*>(a.out)[oi] = v;
  } else if (a.out_mode == kOutBf16) {
    static_cast<__nv_bfloat16*>(a.out)[oi] = __float2bfloat16_rn(v);
  } else {
    int q = __float2int_rn(__fdiv_rn(v, os));
    q = q < -127 ? -127 : (q > 127 ? 127 : q);
    static_cast<int8_t*>(a.out)[oi] = static_cast<int8_t>(q);
  }
}

__global__ void __launch_bounds__(kThreads)
    int8_conv_kernel(const Int8ConvArgs a) {
  __shared__ __align__(16) int8_t sA[2][kBM * kRow];
  __shared__ __align__(16) int8_t sB[2][kBN * kRow];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wm = (warp & 1) * 32;
  const int wn = (warp >> 1) * 32;
  const int m0 = blockIdx.x * kBM;
  // the group's output channels [o_begin, o_end); all of them at groups 1
  const int og = a.O / a.groups;
  const int o_begin = blockIdx.z * og;
  const int o_end = o_begin + og;
  const int n0 = o_begin + blockIdx.y * kBN;
  const int hw_out = a.Ho * a.Wo;
  const int M = a.B * hw_out;

  // this thread's load slot: row lr of the tile, bytes [16 lh, 16 lh + 16)
  const int lr = tid >> 1;
  const int lh = tid & 1;
  const int am = m0 + lr;
  const bool arow = am < M;
  int ab = 0, ay = 0, ax = 0;
  if (arow) {
    ab = am / hw_out;
    const int r = am - ab * hw_out;
    ay = r / a.Wo;
    ax = r - ay * a.Wo;
  }
  const int iy0 = ay * a.stride - a.pad_h;
  const int ix0 = ax * a.stride - a.pad_w;
  const int bo = n0 + lr;
  const bool brow = bo < o_end;

  float facc[2][4][4];
  int iacc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        facc[mt][nt][e] = 0.0f;
        iacc[mt][nt][e] = 0;
      }

  const int taps = a.KH * a.KW;
  for (int p = 0; p < a.nparts; ++p) {
    const int C = a.c[p];  // a group's channels in a grouped conv
    const int8_t* x = a.x[p] + static_cast<size_t>(blockIdx.z) * C;
    const int ld = a.ld[p];
    const int kpad = a.kpad[p];
    const bool vec = a.vec[p] != 0;
    // kpack: a part narrower than a depth step (the stem's 3 channels)
    // runs its taps and channels as one depth, (kh, kw, c) flattened, so
    // a 6x6 tap window of 3 channels takes 4 steps and not 36
    const bool kpack = a.kpack[p] != 0;
    const int chunks = kpad / kBK;
    const int steps = kpack ? chunks : taps * chunks;
    const int8_t* wrow = a.w + static_cast<size_t>(brow ? bo : 0) * a.ktot +
                         a.koff[p];

    auto fetch = [&](int s, int4& va, int4& vb) {
      if (kpack) {
        const int k0 = s * kBK + lh * 16;
        uint32_t wv[4] = {0u, 0u, 0u, 0u};
        if (arow) {
#pragma unroll 4
          for (int j = 0; j < 16; ++j) {
            const int k = k0 + j;
            const int tap = k / C;
            if (tap >= taps) break;
            const int c = k - tap * C;
            const int kh = tap / a.KW;
            const int iy = iy0 + kh * a.dil;
            const int ix = ix0 + (tap - kh * a.KW) * a.dil;
            if (iy >= 0 && iy < a.H && ix >= 0 && ix < a.W) {
              const int8_t v = __ldg(
                  x + (static_cast<size_t>(ab * a.H + iy) * a.W + ix) * ld +
                  c);
              wv[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(v))
                            << (8 * (j & 3));
            }
          }
        }
        va = make_int4(static_cast<int>(wv[0]), static_cast<int>(wv[1]),
                       static_cast<int>(wv[2]), static_cast<int>(wv[3]));
        vb = make_int4(0, 0, 0, 0);
        if (brow) vb = __ldg(reinterpret_cast<const int4*>(wrow + k0));
        return;
      }
      const int tap = s / chunks;
      const int cc = (s - tap * chunks) * kBK + lh * 16;
      const int kh = tap / a.KW;
      const int kw = tap - kh * a.KW;
      const int iy = iy0 + kh * a.dil;
      const int ix = ix0 + kw * a.dil;
      va = make_int4(0, 0, 0, 0);
      if (arow && iy >= 0 && iy < a.H && ix >= 0 && ix < a.W && cc < C) {
        const int8_t* px =
            x + (static_cast<size_t>(ab * a.H + iy) * a.W + ix) * ld;
        va = load_a(px, cc, C, vec);
      }
      vb = make_int4(0, 0, 0, 0);
      if (brow)
        vb = __ldg(reinterpret_cast<const int4*>(wrow + tap * kpad + cc));
    };

    int4 va, vb;
    fetch(0, va, vb);
    for (int s = 0; s < steps; ++s) {
      const int buf = s & 1;
      *reinterpret_cast<int4*>(&sA[buf][lr * kRow + lh * 16]) = va;
      *reinterpret_cast<int4*>(&sB[buf][lr * kRow + lh * 16]) = vb;
      __syncthreads();
      if (s + 1 < steps) fetch(s + 1, va, vb);
      uint32_t af[2][4];
      uint32_t bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int8_t* r0 = &sA[buf][(wm + mt * 16 + g) * kRow + t4 * 4];
        af[mt][0] = lds32(r0);
        af[mt][1] = lds32(r0 + 8 * kRow);
        af[mt][2] = lds32(r0 + 16);
        af[mt][3] = lds32(r0 + 8 * kRow + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int8_t* r0 = &sB[buf][(wn + nt * 8 + g) * kRow + t4 * 4];
        bf[nt][0] = lds32(r0);
        bf[nt][1] = lds32(r0 + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_s8(iacc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
    __syncthreads();  // the next part's first store reuses buffer 0

    if (a.out_mode == kOutI32) continue;  // int32 sums over all parts
    const float* gp = a.g[p];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int o = n0 + wn + nt * 8 + t4 * 2 + j;
        const float gv = o < o_end ? gp[o] : 0.0f;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 2 * h + j;
            const float y = __fmul_rn(__int2float_rn(iacc[mt][nt][e]), gv);
            facc[mt][nt][e] = __fadd_rn(facc[mt][nt][e], y);
            iacc[mt][nt][e] = 0;
          }
        }
      }
    }
  }

#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int o = n0 + wn + nt * 8 + t4 * 2 + j;
      if (o >= o_end) continue;
      const float bnb = a.bnb[o];
      const float bias = a.bias[o];
      const float corr = a.corr[o];
      const float rs = a.res != nullptr ? a.res_scale[o] : 0.0f;
      const float os = a.out_mode == kOutInt8 ? a.out_scale[o] : 1.0f;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 2 * h + j;
          const int m = m0 + wm + mt * 16 + g + 8 * h;
          if (m >= M) continue;
          store_out(a, m, o, facc[mt][nt][e], iacc[mt][nt][e], bnb, bias,
                    corr, rs, os);
        }
      }
    }
  }
}

// A depthwise conv (one part of one input channel a group): one thread an
// output element, output channels fastest (coalesced NHWC stores, and the
// input reads of one pixel's channels side by side), the taps summed in
// int32 from the packed (kpack) weight row, then store_out
__global__ void __launch_bounds__(kDwThreads)
    int8_dw_kernel(const Int8ConvArgs a) {
  const long long n = static_cast<long long>(a.B) * a.Ho * a.Wo * a.O;
  const long long i =
      static_cast<long long>(blockIdx.x) * kDwThreads + threadIdx.x;
  if (i >= n) return;
  const int o = static_cast<int>(i % a.O);
  const int m = static_cast<int>(i / a.O);
  const int hw = a.Ho * a.Wo;
  const int b = m / hw;
  const int r = m - b * hw;
  const int oy = r / a.Wo;
  const int ox = r - oy * a.Wo;
  const int8_t* x = a.x[0] + o / (a.O / a.groups);
  const int8_t* w = a.w + static_cast<size_t>(o) * a.ktot + a.koff[0];
  int isum = 0;
  for (int kh = 0; kh < a.KH; ++kh) {
    const int iy = oy * a.stride - a.pad_h + kh * a.dil;
    if (iy < 0 || iy >= a.H) continue;
    for (int kw = 0; kw < a.KW; ++kw) {
      const int ix = ox * a.stride - a.pad_w + kw * a.dil;
      if (ix < 0 || ix >= a.W) continue;
      const int8_t v =
          __ldg(x + (static_cast<size_t>(b * a.H + iy) * a.W + ix) * a.ld[0]);
      isum += static_cast<int>(v) *
              static_cast<int>(__ldg(w + kh * a.KW + kw));
    }
  }
  // the tile kernel's f32 steps: 0 + the part's scaled sum, then the rest
  const float v = __fadd_rn(0.0f, __fmul_rn(__int2float_rn(isum), a.g[0][o]));
  store_out(a, m, o, v, isum, a.bnb[o], a.bias[o], a.corr[o],
            a.res != nullptr ? a.res_scale[o] : 0.0f,
            a.out_mode == kOutInt8 ? a.out_scale[o] : 1.0f);
}

}  // namespace

extern "C" int desenet_int8_conv(const Int8ConvArgs* args, void* stream,
                                 int device) {
  cudaSetDevice(device);
  const Int8ConvArgs& a = *args;
  const long long M = static_cast<long long>(a.B) * a.Ho * a.Wo;
  if (M <= 0 || a.O <= 0) return 0;
  if (a.groups > 1 && a.c[0] == 1) {  // depthwise: the CUDA-core kernel
    const long long n = M * a.O;
    int8_dw_kernel<<<static_cast<unsigned>((n + kDwThreads - 1) / kDwThreads),
                     kDwThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  const int og = a.O / a.groups;
  const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM),
                  static_cast<unsigned>((og + kBN - 1) / kBN),
                  static_cast<unsigned>(a.groups));
  int8_conv_kernel<<<grid, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
