// Instance-mask assembly of a Segment model (YOLOv5 v7.0's process_mask
// with upsample=False): for every kept box j of an image, the sign of its 32
// mask coefficients against the prototypes at every proto pixel inside the
// box's crop, bit-packed.
//
// No TPU kernel precedes it: the JAX package serves no Segment model, and
// v7.0 runs this step as a matmul, a sigmoid, a crop and a compare in
// PyTorch ops on (n, 160, 160) floats an image.
//
// bit(y, x) of box j = [c_j . P[:, y, x] > 0] * [x1/4 <= x < x2/4] *
// [y1/4 <= y < y2/4] (sigmoid(v) > 0.5 is v > 0), with the box in input
// pixels scaled by the proto's size over the input's (sx, sy). Bit k of byte
// b in row y is pixel x = 8b + k (numpy packbits, bitorder "little"); boxes
// j >= num get zero rows. The dot product is float32 from the bf16 (or f32)
// prototypes and the f32 coefficients, channel by channel in order.
//
// What bounds it on the H100: bytes. At b128/640 the prototypes are 210 MB
// of bf16 and the bits 123 MB, all max_det rows of them, against well under
// a GFLOP of products inside the crops (a box's crop meets few of an
// image's rows). So each block reads its band of the prototypes once,
// coalesced, writes every bit row it owns, and spends instructions only on
// the words a crop touches:
//
// 1. A block takes one image and a band of kBand proto rows. It copies the
//    band's prototypes from the NHWC map into shared memory, channel-major
//    (a row of 32 lanes then reads 32 pixels of one channel pair: no bank
//    conflict), and zeroes the band's rows of all max_det boxes with 16-byte
//    stores where the layout allows (a box's plane a multiple of 16 bytes),
//    else bytes. Meanwhile every thread takes kept boxes j = tid, tid +
//    kThreads, ...: a box whose crop meets the band goes to a list in shared
//    memory with its rows and words there (most boxes meet a few of an
//    image's bands, and the list spares the warps their loads).
// 2. After one barrier (it orders the zeros before the words below), a warp
//    takes the listed boxes i = warp, warp + kWarps, ...: the box's 32
//    coefficients (decode[b, index[j], coff:coff+32]) go to the warp's slot
//    of shared memory, and each 32-pixel word of a row that the crop touches
//    is a task: a lane computes one pixel's dot product and __ballot_sync
//    packs the 32 bits in the order packbits wants, so lane 0 stores the
//    word over the zeros.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBand = 4;  // proto rows a block
constexpr int kNm = 32;   // mask coefficients a box
constexpr unsigned kFull = 0xffffffffu;

// a kept box whose crop meets the band: its row, anchor, the band's rows
// [ylo, yhi) and pixels [xlo, xhi) it touches, its crop's x edges
struct Item {
  int j, a, ylo, yhi, xlo, xhi;
  float cx1, cx2;
};

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
    mask_assembly_kernel(const float* __restrict__ decode, int A, int ncol,
                         int coff, const int* __restrict__ index,
                         const float* __restrict__ boxes,
                         const int* __restrict__ num,
                         const void* __restrict__ proto, int Hp, int Wp,
                         int max_det, float sx, float sy,
                         uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) float coef[kWarps][kNm];
  __shared__ int n_items;
  const int b = blockIdx.y;
  const int y0 = blockIdx.x * kBand;
  const int rows = min(kBand, Hp - y0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int Wb = Wp >> 3;         // bytes a bit row
  const int PS = kBand * Wp + 1;  // a channel word's stride in shared memory
  uint32_t* band = reinterpret_cast<uint32_t*>(smem);
  Item* items = reinterpret_cast<Item*>(band + (kBf16 ? kNm / 2 : kNm) * PS);

  const int n = min(max(num[b], 0), max_det);
  index += static_cast<size_t>(b) * max_det;
  boxes += static_cast<size_t>(b) * max_det * 4;
  out += static_cast<size_t>(b) * max_det * Hp * Wb;
  if (tid == 0) n_items = 0;
  __syncthreads();

  // 1. the boxes whose crops meet the band
  const float fy0 = static_cast<float>(y0);
  const float fy1 = fy0 + static_cast<float>(rows);
  const float fw = static_cast<float>(Wp);
  for (int j = tid; j < n; j += kThreads) {
    const float4 q = reinterpret_cast<const float4*>(boxes)[j];
    const float cx1 = q.x * sx, cy1 = q.y * sy;
    const float cx2 = q.z * sx, cy2 = q.w * sy;
    // rows y with cy1 <= y < cy2 and pixels x with cx1 <= x < cx2, clamped
    // to the band before the casts; the x test is made again per pixel
    const int ylo = static_cast<int>(ceilf(fminf(fmaxf(cy1, fy0), fy1)));
    const int yhi = static_cast<int>(ceilf(fmaxf(fminf(cy2, fy1), fy0)));
    const int xlo = static_cast<int>(ceilf(fminf(fmaxf(cx1, 0.f), fw)));
    const int xhi = static_cast<int>(ceilf(fmaxf(fminf(cx2, fw), 0.f)));
    const int a = index[j];
    if (ylo < yhi && xlo < xhi && a >= 0 && a < A)
      items[atomicAdd(&n_items, 1)] = Item{j, a, ylo, yhi, xlo, xhi, cx1, cx2};
  }

  // ... the band of prototypes, 16 bytes a load (8 bf16 or 4 f32 channels)
  constexpr int kQuads = kBf16 ? kNm / 8 : kNm / 4;  // uint4 a pixel
  const size_t pix0 = (static_cast<size_t>(b) * Hp + y0) * Wp;
  const uint4* src = static_cast<const uint4*>(proto) + pix0 * kQuads;
  for (int e = tid; e < rows * Wp * kQuads; e += kThreads) {
    const uint4 v = src[e];
    const int p = e / kQuads;
    uint32_t* d = band + (e % kQuads) * 4 * PS + p;
    d[0] = v.x;
    d[PS] = v.y;
    d[2 * PS] = v.z;
    d[3 * PS] = v.w;
  }
  // ... and zeros in the band's rows of every box
  const int seg = rows * Wb;  // bytes of one box's band
  if ((Hp * Wb) % 16 == 0 && (y0 * Wb) % 16 == 0 && seg % 16 == 0) {
    const int sv = seg / 16;
    for (int e = tid; e < max_det * sv; e += kThreads) {
      const int j = e / sv;
      reinterpret_cast<uint4*>(out + (static_cast<size_t>(j) * Hp + y0) *
                                         Wb)[e - j * sv] =
          make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int e = tid; e < max_det * seg; e += kThreads) {
      const int j = e / seg;
      out[(static_cast<size_t>(j) * Hp + y0) * Wb + e - j * seg] = 0u;
    }
  }
  __syncthreads();

  // 2. the words the listed boxes' crops touch in this band
  const bool word_store = (Wb & 3) == 0;
  for (int i = warp; i < n_items; i += kWarps) {
    const Item it = items[i];
    const int j = it.j, ylo = it.ylo, yhi = it.yhi;
    const int xlo = it.xlo, xhi = it.xhi;
    const float cx1 = it.cx1, cx2 = it.cx2;
    coef[warp][lane] =
        decode[(static_cast<size_t>(b) * A + it.a) * ncol + coff + lane];
    __syncwarp();
    const float4* c4 = reinterpret_cast<const float4*>(coef[warp]);
    for (int y = ylo; y < yhi; ++y) {
      for (int w = xlo >> 5; w <= (xhi - 1) >> 5; ++w) {
        const int x = 32 * w + lane;
        const float fx = static_cast<float>(x);
        const bool in = x < Wp && fx >= cx1 && fx < cx2;
        const int p = (y - y0) * Wp + min(x, Wp - 1);
        float v = 0.f;
#pragma unroll
        for (int k = 0; k < kNm / 4; ++k) {
          const float4 c = c4[k];
          if (kBf16) {
            const uint32_t p0 = band[(2 * k) * PS + p];
            const uint32_t p1 = band[(2 * k + 1) * PS + p];
            v = fmaf(c.x, __uint_as_float(p0 << 16), v);
            v = fmaf(c.y, __uint_as_float(p0 & 0xffff0000u), v);
            v = fmaf(c.z, __uint_as_float(p1 << 16), v);
            v = fmaf(c.w, __uint_as_float(p1 & 0xffff0000u), v);
          } else {
            v = fmaf(c.x, __uint_as_float(band[(4 * k) * PS + p]), v);
            v = fmaf(c.y, __uint_as_float(band[(4 * k + 1) * PS + p]), v);
            v = fmaf(c.z, __uint_as_float(band[(4 * k + 2) * PS + p]), v);
            v = fmaf(c.w, __uint_as_float(band[(4 * k + 3) * PS + p]), v);
          }
        }
        const unsigned bits = __ballot_sync(kFull, in && v > 0.f);
        if (lane == 0) {
          uint8_t* dst = out + (static_cast<size_t>(j) * Hp + y) * Wb + 4 * w;
          if (word_store) {
            *reinterpret_cast<uint32_t*>(dst) = bits;
          } else {
            for (int t = 0; t < min(4, Wb - 4 * w); ++t)
              dst[t] = (bits >> (8 * t)) & 0xffu;
          }
        }
      }
    }
    __syncwarp();  // the slot is read before the warp's next box fills it
  }
}

}  // namespace

// decode: (B, A, ncol) f32, the coefficients at columns coff .. coff + 31;
// index: (B, max_det) int32 anchors of the kept boxes; boxes: (B, max_det, 4)
// f32 xyxy in input pixels; num: (B,) int32; proto: (B, Hp, Wp, 32) NHWC,
// bf16 (is_bf16) or f32; sx, sy: the proto's size over the input's; out:
// (B, max_det, Hp, Wp / 8) uint8.
extern "C" int desenet_mask_assembly(const void* decode, int A, int ncol,
                                     int coff, const void* index,
                                     const void* boxes, const void* num,
                                     const void* proto, int is_bf16, int B,
                                     int Hp, int Wp, int max_det, float sx,
                                     float sy, void* out, void* stream,
                                     int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const int chan_words = is_bf16 ? kNm / 2 : kNm;
  const size_t smem =
      static_cast<size_t>(chan_words) * (kBand * Wp + 1) * 4 +
      static_cast<size_t>(max_det) * sizeof(Item);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  const auto kern = is_bf16 ? mask_assembly_kernel<true>
                            : mask_assembly_kernel<false>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  if (B == 0 || Hp == 0 || max_det == 0) return cudaSuccess;
  const dim3 grid((Hp + kBand - 1) / kBand, B);
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(decode), A, ncol, coff,
      static_cast<const int*>(index), static_cast<const float*>(boxes),
      static_cast<const int*>(num), proto, Hp, Wp, max_det, sx, sy,
      static_cast<uint8_t*>(out));
  return cudaGetLastError();
}
