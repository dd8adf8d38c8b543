// K1: fused candidate selection + greedy NMS over all anchors, one image per
// thread block.
//
// Replaces: desenet_tpu/ops/nms_fused.py, _fused_kernel (called through
// _run_kernel / fused_select_nms), a Pallas TPU kernel that keeps six dense
// (A/128, 128) planes of one image in VMEM and runs argmax -> write row ->
// IoU suppress over all of them until max_det picks or no score > 0.
//
// What bounds it on the H100: latency, not bytes. The six (B, A) f32 planes
// are 77 MB at B = 128, A = 25200, about 23 us of device-memory time, and the
// IoU tests of a few hundred candidates are nothing; what costs is every
// point at which the whole block waits: a barrier per chunk of a block-wide
// scan, two or three per pick of an argmax loop. One block an image stays
// (128 images on 132 SMs), so the design removes the waits.
//
// What the design does about it, per image:
//
// 1. Count and compact in one pass with no barrier inside: every warp reads
//    32 scores, ballots score > 0 (the prep in torch has already applied
//    conf_thres and the class filter), takes room with one shared-memory
//    atomic and writes a 64-bit key per candidate, (~score bits, anchor
//    index). The keys land in no order: the sort restores it. Only the score
//    plane is read whole; the other five planes are read at the candidates.
// 2. Order once. Ascending keys are (score descending, anchor ascending),
//    the order in which an argmax loop would visit the candidates and break
//    its ties (jnp.argmax: the lowest anchor index). A bitonic sort in shared
//    memory over the next power of two, up to kCandCap (4096) candidates: 36
//    barriers at 256 keys, 78 at 4096. (A rank by counting, every thread
//    counting the keys below its own, was measured beside it up to 1024
//    candidates and was no faster, so one sort stays.) The boxes and classes
//    are then gathered into shared memory in that order.
// 3. nms_walk.cuh's ordered_walk, which kernel K3 shares: the candidates a
//    round against the kept list, the survivors' cover mask, one warp's
//    register scan, the picks written as rows. A few hundred candidates are
//    one round. paths[b] = 0.
//
// An image with more than kCandCap candidates (28 bytes each beside the
// walk's 86 KB: 200,768 B of the block's 227 KB), or a max_det above the
// walk's kKeptCap (2048), takes nms_walk.cuh's argmax_loop over all A
// anchors instead: it compacts in anchor order and ends a pick in one
// barrier (shared memory up to kLoopCap anchors, above that the wrapper's
// (B, 3, A) scratch). paths[b] = 1. The choice is made here, on the device,
// by the count alone; any score may pass the threshold, so that path is
// always there.
//
// index, where the caller passes one, gets each pick's anchor (-1 after the
// last pick): a Segment model's masks read their coefficients there.
//
// The IoU is bit for bit the plain PyTorch version's
// inter / (barea + area - inter + 1e-9), the picked box in the barea place
// (nms_walk.cuh), so the rows equal greedy_select_plain's on every input.

#include <cuda_runtime.h>

#include <cstdint>

#include "nms_walk.cuh"

namespace {

using namespace nms;

constexpr int kCandCap = 4096;  // candidates an image the ordered path takes

// the ordered path's shared memory
struct Ordered {
  Walk walk;
  unsigned long long key[kCandCap];
  float4 box[kCandCap];  // in walk order
  float cls[kCandCap];
};

constexpr int kSmemBytes =
    sizeof(Ordered) > 3 * kLoopCap * sizeof(float)
        ? static_cast<int>(sizeof(Ordered))
        : 3 * kLoopCap * static_cast<int>(sizeof(float));

__device__ __forceinline__ float key_score(unsigned long long key) {
  return __uint_as_float(~static_cast<unsigned>(key >> 32));
}

struct Planes {
  const float* __restrict__ x1;
  const float* __restrict__ y1;
  const float* __restrict__ x2;
  const float* __restrict__ y2;
  __device__ __forceinline__ float4 operator()(int j) const {
    return make_float4(x1[j], y1[j], x2[j], y2[j]);
  }
};

__device__ __forceinline__ void write_row(float* __restrict__ out, int r,
                                          const float4 q, float s, float c) {
  float* row = out + r * 6;
  row[0] = q.x;
  row[1] = q.y;
  row[2] = q.z;
  row[3] = q.w;
  row[4] = s;
  row[5] = c;
}

// A pick of the walk: candidate j of the sorted arrays.
struct EmitSorted {
  const Ordered* S;
  float* __restrict__ out;
  int* __restrict__ index;
  __device__ __forceinline__ void operator()(int r, int j) const {
    write_row(out, r, S->box[j], key_score(S->key[j]), S->cls[j]);
    if (index) index[r] = static_cast<int>(static_cast<unsigned>(S->key[j]));
  }
};

// A pick of the argmax loop: anchor j.
struct EmitAnchor {
  Planes box;
  const float* __restrict__ cls;
  float* __restrict__ out;
  int* __restrict__ index;
  __device__ __forceinline__ void operator()(int r, int j, float s) const {
    write_row(out, r, box(j), s, cls[j]);
    if (index) index[r] = j;
  }
};

__global__ void __launch_bounds__(kThreads)
    nms_fused_kernel(const float* __restrict__ x1, const float* __restrict__ y1,
                     const float* __restrict__ x2, const float* __restrict__ y2,
                     const float* __restrict__ score,
                     const float* __restrict__ cls, int A, int max_det,
                     float iou_thres, float* __restrict__ scratch,
                     float* __restrict__ out, int* __restrict__ paths,
                     int* __restrict__ index) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int wtot[kWarps];
  __shared__ float red_s[2][kWarps];
  __shared__ int red_i[2][kWarps];
  __shared__ int s_next;
  __shared__ int s_nk;
  __shared__ int n_cand;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const size_t off = static_cast<size_t>(b) * A;
  const Planes box{x1 + off, y1 + off, x2 + off, y2 + off};
  score += off;
  cls += off;
  out += static_cast<size_t>(b) * max_det * 6;
  if (index) index += static_cast<size_t>(b) * max_det;
  Ordered& S = *reinterpret_cast<Ordered*>(smem);

  for (int j = tid; j < max_det * 6; j += kThreads) out[j] = 0.f;
  if (index)
    for (int j = tid; j < max_det; j += kThreads) index[j] = -1;
  if (tid == 0) n_cand = 0;
  __syncthreads();

  // 1. count and compact: keys in arrival order, no barrier inside
  for (int base = 0; base < A; base += kThreads) {
    const int j = base + tid;
    const float s = j < A ? score[j] : -1.f;
    const bool keep = s > 0.f;
    const unsigned bal = __ballot_sync(kFull, keep);
    if (bal == 0u) continue;  // uniform over the warp
    int at = 0;
    if (lane == 0) at = atomicAdd(&n_cand, __popc(bal));
    at = __shfl_sync(kFull, at, 0) + __popc(bal & ((1u << lane) - 1u));
    if (keep && at < kCandCap)
      S.key[at] = (static_cast<unsigned long long>(~__float_as_uint(s)) << 32) |
                  static_cast<unsigned>(j);
  }
  __syncthreads();
  const int n = n_cand;
  const bool ordered = n <= kCandCap && max_det <= kKeptCap;
  if (tid == 0) paths[b] = ordered ? 0 : 1;

  if (!ordered) {
    float* live = A <= kLoopCap ? reinterpret_cast<float*>(smem)
                                : scratch + static_cast<size_t>(b) * 3 * A;
    argmax_loop(live, live + A, reinterpret_cast<int*>(live + 2 * A), wtot,
                red_s, red_i, box, score, A, max_det, iou_thres,
                EmitAnchor{box, cls, out, index});
    return;
  }

  // 2. order once (bitonic, ascending, the tail padded with the largest
  // key), then gather in that order
  int N = 32;
  while (N < n) N <<= 1;
  for (int i = n + tid; i < N; i += kThreads) S.key[i] = ~0ull;
  __syncthreads();
  for (int k = 2; k <= N; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < N; i += kThreads) {
        const int p = i ^ j;
        if (p > i) {
          const unsigned long long a = S.key[i], c = S.key[p];
          if ((a > c) == ((i & k) == 0)) {
            S.key[i] = c;
            S.key[p] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < n; i += kThreads) {
    const int j = static_cast<int>(static_cast<unsigned>(S.key[i]));
    S.box[i] = box(j);
    S.cls[i] = cls[j];
  }
  __syncthreads();

  // 3. the walk over the n sorted candidates
  ordered_walk(S.walk, wtot, &s_next, &s_nk, S.box, n, max_det, iou_thres,
               EmitSorted{&S, out, index});
}

}  // namespace

// scratch: (B, 3, A) floats where A > kLoopCap (16384), else unused. paths:
// (B,) ints, 0 where the image took the ordered walk, 1 where the argmax loop.
// index: (B, max_det) ints, each pick's anchor (-1 after the last), or null.
extern "C" int desenet_nms_fused(const void* x1, const void* y1,
                                 const void* x2, const void* y2,
                                 const void* score, const void* cls, int B,
                                 int A, int max_det, float iou_thres,
                                 void* scratch, void* out, void* paths,
                                 void* index, void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(nms_fused_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemBytes);
  if (e != cudaSuccess) return e;
  if (B == 0) return cudaSuccess;
  nms_fused_kernel<<<B, kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x1), static_cast<const float*>(y1),
      static_cast<const float*>(x2), static_cast<const float*>(y2),
      static_cast<const float*>(score), static_cast<const float*>(cls), A,
      max_det, iou_thres, static_cast<float*>(scratch),
      static_cast<float*>(out), static_cast<int*>(paths),
      static_cast<int*>(index));
  return cudaGetLastError();
}
