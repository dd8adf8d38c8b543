// K3: batched greedy NMS over a pre-selected (B, K) candidate set, one image
// per thread block.
//
// Replaces: desenet_tpu/ops/nms_pallas.py, _nms_kernel (called through
// greedy_nms_pallas), a Pallas TPU kernel that keeps the four box planes,
// the scores and a live-score scratch of the whole batch in VMEM and advances
// every image together: argmax -> one-hot gather -> IoU row -> suppress,
// until max_det picks or no image has a live score.
//
// What bounds it on the H100: latency, not work. The IoU tests of the
// validation shape (B = 32, K = 16384, 7200 live, 300 picks) are 1.1 GFLOP
// over 10 MB, microseconds of the card; a loop of one block-wide argmax and
// one suppression pass per pick is max_det dependent steps of two barriers
// each, whatever the work.
//
// What the design does about it: order once, then walk in blocks. Greedy
// NMS by argmax equals one walk over the candidates in (score descending,
// index ascending) order that keeps a candidate iff no earlier kept one
// covers it. The validation path hands over exactly that order (a stable
// descending sort), so a first pass over the scores finds the number of live
// candidates L and whether the live scores are non-increasing by index (the
// live ones are then a prefix), and the block takes one of two paths, chosen
// here, on the device, per image (paths[b] says which):
//
// - path 0, the ordered walk (the order holds and max_det <= kKeptCap):
//   nms_walk.cuh's ordered_walk over the live prefix, which kernel K1 shares;
// - path 1, nms_walk.cuh's argmax_loop, for any other order (shared memory up
//   to kLoopCap candidates, above that a global scratch of the wrapper's).
//
// Ties on equal scores go to the lower index on both paths (jnp.argmax
// order), and the IoU is bit for bit the plain version's (nms_walk.cuh).

#include <cuda_runtime.h>

#include "nms_walk.cuh"

namespace {

using namespace nms;

struct BoxArray {
  const float4* __restrict__ boxes;
  __device__ __forceinline__ float4 operator()(int j) const { return boxes[j]; }
};

// A pick writes its candidate's index and score.
struct EmitIndex {
  const float* __restrict__ scores;
  int* __restrict__ keep_idx;
  float* __restrict__ keep_sc;
  __device__ __forceinline__ void operator()(int r, int j) const {
    keep_idx[r] = j;
    keep_sc[r] = scores[j];
  }
  __device__ __forceinline__ void operator()(int r, int j, float s) const {
    keep_idx[r] = j;
    keep_sc[r] = s;
  }
};

__global__ void __launch_bounds__(kThreads)
    nms_greedy_kernel(const float4* __restrict__ boxes,
                      const float* __restrict__ scores, int K, int max_det,
                      float iou_thres, float* __restrict__ scratch,
                      int* __restrict__ keep_idx, float* __restrict__ keep_sc,
                      int* __restrict__ paths) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int wtot[kWarps];
  __shared__ float red_s[2][kWarps];
  __shared__ int red_i[2][kWarps];
  __shared__ int s_next;
  __shared__ int s_nk;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  boxes += static_cast<size_t>(b) * K;
  scores += static_cast<size_t>(b) * K;
  keep_idx += static_cast<size_t>(b) * max_det;
  keep_sc += static_cast<size_t>(b) * max_det;

  for (int k = tid; k < max_det; k += kThreads) {
    keep_idx[k] = 0;
    keep_sc[k] = -1.f;
  }

  // L live candidates; ordered: every live score is at most the score before
  // it, so the live ones are a prefix in walk order
  bool ok = true;
  int L = 0;
  for (int base = 0; base < K; base += kThreads) {
    const int j = base + tid;
    const float s = j < K ? scores[j] : -1.f;
    if (j + 1 < K) {
      const float s1 = scores[j + 1];
      if (s1 > 0.f && !(s >= s1)) ok = false;
    }
    L += __syncthreads_count(s > 0.f);
  }
  const bool ordered = __syncthreads_and(ok) && max_det <= kKeptCap;
  if (tid == 0) paths[b] = ordered ? 0 : 1;

  if (ordered) {
    ordered_walk(*reinterpret_cast<Walk*>(smem), wtot, &s_next, &s_nk, boxes,
                 L, max_det, iou_thres, EmitIndex{scores, keep_idx, keep_sc});
  } else {
    float* live = K <= kLoopCap ? reinterpret_cast<float*>(smem)
                                : scratch + static_cast<size_t>(b) * 3 * K;
    argmax_loop(live, live + K, reinterpret_cast<int*>(live + 2 * K), wtot,
                red_s, red_i, BoxArray{boxes}, scores, K, max_det, iou_thres,
                EmitIndex{scores, keep_idx, keep_sc});
  }
}

}  // namespace

// scratch: (B, 3, K) floats where K > kLoopCap, else unused. paths: (B,)
// ints, 0 where the image took the ordered walk, 1 where the argmax loop.
extern "C" int desenet_nms_greedy(const void* boxes, const void* scores, int B,
                                  int K, int max_det, float iou_thres,
                                  void* scratch, void* keep_idx, void* keep_sc,
                                  void* paths, void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  constexpr int kMaxSmem = 3 * kLoopCap * static_cast<int>(sizeof(float));
  static_assert(sizeof(Walk) <= kMaxSmem, "the walk's shared memory");
  e = cudaFuncSetAttribute(nms_greedy_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmem);
  if (e != cudaSuccess) return e;
  if (B == 0) return cudaSuccess;
  const int loop_bytes =
      K <= kLoopCap ? 3 * K * static_cast<int>(sizeof(float)) : 0;
  const int smem = max(static_cast<int>(sizeof(Walk)), loop_bytes);
  nms_greedy_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores), K,
      max_det, iou_thres, static_cast<float*>(scratch),
      static_cast<int*>(keep_idx), static_cast<float*>(keep_sc),
      static_cast<int*>(paths));
  return cudaGetLastError();
}
