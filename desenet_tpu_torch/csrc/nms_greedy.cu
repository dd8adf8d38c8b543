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
// - path 0, the ordered walk (the order holds and max_det <= kKeptCap). The
//   prefix is walked kThreads candidates at a time. (a) Every thread tests
//   its candidate against the kept list so far (boxes and areas in shared
//   memory, every lane on the same entry: a broadcast). (b) The survivors
//   are compacted in order (at most kSurv of them; the walk resumes behind
//   the last one taken) and settle among themselves through an
//   upper-triangular bit mask, bit (a, b) = "a covers b" for a < b, computed
//   by all threads. (c) One warp scans the mask 32 survivors at a time: the
//   32 x 32 diagonal block is fetched by shuffles into registers and
//   resolved by a chain of register operations, then the kept rows are ORed
//   into the lanes' removed-words with loads that are all in flight
//   together: no barrier and no dependent memory access inside the scan.
//   (d) The new picks are appended to the kept list and written out. About
//   seven barriers per kThreads candidates instead of two per pick; a sparse
//   set ends after one round, a dense one walks all of L with a short list.
// - path 1, the argmax loop, for any other order. The live candidates are
//   first compacted (index, score, area; shared memory up to kSmemCap
//   candidates, above that a global scratch of the wrapper's), so a pick
//   walks the live ones only; suppression and the next argmax are one pass
//   and a pick ends in one barrier (the warps' partial results go to one of
//   two slots in turn, and every warp reduces the 32 partials itself).
//
// Ties on equal scores go to the lower index on both paths (jnp.argmax
// order). Arithmetic uses the _rn intrinsics so that nvcc fuses no
// multiply-add: the IoU is bit for bit the plain version's
// inter / (barea + area - inter + 1e-9), the earlier (kept) box in the barea
// place. An empty intersection skips the division: 0 / den > thr is false for
// every thr >= 0 (den >= 1e-9, or NaN).

#include <cuda_runtime.h>

#include <cfloat>
#include <climits>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemCap = 16384;  // path 1: 3 fields * 4 B * 16384 = 196,608 B
constexpr int kSurv = 512;       // survivors settled per round of path 0
constexpr int kSurvWords = kSurv / 32;
constexpr int kKeptCap = 2048;   // largest max_det path 0 takes
constexpr unsigned kFull = 0xffffffffu;

static_assert(kWarps == 32, "block_scan and the pick loop reduce 32 partials");

// path 0's shared memory
struct Walk {
  float4 kbox[kKeptCap];
  float4 sbox[kSurv];
  float karea[kKeptCap];
  float sarea[kSurv];
  int sj[kSurv];
  unsigned mask[kSurv * kSurvWords];
  unsigned keptbits[kSurvWords];
};

__device__ __forceinline__ bool better(float s, int i, float s2, int i2) {
  return s > s2 || (s == s2 && i < i2);
}

__device__ __forceinline__ float box_area(const float4 q) {
  return __fmul_rn(fmaxf(__fsub_rn(q.z, q.x), 0.f),
                   fmaxf(__fsub_rn(q.w, q.y), 0.f));
}

// Does the kept box p (area barea) cover q (area qarea): IoU > thr.
__device__ __forceinline__ bool covers(const float4 p, float barea,
                                       const float4 q, float qarea, float thr,
                                       bool skip_empty) {
  const float iw = fmaxf(__fsub_rn(fminf(p.z, q.z), fmaxf(p.x, q.x)), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(p.w, q.w), fmaxf(p.y, q.y)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  if (skip_empty && inter == 0.f) return false;
  const float den = __fadd_rn(__fsub_rn(__fadd_rn(barea, qarea), inter), 1e-9f);
  return __fdiv_rn(inter, den) > thr;
}

// Exclusive prefix count of flag over the block's threads, and the total.
// Two barriers; wtot is kWarps ints of shared memory.
__device__ __forceinline__ int block_scan(bool flag, int* wtot, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned bal = __ballot_sync(kFull, flag);
  if (lane == 0) wtot[warp] = __popc(bal);
  __syncthreads();
  const int v = wtot[lane];
  int inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += n;
  }
  *total = __shfl_sync(kFull, inc, 31);
  const int woff = __shfl_sync(kFull, inc - v, warp);
  __syncthreads();
  return woff + __popc(bal & ((1u << lane) - 1u));
}

// Path 0: the ordered walk over the live prefix [0, L).
__device__ void ordered_walk(Walk& S, int* wtot, int* s_next, int* s_nk,
                             const float4* __restrict__ boxes,
                             const float* __restrict__ scores, int L,
                             int max_det, float thr, int* __restrict__ keep_idx,
                             float* __restrict__ keep_sc) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool skip_empty = thr >= 0.f;
  int nk = 0;
  int pos = 0;
  while (pos < L && nk < max_det) {
    // (a) every candidate of the round against the kept list
    const int C = min(kThreads, L - pos);
    const int j = pos + tid;
    bool alive = tid < C;
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    float qarea = 0.f;
    if (alive) {
      q = boxes[j];
      qarea = box_area(q);
      for (int k = 0; k < nk; ++k) {
        if (covers(S.kbox[k], S.karea[k], q, qarea, thr, skip_empty)) {
          alive = false;
          break;
        }
      }
    }
    // (b) the first kSurv survivors, in order, and their mask
    int ns_all;
    const int rank = block_scan(alive, wtot, &ns_all);
    if (alive && rank < kSurv) {
      S.sbox[rank] = q;
      S.sarea[rank] = qarea;
      S.sj[rank] = j;
      // more survivors than a round settles: resume behind the last taken
      if (rank == kSurv - 1 && ns_all > kSurv) *s_next = j + 1;
    }
    if (tid == 0 && ns_all <= kSurv) *s_next = pos + C;
    if (tid < kSurvWords) S.keptbits[tid] = 0u;
    __syncthreads();
    const int ns = min(ns_all, kSurv);
    const int W = (ns + 31) >> 5;
    for (int e = tid; e < ns * W; e += kThreads) {
      const int wb = e / ns;
      const int a = e - wb * ns;
      unsigned bits = 0u;
      if (wb * 32 + 31 > a) {
        const float4 p = S.sbox[a];
        const float parea = S.sarea[a];
        for (int bit = 0; bit < 32; ++bit) {
          const int b2 = wb * 32 + bit;
          if (b2 > a && b2 < ns &&
              covers(p, parea, S.sbox[b2], S.sarea[b2], thr, skip_empty))
            bits |= 1u << bit;
        }
      }
      S.mask[a * kSurvWords + wb] = bits;
    }
    __syncthreads();
    // (c) one warp settles the survivors, 32 at a time
    if (warp == 0) {
      unsigned rem = 0u;  // lane w: the removed bits of survivors 32w..32w+31
      int n = nk;
      for (int g = 0; g < W && n < max_det; ++g) {
        const int cnt = min(32, ns - 32 * g);
        const unsigned diag =
            lane < cnt ? S.mask[(32 * g + lane) * kSurvWords + g] : 0u;
        unsigned alive_bits = ~__shfl_sync(kFull, rem, g) &
                              (cnt == 32 ? kFull : (1u << cnt) - 1u);
        // the shuffles do not depend on the chain, so they run ahead of it
        unsigned kept = 0u;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const unsigned row = __shfl_sync(kFull, diag, i);
          const unsigned bit = (alive_bits >> i) & 1u;
          kept |= bit << i;
          alive_bits &= ~(row & (0u - bit));
        }
        const int room = max_det - n;
        while (__popc(kept) > room) kept &= ~(0x80000000u >> __clz(kept));
        if (lane == 0) S.keptbits[g] = kept;
        n += __popc(kept);
        unsigned add = 0u;
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if ((kept >> i) & 1u)
            add |= S.mask[(32 * g + i) * kSurvWords + (lane & (kSurvWords - 1))];
        rem |= add;
      }
      if (lane == 0) *s_nk = n;
    }
    __syncthreads();
    // (d) append the picks to the kept list and write them out
    if (tid < ns) {
      const unsigned bits = S.keptbits[warp];
      if ((bits >> lane) & 1u) {
        int r = nk + __popc(bits & ((1u << lane) - 1u));
        for (int w2 = 0; w2 < warp; ++w2) r += __popc(S.keptbits[w2]);
        const int jj = S.sj[tid];
        S.kbox[r] = S.sbox[tid];
        S.karea[r] = S.sarea[tid];
        keep_idx[r] = jj;
        keep_sc[r] = scores[jj];
      }
    }
    nk = *s_nk;
    pos = *s_next;
    __syncthreads();
  }
}

// Path 1: the argmax loop over the compacted live candidates. live, area and
// cidx hold K values each.
__device__ void argmax_loop(float* live, float* area, int* cidx, int* wtot,
                            float (*red_s)[kWarps], int (*red_i)[kWarps],
                            const float4* __restrict__ boxes,
                            const float* __restrict__ scores, int K,
                            int max_det, float thr, int* __restrict__ keep_idx,
                            float* __restrict__ keep_sc) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool skip_empty = thr >= 0.f;
  // compact the live candidates, in index order
  int n = 0;
  for (int base = 0; base < K; base += kThreads) {
    const int j = base + tid;
    const float s = j < K ? scores[j] : -1.f;
    int total;
    const int r = n + block_scan(s > 0.f, wtot, &total);
    if (s > 0.f) {
      live[r] = s;
      area[r] = box_area(boxes[j]);
      cidx[r] = j;
    }
    n += total;
  }
  __syncthreads();

  // Every thread owns the compacted entries i = tid + t * kThreads. Ties by
  // i, which rises with the candidate's index.
  float bs = -FLT_MAX;
  int bi = INT_MAX;
  for (int i = tid; i < n; i += kThreads) {
    const float s = live[i];
    if (better(s, i, bs, bi)) {
      bs = s;
      bi = i;
    }
  }
  for (int k = 0;; ++k) {
    // block argmax of (bs, bi): one barrier, the slots taken in turn
    for (int o = 16; o; o >>= 1) {
      const float s2 = __shfl_xor_sync(kFull, bs, o);
      const int i2 = __shfl_xor_sync(kFull, bi, o);
      if (better(s2, i2, bs, bi)) {
        bs = s2;
        bi = i2;
      }
    }
    if (lane == 0) {
      red_s[k & 1][warp] = bs;
      red_i[k & 1][warp] = bi;
    }
    __syncthreads();
    float m = red_s[k & 1][lane];
    int ib = red_i[k & 1][lane];
    for (int o = 16; o; o >>= 1) {
      const float s2 = __shfl_xor_sync(kFull, m, o);
      const int i2 = __shfl_xor_sync(kFull, ib, o);
      if (better(s2, i2, m, ib)) {
        m = s2;
        ib = i2;
      }
    }
    if (k == max_det || !(m > 0.f)) break;  // uniform over the block
    const int jb = cidx[ib];
    if (tid == 0) {
      keep_idx[k] = jb;
      keep_sc[k] = m;
    }
    const float4 p = boxes[jb];
    const float barea = area[ib];
    bs = -FLT_MAX;
    bi = INT_MAX;
    for (int i = tid; i < n; i += kThreads) {
      float s = live[i];
      if (s > 0.f) {
        if (i == ib ||
            covers(p, barea, boxes[cidx[i]], area[i], thr, skip_empty)) {
          s = -1.f;
          live[i] = s;
        }
      }
      if (better(s, i, bs, bi)) {
        bs = s;
        bi = i;
      }
    }
  }
}

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
                 scores, L, max_det, iou_thres, keep_idx, keep_sc);
  } else {
    float* live = K <= kSmemCap ? reinterpret_cast<float*>(smem)
                                : scratch + static_cast<size_t>(b) * 3 * K;
    argmax_loop(live, live + K, reinterpret_cast<int*>(live + 2 * K), wtot,
                red_s, red_i, boxes, scores, K, max_det, iou_thres, keep_idx,
                keep_sc);
  }
}

}  // namespace

// scratch: (B, 3, K) floats where K > kSmemCap, else unused. paths: (B,)
// ints, 0 where the image took the ordered walk, 1 where the argmax loop.
extern "C" int desenet_nms_greedy(const void* boxes, const void* scores, int B,
                                  int K, int max_det, float iou_thres,
                                  void* scratch, void* keep_idx, void* keep_sc,
                                  void* paths, void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  constexpr int kMaxSmem = 3 * kSmemCap * static_cast<int>(sizeof(float));
  static_assert(sizeof(Walk) <= kMaxSmem, "the walk's shared memory");
  e = cudaFuncSetAttribute(nms_greedy_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmem);
  if (e != cudaSuccess) return e;
  if (B == 0) return cudaSuccess;
  const int loop_bytes =
      K <= kSmemCap ? 3 * K * static_cast<int>(sizeof(float)) : 0;
  const int smem = max(static_cast<int>(sizeof(Walk)), loop_bytes);
  nms_greedy_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores), K,
      max_det, iou_thres, static_cast<float*>(scratch),
      static_cast<int*>(keep_idx), static_cast<float*>(keep_sc),
      static_cast<int*>(paths));
  return cudaGetLastError();
}
