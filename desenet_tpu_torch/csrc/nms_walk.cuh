// The two greedy-NMS selections that K3 (nms_greedy.cu) and K1 (nms_fused.cu)
// share, for one image per block of kThreads threads:
//
// - ordered_walk: one walk over candidates that are already in (score
//   descending, index ascending) order, keeping a candidate iff no earlier
//   kept one covers it. The prefix is walked kThreads candidates at a time.
//   (a) Every thread tests its candidate against the kept list so far (boxes
//   and areas in shared memory, every lane on the same entry: a broadcast).
//   (b) The survivors are compacted in order (at most kSurv of them; the walk
//   resumes behind the last one taken) and settle among themselves through an
//   upper-triangular bit mask, bit (a, b) = "a covers b" for a < b, computed
//   by all threads. (c) One warp scans the mask 32 survivors at a time: the
//   32 x 32 diagonal block is fetched by shuffles into registers and resolved
//   by a chain of register operations, then the kept rows are ORed into the
//   lanes' removed-words with loads that are all in flight together: no
//   barrier and no dependent memory access inside the scan. (d) The new picks
//   are appended to the kept list and handed to the caller's emit(rank,
//   candidate). About seven barriers per kThreads candidates instead of two
//   per pick; a sparse set ends after one round, a dense one walks the whole
//   prefix with a short list.
// - argmax_loop: for candidates in any order. The live candidates are first
//   compacted in index order (index, score, area), so a pick walks the live
//   ones only; suppression and the next argmax are one pass and a pick ends
//   in one barrier (the warps' partial results go to one of two slots in
//   turn, and every warp reduces the 32 partials itself).
//
// The callers differ in where a box comes from (K3: a float4 array in device
// memory; K1: its sorted candidates in shared memory, or four planes) and in
// what a pick writes, so the box source and the emit are functors.
//
// Ties on equal scores go to the lower index in both (jnp.argmax order).
// Arithmetic uses the _rn intrinsics so that nvcc fuses no multiply-add: the
// IoU is bit for bit the plain version's
// inter / (barea + area - inter + 1e-9), the earlier (kept) box in the barea
// place. An empty intersection skips the division: 0 / den > thr is false for
// every thr >= 0 (den >= 1e-9, or NaN).

#pragma once

#include <cuda_runtime.h>

#include <cfloat>
#include <climits>

namespace nms {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kLoopCap = 16384;  // argmax_loop: 3 fields * 4 B * 16384 = 196,608 B
constexpr int kSurv = 512;       // survivors settled per round of the walk
constexpr int kSurvWords = kSurv / 32;
constexpr int kKeptCap = 2048;   // largest max_det the walk takes
constexpr unsigned kFull = 0xffffffffu;

static_assert(kWarps == 32, "block_scan and the pick loop reduce 32 partials");

// the walk's shared memory
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

// The ordered walk over the candidates [0, L), which are in (score
// descending, index ascending) order. emit(r, j): candidate j is pick r.
template <class Emit>
__device__ void ordered_walk(Walk& S, int* wtot, int* s_next, int* s_nk,
                             const float4* __restrict__ boxes, int L,
                             int max_det, float thr, Emit emit) {
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
    // (d) append the picks to the kept list and hand them to the caller
    if (tid < ns) {
      const unsigned bits = S.keptbits[warp];
      if ((bits >> lane) & 1u) {
        int r = nk + __popc(bits & ((1u << lane) - 1u));
        for (int w2 = 0; w2 < warp; ++w2) r += __popc(S.keptbits[w2]);
        S.kbox[r] = S.sbox[tid];
        S.karea[r] = S.sarea[tid];
        emit(r, S.sj[tid]);
      }
    }
    nk = *s_nk;
    pos = *s_next;
    __syncthreads();
  }
}

// The argmax loop over the live ones of K candidates in any order. live, area
// and cidx hold K values each; box(j) is candidate j's float4; emit(r, j, s):
// candidate j, of score s, is pick r.
template <class Box, class Emit>
__device__ void argmax_loop(float* live, float* area, int* cidx, int* wtot,
                            float (*red_s)[kWarps], int (*red_i)[kWarps],
                            Box box, const float* __restrict__ scores, int K,
                            int max_det, float thr, Emit emit) {
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
      area[r] = box_area(box(j));
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
    if (tid == 0) emit(k, jb, m);
    const float4 p = box(jb);
    const float barea = area[ib];
    bs = -FLT_MAX;
    bi = INT_MAX;
    for (int i = tid; i < n; i += kThreads) {
      float s = live[i];
      if (s > 0.f) {
        if (i == ib || covers(p, barea, box(cidx[i]), area[i], thr, skip_empty)) {
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

}  // namespace nms
