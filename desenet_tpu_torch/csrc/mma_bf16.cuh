// The tensor-core tile that K4's conv_gemm and K6's C3 stages share, and
// whose mma.sync and cp.async K5's stem conv uses too: device functions only,
// bf16 operands, f32 accumulators.
//
// - mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, one warp per
//   16 x 8 x 16 product. mma.sync and not wgmma: the A operand of both
//   kernels is a set of pixel rows whose addresses are not one strided tile
//   (a 3x3 tap shifts rows by the frame pitch, K4's taps are dilated and
//   zero-padded at the image border, K6's cv3 reads [y1 | y2] from two
//   buffers). ldmatrix takes one row address from each lane, so all of that
//   stays address arithmetic; a wgmma shared-memory descriptor would need a
//   copy into a swizzled tile first.
// - ldmatrix.x4 for A (16 pixel rows x 16 k, k contiguous) and
//   ldmatrix.x4.trans for B: the weights are (K, N) row-major, so one x4.trans
//   brings the 16 k x 16 n of two neighbouring n8 tiles (two x2.trans in one
//   instruction).
// - cp.async 16-byte copies from global to shared memory with zero fill
//   (src-size 0 where the predicate is false), commit_group / wait_group.
//
// Shared-memory rows that ldmatrix reads are padded by 16 bytes (kPad
// elements), so that a row pitch of 2^k bytes becomes an odd number of
// 16-byte units and the eight rows of one 8x8 matrix fall into different
// banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace mma {

constexpr int kPad = 8;  // bf16 elements of padding per shared-memory row

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros where !pred (src must still be a valid
// pointer, it is not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(__cvta_generic_to_global(src)), "r"(n)
               : "memory");
}

// 4 bytes global -> shared, for rows whose start is only 4-byte aligned
// (K5's NHWC window: a pixel is 6 bytes); zeros where !pred.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool pred) {
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(__cvta_generic_to_global(src)), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8. For an A tile (16 rows x 16 k): lane l -> row l % 16, k (l / 16) * 8,
// which yields the mma's a0..a3.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// The same, transposed on the way: for a (K, N) row-major B tile of 16 k x
// 16 n, lane l -> row k = l % 16, column (l / 16) * 8; r[0], r[1] are b0, b1
// of the first n8 tile, r[2], r[3] of the second.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c (16 x 8, f32) += a (16 x 16, bf16) * b (16 x 8, bf16). Lane l = 4 g + t
// holds c[0], c[1] = rows g, columns 2t, 2t + 1 and c[2], c[3] = row g + 8.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k16 step of a warp tile of MT * 16 rows x NT * 8 columns (NT even):
// acc += A * B. a_addr[mt] is this lane's ldmatrix address in the mt-th
// 16-row slab of A (its row l % 16, k offset (l / 16) * 8); b_addr its
// address in B's 16 k rows at the tile's first column (row l % 16, column
// (l / 16) * 8). Only the first nmt slabs and nnt n8 tiles (even) are
// computed; both are uniform over the warp.
template <int MT, int NT>
__device__ __forceinline__ void warp_mma_k16(float (&acc)[MT][NT][4],
                                             const uint32_t (&a_addr)[MT],
                                             uint32_t b_addr, int nmt,
                                             int nnt) {
  // every fragment first, then the products: the loads are in flight
  // together and the tensor core is fed back to back
  uint32_t a[MT][4];
  uint32_t b[NT / 2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    if (mt < nmt) ldmatrix_x4(a[mt], a_addr[mt]);
#pragma unroll
  for (int np = 0; np < NT / 2; ++np)
    if (2 * np < nnt) ldmatrix_x4_trans(b[np], b_addr + np * 32);
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    if (2 * np < nnt) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt < nmt) {
          mma_16816(acc[mt][2 * np], a[mt], b[np][0], b[np][1]);
          mma_16816(acc[mt][2 * np + 1], a[mt], b[np][2], b[np][3]);
        }
      }
    }
  }
}

}  // namespace mma
