// bf16 tensor-core building blocks for sm_80+ (used on Hopper, sm_90a), in
// inline PTX: the warp-level product mma.sync m16n8k16 (bf16 operands, fp32
// accumulation), ldmatrix (four 8 x 8 b16 matrices from shared memory, plain
// or transposed), 16-byte cp.async copies with their commit and wait, and the
// repack of an fp32 accumulator fragment into a bf16 A fragment, so that a
// product's result feeds the next product without leaving registers.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A, 16 x 16, row-major:  a[0] (g, 2t..2t+1)  a[1] (g+8, 2t..)
//                           a[2] (g, 2t+8..)    a[3] (g+8, 2t+8..)
//   B, 16 x 8, "col":       b[0] (k 2t..2t+1, n g)  b[1] (k 2t+8.., n g)
//   C/D, 16 x 8, fp32:      c[0..1] (g, 2t..2t+1)   c[2..3] (g+8, 2t..2t+1)
// The lane-address helpers below give, for each of these, the shared-memory
// row and column that lane `lane` hands to ldmatrix.x4.
//
// No CUTLASS or CuTe: raw PTX keeps each nvcc build in seconds.

#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace tc {

// d += a * b for one 16 x 8 x 16 tile.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 b16 matrices; lanes 8i..8i+7 give the shared-memory addresses
// (32-bit, from smem_addr) of matrix i's rows, and r[i] receives that
// matrix's fragment (row g, columns 2t, 2t+1). Kernels compute each lane's
// address once and step it by constant byte offsets, which keeps 64-bit
// generic pointers out of the registers.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(row));
}

// The same, each matrix transposed: r[i] receives (M[2t][g], M[2t+1][g]).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(row));
}

// ldmatrix lane (row, column) offsets in a 16 x 16 tile of a row-major
// array, for each of the four uses:
//   A operand stored row-major [m][k]                     -> a[0..3]
__device__ __forceinline__ int a_row(int lane) { return lane & 15; }
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) << 3; }
//   B operand stored as [n][k] (B^T row-major), non-transposed load:
//   r[0], r[1] = b0, b1 of n-block 0; r[2], r[3] = b0, b1 of n-block 1
__device__ __forceinline__ int bt_row(int lane) { return (lane & 7) + ((lane >> 4) << 3); }
__device__ __forceinline__ int bt_col(int lane) { return ((lane >> 3) & 1) << 3; }
//   B operand stored as [k][n] (row-major), transposed load:
//   r[0], r[1] = b0, b1 of n-block 0; r[2], r[3] = b0, b1 of n-block 1
__device__ __forceinline__ int bk_row(int lane) { return (lane & 7) + (((lane >> 3) & 1) << 3); }
__device__ __forceinline__ int bk_col(int lane) { return (lane >> 4) << 3; }
//   A operand stored as [k][m] (A^T row-major), transposed load -> a[0..3]
//   (the rows are k and the columns m: the B-as-[n][k] pattern, transposed)
__device__ __forceinline__ int at_row(int lane) { return bt_row(lane); }
__device__ __forceinline__ int at_col(int lane) { return bt_col(lane); }

// threadIdx.x through a volatile read, which the compiler may not hoist: an
// address derived from it where it is used is recomputed there instead of
// holding a register across a loop.
__device__ __forceinline__ int tid_x() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
  return t;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// Two m16n8 fp32 accumulators (n-blocks 2k and 2k + 1 of one 16-row strip)
// as the bf16 A fragment of k-block k: the FlashAttention-2 repack.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// 16 bytes global -> shared (a 32-bit shared address), bypassing L1.
// `bytes` (0..16) of the source are read and the rest of the 16 is
// zero-filled; both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Stage 8 consecutive bf16 values, `valid` (<= 8) of them read from `src`
// and the rest zero, into 16 bytes of shared memory at the 32-bit address
// `dst`. With kAsync the copy is a cp.async (both addresses 16-byte aligned;
// `src` must be a valid address even when `valid` is 0); without it,
// ordinary 2-byte loads, for sources that are not 16-byte aligned.
template <bool kAsync>
__device__ __forceinline__ void stage8(uint32_t dst, const __nv_bfloat16* src, int valid) {
  if constexpr (kAsync) {
    cp_async16(dst, src, valid > 0 ? 2 * min(valid, 8) : 0);
  } else {
    // One value at a time: a fallback that holds almost no registers.
#pragma unroll 1
    for (int e = 0; e < 8; ++e) {
      const unsigned short v = e < valid ? __bfloat16_as_ushort(src[e]) : 0;
      asm volatile("st.shared.u16 [%0], %1;\n" :: "r"(dst + 2 * e), "h"(v) : "memory");
    }
  }
}

}  // namespace tc
