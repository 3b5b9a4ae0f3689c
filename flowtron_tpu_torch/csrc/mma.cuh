// Tensor-core and async-copy helpers shared by csrc/w4.cu,
// csrc/resident.cu, csrc/qmm.cu and csrc/wavenet.cu (and smem_addr by
// csrc/grid_sync.cuh):
// the bf16, int8 and tf32 mma.sync tiles, ldmatrix fragment loads and
// cp.async 16-byte copies into shared memory.

#pragma once

#include <stdint.h>

namespace {

// c += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, fp32 out.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a (16 x 32, row-major) * b (32 x 8, column-major), int8 in, exact
// int32 sums. Fragments: a[0] row lane / 4, columns 4 (lane % 4) .. + 3;
// a[1] the same columns of row lane / 4 + 8; a[2], a[3] those rows at
// columns + 16; b0 rows 4 (lane % 4) .. + 3 of column lane / 4, b1 those
// rows + 16; c[0], c[1] row lane / 4, columns 2 (lane % 4) and + 1, c[2],
// c[3] those columns of row lane / 4 + 8.
__device__ __forceinline__ void mma_s8_m16n8k32(int (&c)[4],
                                                const uint32_t (&a)[4],
                                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a (16 x 8, row-major) * b (8 x 8, column-major), tf32 in (fp32 bit
// patterns whose low 13 bits the tensor cores ignore), fp32 out.
// Fragments: a[0] (row lane / 4, column lane % 4), a[1] row + 8, a[2] and
// a[3] those rows at column + 4; b0 (row lane % 4, column lane / 4), b1
// row + 4; c as mma_s8_m16n8k32's.
__device__ __forceinline__ void mma_tf32_m16n8k8(float (&c)[4],
                                                 const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to tf32 (10 mantissa bits), to nearest with ties away from
// zero, as cvt.rna.tf32.f32 rounds a finite x, in two integer operations
// (the cvt takes about five on sm_90): half a tf32 ulp added to the
// magnitude bits, the low 13 bits cleared.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices; lanes 8i .. 8i + 7 give the row addresses of
// matrix i, and r[i] is this lane's part of it (row lane / 4, columns
// 2 (lane % 4) and + 1; with kTrans, those rows and columns swapped).
template <bool kTrans>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  if (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
}

// Two 8 x 8 bf16 matrices; lanes 8i .. 8i + 7 give the row addresses of
// matrix i (lanes 16 .. 31 are not read), r[i] as ldmatrix_x4's.
template <bool kTrans>
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  if (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
        : "=r"(r[0]), "=r"(r[1])
        : "r"(smem_addr(p)));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
        : "=r"(r[0]), "=r"(r[1])
        : "r"(smem_addr(p)));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

// The first src_bytes (0 or 16) of src, zeros for the rest.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most kPending of this thread's copy groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

}  // namespace
