// Warp-level tensor-core helpers for the attention kernels (sm_80 and up;
// built for sm_90a): cp.async copies, ldmatrix, mma.sync in bf16 and TF32,
// and the split of an f32 value into two TF32 values.
//
// Fragment layouts of mma.sync (PTX ISA, "Matrix fragments for mma.m16n8k*").
// A warp's lane is 4·g + t, with g = lane / 4 (0..7) and t = lane % 4:
//
//   m16n8k16 bf16, A 16×16 row-major, B 16×8 col-major, C 16×8 f32
//     a0 = A[g][2t,2t+1]  a1 = A[g+8][2t,2t+1]  a2 = A[g][2t+8,2t+9]  a3 = A[g+8][2t+8,2t+9]
//     b0 = B[2t,2t+1][g]  b1 = B[2t+8,2t+9][g]
//   m16n8k8 tf32, A 16×8, B 8×8
//     a0 = A[g][t]  a1 = A[g+8][t]  a2 = A[g][t+4]  a3 = A[g+8][t+4]
//     b0 = B[t][g]  b1 = B[t+4][g]
//   C (both shapes)
//     c0 = C[g][2t]  c1 = C[g][2t+1]  c2 = C[g+8][2t]  c3 = C[g+8][2t+1]
//
// Two adjacent n8 C-fragments of bf16 scores form one k16 A-fragment of p
// as they stand. A tf32 C-fragment holds columns 2t and 2t+1 but the A
// operand wants t and t+4; the kernels permute the reduction index instead
// of the registers (see flash_attention_fwd.cu).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace dr4sr {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared, bypassing L1; with `valid` false the 16 bytes
// are zero-filled and nothing is read (src-size 0).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8×8 b16 matrices; lane 8·i + r gives the address of row r of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a·b, bf16 operands, f32 accumulation
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a·b, tf32 operands (each the bits of a value from to_tf32), f32 accumulation
__device__ __forceinline__ void mma_tf32_1688(float (&c)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// round to TF32 (10 mantissa bits), to nearest with ties away from zero: the
// rounding of cvt.rna.tf32.f32, in two integer instructions. For sm_90, ptxas
// turns that PTX instruction into four (a finiteness test and a select around
// the same add and mask); the operands here are finite, and an infinity stays
// one. A tf32 mma given raw f32 bits would truncate them instead.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x ≈ big + small, both TF32; x − big is exact in f32, so the pair keeps
// about 22 of x's 24 significant bits. a·b ≈ big·big + big·small + small·big
// (3xTF32) then carries f32 accuracy through the tensor cores.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// c += a·b in 3xTF32, the small terms first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4], uint32_t b0_big,
                                           uint32_t b1_big, uint32_t b0_small,
                                           uint32_t b1_small) {
  mma_tf32_1688(c, a_small, b0_big, b1_big);
  mma_tf32_1688(c, a_big, b0_small, b1_small);
  mma_tf32_1688(c, a_big, b0_big, b1_big);
}

// two f32 → one register of two bf16 (RNE), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace dr4sr
