// Warp-level tensor-core helpers for sm_90a, shared by the split-K matmuls
// (split_k_matmul.cuh) and the SEANet convolutions (seanet_mma.cuh):
// ldmatrix from shared memory and mma.sync m16n8k16 with bf16 operands and
// float32 accumulation.
//
// Fragments of m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major): a0 (row g, k 2t..2t+1), a1 (row g+8, k 2t..),
//                           a2 (row g, k 2t+8..),    a3 (row g+8, k 2t+8..)
//   B (16 x 8):             b0 (k 2t..2t+1, col g),  b1 (k 2t+8.., col g)
//   C (16 x 8, float32):    c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8)
// A B fragment is what ldmatrix (not transposed) gives from rows n holding
// 8 consecutive k each.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Lanes 0-15 give the rows' addresses (the others' are ignored).
__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace mma
