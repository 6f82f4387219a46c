// Helpers shared by the attention kernels in this directory: the bf16
// tensor-core product (mma.sync m16n8k16, f32 accumulators), bf16 packing,
// and the reductions over the four threads of an mma row quad.
//
// Fragment layout used throughout (PTX ISA, mma.m16n8k16 .bf16): lane =
// 4 * g + t; the A fragment holds rows g and g + 8, columns 2t, 2t + 1 and
// 2t + 8, 2t + 9; the B fragment holds columns (n) g, rows (k) 2t, 2t + 1 and
// 2t + 8, 2t + 9; the C fragment holds rows g (c0, c1) and g + 8 (c2, c3),
// columns 2t and 2t + 1. A C fragment of one product is therefore the A
// fragment of the next, which keeps P in registers between Q.K^T and P.V.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lvt {

constexpr float kNegInf = -1073741824.0f;  // -2**30, the finite mask value

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16 (round to nearest even)
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Four 8x8 bf16 matrices from shared memory, each transposed on the way
// (ldmatrix .trans): lanes 0-15 give the addresses of rows 0-15 of a 16-row
// block at columns c, lanes 16-31 the same rows at columns c + 8. For a
// row-major tile [k][n] this yields the B fragments (b0, b1) of two
// neighbouring n-tiles: r0, r1 for columns c..c+7 and r2, r3 for c+8..c+15.
// Addresses must be 16-byte aligned.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace lvt
