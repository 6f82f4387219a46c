// Helpers shared by the attention kernels in this directory: the finite
// mask value, bf16 packing, and the reductions over the four threads of an
// accumulator row quad.
//
// Fragment layout (PTX ISA, mma.m16n8k16 .bf16, which each warp's share of
// a wgmma accumulator follows): lane = 4 * g + t; the A fragment holds rows
// g and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9; the C fragment holds
// rows g (c0, c1) and g + 8 (c2, c3), columns 2t and 2t + 1. A C fragment
// of one product is therefore the A fragment of the next, which keeps P in
// registers between Q.K^T and P.V.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lvt {

constexpr float kNegInf = -1073741824.0f;  // -2**30, the finite mask value

// two floats -> one register of two bf16 (round to nearest even)
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
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
