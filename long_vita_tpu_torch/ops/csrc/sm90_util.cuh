// Hopper (sm_90a) building blocks for the attention forward
// (flash_fwd_sm90.cuh, with its int8 instance K2) and backward
// (flash_bwd_sm90.cuh) and the w4a16 product (w4_matmul.cu), as inline
// PTX: mbarriers, TMA tile loads, named barriers,
// the register hand-over between warpgroups (setmaxnreg), wgmma with its
// shared-memory matrix descriptors, and the widening of int8 codes into the
// swizzled bf16 layout wgmma reads.
//
// Shared-memory tiles are written by TMA with the 128-byte swizzle: a tile
// of R rows x 64 bf16 (one TMA box) is R rows of 128 bytes in which the
// 16-byte chunk c of row r sits at chunk c ^ (r % 8); eight rows make a
// 1024-byte atom, and a tile must start 1024-byte aligned. A wider tile is
// several such boxes side by side (box b at b * R * 128 bytes).
//
// wgmma reads such a tile through a 64-bit descriptor (PTX ISA, "matrix
// descriptor"): start address >> 4 (bits 0-13), leading byte offset >> 4
// (16-29), stride byte offset >> 4 (32-45), layout 1 = 128-byte swizzle
// (62-63).
//   - K-major operand (the contraction dim contiguous: Q and K of Q.K^T):
//     stride offset = 1024 (the next 8 rows); the leading offset is unused.
//     The k16 slice kk of a box starts kk * 32 bytes into it (the swizzle is
//     a function of the address, so the slice needs no other change).
//   - MN-major operand (V of P.V: kv rows are the contraction, D is
//     contiguous): stride offset = 1024 (the next 8 kv rows), leading
//     offset = the distance between the 64-column boxes; the k16 slice kk
//     starts kk * 16 * 128 bytes in. The instruction's transpose bit is set.
//
// The f32 accumulator of wgmma m64nNk16 holds, in thread t of the warpgroup
// (warp w = t / 32, lane = 4g + i), rows 16w + g and 16w + g + 8 and columns
// 8n + 2i, 8n + 2i + 1 at d[4n + {0,1}] and d[4n + {2,3}]: per warp, the
// mma.sync m16n8 C layout of mma_util.cuh. So the S accumulator converts to
// the A-register operand of the next product (a0..a3 of k slice kk are the
// bf16 pairs of n-tiles 2kk and 2kk + 1), and P never leaves registers.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lvt {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x by the special-function unit (denormals flushed): 2^(-2^30) is 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// arrive, and expect `bytes` more from TMA before the phase completes
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed; a wait that never
// ends (a broken hand-over) traps after ~2^28 polls instead of hanging the
// card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (polls == (1u << 28)) __trap();
  }
}

// ---- TMA -------------------------------------------------------------------

// one box of a 4-d tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// add a box of shared memory into a 4-d tensor map's region of global
// memory (f32 add, done by the TMA unit; elements out of bounds are
// dropped), in the thread's bulk async-group
__device__ __forceinline__ void tma_reduce_add_4d(const CUtensorMap* map, uint32_t src, int c0,
                                                  int c1, int c2, int c3) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until at most N of the thread's bulk async-groups still read their
// shared-memory source
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// wait until the thread's bulk async-groups are complete
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// order this thread's ordinary shared-memory writes before later reads by
// the async proxy (wgmma, TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- rings of kv tiles -----------------------------------------------------

// The tiles j in [begin, end) a block needs, in order: with segments, only
// those whose (min, max) id range meets the block's [lo, hi] (every logit of
// another tile is masked). Each warp finds them itself, 32 at a time, from
// the same read-only ranges, so producer and consumers walk the same
// sequence of tiles through the ring.
template <bool kSeg>
struct TileWalk {
  int j0;
  uint32_t mask = 0;

  __device__ explicit TileWalk(int begin = 0) : j0(begin - 32) {}

  __device__ __forceinline__ int next(int end, const int2* ranges, int lo, int hi) {  // or -1
    while (mask == 0) {
      j0 += 32;
      if (j0 >= end) return -1;
      const int j = j0 + (int)(threadIdx.x & 31);
      bool need = j < end;
      if (kSeg && need) {
        const int2 r = ranges[j];
        need = r.x <= hi && r.y >= lo;
      }
      mask = __ballot_sync(0xffffffffu, need);
    }
    const int j = j0 + __ffs(mask) - 1;
    mask &= mask - 1;
    return j;
  }
};

// Zero rows [r_begin, r_end) of a swizzled bf16 tile of D columns (boxes of
// 64 columns, `box_bytes` apart), thread t of n; the caller fences the
// async proxy before wgmma reads it.
template <int D>
__device__ __forceinline__ void zero_tile_rows(unsigned char* tile, int box_bytes, int r_begin,
                                               int r_end, int t, int n) {
  for (int x = t; x < (r_end - r_begin) * (D / 8); x += n) {
    const int r = r_begin + x / (D / 8), c = x % (D / 8);  // c: 16-byte chunk of the row
    *reinterpret_cast<uint4*>(tile + (c / 8) * box_bytes + r * 128 + (c % 8) * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// A block's last, partial kv tile: its rows from r_begin on lie inside the
// tensor and may hold anything, so the producer warp loads it onto the side
// barrier `aux` (at most one such tile a block: phase 0), zeroes those rows
// of `a` and of `b` (if not null) and only then releases the ring stage on
// `full`.
template <int D>
__device__ __forceinline__ void zero_then_release(uint32_t aux, uint32_t full, unsigned char* a,
                                                  unsigned char* b, int box_bytes, int r_begin,
                                                  int rows) {
  const int lane = threadIdx.x & 31;
  mbar_wait(aux, 0);
  zero_tile_rows<D>(a, box_bytes, r_begin, rows, lane, 32);
  if (b != nullptr) zero_tile_rows<D>(b, box_bytes, r_begin, rows, lane, 32);
  fence_proxy_async();
  __syncwarp();
  if (lane == 0) mbar_arrive(full);
}

// ---- int8 codes widened to bf16 ----------------------------------------------

// Four int8 codes (little endian) -> four bf16 in two registers, exactly and
// without I2F: the sign bit of each code c is flipped (c + 128 as a byte),
// a byte permute makes that byte the low mantissa byte of the f32 2^23 + c +
// 128, one FADD subtracts 2^23 + 128, and each pair is rounded to bf16
// (exact for every int8).
__device__ __forceinline__ void i8x4_to_bf16x4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
  __nv_bfloat162 a = __floats2bfloat162_rn(f0, f1), b = __floats2bfloat162_rn(f2, f3);
  lo = *reinterpret_cast<uint32_t*>(&a);
  hi = *reinterpret_cast<uint32_t*>(&b);
}

// Widen a tile of `rows` x D int8 codes (row r at raw + r * D, as TMA
// writes a box without swizzle) into the 128-byte-swizzled bf16 layout that
// wgmma reads (boxes of 64 columns, `box_bytes` apart): thread t of n takes
// 16 codes at a time, one 16-byte shared load and two 16-byte stores. The
// caller fences the async proxy before wgmma reads the tile.
template <int D>
__device__ __forceinline__ void widen_i8_tile(const unsigned char* raw, unsigned char* dst,
                                              int box_bytes, int rows, int t, int n) {
  constexpr int kChunks = D / 16;  // 16-code chunks a row
#pragma unroll 4
  for (int x = t; x < rows * kChunks; x += n) {
    const int r = x / kChunks, c = 2 * (x % kChunks);  // c: the first bf16 chunk
    const uint4 w = *reinterpret_cast<const uint4*>(raw + r * D + (x % kChunks) * 16);
    uint32_t o[8];
    i8x4_to_bf16x4(w.x, o[0], o[1]);
    i8x4_to_bf16x4(w.y, o[2], o[3]);
    i8x4_to_bf16x4(w.z, o[4], o[5]);
    i8x4_to_bf16x4(w.w, o[6], o[7]);
    unsigned char* row = dst + (c / 8) * box_bytes + r * 128;
    *reinterpret_cast<uint4*>(row + (((c % 8)) ^ (r & 7)) * 16) = make_uint4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<uint4*>(row + (((c % 8) + 1) ^ (r & 7)) * 16) =
        make_uint4(o[4], o[5], o[6], o[7]);
  }
}

// ---- warpgroups ------------------------------------------------------------

// named barrier `id` (1-15; 0 is __syncthreads) over the first `threads`
// threads of the block that reach it
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- wgmma -----------------------------------------------------------------

__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lead_bytes,
                                               uint32_t stride_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead_bytes >> 4) << 16) |
         (static_cast<uint64_t>(stride_bytes >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], A and B K-major in shared memory;
// accumulate == 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 16] (+)= A[64 x 16] . B[16 x 16], A and B K-major in shared memory;
// accumulate == 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n16(float (&d)[8], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B K-major in shared memory;
// accumulate == 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B MN-major in shared memory
// (both transpose bits set: A's M and B's N are the contiguous dims);
// accumulate == 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n64_mn(float (&d)[32], uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 32] (+)= A[64 x 16] . B[16 x 32], both MN-major as above; B's 32
// columns may start half-way into a 128-byte swizzled row (the swizzle is a
// function of the address); accumulate == 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n32_mn(float (&d)[16], uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, %16, %17, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], A K-major and B MN-major (the
// transpose bit of B set) in shared memory; accumulate == 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n128_tb(float (&d)[64], uint64_t da, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A K-major and B MN-major in shared
// memory; accumulate == 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n64_tb(float (&d)[32], uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A in registers (the mma.sync A
// fragment layout), B MN-major in shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, {%64,%65,%66,%67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A in registers (the mma.sync A
// fragment layout), B MN-major in shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, {%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 8] (+)= A[64 x 16] . B[16 x 8], A MN-major (the transpose bit of A
// set) and B K-major in shared memory; accumulate == 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n8_ta(float (&d)[4], uint64_t da, uint64_t db,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3}, %4, %5, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 16] (+)= A[64 x 16] . B[16 x 16], A MN-major (the transpose bit of A
// set) and B K-major in shared memory; accumulate == 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n16_ta(float (&d)[8], uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7}, %8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 32] (+)= A[64 x 16] . B[16 x 32], A MN-major (the transpose bit of A
// set) and B K-major in shared memory; accumulate == 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n32_ta(float (&d)[16], uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, %16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A MN-major (the transpose bit of A
// set) and B K-major in shared memory; accumulate == 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n64_ta(float (&d)[32], uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, %32, %33, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], A MN-major (the transpose bit of A
// set) and B K-major in shared memory; accumulate == 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n128_ta(float (&d)[64], uint64_t da, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, %64, %65, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The swap-AB product of the w4a16 kernel: D[64 x N] (+)= A . B with A
// MN-major and B K-major (N = 8, 16, 32, 64 or 128).
template <int N>
__device__ __forceinline__ void wgmma_ss_ta(float (&d)[N / 2], uint64_t da, uint64_t db,
                                            int accumulate) {
  static_assert(N == 8 || N == 16 || N == 32 || N == 64 || N == 128, "wgmma width");
  if constexpr (N == 8) wgmma_ss_m64n8_ta(d, da, db, accumulate);
  else if constexpr (N == 16) wgmma_ss_m64n16_ta(d, da, db, accumulate);
  else if constexpr (N == 32) wgmma_ss_m64n32_ta(d, da, db, accumulate);
  else if constexpr (N == 64) wgmma_ss_m64n64_ta(d, da, db, accumulate);
  else wgmma_ss_m64n128_ta(d, da, db, accumulate);
}

// D[64 x 8] (+)= A[64 x 16] . B[16 x 8], A in registers (the mma.sync A
// fragment layout), B K-major in shared memory; accumulate == 0 overwrites D.
__device__ __forceinline__ void wgmma_rs_m64n8_kb(float (&d)[4], const uint32_t (&a)[4],
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 16] (+)= A[64 x 16] . B[16 x 16], A in registers (the mma.sync A
// fragment layout), B K-major in shared memory; accumulate == 0 overwrites D.
__device__ __forceinline__ void wgmma_rs_m64n16_kb(float (&d)[8], const uint32_t (&a)[4],
                                                   uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7}, {%8,%9,%10,%11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 32] (+)= A[64 x 16] . B[16 x 32], A in registers (the mma.sync A
// fragment layout), B K-major in shared memory; accumulate == 0 overwrites D.
__device__ __forceinline__ void wgmma_rs_m64n32_kb(float (&d)[16], const uint32_t (&a)[4],
                                                   uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, {%16,%17,%18,%19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// The w4a16 kernel's register-A product at its decode row tiles: D[64 x N]
// (+)= A . B with A in registers and B K-major (N = 8, 16 or 32).
template <int N>
__device__ __forceinline__ void wgmma_rs_kb(float (&d)[N / 2], const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
  static_assert(N == 8 || N == 16 || N == 32, "wgmma width");
  if constexpr (N == 8) wgmma_rs_m64n8_kb(d, a, db, accumulate);
  else if constexpr (N == 16) wgmma_rs_m64n16_kb(d, a, db, accumulate);
  else wgmma_rs_m64n32_kb(d, a, db, accumulate);
}

// ---- host side: TMA tensor maps ------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime's entry-point
// query: the library links the CUDA runtime only
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// bf16 [B, S, H, D] with element strides (sb, ss) and packed [H, D], as the
// 4-d map (D, H, S, B): boxes of 64 columns x `rows` rows of one head, the
// 128-byte swizzle, zeros past S. A dim of extent 1 gets the packed stride.
inline bool bshd_map(CUtensorMap* map, const void* ptr, int b, int s, int h, int d,
                     long long sb, long long ss, int rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const long long ss_eff = s > 1 ? ss : (long long)h * d;
  const long long sb_eff = b > 1 ? sb : (long long)s * ss_eff;
  cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)s, (cuuint64_t)b};
  cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)ss_eff * 2, (cuuint64_t)sb_eff * 2};
  cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// f32 [B, S, H, D], contiguous, as the 4-d map (D, H, S, B): boxes of 32
// columns (128 bytes) x `rows` rows of one head, the 128-byte swizzle
inline bool f32_bshd_map(CUtensorMap* map, void* ptr, int b, int s, int h, int d, int rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)s, (cuuint64_t)b};
  cuuint64_t strides[3] = {(cuuint64_t)d * 4, (cuuint64_t)h * d * 4, (cuuint64_t)s * h * d * 4};
  cuuint32_t box[4] = {32, 1, (cuuint32_t)rows, 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptr, dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// int32 [B, Skv] segment ids with row stride `sb` (a multiple of 4 when
// B > 1), as the 2-d map (Skv, B) in boxes of `rows` ids
inline bool seg_map(CUtensorMap* map, const void* ptr, int b, int skv, long long sb, int rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const long long sb_eff = b > 1 ? sb : ((long long)skv + 3) / 4 * 4;
  cuuint64_t dims[2] = {(cuuint64_t)skv, (cuuint64_t)b};
  cuuint64_t strides[1] = {(cuuint64_t)sb_eff * 4};
  cuuint32_t box[2] = {(cuuint32_t)rows, 1};
  cuuint32_t estr[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, const_cast<void*>(ptr), dims, strides, box,
                estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// int8 [B, S, H, D] with byte strides (sb, ss) and packed [H, D], as the 4-d
// map (D, H, S, B): boxes of D bytes x `rows` rows of one head, no swizzle,
// zeros past S. A dim of extent 1 gets the packed stride.
inline bool i8_bshd_map(CUtensorMap* map, const void* ptr, int b, int s, int h, int d,
                        long long sb, long long ss, int rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const long long ss_eff = s > 1 ? ss : (long long)h * d;
  const long long sb_eff = b > 1 ? sb : (long long)s * ss_eff;
  cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)s, (cuuint64_t)b};
  cuuint64_t strides[3] = {(cuuint64_t)d, (cuuint64_t)ss_eff, (cuuint64_t)sb_eff};
  cuuint32_t box[4] = {(cuuint32_t)d, 1, (cuuint32_t)rows, 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(ptr), dims, strides, box,
                estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A row-major matrix [outer, inner] with rows `row_bytes` apart, as the 2-d
// map (inner, outer) in boxes of box_inner x box_outer; zeros past either
// edge.
inline bool matrix_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
                       long long inner, long long outer, long long row_bytes, int box_inner,
                       int box_outer, CUtensorMapSwizzle swizzle) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  cuuint32_t estr[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace lvt
