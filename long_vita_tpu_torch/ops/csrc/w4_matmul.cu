// w4a16 matrix product (K6) for Hopper (sm_90a), bound to Python through a
// plain C entry point (lvt_w4_matmul) and ctypes.
//
// Replaces: the Pallas TPU kernels `_w4_matmul_pallas_u`
// (long_vita_tpu/ops/quant_matmul.py:132, pallas_call :173) and
// `_w4_matmul_pallas` (:187, pallas_call :237), two tilings of one function
// that `w4_matmul` (:259) routes row counts <= 512 to. What it computes:
// out = sum_g s_g * (x_g @ q_g) for x [rows, in] (bf16, or f32), q the int4
// weight [in, out] packed split-half into int8 [in/2, out] (the low nibble of
// byte p holds row p, the high nibble row in/2 + p) and f32 scales
// [in/128, out], one per (128-row input group, output column); each group's
// dot is taken with f32 accumulation and scaled after it, added in the plain
// version's order (acc + pt * s_top + pb * s_bottom: the top-half group g,
// then its bottom-half partner G/2 + g, as at :168-170), and the f32 sum is
// cast once to the output dtype (bf16 for the projections, f32 for the
// head). Two calls give the same bits.
//
// What bounds it on the H100: at decode row counts (1-8 rows) the packed
// weight is read once and used for a handful of products, so the kernel is
// bound by bytes: q_proj at one row reads 13.1 MB of codes and 0.8 MB of
// scales, 4.2 us at 3.35 TB/s; one decode step's projections and head read
// 7.43 GB, a floor of 2.2 ms. From about 74 rows up the tensor cores bound
// it (q_proj at 512 rows: 26.8 GFLOP, 27 us at 989 TFLOP/s). The design:
//   - "swap AB": the kernel computes out^T = W^T . x^T with wgmma, the
//     dequantised weight as the A operand (M = 64 output columns a consumer
//     warpgroup) and x^T as the K-major B operand (N = the row tile: 8, 16,
//     32, 64 or 128 rows, the fewest that hold `rows`, else tiles of 128).
//     A decode step's rows all sit in one N = 8 tile, so each packed byte
//     is read once and no tensor-core work is spent on 16-row padding;
//   - a block owns 128 output columns (two consumer warpgroups) of one row
//     tile and a producer warp; its producer thread keeps a TMA ring of
//     stages in flight, each the packed tile of one group pair (128 packed
//     rows x 128 columns, 16 KB, 128-byte swizzle) and x's 2 x 128 input
//     columns of the row tile (128-byte swizzle, zeros past `rows`): 10
//     stages at N = 8 (160 KB of codes in flight a block), 8 at 16, 6 at
//     32, 3 at 64, 2 at 128;
//   - N <= 32 (decode, verify steps, the last-row pass): each consumer
//     thread unpacks its A fragments straight into registers: its two
//     output columns are the two bytes of one 16-bit shared load a packed
//     row (the warpgroup's A rows are permuted so: row 16w + g is column
//     16w + 2g, row 16w + g + 8 column 16w + 2g + 1), a byte permute pairs
//     two rows, and a mask, xor and bf16x2 subtract (0x4300 | (n ^ 8) is the
//     bf16 of 136 + n) give the top and the bottom group's values; the top
//     group's 8 k-steps and the bottom's run back to back into two
//     accumulators. Unpacking through a shared bf16 tile (the path N >= 64
//     takes) moved ~164 KB of shared memory a unit, as long as the unit's
//     16 KB take from device memory at a block an SM;
//   - N >= 64: each consumer warpgroup unpacks its 64 columns into two
//     MN-major bf16 A tiles in shared memory and runs the top group's 8
//     k-steps, then the bottom group's (the accumulators would not fit
//     twice at N = 128);
//   - each group's dot lands in a zeroed accumulator and is added times its
//     column's scale into the running f32 sum, top group first;
//   - one launch, deterministic split-K (stream-K): the (row tile, column
//     tile, group pair) units are cut into one contiguous range per block,
//     one block per SM (fewer when a block would get under four units), so
//     every shape fills the card with no tail wave. A tile whose pairs span
//     several blocks is summed by the last of them to arrive (a per-tile
//     counter after a __threadfence): it adds the f32 partials in block
//     order, so two calls give the same bits, and resets the counter for
//     the next call. `w4_split_plan` in ops/quant_matmul.py is the Python
//     mirror of the cut.
// f32 activations take a CUDA-core kernel (f32 products, the same group
// order); it exists for the checks against the f32 plain version.

#include "sm90_util.cuh"

namespace {

using namespace lvt;

constexpr int kGroup = 128;               // input rows a scale group
constexpr int kBM = 128;                  // output columns a block
constexpr int kConsumers = 2;             // warpgroups of 64 output columns
constexpr int kThreads = 128 * kConsumers + 32;  // and one producer warp
constexpr int kPacked = kGroup * kBM;     // bytes of a stage's packed tile
constexpr int kA = kGroup * 64 * 2;       // bytes of a warpgroup's bf16 A tile (one group)

// shared memory of the row tile N, in bytes from a 1024-aligned base
template <int N>
struct Smem {
  static constexpr bool kRegA = N <= 32;  // the A fragments unpacked into registers
  static constexpr int kStages = N == 8 ? 10 : N == 16 ? 8 : N == 32 ? 6 : N == 64 ? 3 : 2;
  static constexpr int kXBox = N * 128;               // 64 inputs x N rows of x
  static constexpr int kStage = kPacked + 4 * kXBox;  // packed, x top (2 boxes), x bottom
  static constexpr int a = kStages * kStage;          // A tiles: [consumer][top, bottom]
  static constexpr int bar = a + (kRegA ? 0 : kConsumers * 2 * kA);
  static constexpr int flag = bar + 2 * kStages * 8;  // barriers full, empty [stages]
  static constexpr int bytes = flag + kConsumers * 4;
  static constexpr int alloc = bytes + 1024;  // room to align the base
};

struct Params {
  CUtensorMap tx;       // x [rows, n_in] bf16: boxes of 64 inputs x N rows
  CUtensorMap tp;       // packed [n_in / 2, n_out] int8: boxes of 128 x 128
  const float* scales;  // [n_in / 128, n_out]
  void* out;            // [rows, n_out]
  float* partials;      // [blocks][2 slots][kConsumers][128 threads][N / 2]
  int* counters;        // [tiles][kConsumers], 0 between calls
  int rows, n_out, half, n_ct, pairs, units, blocks;
};

// the units [begin, end) of block b: units * b / blocks rounded down
__host__ __device__ __forceinline__ int unit_begin(int b, int units, int blocks) {
  return (int)((long long)units * b / blocks);
}

// the block whose range holds unit u
__device__ __forceinline__ int block_of(int u, int units, int blocks) {
  return (int)(((long long)(u + 1) * blocks - 1) / units);
}

__device__ __forceinline__ uint32_t nibbles_to_bf16x2(uint32_t v) {
  // v holds two nibbles at bits 0-3 and 16-19 (two's complement int4):
  // (n ^ 8) | 0x4300 is the bf16 of 128 + (n + 8); minus 136 gives n exactly
  const uint32_t biased = (v & 0x000F000Fu) ^ 0x43084308u;
  __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&biased);
  const __nv_bfloat162 off = __floats2bfloat162_rn(136.f, 136.f);
  b = __hsub2(b, off);
  return *reinterpret_cast<uint32_t*>(&b);
}

// 16 packed bytes (16 consecutive columns of one packed row) -> their 16
// top-half and 16 bottom-half values as bf16, in column order
__device__ __forceinline__ void unpack16(const uint4& pk, uint32_t (&t)[8], uint32_t (&b)[8]) {
  const uint32_t w[4] = {pk.x, pk.y, pk.z, pk.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = __byte_perm(w[i], 0u, 0x4140);  // bytes 0, 1 -> halves 0, 1
    const uint32_t hi = __byte_perm(w[i], 0u, 0x4342);  // bytes 2, 3 -> halves 0, 1
    t[2 * i] = nibbles_to_bf16x2(lo);
    t[2 * i + 1] = nibbles_to_bf16x2(hi);
    b[2 * i] = nibbles_to_bf16x2(lo >> 4);
    b[2 * i + 1] = nibbles_to_bf16x2(hi >> 4);
  }
}

__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) { *p = __float2bfloat16_rn(a); }

__device__ __forceinline__ void store1(float* p, float a) { *p = a; }

// The end of a tile's segment in this block: acc holds rows rt * N + 8n +
// 2 i4 (+1) of columns col_lo and col_hi. A tile that spans blocks
// (`split`) goes through the workspace: the partial is written and
// counted, and the last of the tile's blocks to arrive adds every partial
// in block order (the same bits every call) and resets the counter.
template <int N, typename OutT>
__device__ __forceinline__ void finish_tile(const Params& p, int* flag, int wg, int tile,
                                            bool split, int col_lo, int col_hi,
                                            float (&acc)[N / 2]) {
  const int t = threadIdx.x & 127, i4 = t & 3;
  if (split) {
    auto part = [&](int b) {  // block b's partial of this tile
      const int slot = tile == unit_begin(b, p.units, p.blocks) / p.pairs ? 0 : 1;
      return reinterpret_cast<float4*>(
          p.partials + ((((long long)b * 2 + slot) * kConsumers + wg) * 128 + t) * (N / 2));
    };
    float4* mine = part(blockIdx.x);
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      mine[j] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
    __threadfence();
    bar_sync(2 + wg, 128);
    const int b_first = block_of(tile * p.pairs, p.units, p.blocks);
    const int b_last = block_of(tile * p.pairs + p.pairs - 1, p.units, p.blocks);
    if (t == 0) {
      int* counter = p.counters + tile * kConsumers + wg;
      *flag = atomicAdd(counter, 1) == b_last - b_first;
      if (*flag) *counter = 0;  // every block of the tile has arrived: ready for the next call
    }
    bar_sync(2 + wg, 128);
    if (!*flag) return;
    __threadfence();
    // the partials of kChunk blocks are loaded before they are added, so a
    // few of them are in flight at once
    constexpr int kChunk = N == 8 ? 4 : N == 16 ? 2 : 1;
    for (int b0 = b_first; b0 <= b_last; b0 += kChunk) {
      float4 v[kChunk][N / 8];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const float4* src = part(min(b0 + k, b_last));
#pragma unroll
        for (int j = 0; j < N / 8; ++j) v[k][j] = __ldcg(src + j);
      }
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        if (b0 + k > b_last) continue;
        const bool first = b0 + k == b_first;
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          acc[4 * j] = first ? v[k][j].x : acc[4 * j] + v[k][j].x;
          acc[4 * j + 1] = first ? v[k][j].y : acc[4 * j + 1] + v[k][j].y;
          acc[4 * j + 2] = first ? v[k][j].z : acc[4 * j + 2] + v[k][j].z;
          acc[4 * j + 3] = first ? v[k][j].w : acc[4 * j + 3] + v[k][j].w;
        }
      }
    }
  }
  OutT* out = static_cast<OutT*>(p.out);
  const int rt = tile / p.n_ct;
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = rt * N + 8 * n + 2 * i4 + (e & 1);
      if (row < p.rows)
        store1(out + (long long)row * p.n_out + (e >> 1 ? col_hi : col_lo), acc[4 * n + e]);
    }
  }
}

// the group's dot d, scaled after it, into acc: rows of column lo, then hi
template <int N>
__device__ __forceinline__ void add_scaled(float (&acc)[N / 2], const float (&d)[N / 2],
                                           float s_lo, float s_hi) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    acc[4 * n] = acc[4 * n] + d[4 * n] * s_lo;
    acc[4 * n + 1] = acc[4 * n + 1] + d[4 * n + 1] * s_lo;
    acc[4 * n + 2] = acc[4 * n + 2] + d[4 * n + 2] * s_hi;
    acc[4 * n + 3] = acc[4 * n + 3] + d[4 * n + 3] * s_hi;
  }
}

// x's descriptor for k16 slice kk of group h (0 top, 1 bottom) of a stage
template <int N>
__device__ __forceinline__ uint64_t x_desc(uint32_t x_u, int h, int kk) {
  return sw128_desc(x_u + (2 * h + kk / 4) * Smem<N>::kXBox + (kk % 4) * 32, 16, 1024);
}

// One consumer warpgroup at N <= 32: its 64 columns of every unit of the
// block's range, the A fragments unpacked into registers.
template <int N, typename OutT>
__device__ __forceinline__ void consume_rs(const Params& p, unsigned char* base, uint32_t base_u,
                                           int wg, int u0, int u1) {
  using L = Smem<N>;
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31, g = lane >> 2, i4 = lane & 3;
  const uint32_t bar_full = base_u + L::bar, bar_empty = base_u + L::bar + 8 * L::kStages;
  int* flag = reinterpret_cast<int*>(base + L::flag) + wg;
  // this thread's two output columns, cb and cb + 1 of the block's 128:
  // A rows 16 warp + g and 16 warp + g + 8
  const int cb = wg * 64 + warp * 16 + 2 * g;
  auto scales_of = [&](int u, float2& top, float2& bot) {
    const int tile = u / p.pairs, pr = u - tile * p.pairs;
    const float* s = p.scales + (long long)pr * p.n_out + (tile % p.n_ct) * kBM + cb;
    top = __ldg(reinterpret_cast<const float2*>(s));
    bot = __ldg(reinterpret_cast<const float2*>(s + (long long)p.pairs * p.n_out));
  };
  float2 st, sb;
  scales_of(u0, st, sb);
  float acc[N / 2], dt[N / 2], db[N / 2];
  for (int u = u0, i = 0; u < u1; ++u, ++i) {  // i: the ring position
    const int tile = u / p.pairs, pr = u - tile * p.pairs, s = i % L::kStages;
    if (u == u0 || pr == 0) {
#pragma unroll
      for (int j = 0; j < N / 2; ++j) acc[j] = 0.f;
    }
    float2 st_next = st, sb_next = sb;  // the next unit's scales, a unit ahead
    if (u + 1 < u1) scales_of(u + 1, st_next, sb_next);
    mbar_wait(bar_full + 8 * s, (i / L::kStages) & 1);
    // the A fragments of the top (at) and bottom (ab) group: k16 slice kk
    // holds rows 16 kk + 2 i4 (+1) in registers 0-1 and 16 kk + 2 i4 + 8
    // (+1) in 2-3, of column cb in the even and cb + 1 in the odd ones
    const unsigned char* pk = base + s * L::kStage;
    uint32_t at[kGroup / 16][4], ab[kGroup / 16][4];
#pragma unroll
    for (int kk = 0; kk < kGroup / 16; ++kk) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int r = 16 * kk + 2 * i4 + 8 * h2;
        // two bytes of packed rows r and r + 1 (TMA's 128-byte swizzle)
        const uint32_t w0 = *reinterpret_cast<const uint16_t*>(
            pk + r * 128 + ((((cb >> 4) ^ (r & 7)) << 4) | (cb & 15)));
        const uint32_t w1 = *reinterpret_cast<const uint16_t*>(
            pk + (r + 1) * 128 + ((((cb >> 4) ^ ((r + 1) & 7)) << 4) | (cb & 15)));
        const uint32_t lo = __byte_perm(w0, w1, 0x6420);  // column cb: rows r, r + 1
        const uint32_t hi = __byte_perm(w0, w1, 0x6521);  // column cb + 1
        at[kk][2 * h2] = nibbles_to_bf16x2(lo);
        at[kk][2 * h2 + 1] = nibbles_to_bf16x2(hi);
        ab[kk][2 * h2] = nibbles_to_bf16x2(lo >> 4);
        ab[kk][2 * h2 + 1] = nibbles_to_bf16x2(hi >> 4);
      }
    }
    const uint32_t x_u = base_u + s * L::kStage + kPacked;
    fence_regs(dt);
    fence_regs(db);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kGroup / 16; ++kk) wgmma_rs_kb<N>(dt, at[kk], x_desc<N>(x_u, 0, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < kGroup / 16; ++kk) wgmma_rs_kb<N>(db, ab[kk], x_desc<N>(x_u, 1, kk), kk);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(dt);
    add_scaled<N>(acc, dt, st.x, st.y);
    wgmma_wait<0>();
    fence_regs(db);
    if (t == 0) mbar_arrive(bar_empty + 8 * s);  // both groups' products are done
    add_scaled<N>(acc, db, sb.x, sb.y);
    st = st_next;
    sb = sb_next;
    if (u == u1 - 1 || pr == p.pairs - 1)
      finish_tile<N, OutT>(p, flag, wg, tile, tile * p.pairs < u0 || pr != p.pairs - 1,
                           (tile % p.n_ct) * kBM + cb, (tile % p.n_ct) * kBM + cb + 1, acc);
  }
}

// One consumer warpgroup at N >= 64: its 64 columns of every unit of the
// block's range, unpacked through shared bf16 A tiles.
template <int N, typename OutT>
__device__ __forceinline__ void consume_ss(const Params& p, unsigned char* base, uint32_t base_u,
                                           int wg, int u0, int u1) {
  using L = Smem<N>;
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31, g = lane >> 2;
  const uint32_t bar_full = base_u + L::bar, bar_empty = base_u + L::bar + 8 * L::kStages;
  unsigned char* a_top = base + L::a + wg * 2 * kA;
  const uint32_t a_top_u = base_u + L::a + wg * 2 * kA;
  int* flag = reinterpret_cast<int*>(base + L::flag) + wg;
  float acc[N / 2], tmp[N / 2];
  for (int u = u0, i = 0; u < u1; ++u, ++i) {  // i: the ring position
    const int tile = u / p.pairs, pr = u - tile * p.pairs, s = i % L::kStages;
    const int col_lo = (tile % p.n_ct) * kBM + wg * 64 + warp * 16 + g;  // and col_lo + 8
    if (u == u0 || pr == 0) {
#pragma unroll
      for (int j = 0; j < N / 2; ++j) acc[j] = 0.f;
    }
    const float* st = p.scales + (long long)pr * p.n_out + col_lo;
    const float* sb = p.scales + (long long)(p.pairs + pr) * p.n_out + col_lo;
    const float st_lo = __ldg(st), st_hi = __ldg(st + 8), sb_lo = __ldg(sb), sb_hi = __ldg(sb + 8);
    mbar_wait(bar_full + 8 * s, (i / L::kStages) & 1);
    bar_sync(2 + wg, 128);  // every warp's products of the last unit are done with A
    // unpack this warpgroup's 64 columns: 128 rows x 4 chunks of 16 bytes
    const unsigned char* pk = base + s * L::kStage;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int r = (t + x * 128) >> 2, q = (t + x * 128) & 3;
      const int c = wg * 4 + q;  // the 16-byte chunk of the packed row (TMA swizzle)
      const uint4 w = *reinterpret_cast<const uint4*>(pk + r * 128 + ((c ^ (r & 7)) * 16));
      uint32_t tv[8], bv[8];
      unpack16(w, tv, bv);
      unsigned char* rt_ = a_top + r * 128;
      unsigned char* rb_ = a_top + kA + r * 128;
      const int c0 = ((2 * q) ^ (r & 7)) * 16, c1 = ((2 * q + 1) ^ (r & 7)) * 16;
      *reinterpret_cast<uint4*>(rt_ + c0) = make_uint4(tv[0], tv[1], tv[2], tv[3]);
      *reinterpret_cast<uint4*>(rt_ + c1) = make_uint4(tv[4], tv[5], tv[6], tv[7]);
      *reinterpret_cast<uint4*>(rb_ + c0) = make_uint4(bv[0], bv[1], bv[2], bv[3]);
      *reinterpret_cast<uint4*>(rb_ + c1) = make_uint4(bv[4], bv[5], bv[6], bv[7]);
    }
    fence_proxy_async();
    bar_sync(2 + wg, 128);  // A is written
    const uint32_t x_u = base_u + s * L::kStage + kPacked;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the top group, then its bottom partner
      fence_regs(tmp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kGroup / 16; ++kk) {
        const uint64_t da = sw128_desc(a_top_u + h * kA + kk * 16 * 128, kA, 1024);
        wgmma_ss_ta<N>(tmp, da, x_desc<N>(x_u, h, kk), kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(tmp);
      if (h == 1 && t == 0) mbar_arrive(bar_empty + 8 * s);  // both groups' products done
      add_scaled<N>(acc, tmp, h ? sb_lo : st_lo, h ? sb_hi : st_hi);
    }
    if (u == u1 - 1 || pr == p.pairs - 1)
      finish_tile<N, OutT>(p, flag, wg, tile, tile * p.pairs < u0 || pr != p.pairs - 1, col_lo,
                           col_lo + 8, acc);
  }
}

template <int N, typename OutT>
__global__ void __launch_bounds__(kThreads, 1) w4_wgmma_kernel(const __grid_constant__ Params p) {
  using L = Smem<N>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_u = smem_u32(smem_raw);
  const uint32_t base_u = (raw_u + 1023u) & ~1023u;  // the 128-byte swizzle's atoms
  unsigned char* base = smem_raw + (base_u - raw_u);
  const uint32_t bar_full = base_u + L::bar, bar_empty = base_u + L::bar + 8 * L::kStages;
  const int u0 = unit_begin(blockIdx.x, p.units, p.blocks);
  const int u1 = unit_begin(blockIdx.x + 1, p.units, p.blocks);

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg < kConsumers) {
    if constexpr (L::kRegA) consume_rs<N, OutT>(p, base, base_u, wg, u0, u1);
    else consume_ss<N, OutT>(p, base, base_u, wg, u0, u1);
  } else if (threadIdx.x == 128 * kConsumers) {  // the producer warp's first thread
    for (int u = u0, i = 0; u < u1; ++u, ++i) {
      const int s = i % L::kStages;
      if (i >= L::kStages) mbar_wait(bar_empty + 8 * s, ((i / L::kStages) + 1) & 1);
      const int tile = u / p.pairs, pr = u % p.pairs;
      const int rt = tile / p.n_ct, ct = tile % p.n_ct;
      const uint32_t dst = base_u + s * L::kStage;
      mbar_arrive_tx(bar_full + 8 * s, L::kStage);
      tma_load_2d(dst, &p.tp, bar_full + 8 * s, ct * kBM, pr * kGroup);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          tma_load_2d(dst + kPacked + (2 * h + c) * L::kXBox, &p.tx, bar_full + 8 * s,
                      h * p.half + pr * kGroup + c * 64, rt * N);
    }
  }
}

// f32 activations: one thread per output column and 8 rows, f32 products,
// the groups in the plain version's order
constexpr int kF32Rows = 8;

template <typename OutT>
__global__ void w4_f32_kernel(const float* x, const int8_t* packed, const float* scales,
                              OutT* out, int rows, int n_in, int n_out) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int r0 = blockIdx.y * kF32Rows;
  if (col >= n_out) return;
  const int nr = min(kF32Rows, rows - r0);
  const int half = n_in / 2, half_groups = half / kGroup;
  float acc[kF32Rows] = {};
  for (int grp = 0; grp < half_groups; ++grp) {
    float pt[kF32Rows] = {}, pb[kF32Rows] = {};
    for (int k = 0; k < kGroup; ++k) {
      const int kr = grp * kGroup + k;
      const int v = packed[(long long)kr * n_out + col];  // sign-extended byte
      const float top = (float)(((v & 0xF) ^ 8) - 8);
      const float bot = (float)((((v >> 4) & 0xF) ^ 8) - 8);
#pragma unroll
      for (int r = 0; r < kF32Rows; ++r) {
        if (r < nr) {
          const float* xr = x + (long long)(r0 + r) * n_in;
          pt[r] += xr[kr] * top;
          pb[r] += xr[half + kr] * bot;
        }
      }
    }
    const float st = scales[(long long)grp * n_out + col];
    const float sb = scales[(long long)(half_groups + grp) * n_out + col];
#pragma unroll
    for (int r = 0; r < kF32Rows; ++r) acc[r] = acc[r] + pt[r] * st + pb[r] * sb;
  }
  for (int r = 0; r < nr; ++r) store1(out + (long long)(r0 + r) * n_out + col, acc[r]);
}

// the row tile of `rows` rows: the fewest of 8, 16, 32, 64 that hold them, else 128
int row_tile(int rows) {
  for (int n = 8; n < 128; n *= 2)
    if (rows <= n) return n;
  return 128;
}

template <int N, typename OutT>
int launch_tile(Params& p, const void* x, const void* packed, int rows, int n_in,
                cudaStream_t stream) {
  if (!matrix_map(&p.tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, n_in, rows, (long long)n_in * 2, 64,
                  N, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !matrix_map(&p.tp, CU_TENSOR_MAP_DATA_TYPE_UINT8, packed, p.n_out, n_in / 2, p.n_out, kBM,
                  kGroup, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = Smem<N>::alloc;
  cudaError_t err = cudaFuncSetAttribute(w4_wgmma_kernel<N, OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  w4_wgmma_kernel<N, OutT><<<p.blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch(const void* x, const int8_t* packed, const float* scales, void* out, void* ws,
           int rows, int n_in, int n_out, int blocks, int x_f32, cudaStream_t stream) {
  if (x_f32) {
    dim3 grid((n_out + 127) / 128, (rows + kF32Rows - 1) / kF32Rows);
    w4_f32_kernel<OutT><<<grid, 128, 0, stream>>>(
        static_cast<const float*>(x), packed, scales, static_cast<OutT*>(out), rows, n_in, n_out);
    return (int)cudaGetLastError();
  }
  const int n = row_tile(rows);
  Params p;
  p.scales = scales;
  p.out = out;
  p.rows = rows;
  p.n_out = n_out;
  p.half = n_in / 2;
  p.n_ct = n_out / kBM;
  p.pairs = n_in / (2 * kGroup);
  const int tiles = p.n_ct * ((rows + n - 1) / n);
  p.units = tiles * p.pairs;
  p.blocks = blocks;
  if (blocks < 1 || blocks > p.units || ws == nullptr) return (int)cudaErrorInvalidValue;
  // the workspace: the counters, then (from a 256-byte boundary) the partials
  p.counters = static_cast<int*>(ws);
  p.partials = reinterpret_cast<float*>(static_cast<char*>(ws) +
                                        ((long long)tiles * kConsumers * 4 + 255) / 256 * 256);
  switch (n) {
    case 8: return launch_tile<8, OutT>(p, x, packed, rows, n_in, stream);
    case 16: return launch_tile<16, OutT>(p, x, packed, rows, n_in, stream);
    case 32: return launch_tile<32, OutT>(p, x, packed, rows, n_in, stream);
    case 64: return launch_tile<64, OutT>(p, x, packed, rows, n_in, stream);
    default: return launch_tile<128, OutT>(p, x, packed, rows, n_in, stream);
  }
}

}  // namespace

// x [rows, n_in] (bf16, or f32 when x_f32), packed int8 [n_in / 2, n_out],
// scales f32 [n_in / 128, n_out], out [rows, n_out] (bf16, or f32 when
// out_f32). The bf16 path launches one block per `blocks` (1 <= blocks <=
// the units of w4_split_plan) and takes ws: [tiles][2] int32 counters, zero
// before the first call (the kernel leaves them zero), then from the next
// 256-byte boundary [blocks][2][2][128][N / 2] f32 partials. All
// contiguous and 16-byte aligned; n_in % 256 == 0, n_out % 128 == 0.
// Returns the launch's CUDA error (0 when it launched).
extern "C" int lvt_w4_matmul(const void* x, const void* packed, const void* scales, void* out,
                             void* ws, int rows, int n_in, int n_out, int blocks, int x_f32,
                             int out_f32, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  if (n_in % (2 * kGroup) || n_out % kBM) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* pk = static_cast<const int8_t*>(packed);
  const float* sc = static_cast<const float*>(scales);
  return out_f32 ? launch<float>(x, pk, sc, out, ws, rows, n_in, n_out, blocks, x_f32, s)
                 : launch<__nv_bfloat16>(x, pk, sc, out, ws, rows, n_in, n_out, blocks, x_f32, s);
}

// Dynamic shared memory a block takes at the row tile n (for the build
// report); 0 for another n.
extern "C" int lvt_w4_matmul_smem_bytes(int n) {
  switch (n) {
    case 8: return Smem<8>::alloc;
    case 16: return Smem<16>::alloc;
    case 32: return Smem<32>::alloc;
    case 64: return Smem<64>::alloc;
    case 128: return Smem<128>::alloc;
    default: return 0;
  }
}
