// The bf16 attention backward for Hopper (sm_90a): one template behind K4
// (flash_bwd.cu, entry lvt_flash_bwd) and K5 (flash_bwd_2pass.cu, entries
// lvt_flash_bwd_dkv and lvt_flash_bwd_dq). What the entry points compute is
// the contract in flash_bwd_common.cuh.
//
// What bounds it: S, dP, dV, dK and dQ are 2 x D operations each for every
// unmasked (q, k) pair and q head, on operands each block reads once per
// 64-128 rows, far above the H100's ~295 FLOP/byte ridge: tensor-core
// bound, and at D = 64 as much by the exp2 and the element-wise dS. On
// packed training rows most of the causal triangle lies between segments,
// so the first saving is not to compute it. The design:
//   - kv-major block (dkv_kernel; K5's first pass, and K4 with kFused): one
//     (128-row kv tile, kv head, batch row), two consumer warpgroups of 64
//     kv rows and a producer warpgroup; setmaxnreg hands the producer's
//     registers to the consumers, which keep dK and dV in f32 registers for
//     the whole sweep. K and V come in once by TMA; one producer warp then
//     streams 64-row tiles of Q and dO (TMA) with their lse, delta and q
//     segment ids (plain loads) through a ring of shared-memory stages
//     handed over by full and empty mbarriers, over the GQA group's q heads
//     and only the q tiles that can see the kv tile: from the causal
//     diagonal on, below kv_valid_len, and with a segment-id range that
//     meets the kv tile's. Causal grids start the heaviest blocks first: kv
//     tile 0 (seen by every q row), or with segments the order the wrapper
//     computes from the tiles' id ranges (packed rows make blocks of very
//     unequal work, and a heavy block started last runs alone);
//   - per (q tile, kv tile) pair: S^T = K.Q^T and dP^T = V.dO^T (wgmma
//     m64n64k16, both operands K-major in shared memory); P^T and dS^T in
//     registers, whose accumulator layout is the A operand of dV += P^T.dO
//     and dK += dS^T.Q (wgmma RS, dO and Q MN-major through the transpose
//     bit). Pairs wholly inside kv_len, below the warpgroup's diagonal and
//     inside one segment skip the mask;
//   - K4 (kFused) also writes dS^T to shared memory (bf16, [kv][q], the
//     128-byte swizzle; two buffers, so one named barrier a pair suffices),
//     forms the tile's dQ = dS.K by wgmma (A and B MN-major; warpgroup w
//     takes the columns w D/2..; dK += dS^T.Q reads the same buffer as a
//     K-major A, which keeps dS out of the registers) and adds it into the
//     f32 [B, Sq, Hq, D] buffer the wrapper zeroes by a TMA reduce-add of
//     the f32 tile staged in shared memory (cp.reduce.async.bulk.tensor:
//     one instruction a warpgroup and pair; per-element float2 or float4
//     atomics, one per thread and column pair, were K4's bottleneck). dQ is not
//     bit-reproducible (the order of the adds varies); dK and dV are (each
//     block owns its rows);
//   - q-major block (dq_kernel; K5's second pass), as the forward: one (128
//     q rows, q head, batch row), Q and dO loaded once, K, V and the kv
//     segment ids of 128-row tiles through the ring, skipping the tiles past
//     min(causal diagonal, kv_len) and those whose id range misses the
//     block's. S = Q.K^T and dP = dO.V^T (wgmma m64n128k16), dS in
//     registers, dQ += dS.K (wgmma RS, K MN-major); dQ written once in bf16.
// Registers: at D = 128 a kv-major consumer thread holds dK and dV (128
// f32), S^T and dP^T (64) and the A fragments (32) of its 240; ptxas
// still reports "C7512 wgmma serialized due to insufficient register
// resources" for these four kernels and spills 0.3-1 KB (their SASS moves
// S^T, dP^T, dV and dK through one accumulator window), the open item of
// this design; the q-major and the D = 64 kernels do not. Neither dS^T
// read from shared memory for dK, nor K4's dQ product in a commit group of
// its own, nor (kept) dV waited for before dK is issued clears it
// (tools/attn_bwd_variants.py).
// Rows between kv_len and Skv are inside the tensor, so TMA loads them as
// they are, and dQ = dS.K would meet them (0 x NaN = NaN): the K and V rows
// from kv_len on are zeroed in shared memory before any consumer reads
// them. Rows past Sq come in as zeros with lse = +inf and delta = 0, so
// their p and dS are 0 without a mask. A row with no unmasked key (lse =
// -2^30) only meets masked pairs, which never count as interior.
#pragma once

#include <climits>

#include "mma_util.cuh"
#include "sm90_util.cuh"

namespace lvt {
namespace bwd90 {

constexpr int kBN = 128;          // kv rows: a kv-major block; a tile of the dq pass
constexpr int kBQ = 64;           // q rows: a kv-major block's tile; a dq warpgroup's
constexpr int kBQdq = 128;        // q rows of a dq block
constexpr int kBox = 128 * 128;   // bytes of one 128-row x 64-column bf16 box (K, V)
constexpr int kQBox = 64 * 128;   // bytes of one 64-row x 64-column bf16 box (Q, dO)
constexpr int kDsBytes = kBN * kBQ * 2;  // one dS^T buffer: 128 kv rows x 64 q columns, bf16
constexpr int kDqBox = kBQ * 128;        // one f32 box of dQ: 64 rows x 32 columns
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kConsumerRegs = 240, kProducerRegs = 24;
static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <= 65536, "registers");
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  CUtensorMap tq, tdo;  // [B, Sq, Hq, D] in boxes of kBQ rows
  CUtensorMap tk, tv;   // [B, Skv, Hkv, D] in boxes of kBN rows
  CUtensorMap tkseg;    // [B, Skv] int32 in boxes of kBN ids, with segments only
  CUtensorMap tdq;      // K4's f32 dQ sums [B, Sq, Hq, D] in boxes of kBQ rows x 32 columns
  const float* lse;     // [B, Hq, Sq]
  const float* delta;   // [B, Hq, Sq]
  void* dq;             // [B, Sq, Hq, D]: f32 sums (K4) or bf16 (dq pass)
  __nv_bfloat16* dk;    // [B, Skv, Hkv, D]
  __nv_bfloat16* dv;
  const int* qseg;      // [B, Sq] or null
  const int* kseg;      // [B, kseg_sb] or null
  // with segments: per batch row, the (min, max) segment id of each kBQ-row
  // q tile, each kBQdq-row q block, then each kBN-row kv tile:
  // [B, n_qt + n_qb + n_kt, 2]
  const int* seg_ranges;
  // with segments under a causal mask: per batch row, the kv tiles heaviest
  // first (the kv-major grid's order), [B, n_kt]; else null (tile order)
  const int* tile_order;
  const int* meta;      // device int32 [q_offset, kv_offset, kv_valid_len]
  long long qseg_sb, kseg_sb;
  int sq, skv, hq, hkv, n_qt, n_qb, n_kt;
  float scale, scale_log2;
};

// ---- the kv-major block: dK and dV (and K4's dQ sums) -----------------------

template <int D, bool kFused>
struct KvSmem {
  static constexpr int kStages = D == 128 ? (kFused ? 2 : 3) : 4;
  static constexpr int kTile = (D / 64) * kBox;    // K or V
  static constexpr int kQTile = (D / 64) * kQBox;  // Q or dO
  static constexpr int k = 0;
  static constexpr int v = k + kTile;
  static constexpr int q = v + kTile;                    // + stage * kQTile
  static constexpr int dout = q + kStages * kQTile;      // + stage * kQTile
  static constexpr int ds = dout + kStages * kQTile;     // + buffer * kDsBytes (K4)
  static constexpr int kDqStage = (D / 64) * kDqBox;   // a warpgroup's f32 [64 x D/2] dQ (K4)
  static constexpr int dqs = ds + (kFused ? 2 * kDsBytes : 0);  // + warpgroup * kDqStage
  static constexpr int lse2 = dqs + (kFused ? kConsumers * kDqStage : 0);  // + stage * kBQ * 4
  static constexpr int delta = lse2 + kStages * kBQ * 4;
  static constexpr int qseg = delta + kStages * kBQ * 4;
  static constexpr int bar = qseg + kStages * kBQ * 4;
  // barriers: kv, full[stages], empty[stages]
  static constexpr int bytes = bar + (1 + 2 * kStages) * 8;
  static constexpr int alloc = bytes + 1024;  // room to align the base
};

struct KvBars {
  uint32_t base;
  int stages;
  __device__ uint32_t kv() const { return base; }
  __device__ uint32_t full(int s) const { return base + 8 + 8 * s; }
  __device__ uint32_t empty(int s) const { return base + 8 + 8 * (stages + s); }
};

// what producer and consumers agree on for one kv-major block
struct KvBlock {
  int hk, b, kt, k0, kv_len, group, qt_begin, n_qt;
  long long q_off, k_off;
  int ks_min, ks_max;      // the kv tile's segment ids (with segments)
  const int2* qt_ranges;   // each kBQ-row q tile's (min, max) id (with segments)
};

// The (q head, q tile) pairs of a kv-major block: the group's heads in turn,
// each over the same q tiles.
template <bool kSeg>
struct GroupWalk {
  int hh = 0;  // the head in the GQA group of the tile last returned
  TileWalk<kSeg> w;

  __device__ explicit GroupWalk(const KvBlock& blk) : w(blk.qt_begin) {}

  __device__ __forceinline__ int next(const KvBlock& blk) {  // -> the next q tile, or -1
    for (;;) {
      const int qt = w.next(blk.n_qt, blk.qt_ranges, blk.ks_min, blk.ks_max);
      if (qt >= 0) return qt;
      if (hh + 1 >= blk.group) return -1;
      ++hh;
      w = TileWalk<kSeg>(blk.qt_begin);
    }
  }
};

// One producer warp: K and V of the block once, then Q and dO of each q tile
// by TMA, its lse (in log2 units), delta and q segment ids by plain loads
// (rows past Sq: lse = +inf, so p = 0; delta = 0). The lanes' stores are
// released by their arrivals on the stage's full barrier (count 32).
template <int D, bool kSeg, bool kFused>
__device__ __forceinline__ void produce_kv(const Params& p, const KvBlock& blk,
                                           unsigned char* base, uint32_t base_u,
                                           const KvBars& bars) {
  using L = KvSmem<D, kFused>;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    mbar_arrive_tx(bars.kv(), 2 * L::kTile);
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      tma_load_4d(base_u + L::k + c * kBox, &p.tk, bars.kv(), c * 64, blk.hk, blk.k0, blk.b);
      tma_load_4d(base_u + L::v + c * kBox, &p.tv, bars.kv(), c * 64, blk.hk, blk.k0, blk.b);
    }
  }
  GroupWalk<kSeg> walk(blk);
  for (int qt = walk.next(blk), it = 0; qt >= 0; qt = walk.next(blk), ++it) {
    const int s = it % L::kStages, q0 = qt * kBQ;
    const int h = blk.hk * blk.group + walk.hh;
    if (it >= L::kStages) mbar_wait(bars.empty(s), ((it / L::kStages) + 1) & 1);
    const long long stat = ((long long)blk.b * p.hq + h) * p.sq;
    float* lse2 = reinterpret_cast<float*>(base + L::lse2 + s * kBQ * 4);
    float* delta = reinterpret_cast<float*>(base + L::delta + s * kBQ * 4);
    int* qseg = reinterpret_cast<int*>(base + L::qseg + s * kBQ * 4);
#pragma unroll
    for (int r = lane; r < kBQ; r += 32) {
      const int i = q0 + r;
      const bool in = i < p.sq;
      lse2[r] = in ? p.lse[stat + i] * kLog2e : INFINITY;
      delta[r] = in ? p.delta[stat + i] : 0.f;
      if (kSeg) qseg[r] = in ? p.qseg[blk.b * p.qseg_sb + i] : -1;
    }
    if (lane == 0) {
      mbar_arrive_tx(bars.full(s), 2 * L::kQTile);
      const uint32_t q_dst = base_u + L::q + s * L::kQTile;
      const uint32_t do_dst = base_u + L::dout + s * L::kQTile;
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(q_dst + c * kQBox, &p.tq, bars.full(s), c * 64, h, q0, blk.b);
        tma_load_4d(do_dst + c * kQBox, &p.tdo, bars.full(s), c * 64, h, q0, blk.b);
      }
    } else {
      mbar_arrive(bars.full(s));
    }
  }
}

// One consumer warpgroup's 64 kv rows (rows r0.. of the block's tile). No
// wgmma sits under a condition that varies inside the loop.
template <int D, bool kCausal, bool kSeg, bool kFused>
__device__ __forceinline__ void consume_kv(const Params& p, const KvBlock& blk,
                                           unsigned char* base, uint32_t base_u,
                                           const KvBars& bars, int wg) {
  using L = KvSmem<D, kFused>;
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31, g = lane >> 2, i4 = lane & 3;
  const int r0 = wg * 64;
  const int rl = r0 + warp * 16 + g;  // this thread's first kv row in the tile (and rl + 8)
  const int j_lo = blk.k0 + rl, j_hi = j_lo + 8;
  // the first q row that sees key j (causal: q_off + i >= k_off + j), or
  // never for a key at or past kv_len; q rows past Sq need no mask (p = 0)
  auto first_row = [&](int j) {
    if (j >= blk.kv_len) return INT_MAX;
    if (!kCausal) return INT_MIN;
    const long long f = blk.k_off + j - blk.q_off;
    return (int)max(min(f, (long long)INT_MAX), (long long)INT_MIN);
  };
  const int i0_lo = first_row(j_lo), i0_hi = first_row(j_hi);
  int ks_lo = 0, ks_hi = 0;
  if (kSeg) {
    ks_lo = j_lo < blk.kv_len ? p.kseg[blk.b * p.kseg_sb + j_lo] : -2;
    ks_hi = j_hi < blk.kv_len ? p.kseg[blk.b * p.kseg_sb + j_hi] : -2;
  }

  // K and V rows from kv_len on may hold anything (inside the tensor): zero
  // them before the first product; then both warpgroups' rows are final
  mbar_wait(bars.kv(), 0);
  if (blk.k0 + kBN > blk.kv_len) {
    const int rz = max(blk.kv_len - blk.k0, r0);
    zero_tile_rows<D>(base + L::k, kBox, rz, r0 + 64, t, 128);
    zero_tile_rows<D>(base + L::v, kBox, rz, r0 + 64, t, 128);
    fence_proxy_async();
  }
  bar_sync(1, 128 * kConsumers);

  const uint32_t k_wg = base_u + L::k + r0 * 128;  // this warpgroup's rows in each box
  const uint32_t v_wg = base_u + L::v + r0 * 128;
  const float sl = p.scale_log2, scale = p.scale;
  // a pair is interior (every (q, k) of it unmasked; rows past Sq have p =
  // 0 anyway) when the warpgroup's rows lie inside kv_len, the q tile is at
  // or past qt_inner (its first row sees the rows' last key) and, with
  // segments, both tiles hold one and the same id; worked out here in 32
  // bits, so no 64-bit offset stays live in the loop
  int qt_inner = blk.k0 + r0 + 64 <= blk.kv_len ? 0 : INT_MAX;
  if (kCausal && qt_inner == 0) {
    const long long f = blk.k_off + blk.k0 + r0 + 63 - blk.q_off;  // the first such q row
    qt_inner = f <= 0 ? 0 : (int)min((f + kBQ - 1) / kBQ, (long long)INT_MAX);
  }
  if (kSeg && blk.ks_min != blk.ks_max) qt_inner = INT_MAX;
  auto interior = [&](int qt) {
    bool in = qt >= qt_inner;
    if (kSeg) {
      const int2 rg = blk.qt_ranges[qt];
      in = in && rg.x == blk.ks_min && rg.y == blk.ks_min;
    }
    return in;
  };

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) dk[x] = dv[x] = 0.f;

  GroupWalk<kSeg> walk(blk);
  int it = 0;
  for (int qt = walk.next(blk); qt >= 0; qt = walk.next(blk), ++it) {
    const int s = it % L::kStages, q0 = qt * kBQ;
    const uint32_t q_s = base_u + L::q + s * L::kQTile;
    const uint32_t do_s = base_u + L::dout + s * L::kQTile;
    const float* lse2 = reinterpret_cast<const float*>(base + L::lse2 + s * kBQ * 4);
    const float* delta = reinterpret_cast<const float*>(base + L::delta + s * kBQ * 4);
    const int* qseg = reinterpret_cast<const int*>(base + L::qseg + s * kBQ * 4);
    mbar_wait(bars.full(s), (it / L::kStages) & 1);
    // K's and V's addresses are opaque to the compiler in each iteration, so
    // that it builds their descriptors where they are used instead of
    // keeping all of them in registers across the loop
    uint32_t k_a = k_wg, v_a = v_wg, k_all = base_u + L::k;
    asm volatile("" : "+r"(k_a), "+r"(v_a), "+r"(k_all));

    // S^T = K.Q^T and dP^T = V.dO^T: 64 kv rows x 64 q columns. The first
    // k16 slice overwrites them, but the asm reads its accumulator operand,
    // so they are zeroed first: otherwise the last tile's values stay live
    // through the loop and dK, dV, S^T, dP^T and the A fragments no longer
    // fit in the registers (ptxas then serialises the wgmma and spills)
    float st[kBQ / 2], dpt[kBQ / 2];
#pragma unroll
    for (int x = 0; x < kBQ / 2; ++x) st[x] = dpt[x] = 0.f;
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // the k16 slice inside a 64-column box
      wgmma_ss_m64n64(st, sw128_desc(k_a + (kk / 4) * kBox + off, 16, 1024),
                      sw128_desc(q_s + (kk / 4) * kQBox + off, 16, 1024), kk);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss_m64n64(dpt, sw128_desc(v_a + (kk / 4) * kBox + off, 16, 1024),
                      sw128_desc(do_s + (kk / 4) * kQBox + off, 16, 1024), kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // P^T and dS^T in place
    const bool in = interior(qt);
#pragma unroll
    for (int n = 0; n < kBQ / 8; ++n) {
      const int c = n * 8 + 2 * i4;  // q column in the tile (and c + 1)
      const float2 l2 = *reinterpret_cast<const float2*>(lse2 + c);
      const float2 dl = *reinterpret_cast<const float2*>(delta + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lse_c = (e & 1) ? l2.y : l2.x, del_c = (e & 1) ? dl.y : dl.x;
        float pv = exp2_approx(fmaf(st[4 * n + e], sl, -lse_c));
        float ds = pv * (dpt[4 * n + e] - del_c) * scale;
        if (!in) {
          bool ok = q0 + c + (e & 1) >= (e < 2 ? i0_lo : i0_hi);
          if (kSeg) ok = ok && qseg[c + (e & 1)] == (e < 2 ? ks_lo : ks_hi);
          if (!ok) pv = ds = 0.f;
        }
        st[4 * n + e] = pv;
        dpt[4 * n + e] = ds;
      }
    }
    uint32_t pf[kBQ / 16][4];
#pragma unroll
    for (int n = 0; n < kBQ / 8; ++n) {
      pf[n / 2][(n & 1) * 2 + 0] = pack_f32(st[4 * n], st[4 * n + 1]);
      pf[n / 2][(n & 1) * 2 + 1] = pack_f32(st[4 * n + 2], st[4 * n + 3]);
    }

    if constexpr (kFused) {
      // dS^T to shared memory as [kv row][q column] (the 128-byte swizzle:
      // chunk n of row r at n ^ (r % 8)): the K-major A operand of dK +=
      // dS^T.Q for this warpgroup's rows, and the MN-major A operand of
      // dQ[q tile] = dS.K over all 128 kv rows, of which this warpgroup
      // forms the columns wg D/2..; dV += P^T.dO keeps P^T in registers
      unsigned char* ds_s = base + L::ds + (it & 1) * kDsBytes;
#pragma unroll
      for (int n = 0; n < kBQ / 8; ++n) {
        const int off = ((n ^ (rl & 7)) * 16) + 4 * i4;
        *reinterpret_cast<uint32_t*>(ds_s + rl * 128 + off) = pack_f32(dpt[4 * n], dpt[4 * n + 1]);
        *reinterpret_cast<uint32_t*>(ds_s + (rl + 8) * 128 + off) =
            pack_f32(dpt[4 * n + 2], dpt[4 * n + 3]);
      }
      fence_proxy_async();
      if (t == 0) bulk_wait_read<0>();  // the last tile's dQ stage has been read
      bar_sync(1, 128 * kConsumers);
      const uint32_t ds_u = base_u + L::ds + (it & 1) * kDsBytes;
      float dqa[D / 4];
#pragma unroll
      for (int x = 0; x < D / 4; ++x) dqa[x] = 0.f;  // as st and dpt above
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(dqa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        const uint64_t bo = sw128_desc(do_s + kk * 16 * 128, kQBox, 1024);
        if constexpr (D == 128) wgmma_rs_m64n128(dv, pf[kk], bo);
        else wgmma_rs_m64n64(dv, pf[kk], bo);
      }
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        const uint64_t da = sw128_desc(ds_u + r0 * 128 + kk * 32, 16, 1024);
        const uint64_t bq = sw128_desc(q_s + kk * 16 * 128, kQBox, 1024);
        if constexpr (D == 128) wgmma_ss_m64n128_tb(dk, da, bq, 1);
        else wgmma_ss_m64n64_tb(dk, da, bq, 1);
      }
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        const uint64_t da = sw128_desc(ds_u + kk * 16 * 128, kQBox, 1024);
        if constexpr (D == 128) {
          wgmma_ss_m64n64_mn(dqa, da, sw128_desc(k_all + wg * kBox + kk * 16 * 128, kBox,
                                                 1024), kk);
        } else {
          wgmma_ss_m64n32_mn(dqa, da, sw128_desc(k_all + wg * 64 + kk * 16 * 128, kBox,
                                                 1024), kk);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dqa);
      const int h = blk.hk * blk.group + walk.hh;
      // stage this warpgroup's [64 x D/2] f32 part in shared memory (boxes
      // of 32 columns, the 128-byte swizzle: chunk x of row r at x ^ (r %
      // 8)) and add it into the f32 sums with TMA reduce-adds (rows past
      // Sq are dropped); the stage is free again once the adds have read it
      unsigned char* dqs = base + L::dqs + wg * L::kDqStage;
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        const int c = n * 8 + 2 * i4, cc = c % 32;
        const int r = warp * 16 + g;
        unsigned char* box = dqs + (c / 32) * kDqBox;
        *reinterpret_cast<float2*>(box + r * 128 + (((cc / 4) ^ (r & 7)) * 16) + (cc % 4) * 4) =
            make_float2(dqa[4 * n], dqa[4 * n + 1]);
        *reinterpret_cast<float2*>(box + (r + 8) * 128 + (((cc / 4) ^ (r & 7)) * 16) +
                                   (cc % 4) * 4) = make_float2(dqa[4 * n + 2], dqa[4 * n + 3]);
      }
      fence_proxy_async();
      bar_sync(2 + wg, 128);
      if (t == 0) {
#pragma unroll
        for (int x = 0; x < D / 64; ++x)
          tma_reduce_add_4d(&p.tdq, base_u + L::dqs + wg * L::kDqStage + x * kDqBox,
                            wg * (D / 2) + x * 32, h, q0, blk.b);
        bulk_commit();
      }
    } else {
      // dV += P^T.dO and dK += dS^T.Q (the contraction over the tile's q
      // rows), both A operands in registers; dV is waited for before dK is
      // issued (1.5-3% faster than one group on the H100, with less
      // spilled: tools/attn_bwd_variants.py)
      uint32_t df[kBQ / 16][4];
#pragma unroll
      for (int n = 0; n < kBQ / 8; ++n) {
        df[n / 2][(n & 1) * 2 + 0] = pack_f32(dpt[4 * n], dpt[4 * n + 1]);
        df[n / 2][(n & 1) * 2 + 1] = pack_f32(dpt[4 * n + 2], dpt[4 * n + 3]);
      }
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        const uint64_t bo = sw128_desc(do_s + kk * 16 * 128, kQBox, 1024);
        if constexpr (D == 128) wgmma_rs_m64n128(dv, pf[kk], bo);
        else wgmma_rs_m64n64(dv, pf[kk], bo);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        const uint64_t bq = sw128_desc(q_s + kk * 16 * 128, kQBox, 1024);
        if constexpr (D == 128) wgmma_rs_m64n128(dk, df[kk], bq);
        else wgmma_rs_m64n64(dk, df[kk], bq);
      }
      wgmma_commit();
      wgmma_wait<0>();
    }
    fence_regs(dv);
    fence_regs(dk);
    if (t == 0) mbar_arrive(bars.empty(s));
  }

  if (kFused && t == 0) bulk_wait_all();  // the dQ adds are done before the block exits

  // dK and dV rows of the warpgroup (zeros past kv_valid_len)
  const long long rs = (long long)p.hkv * D;
  __nv_bfloat16* dkg = p.dk + (long long)blk.b * p.skv * rs + (long long)blk.hk * D;
  __nv_bfloat16* dvg = p.dv + (long long)blk.b * p.skv * rs + (long long)blk.hk * D;
  const bool lo_in = j_lo < blk.kv_len, hi_in = j_hi < blk.kv_len;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * i4;
    if (j_lo < p.skv) {
      *reinterpret_cast<uint32_t*>(dkg + j_lo * rs + c) =
          lo_in ? pack_f32(dk[4 * n], dk[4 * n + 1]) : 0u;
      *reinterpret_cast<uint32_t*>(dvg + j_lo * rs + c) =
          lo_in ? pack_f32(dv[4 * n], dv[4 * n + 1]) : 0u;
    }
    if (j_hi < p.skv) {
      *reinterpret_cast<uint32_t*>(dkg + j_hi * rs + c) =
          hi_in ? pack_f32(dk[4 * n + 2], dk[4 * n + 3]) : 0u;
      *reinterpret_cast<uint32_t*>(dvg + j_hi * rs + c) =
          hi_in ? pack_f32(dv[4 * n + 2], dv[4 * n + 3]) : 0u;
    }
  }
}

template <int D, bool kCausal, bool kSeg, bool kFused>
__global__ void __launch_bounds__(kThreads, 1) dkv_kernel(const __grid_constant__ Params p) {
  using L = KvSmem<D, kFused>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_u = smem_u32(smem_raw);
  const uint32_t base_u = (raw_u + 1023u) & ~1023u;  // the 128-byte swizzle's atoms
  unsigned char* base = smem_raw + (base_u - raw_u);
  const KvBars bars{base_u + L::bar, L::kStages};

  KvBlock blk;
  if (kCausal) {  // grid (Hkv, B, kv tiles), the heaviest kv tiles first: tile 0
    blk.hk = blockIdx.x;  // (seen by every q row), or with segments the given order
    blk.b = blockIdx.y;
    blk.kt = p.tile_order ? p.tile_order[(long long)blk.b * p.n_kt + blockIdx.z] : blockIdx.z;
  } else {  // grid (kv tiles, Hkv, B): the kv tiles of one head run together
    blk.kt = blockIdx.x;
    blk.hk = blockIdx.y;
    blk.b = blockIdx.z;
  }
  blk.k0 = blk.kt * kBN;
  blk.group = p.hq / p.hkv;
  blk.q_off = p.meta[0];
  blk.k_off = p.meta[1];
  blk.kv_len = min(max(p.meta[2], 0), p.skv);
  blk.n_qt = blk.k0 < blk.kv_len ? p.n_qt : 0;  // a tile wholly past kv_len sees no q row
  blk.qt_begin = 0;
  if (kCausal) {  // the q tile of the first row that sees the tile's first key
    const long long first = blk.k_off + blk.k0 - blk.q_off;
    blk.qt_begin = first <= 0 ? 0 : (int)min(first / kBQ, (long long)blk.n_qt);
  }
  blk.ks_min = blk.ks_max = 0;
  blk.qt_ranges = nullptr;
  if (kSeg) {
    const int* ranges = p.seg_ranges + (long long)blk.b * 2 * (p.n_qt + p.n_qb + p.n_kt);
    blk.qt_ranges = reinterpret_cast<const int2*>(ranges);
    const int2 kr = reinterpret_cast<const int2*>(ranges + 2 * (p.n_qt + p.n_qb))[blk.kt];
    blk.ks_min = kr.x;
    blk.ks_max = kr.y;
  }

  if (threadIdx.x == 0) {
    mbar_init(bars.kv(), 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(bars.full(s), 32);
      mbar_init(bars.empty(s), kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    if ((threadIdx.x >> 5) == 4 * kConsumers)  // one warp loads
      produce_kv<D, kSeg, kFused>(p, blk, base, base_u, bars);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    consume_kv<D, kCausal, kSeg, kFused>(p, blk, base, base_u, bars, wg);
  }
}

// ---- the q-major block: K5's dQ --------------------------------------------

template <int D>
struct QSmem {
  static constexpr int kStages = D == 128 ? 2 : 4;
  static constexpr int kTile = (D / 64) * kBox;    // K or V
  static constexpr int kQTile = (D / 64) * kQBox;  // a warpgroup's 64 rows of Q or dO
  static constexpr int q = 0;                            // + warpgroup * kQTile
  static constexpr int dout = q + kConsumers * kQTile;   // + warpgroup * kQTile
  static constexpr int k = dout + kConsumers * kQTile;   // + stage * kTile
  static constexpr int v = k + kStages * kTile;          // + stage * kTile
  static constexpr int kseg = v + kStages * kTile;       // + stage * kBN * 4
  static constexpr int bar = kseg + kStages * kBN * 4;
  // barriers: q, aux, full[stages], empty[stages]
  static constexpr int bytes = bar + (2 + 2 * kStages) * 8;
  static constexpr int alloc = bytes + 1024;
};

struct QBars {
  uint32_t base;
  int stages;
  __device__ uint32_t q() const { return base; }
  __device__ uint32_t aux() const { return base + 8; }
  __device__ uint32_t full(int s) const { return base + 16 + 8 * s; }
  __device__ uint32_t empty(int s) const { return base + 16 + 8 * (stages + s); }
};

struct QBlock {
  int h, b, hk, q0, kv_len, n_tiles, n_wg;
  long long q_off, k_off;
  int qs_min, qs_max;       // the block's segment ids (with segments)
  const int2* kt_ranges;    // each kv tile's (min, max) id (with segments)
};

template <int D, bool kSeg>
__device__ __forceinline__ void produce_q(const Params& p, const QBlock& blk, unsigned char* base,
                                          uint32_t base_u, const QBars& bars) {
  using L = QSmem<D>;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    mbar_arrive_tx(bars.q(), 2 * blk.n_wg * L::kQTile);
    for (int w = 0; w < blk.n_wg; ++w)
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        const int r = blk.q0 + w * kBQ;
        tma_load_4d(base_u + L::q + w * L::kQTile + c * kQBox, &p.tq, bars.q(), c * 64, blk.h, r,
                    blk.b);
        tma_load_4d(base_u + L::dout + w * L::kQTile + c * kQBox, &p.tdo, bars.q(), c * 64,
                    blk.h, r, blk.b);
      }
  }
  TileWalk<kSeg> walk;
  for (int j = walk.next(blk.n_tiles, blk.kt_ranges, blk.qs_min, blk.qs_max), it = 0; j >= 0;
       j = walk.next(blk.n_tiles, blk.kt_ranges, blk.qs_min, blk.qs_max), ++it) {
    const int s = it % L::kStages, k0 = j * kBN;
    if (it >= L::kStages) mbar_wait(bars.empty(s), ((it / L::kStages) + 1) & 1);
    const uint32_t k_dst = base_u + L::k + s * L::kTile;
    const uint32_t v_dst = base_u + L::v + s * L::kTile;
    const uint32_t seg_dst = base_u + L::kseg + s * kBN * 4;
    const uint32_t bytes = 2 * L::kTile + (kSeg ? kBN * 4 : 0);
    // the last, partial tile: its K and V rows from kv_len on are inside the
    // tensor and may hold anything; it lands on the side barrier, is zeroed
    // there, and only then released (at most one such tile a block)
    const bool partial = k0 + kBN > blk.kv_len && blk.kv_len < p.skv;
    const uint32_t bar = partial ? bars.aux() : bars.full(s);
    if (lane == 0) {
      mbar_arrive_tx(bar, bytes);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(k_dst + c * kBox, &p.tk, bar, c * 64, blk.hk, k0, blk.b);
        tma_load_4d(v_dst + c * kBox, &p.tv, bar, c * 64, blk.hk, k0, blk.b);
      }
      if (kSeg) tma_load_2d(seg_dst, &p.tkseg, bar, k0, blk.b);
    }
    if (partial)
      zero_then_release<D>(bars.aux(), bars.full(s), base + L::k + s * L::kTile,
                           base + L::v + s * L::kTile, kBox, blk.kv_len - k0, kBN);
  }
}

// One consumer warpgroup's 64 q rows of a dq block.
template <int D, bool kCausal, bool kSeg>
__device__ __forceinline__ void consume_q(const Params& p, const QBlock& blk, unsigned char* base,
                                          uint32_t base_u, const QBars& bars, int wg) {
  using L = QSmem<D>;
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31, g = lane >> 2, i4 = lane & 3;
  const int row0 = blk.q0 + wg * kBQ;  // this warpgroup's first q row
  const int qi_lo = row0 + warp * 16 + g, qi_hi = qi_lo + 8;
  // the last key a row sees: below kv_len and (causal) k_off + col <= q_off + i
  auto last_col = [&](int i) {
    long long c = blk.kv_len - 1;
    if (kCausal) c = min(c, blk.q_off + i - blk.k_off);
    return (int)max(c, -1LL);
  };
  const int cmax_lo = last_col(qi_lo), cmax_hi = last_col(qi_hi);
  const long long stat = ((long long)blk.b * p.hq + blk.h) * p.sq;
  // rows past Sq: lse = +inf (p = 0) and delta = 0
  const float lse_lo = qi_lo < p.sq ? p.lse[stat + qi_lo] * kLog2e : INFINITY;
  const float lse_hi = qi_hi < p.sq ? p.lse[stat + qi_hi] * kLog2e : INFINITY;
  const float del_lo = qi_lo < p.sq ? p.delta[stat + qi_lo] : 0.f;
  const float del_hi = qi_hi < p.sq ? p.delta[stat + qi_hi] : 0.f;
  int qs_lo = 0, qs_hi = 0;
  if (kSeg) {
    qs_lo = qi_lo < p.sq ? p.qseg[blk.b * p.qseg_sb + qi_lo] : -1;
    qs_hi = qi_hi < p.sq ? p.qseg[blk.b * p.qseg_sb + qi_hi] : -1;
  }
  const float sl = p.scale_log2, scale = p.scale;
  const uint32_t q_wg = base_u + L::q + wg * L::kQTile;
  const uint32_t do_wg = base_u + L::dout + wg * L::kQTile;
  auto interior = [&](int j) {  // every (q, k) of the pair unmasked
    const int k0 = j * kBN;
    bool in = k0 + kBN <= blk.kv_len &&
              (!kCausal || blk.k_off + k0 + kBN - 1 <= blk.q_off + row0);
    if (kSeg) {
      const int2 rg = blk.kt_ranges[j];
      in = in && rg.x == rg.y && blk.qs_min == blk.qs_max && rg.x == blk.qs_min;
    }
    return in;
  };

  float dq[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) dq[x] = 0.f;
  TileWalk<kSeg> walk;
  int it = 0, j = walk.next(blk.n_tiles, blk.kt_ranges, blk.qs_min, blk.qs_max);
  if (j >= 0) mbar_wait(bars.q(), 0);
  for (; j >= 0; j = walk.next(blk.n_tiles, blk.kt_ranges, blk.qs_min, blk.qs_max), ++it) {
    const int s = it % L::kStages, k0 = j * kBN;
    const uint32_t k_s = base_u + L::k + s * L::kTile;
    const uint32_t v_s = base_u + L::v + s * L::kTile;
    const int* kseg = reinterpret_cast<const int*>(base + L::kseg + s * kBN * 4);
    mbar_wait(bars.full(s), (it / L::kStages) & 1);

    // S = Q.K^T and dP = dO.V^T: 64 q rows x 128 kv columns (zeroed first,
    // as in the kv-major block)
    float sc[kBN / 2], dp[kBN / 2];
#pragma unroll
    for (int x = 0; x < kBN / 2; ++x) sc[x] = dp[x] = 0.f;
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss_m64n128(sc, sw128_desc(q_wg + (kk / 4) * kQBox + off, 16, 1024),
                       sw128_desc(k_s + (kk / 4) * kBox + off, 16, 1024), kk);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss_m64n128(dp, sw128_desc(do_wg + (kk / 4) * kQBox + off, 16, 1024),
                       sw128_desc(v_s + (kk / 4) * kBox + off, 16, 1024), kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // dS in registers, as the bf16 A operand of dQ += dS.K
    const bool in = interior(j);
    uint32_t df[kBN / 16][4];
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e < 2;
        const float pv = exp2_approx(fmaf(sc[4 * n + e], sl, -(lo ? lse_lo : lse_hi)));
        ds[e] = pv * (dp[4 * n + e] - (lo ? del_lo : del_hi)) * scale;
        if (!in) {
          const int col = k0 + n * 8 + 2 * i4 + (e & 1);
          bool ok = col <= (lo ? cmax_lo : cmax_hi);
          if (kSeg) ok = ok && kseg[col - k0] == (lo ? qs_lo : qs_hi);
          if (!ok) ds[e] = 0.f;
        }
      }
      df[n / 2][(n & 1) * 2 + 0] = pack_f32(ds[0], ds[1]);
      df[n / 2][(n & 1) * 2 + 1] = pack_f32(ds[2], ds[3]);
    }

    // dQ += dS.K (the contraction over the tile's kv rows; K MN-major)
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint64_t bk = sw128_desc(k_s + kk * 16 * 128, kBox, 1024);
      if constexpr (D == 128) wgmma_rs_m64n128(dq, df[kk], bk);
      else wgmma_rs_m64n64(dq, df[kk], bk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    if (t == 0) mbar_arrive(bars.empty(s));
  }

  const long long rs = (long long)p.hq * D;
  __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(p.dq) + (long long)blk.b * p.sq * rs +
                       (long long)blk.h * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * i4;
    if (qi_lo < p.sq)
      *reinterpret_cast<uint32_t*>(dqg + qi_lo * rs + c) = pack_f32(dq[4 * n], dq[4 * n + 1]);
    if (qi_hi < p.sq)
      *reinterpret_cast<uint32_t*>(dqg + qi_hi * rs + c) = pack_f32(dq[4 * n + 2], dq[4 * n + 3]);
  }
}

template <int D, bool kCausal, bool kSeg>
__global__ void __launch_bounds__(kThreads, 1) dq_kernel(const __grid_constant__ Params p) {
  using L = QSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_u = smem_u32(smem_raw);
  const uint32_t base_u = (raw_u + 1023u) & ~1023u;
  unsigned char* base = smem_raw + (base_u - raw_u);
  const QBars bars{base_u + L::bar, L::kStages};

  QBlock blk;
  if (kCausal) {  // grid (Hq, B, q blocks), the last (heaviest) q block first
    blk.h = blockIdx.x;
    blk.b = blockIdx.y;
    blk.q0 = (p.n_qb - 1 - (int)blockIdx.z) * kBQdq;
  } else {  // grid (q blocks, Hq, B)
    blk.q0 = blockIdx.x * kBQdq;
    blk.h = blockIdx.y;
    blk.b = blockIdx.z;
  }
  blk.hk = blk.h / (p.hq / p.hkv);
  blk.q_off = p.meta[0];
  blk.k_off = p.meta[1];
  blk.kv_len = min(max(p.meta[2], 0), p.skv);
  blk.n_tiles = (blk.kv_len + kBN - 1) / kBN;
  if (kCausal) {  // the last kv index the block's last real row may see
    const long long diag = blk.q_off + min(blk.q0 + kBQdq, p.sq) - 1 - blk.k_off;
    blk.n_tiles = diag < 0 ? 0 : (int)min((long long)blk.n_tiles, diag / kBN + 1);
  }
  blk.qs_min = blk.qs_max = 0;
  blk.kt_ranges = nullptr;
  if (kSeg) {
    const int* ranges = p.seg_ranges + (long long)blk.b * 2 * (p.n_qt + p.n_qb + p.n_kt);
    const int qb = blk.q0 / kBQdq;
    blk.qs_min = ranges[2 * (p.n_qt + qb)];
    blk.qs_max = ranges[2 * (p.n_qt + qb) + 1];
    blk.kt_ranges = reinterpret_cast<const int2*>(ranges + 2 * (p.n_qt + p.n_qb));
  }
  blk.n_wg = min(kConsumers, (p.sq - blk.q0 + kBQ - 1) / kBQ);

  if (threadIdx.x == 0) {
    mbar_init(bars.q(), 1);
    mbar_init(bars.aux(), 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(bars.full(s), 1);
      mbar_init(bars.empty(s), blk.n_wg);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    if ((threadIdx.x >> 5) == 4 * kConsumers && blk.n_tiles > 0)  // one warp loads
      produce_q<D, kSeg>(p, blk, base, base_u, bars);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    if (wg < blk.n_wg) consume_q<D, kCausal, kSeg>(p, blk, base, base_u, bars, wg);
  }
}

// ---- host side ---------------------------------------------------------------

// Fill the tensor maps and scalars for the bf16 backward; false if a map is
// refused. kseg (null without segments) has row stride kseg_sb, a multiple
// of 4 ids; dq_f32: dq is K4's contiguous f32 buffer of sums (its map is
// built), else the dq pass's bf16 output.
inline bool make_params(Params* p, const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, void* dk, void* dv,
                        const void* qseg, const void* kseg, const void* seg_ranges,
                        const void* tile_order, const void* meta, long long q_sb,
                        long long q_ss, long long k_sb, long long k_ss, long long v_sb,
                        long long v_ss, long long do_sb, long long do_ss, long long qseg_sb,
                        long long kseg_sb, int batch, int sq, int skv, int hq, int hkv, int d,
                        float scale, bool dq_f32) {
  if (!bshd_map(&p->tq, q, batch, sq, hq, d, q_sb, q_ss, kBQ)) return false;
  if (!bshd_map(&p->tdo, dout, batch, sq, hq, d, do_sb, do_ss, kBQ)) return false;
  if (!bshd_map(&p->tk, k, batch, skv, hkv, d, k_sb, k_ss, kBN)) return false;
  if (!bshd_map(&p->tv, v, batch, skv, hkv, d, v_sb, v_ss, kBN)) return false;
  if (kseg != nullptr && !seg_map(&p->tkseg, kseg, batch, skv, kseg_sb, kBN)) return false;
  if (dq_f32 && !f32_bshd_map(&p->tdq, dq, batch, sq, hq, d, kBQ)) return false;
  p->lse = static_cast<const float*>(lse);
  p->delta = static_cast<const float*>(delta);
  p->dq = dq;
  p->dk = static_cast<__nv_bfloat16*>(dk);
  p->dv = static_cast<__nv_bfloat16*>(dv);
  p->qseg = static_cast<const int*>(qseg);
  p->kseg = static_cast<const int*>(kseg);
  p->seg_ranges = static_cast<const int*>(seg_ranges);
  p->tile_order = static_cast<const int*>(tile_order);
  p->meta = static_cast<const int*>(meta);
  p->qseg_sb = qseg_sb;
  p->kseg_sb = kseg_sb;
  p->sq = sq;
  p->skv = skv;
  p->hq = hq;
  p->hkv = hkv;
  p->n_qt = (sq + kBQ - 1) / kBQ;
  p->n_qb = (sq + kBQdq - 1) / kBQdq;
  p->n_kt = (skv + kBN - 1) / kBN;
  p->scale = scale;
  p->scale_log2 = scale * kLog2e;
  return true;
}

template <int D, bool kCausal, bool kSeg, bool kFused>
cudaError_t launch_dkv(const Params& p, int batch, cudaStream_t stream) {
  constexpr int smem = KvSmem<D, kFused>::alloc;
  auto* kernel = dkv_kernel<D, kCausal, kSeg, kFused>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = kCausal ? dim3(p.hkv, batch, p.n_kt) : dim3(p.n_kt, p.hkv, batch);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, bool kCausal, bool kSeg>
cudaError_t launch_dq(const Params& p, int batch, cudaStream_t stream) {
  constexpr int smem = QSmem<D>::alloc;
  auto* kernel = dq_kernel<D, kCausal, kSeg>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = kCausal ? dim3(p.hq, batch, p.n_qb) : dim3(p.n_qb, p.hq, batch);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// the kv-major kernel for a head dim, mask and segment flag
template <bool kFused>
cudaError_t launch_dkv_any(const Params& p, int batch, int d, bool causal, bool seg,
                           cudaStream_t stream) {
  if (d == 128) {
    if (causal) return seg ? launch_dkv<128, true, true, kFused>(p, batch, stream)
                           : launch_dkv<128, true, false, kFused>(p, batch, stream);
    return seg ? launch_dkv<128, false, true, kFused>(p, batch, stream)
               : launch_dkv<128, false, false, kFused>(p, batch, stream);
  }
  if (causal) return seg ? launch_dkv<64, true, true, kFused>(p, batch, stream)
                         : launch_dkv<64, true, false, kFused>(p, batch, stream);
  return seg ? launch_dkv<64, false, true, kFused>(p, batch, stream)
             : launch_dkv<64, false, false, kFused>(p, batch, stream);
}

inline cudaError_t launch_dq_any(const Params& p, int batch, int d, bool causal, bool seg,
                                 cudaStream_t stream) {
  if (d == 128) {
    if (causal) return seg ? launch_dq<128, true, true>(p, batch, stream)
                           : launch_dq<128, true, false>(p, batch, stream);
    return seg ? launch_dq<128, false, true>(p, batch, stream)
               : launch_dq<128, false, false>(p, batch, stream);
  }
  if (causal) return seg ? launch_dq<64, true, true>(p, batch, stream)
                         : launch_dq<64, true, false>(p, batch, stream);
  return seg ? launch_dq<64, false, true>(p, batch, stream)
             : launch_dq<64, false, false>(p, batch, stream);
}

}  // namespace bwd90
}  // namespace lvt
