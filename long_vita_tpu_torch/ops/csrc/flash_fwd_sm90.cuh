// The bf16 attention forward for Hopper (sm_90a): one template behind K1's
// bf16 body (flash_fwd.cu, entry lvt_flash_fwd) and K3 (short_attn.cu,
// entry lvt_short_attn).
//
// What it computes (the contract of both entry points): s = q.k^T / sqrt(D)
// in f32; masked logits are the finite -2^30 (causal: kv_off + j <= q_off +
// i; the kv_valid_len tail j < kv_len; optional segment ids); an online max
// and sum in f32; p rounded to bf16 before P.V with f32 accumulation; o =
// acc / l and lse = m + log(l) in natural log; a row with no unmasked key
// gives o = 0 and lse = -2^30. GQA: q head h reads kv head h / (Hq / Hkv).
//
// What bounds it: at the serving chunk (2048 rows against 6144 valid slots,
// 40 heads, D = 128) and the ViT's [64, 1025, 16, 64] the work is ~4 S^2 H D
// operations on operands each block reads once per 128-192 query rows, far
// above the H100's ~295 FLOP/byte ridge: tensor-core bound, and at D = 64
// as much bound by the one exp2 a logit (16 a clock per SM, against 4096
// FLOP a clock of the tensor cores: 256 FLOP a logit at D = 64). The design:
//   - one block per (q tile, q head, batch row): two consumer warpgroups of
//     64 query rows at D = 128, three at D = 64 (Cfg), and a producer
//     warpgroup; setmaxnreg hands the producer's registers to the
//     consumers. Under a causal mask the grid is (Hq, B, q tiles) with the
//     last q tile first, so from position 0 the heaviest blocks start in
//     the first wave; without one it is (q tiles, Hq, B), so the q tiles of
//     one head run side by side and share its K/V in L2;
//   - one producer thread loads Q once and then K and V tiles of 128 kv rows
//     with TMA into a ring of shared-memory stages (3 at D = 128, 4 at D =
//     64), each handed over by full and empty mbarriers (K and V on separate
//     full barriers). The ring stops at min(causal diagonal, kv_len), so a
//     chunk never walks the unwritten tail of a preallocated cache; with
//     segment ids it skips every tile whose id range misses the q block's
//     (packed training rows: most of the causal triangle);
//   - TMA reads [B, S, H, D] through the caller's strides (a cache slice or
//     the ViT's qkv views are never copied), in boxes of 64 columns with the
//     128-byte swizzle that wgmma reads; rows past S come in as zeros;
//   - S = Q.K^T is wgmma m64n128k16 with both operands in shared memory; P
//     stays in registers as the A operand of O += P.V (wgmma m64nDk16, V
//     MN-major through the transpose bit); f32 accumulators in registers.
//     Each warpgroup issues S of tile j before P.V of tile j - 1, so its
//     softmax of tile j runs while the tensor cores do that product;
//   - the softmax keeps the max of the unscaled logits and takes each p as
//     exp2 of one FFMA; tiles fully inside kv_len, below the warpgroup's
//     diagonal and inside one segment skip the mask; a tile of which at
//     most 16 columns can be seen by the warpgroup (the ViT's 1025th key, a
//     ragged kv_len, the edge of the diagonal) runs a 16-column product;
//   - a block's warpgroups whose rows lie past Sq exit at once: the ViT's
//     1025 = 5 x 192 + 65 rows end in a block of two warpgroups, one of
//     them for a single row.
// Rows between kv_len and Skv are inside the tensor, so TMA loads them as
// they are; the producer zeroes those rows of V in the last partial tile
// before the consumers may read it, so p = 0 never meets a non-finite
// value. Their logits are masked, so K's rows need no such care.
#pragma once

#include "mma_util.cuh"
#include "sm90_util.cuh"

namespace lvt {
namespace fwd90 {

constexpr int kBN = 128;              // kv rows a tile
constexpr int kNarrow = 16;           // the width of a narrow tile's product
constexpr int kBox = 128 * 128;       // bytes of one 128-row x 64-column bf16 K or V box

// Consumer warpgroups of 64 query rows a block, and the registers
// setmaxnreg gives each thread: at D = 128 two (S 64 + O 64 + P 32
// registers a thread), at D = 64 three (S 64 + O 32 + P 32), which raises
// the rows that share each K/V tile and the warps that hide latency; the
// producer warpgroup comes after them. 65,536 registers either way.
template <int D>
struct Cfg {
  static constexpr int kConsumers = D == 64 ? 3 : 2;
  static constexpr int kBM = 64 * kConsumers;          // query rows a block
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kConsumerRegs = D == 64 ? 160 : 232;
  static constexpr int kProducerRegs = D == 64 ? 24 : 40;
  static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <= 65536, "registers");
};

// query rows a block of the head dim d (host side)
inline int block_q(int d) { return d == 64 ? Cfg<64>::kBM : Cfg<128>::kBM; }
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  CUtensorMap tq, tk, tv, tkseg;  // tkseg: [B, Skv] int32, with segments only
  __nv_bfloat16* o;
  float* lse;           // [B, Hq, Sq]
  const int* qseg;      // [B, Sq] or null
  // with segments: per batch row, the (min, max) segment id of each q block
  // of Cfg<D>::kBM rows, then of each kv tile of kBN rows: [B, n_qt + n_kt, 2]
  const int* seg_ranges;
  const int* meta;      // device int32 [q_offset, kv_offset, kv_valid_len]; null: 0, 0, Skv
  long long o_sb, o_ss, qseg_sb;  // element strides
  int sq, skv, hq, hkv, n_qt, n_kt;
  float scale_log2;     // 1/sqrt(D) * log2(e)
};

// shared memory, in bytes from a 1024-aligned base
template <int D>
struct Smem {
  static constexpr int kStages = D == 128 ? 3 : 4;  // 231,000 and 157,808 bytes with Q
  static constexpr int kTile = (D / 64) * kBox;  // a K or V tile
  static constexpr int kQBox = Cfg<D>::kBM * 128;  // bytes of a 64-column box of Q
  static constexpr int kQTile = (D / 64) * kQBox;
  static constexpr int q = 0;
  static constexpr int k = q + kQTile;                // + stage * kTile
  static constexpr int v = k + kStages * kTile;       // + stage * kTile
  static constexpr int kseg = v + kStages * kTile;    // + stage * kBN * 4
  static constexpr int bar = kseg + kStages * kBN * 4;
  // barriers: q, aux, full_k[stages], full_v[stages], empty[stages]
  static constexpr int bytes = bar + (2 + 3 * kStages) * 8;
  static constexpr int alloc = bytes + 1024;  // room to align the base
};

struct Bars {
  uint32_t base;
  int stages;
  __device__ uint32_t q() const { return base; }
  __device__ uint32_t aux() const { return base + 8; }
  __device__ uint32_t full_k(int s) const { return base + 16 + 8 * s; }
  __device__ uint32_t full_v(int s) const { return base + 16 + 8 * (stages + s); }
  __device__ uint32_t empty(int s) const { return base + 16 + 8 * (2 * stages + s); }
};

// what producer and consumers agree on for one block
struct Block {
  int h, b, hk, q0, kv_len, n_tiles;
  long long q_off, k_off;
  int qs_min, qs_max;        // the block's segment ids (with segments)
  const int2* kt_ranges;     // each kv tile's (min, max) id (with segments)
};

template <int D, bool kSeg>
__device__ __forceinline__ void produce(const Params& p, const Block& blk, unsigned char* base,
                                        uint32_t base_u, const Bars& bars) {
  using L = Smem<D>;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    mbar_arrive_tx(bars.q(), L::kQTile);
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
      tma_load_4d(base_u + L::q + c * L::kQBox, &p.tq, bars.q(), c * 64, blk.h, blk.q0, blk.b);
  }
  TileWalk<kSeg> walk;
  auto next = [&] { return walk.next(blk.n_tiles, blk.kt_ranges, blk.qs_min, blk.qs_max); };
  for (int j = next(), it = 0; j >= 0; j = next(), ++it) {
    const int s = it % L::kStages, k0 = j * kBN;
    if (it >= L::kStages) mbar_wait(bars.empty(s), ((it / L::kStages) + 1) & 1);
    const uint32_t k_dst = base_u + L::k + s * L::kTile;
    const uint32_t v_dst = base_u + L::v + s * L::kTile;
    if (lane == 0) {
      mbar_arrive_tx(bars.full_k(s), L::kTile + (kSeg ? kBN * 4 : 0));
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_load_4d(k_dst + c * kBox, &p.tk, bars.full_k(s), c * 64, blk.hk, k0, blk.b);
      if (kSeg) tma_load_2d(base_u + L::kseg + s * kBN * 4, &p.tkseg, bars.full_k(s), k0, blk.b);
    }
    if (k0 + kBN <= blk.kv_len || blk.kv_len == p.skv) {
      if (lane == 0) {
        mbar_arrive_tx(bars.full_v(s), L::kTile);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(v_dst + c * kBox, &p.tv, bars.full_v(s), c * 64, blk.hk, k0, blk.b);
      }
    } else {  // the last, partial tile: V's rows from kv_len on zeroed
      if (lane == 0) {
        mbar_arrive_tx(bars.aux(), L::kTile);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(v_dst + c * kBox, &p.tv, bars.aux(), c * 64, blk.hk, k0, blk.b);
      }
      zero_then_release<D>(bars.aux(), bars.full_v(s), base + L::v + s * L::kTile, nullptr,
                           kBox, blk.kv_len - k0, kBN);
    }
  }
}

// S = Q.K^T over the N columns of a K tile (128, or 16 for a narrow tile),
// issued and committed, not waited for; the first k16 slice overwrites sc
template <int D, int N>
__device__ __forceinline__ void issue_s(float (&sc)[N / 2], uint32_t q_base, uint32_t k_base) {
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;  // the k16 slice inside a 64-column box
    const uint64_t da = sw128_desc(q_base + (kk / 4) * Smem<D>::kQBox + off, 16, 1024);
    const uint64_t db = sw128_desc(k_base + (kk / 4) * kBox + off, 16, 1024);
    if constexpr (N == kBN) wgmma_ss_m64n128(sc, da, db, kk);
    else wgmma_ss_m64n16(sc, da, db, kk);
  }
  wgmma_commit();
}

// O += P.V over the first N rows of a V tile, issued and committed
template <int D, int N>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pf)[kBN / 16][4],
                                         uint32_t v_base) {
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const uint64_t dv = sw128_desc(v_base + kk * 16 * 128, kBox, 1024);
    if constexpr (D == 128) wgmma_rs_m64n128(o, pf[kk], dv);
    else wgmma_rs_m64n64(o, pf[kk], dv);
  }
  wgmma_commit();
}

// the thread's two query rows and their running statistics
struct Rows {
  long long qpos_lo, qpos_hi;    // positions
  int qs_lo, qs_hi;              // segment ids
  float m_lo, m_hi, l_lo, l_hi;  // max of the unscaled logits, per-thread partial sums
};

// The masked online softmax of one S tile, in place: sc becomes p =
// exp2(s * scale * log2 e - m * scale * log2 e), one FFMA and one exp2 a
// logit (0 where masked, and in a row that has seen no unmasked key); m and
// l move on. -> the factors that rescale O.
template <bool kCausal, bool kSeg, int N>
__device__ __forceinline__ void softmax(const Params& p, const Block& blk, float (&sc)[N / 2],
                                        Rows& r, const int* kseg, int k0, bool interior,
                                        float& alpha_lo, float& alpha_hi) {
  const int i4 = threadIdx.x & 3;
  const float sl = p.scale_log2;
  float mx_lo = r.m_lo, mx_hi = r.m_hi;
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    if (!interior) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * i4 + (e & 1);
        bool ok = col < blk.kv_len;
        if (kCausal) ok = ok && blk.k_off + col <= (e < 2 ? r.qpos_lo : r.qpos_hi);
        if (kSeg) ok = ok && kseg[col - k0] == (e < 2 ? r.qs_lo : r.qs_hi);
        if (!ok) sc[4 * n + e] = kNegInf;
      }
    }
    mx_lo = fmaxf(mx_lo, fmaxf(sc[4 * n], sc[4 * n + 1]));
    mx_hi = fmaxf(mx_hi, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
  }
  mx_lo = quad_max(mx_lo);
  mx_hi = quad_max(mx_hi);
  // the max in log2 units; a row whose max is still -2^30 has seen no
  // unmasked key, and subtracting 0 keeps its p = exp2(-2^30 * scale) = 0
  const float ms_lo = mx_lo == kNegInf ? 0.f : mx_lo * sl;
  const float ms_hi = mx_hi == kNegInf ? 0.f : mx_hi * sl;
  alpha_lo = exp2_approx(fmaf(r.m_lo, sl, -ms_lo));
  alpha_hi = exp2_approx(fmaf(r.m_hi, sl, -ms_hi));
  r.m_lo = mx_lo;
  r.m_hi = mx_hi;
  float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    sc[4 * n] = exp2_approx(fmaf(sc[4 * n], sl, -ms_lo));
    sc[4 * n + 1] = exp2_approx(fmaf(sc[4 * n + 1], sl, -ms_lo));
    sc[4 * n + 2] = exp2_approx(fmaf(sc[4 * n + 2], sl, -ms_hi));
    sc[4 * n + 3] = exp2_approx(fmaf(sc[4 * n + 3], sl, -ms_hi));
    sum_lo += sc[4 * n] + sc[4 * n + 1];
    sum_hi += sc[4 * n + 2] + sc[4 * n + 3];
  }
  // per-thread partial sums; the quad reduction happens once at the end
  r.l_lo = r.l_lo * alpha_lo + sum_lo;
  r.l_hi = r.l_hi * alpha_hi + sum_hi;
}

// p (f32, in the S accumulator's layout) -> the bf16 A operand of P.V
template <int N>
__device__ __forceinline__ void pack_p(const float (&sc)[N / 2], uint32_t (&pf)[kBN / 16][4]) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    pf[n / 2][(n & 1) * 2 + 0] = pack_f32(sc[4 * n], sc[4 * n + 1]);
    pf[n / 2][(n & 1) * 2 + 1] = pack_f32(sc[4 * n + 2], sc[4 * n + 3]);
  }
}

template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2], float alpha_lo, float alpha_hi) {
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    o[4 * dn + 0] *= alpha_lo;
    o[4 * dn + 1] *= alpha_lo;
    o[4 * dn + 2] *= alpha_hi;
    o[4 * dn + 3] *= alpha_hi;
  }
}

// One consumer warpgroup's 64 query rows. The loop is software-pipelined
// within the warpgroup: S of tile j is issued, then P.V of tile j - 1, so
// the softmax of tile j runs while the tensor cores do that product; O is
// rescaled once it has landed. No wgmma sits under a condition that varies
// inside the loop (ptxas would serialise them all): the first tile is
// peeled, and a narrow tile (the warpgroup's columns end within 16 of its
// start) runs on its own after the loop. It is the last tile the
// warpgroup needs; a later one, which the block can hold at D = 64, lies
// wholly past the warpgroup's columns, is left to the warpgroups of later
// rows and is the block's last, so no producer waits for its release.
template <int D, bool kCausal, bool kSeg>
__device__ __forceinline__ void consume(const Params& p, const Block& blk, unsigned char* base,
                                        uint32_t base_u, const Bars& bars, int wg) {
  using L = Smem<D>;
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31, g = lane >> 2;
  const int row0 = blk.q0 + wg * 64;  // this warpgroup's first query row
  const int qi_lo = row0 + warp * 16 + g, qi_hi = qi_lo + 8;
  Rows r;
  r.qpos_lo = blk.q_off + qi_lo;
  r.qpos_hi = blk.q_off + qi_hi;
  r.qs_lo = r.qs_hi = 0;
  if (kSeg) {
    r.qs_lo = qi_lo < p.sq ? p.qseg[blk.b * p.qseg_sb + qi_lo] : -1;
    r.qs_hi = qi_hi < p.sq ? p.qseg[blk.b * p.qseg_sb + qi_hi] : -1;
  }
  r.m_lo = r.m_hi = kNegInf;
  r.l_lo = r.l_hi = 0.f;
  // the columns any row of this warpgroup may see end here
  long long end = blk.kv_len;
  if (kCausal) end = min(end, blk.q_off + min(row0 + 64, p.sq) - blk.k_off);
  const uint32_t q_base = base_u + L::q + wg * 64 * 128;

  // the ring slot of tile j at ring position it
  auto k_base = [&](int it) { return base_u + L::k + (it % L::kStages) * L::kTile; };
  auto v_base = [&](int it) { return base_u + L::v + (it % L::kStages) * L::kTile; };
  auto kseg_of = [&](int it) {
    return reinterpret_cast<const int*>(base + L::kseg + (it % L::kStages) * kBN * 4);
  };
  auto parity = [&](int it) { return (uint32_t)((it / L::kStages) & 1); };
  auto interior = [&](int j) {
    const int k0 = j * kBN;
    bool in = k0 + kBN <= blk.kv_len &&
              (!kCausal || blk.k_off + k0 + kBN - 1 <= blk.q_off + row0);
    if (kSeg) {  // one segment on both sides: the segment mask is moot
      const int2 rg = blk.kt_ranges[j];
      in = in && rg.x == rg.y && blk.qs_min == blk.qs_max && rg.x == blk.qs_min;
    }
    return in;
  };
  auto release = [&](int it) {  // this warpgroup's products are complete
    if (t == 0) mbar_arrive(bars.empty(it % L::kStages));
  };

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float sc[kBN / 2];
  uint32_t pf[kBN / 16][4];
  float alpha_lo, alpha_hi;
  TileWalk<kSeg> walk;
  auto next = [&] { return walk.next(blk.n_tiles, blk.kt_ranges, blk.qs_min, blk.qs_max); };
  int it = 0, j = next();
  if (j >= 0) mbar_wait(bars.q(), 0);
  if (j >= 0 && end - j * kBN > kNarrow) {
    // the first tile: S and its softmax; P.V waits for the next iteration
    mbar_wait(bars.full_k(0), 0);
    issue_s<D, kBN>(sc, q_base, k_base(0));
    wgmma_wait<0>();
    fence_regs(sc);
    softmax<kCausal, kSeg, kBN>(p, blk, sc, r, kseg_of(0), j * kBN, interior(j), alpha_lo,
                                alpha_hi);
    pack_p<kBN>(sc, pf);
    // the rest: S of tile it, then P.V of tile it - 1
    for (j = next(), ++it; j >= 0; j = next(), ++it) {
      if (end - j * kBN <= kNarrow) break;
      mbar_wait(bars.full_k(it % L::kStages), parity(it));
      mbar_wait(bars.full_v((it - 1) % L::kStages), parity(it - 1));
      issue_s<D, kBN>(sc, q_base, k_base(it));
      issue_pv<D, kBN>(o, pf, v_base(it - 1));
      wgmma_wait<1>();  // S has landed; P.V may still run
      fence_regs(sc);
      softmax<kCausal, kSeg, kBN>(p, blk, sc, r, kseg_of(it), j * kBN, interior(j), alpha_lo,
                                  alpha_hi);
      wgmma_wait<0>();
      fence_regs(o);
      release(it - 1);
      rescale<D>(o, alpha_lo, alpha_hi);
      pack_p<kBN>(sc, pf);
    }
    // the last full tile's P.V
    mbar_wait(bars.full_v((it - 1) % L::kStages), parity(it - 1));
    issue_pv<D, kBN>(o, pf, v_base(it - 1));
    wgmma_wait<0>();
    fence_regs(o);
    release(it - 1);
  }
  if (j >= 0) {
    // a narrow tile (the warpgroup's last): 16 columns, 16 rows of V
    float sn[kNarrow / 2];
    mbar_wait(bars.full_k(it % L::kStages), parity(it));
    issue_s<D, kNarrow>(sn, q_base, k_base(it));
    wgmma_wait<0>();
    fence_regs(sn);
    softmax<kCausal, kSeg, kNarrow>(p, blk, sn, r, kseg_of(it), j * kBN, false, alpha_lo,
                                    alpha_hi);
    rescale<D>(o, alpha_lo, alpha_hi);
    pack_p<kNarrow>(sn, pf);
    mbar_wait(bars.full_v(it % L::kStages), parity(it));
    issue_pv<D, kNarrow>(o, pf, v_base(it));
    wgmma_wait<0>();
    fence_regs(o);
    release(it);
  }

  r.l_lo = quad_sum(r.l_lo);
  r.l_hi = quad_sum(r.l_hi);
  const float div_lo = r.l_lo == 0.f ? 1.f : r.l_lo;
  const float div_hi = r.l_hi == 0.f ? 1.f : r.l_hi;
  __nv_bfloat16* og = p.o + blk.b * p.o_sb + (long long)blk.h * D;
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int c = dn * 8 + c0;
    if (qi_lo < p.sq)
      *reinterpret_cast<uint32_t*>(og + qi_lo * p.o_ss + c) =
          pack_f32(o[4 * dn] / div_lo, o[4 * dn + 1] / div_lo);
    if (qi_hi < p.sq)
      *reinterpret_cast<uint32_t*>(og + qi_hi * p.o_ss + c) =
          pack_f32(o[4 * dn + 2] / div_hi, o[4 * dn + 3] / div_hi);
  }
  if ((lane & 3) == 0) {
    float* lg = p.lse + ((long long)blk.b * p.hq + blk.h) * p.sq;
    const float scale = p.scale_log2 * kLn2;  // m is in units of the unscaled logits
    if (qi_lo < p.sq) lg[qi_lo] = r.l_lo == 0.f ? kNegInf : r.m_lo * scale + logf(r.l_lo);
    if (qi_hi < p.sq) lg[qi_hi] = r.l_hi == 0.f ? kNegInf : r.m_hi * scale + logf(r.l_hi);
  }
}

template <int D, bool kCausal, bool kSeg>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
    fwd_kernel(const __grid_constant__ Params p) {
  using L = Smem<D>;
  using C = Cfg<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_u = smem_u32(smem_raw);
  const uint32_t base_u = (raw_u + 1023u) & ~1023u;  // the 128-byte swizzle's atoms
  unsigned char* base = smem_raw + (base_u - raw_u);
  const Bars bars{base_u + L::bar, L::kStages};

  Block blk;
  if (kCausal) {  // grid (Hq, B, q tiles), the last (heaviest) q tile first
    blk.h = blockIdx.x;
    blk.b = blockIdx.y;
    blk.q0 = (p.n_qt - 1 - (int)blockIdx.z) * C::kBM;
  } else {  // grid (q tiles, Hq, B): the q tiles of one head run together
    blk.q0 = blockIdx.x * C::kBM;
    blk.h = blockIdx.y;
    blk.b = blockIdx.z;
  }
  blk.hk = blk.h / (p.hq / p.hkv);
  blk.q_off = p.meta ? p.meta[0] : 0;
  blk.k_off = p.meta ? p.meta[1] : 0;
  blk.kv_len = p.meta ? min(max(p.meta[2], 0), p.skv) : p.skv;
  blk.n_tiles = (blk.kv_len + kBN - 1) / kBN;
  if (kCausal) {
    // the last kv index the block's last real row may see
    const long long diag = blk.q_off + min(blk.q0 + C::kBM, p.sq) - 1 - blk.k_off;
    blk.n_tiles = diag < 0 ? 0 : (int)min((long long)blk.n_tiles, diag / kBN + 1);
  }
  if (kSeg) {
    const int* ranges = p.seg_ranges + (long long)blk.b * 2 * (p.n_qt + p.n_kt);
    const int qt = blk.q0 / C::kBM;
    blk.qs_min = ranges[2 * qt];
    blk.qs_max = ranges[2 * qt + 1];
    blk.kt_ranges = reinterpret_cast<const int2*>(ranges + 2 * p.n_qt);
  }
  const int n_consumers = min(C::kConsumers, (p.sq - blk.q0 + 63) / 64);

  if (threadIdx.x == 0) {
    mbar_init(bars.q(), 1);
    mbar_init(bars.aux(), 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(bars.full_k(s), 1);
      mbar_init(bars.full_v(s), 1);
      mbar_init(bars.empty(s), n_consumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == C::kConsumers) {
    setmaxnreg_dec<C::kProducerRegs>();
    if ((threadIdx.x >> 5) == 4 * C::kConsumers && blk.n_tiles > 0)  // one warp loads
      produce<D, kSeg>(p, blk, base, base_u, bars);
  } else {
    setmaxnreg_inc<C::kConsumerRegs>();
    if (wg < n_consumers) consume<D, kCausal, kSeg>(p, blk, base, base_u, bars, wg);
  }
}

// ---- host side ---------------------------------------------------------------

// Fill the tensor maps of q, k, v (and the kv segment ids when kseg is not
// null) and the scalars; false if a map is refused. With segments,
// seg_ranges holds the (min, max) ids of every block_q(d)-row q block and
// kBN-row kv tile of each batch row (Params::seg_ranges).
inline bool make_params(Params* p, const void* q, const void* k, const void* v, void* o,
                        void* lse, const void* qseg, const void* kseg,
                        const void* seg_ranges, const void* meta,
                        long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                        long long v_sb, long long v_ss, long long o_sb, long long o_ss,
                        long long qseg_sb, long long kseg_sb, int batch, int sq, int skv,
                        int hq, int hkv, int d, float scale) {
  if (!bshd_map(&p->tq, q, batch, sq, hq, d, q_sb, q_ss, block_q(d))) return false;
  if (!bshd_map(&p->tk, k, batch, skv, hkv, d, k_sb, k_ss, kBN)) return false;
  if (!bshd_map(&p->tv, v, batch, skv, hkv, d, v_sb, v_ss, kBN)) return false;
  if (kseg != nullptr && !seg_map(&p->tkseg, kseg, batch, skv, kseg_sb, kBN)) return false;
  p->o = static_cast<__nv_bfloat16*>(o);
  p->lse = static_cast<float*>(lse);
  p->qseg = static_cast<const int*>(qseg);
  p->seg_ranges = static_cast<const int*>(seg_ranges);
  p->meta = static_cast<const int*>(meta);
  p->o_sb = o_sb;
  p->o_ss = o_ss;
  p->qseg_sb = qseg_sb;
  p->sq = sq;
  p->skv = skv;
  p->hq = hq;
  p->hkv = hkv;
  p->n_qt = (sq + block_q(d) - 1) / block_q(d);
  p->n_kt = (skv + kBN - 1) / kBN;
  p->scale_log2 = scale * 1.4426950408889634f;
  return true;
}

template <int D, bool kCausal, bool kSeg>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr int smem = Smem<D>::alloc;
  cudaError_t err = cudaFuncSetAttribute(fwd_kernel<D, kCausal, kSeg>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = kCausal ? dim3(p.hq, batch, p.n_qt) : dim3(p.n_qt, p.hq, batch);
  fwd_kernel<D, kCausal, kSeg><<<grid, Cfg<D>::kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace fwd90
}  // namespace lvt
