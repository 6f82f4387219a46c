// Causal flash attention forward against an int8 KV cache, for Hopper
// (sm_90a), bound to Python through a plain C entry point
// (lvt_flash_fwd_quant) and ctypes.
//
// Replaces: the Pallas TPU kernel `_fwd_quant_kernel`
// (long_vita_tpu/ops/flash_attention.py:261, launched by
// `flash_attention_quant` :1360, pallas_call :1468). Same contract: K and V
// are int8 codes with one f32 scale per (token, kv head); the dequantisation
// folds into the surrounding math instead of scaling K/V elementwise:
//   s = ((q . k_codes) * sm_scale) * k_scale[j]      (f32, after the dot)
//   online max m and sum l over p = exp(s - m)        (f32; l sums p)
//   acc += bf16(p * v_scale[j]) . v_codes            (v scale before the dot)
//   o = acc / l, lse = m + log(l)
// with the causal mask kv_off + j <= q_off + i, the kv_valid_len tail
// j < kv_len, finite NEG_INF = -2^30, and a row with l == 0 giving o = 0 and
// lse = -2^30. GQA: q head h reads kv head h / (Hq / Hkv). D is 128 or 64;
// q_offset, kv_offset and kv_valid_len are read on the device; the cache is
// read through the caller's strides, never copied.
//
// What bounds it on the H100: a serving prefill chunk (2048 query rows, 40 q
// heads, D = 128) against 16K written slots does ~4*Sq*Skv*Hq*D operations
// on a cache that L2 serves to the 80 blocks of each kv head: tensor-core
// bound, like K1. The int8 cache halves the bytes a tile, which matters for
// the cache's size on the card (about 1.9x the tokens of a bf16 cache) more
// than for this kernel's time; widening the codes to bf16 for wgmma is the
// work K1 does not have.
//
// The design is the int8 instance (kQuant) of K1's Hopper forward,
// flash_fwd_sm90.cuh: the same grid (heaviest q tile first), consumer
// warpgroups, pipelined S / P.V wgmma loop, peeled first tile, narrow last
// tile, interior-tile mask skip and walk to min(causal diagonal, kv_len).
// What differs:
//   - the whole producer warpgroup widens: thread 0 keeps TMA loads of raw
//     int8 K and V tiles (128 rows, no swizzle) in flight through a ring of
//     three slots; all 128 threads widen each tile, 16 codes at a time, into
//     the 128-byte-swizzled bf16 stage that wgmma reads (a byte permute into
//     the f32 2^23 + c + 128 and one FADD a code, no I2F), fence the async
//     proxy and arrive on the stage's full barrier. The codes come by TMA and
//     not by the widening threads' own loads so that none of the producer's
//     56 registers (setmaxnreg) holds a load in flight;
//   - the scales come in by plain loads (a head's scales are Hkv floats
//     apart, under TMA's 16-byte box minimum): each producer thread loads
//     one row's k and v scale and stores it beside the stage; rows past
//     kv_len get 0, so p = 0 never meets a non-finite scale (codes are
//     finite and TMA zero-fills rows past Skv, so no row is zeroed);
//   - shared memory: three bf16 stages (64 KB each at D = 128) and Q leave
//     no room for the scales (K1 takes 232,024 of the 232,448 bytes), so
//     the ring has two bf16 stages, whose K and V halves are freed apart
//     (K when S has landed, V when P.V has), plus the three raw slots:
//     Q 32,768 + 2 x 65,536 + 3 x 16,384 + scales 2 x 1,024 + 104 of
//     barriers = 215,144 bytes, 216,168 with the alignment slack (D = 64:
//     three stages, four slots, 151,696);
//   - each logit takes its column's k scale (one FMUL before the row max),
//     and each p its column's v scale before the bf16 pack that feeds the
//     register-A wgmma of P.V; the consumers wait for V's half of the stage
//     before packing, since its scales arrive with it;
//   - two consumer warpgroups of 64 query rows at both D (224 registers).

#include "flash_fwd_sm90.cuh"

namespace {

using namespace lvt;

bool make_params_quant(fwd90::Params* p, const void* q, const void* k, const void* v,
                       const void* ks, const void* vs, void* o, void* lse, const void* meta,
                       long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                       long long v_sb, long long v_ss, long long o_sb, long long o_ss,
                       long long ks_sb, long long ks_ss, long long ks_sh, long long vs_sb,
                       long long vs_ss, long long vs_sh, int batch, int sq, int skv, int hq,
                       int hkv, int d, float scale) {
  const int bq = fwd90::block_q(d, true);
  if (!bshd_map(&p->tq, q, batch, sq, hq, d, q_sb, q_ss, bq)) return false;
  if (!i8_bshd_map(&p->tk, k, batch, skv, hkv, d, k_sb, k_ss, fwd90::kBN)) return false;
  if (!i8_bshd_map(&p->tv, v, batch, skv, hkv, d, v_sb, v_ss, fwd90::kBN)) return false;
  p->o = static_cast<__nv_bfloat16*>(o);
  p->lse = static_cast<float*>(lse);
  p->qseg = nullptr;
  p->seg_ranges = nullptr;
  p->meta = static_cast<const int*>(meta);
  p->o_sb = o_sb;
  p->o_ss = o_ss;
  p->qseg_sb = 0;
  p->ks = static_cast<const float*>(ks);
  p->vs = static_cast<const float*>(vs);
  p->ks_sb = ks_sb;
  p->ks_ss = ks_ss;
  p->ks_sh = ks_sh;
  p->vs_sb = vs_sb;
  p->vs_ss = vs_ss;
  p->vs_sh = vs_sh;
  p->sq = sq;
  p->skv = skv;
  p->hq = hq;
  p->hkv = hkv;
  p->n_qt = (sq + bq - 1) / bq;
  p->n_kt = (skv + fwd90::kBN - 1) / fwd90::kBN;
  p->scale_log2 = scale * 1.4426950408889634f;
  return true;
}

}  // namespace

// q, o bf16; k, v int8; k_scale, v_scale f32. Returns a cudaError_t (0 on
// success).
extern "C" int lvt_flash_fwd_quant(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, void* o, void* lse, const void* meta,
    long long q_sb, long long q_ss, long long k_sb, long long k_ss,
    long long v_sb, long long v_ss, long long o_sb, long long o_ss,
    long long ks_sb, long long ks_ss, long long ks_sh,
    long long vs_sb, long long vs_ss, long long vs_sh,
    int batch, int sq, int skv, int hq, int hkv, int d, float scale,
    void* stream) {
  if (sq <= 0 || batch <= 0) return (int)cudaSuccess;
  if (d != 64 && d != 128) return (int)cudaErrorInvalidValue;
  fwd90::Params p;
  if (!make_params_quant(&p, q, k, v, k_scale, v_scale, o, lse, meta, q_sb, q_ss, k_sb, k_ss,
                         v_sb, v_ss, o_sb, o_ss, ks_sb, ks_ss, ks_sh, vs_sb, vs_ss, vs_sh, batch,
                         sq, skv, hq, hkv, d, scale))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(d == 128 ? fwd90::launch<128, true, false, true>(p, batch, st)
                        : fwd90::launch<64, true, false, true>(p, batch, st));
}

// Dynamic shared memory a block takes at head dim d (for the build report);
// 0 for another d.
extern "C" int lvt_flash_fwd_quant_smem_bytes(int d) {
  return d == 128 ? fwd90::SmemQ<128>::alloc : d == 64 ? fwd90::SmemQ<64>::alloc : 0;
}
