// The forward-kernel lab (K7) for Hopper (sm_90a), bound to Python through
// a plain C entry point (lvt_fwd_lab) and ctypes.
//
// Replaces: the Pallas TPU kernel `_variant_kernel` (benchmarks/
// fwd_kernel_lab.py:44, launched by `variant_flash` :131, pallas_call :155),
// the lab's scratch variants of K1's causal forward. Same contract: causal
// attention from position 0 with no segments and no offsets; head-major q
// [B, Hq, S, D], k and v [B, Hkv, S, D] in bf16, kv head h / (Hq / Hkv); s =
// q.k^T / sqrt(D) in f32, an online max and sum in f32, p rounded to bf16
// before P.V with f32 accumulation; o [B, Hq, S, D] = acc / l and lse [B, Hq,
// S] f32 (the Pallas kernel's [B, Hq, n_q, block_q, 1], the same memory);
// a row with l = 0 gets o = 0.
//
// The Pallas kernel masks with the f32 minimum and gives an empty row lse =
// the f32 minimum; this kernel is the Hopper forward of flash_fwd_sm90.cuh
// and masks with its finite -2^30. Causal attention from position 0 leaves
// no row empty (every row sees its own key), so the two give the same
// outputs.
//
// What it is for: the lab times the Hopper counterparts of the TPU lab's
// switches one at a time against K1 (production) and a library call. Each is
// a compile-time policy of the Hopper forward (LabPolicy below); the default
// policy is K1's, so K1, K2 and K3 are the same instantiations as before:
//   - fastpath: on, a tile fully inside kv_len and below a warpgroup's
//     diagonal skips the mask (K1); off, every computed tile is masked;
//   - cheap_mask: on, each row's position is kept in registers and compared
//     with the column (K1); off, both positions are computed again for every
//     element from the wgmma fragment layout (the TPU's 2-D iotas);
//   - wide_ml: on, each tile's row sum is reduced across the quad of threads
//     that share a row and kept replicated (the TPU's 128-lane m and l); off,
//     each thread keeps a partial sum, reduced once at the end (K1). The row
//     max is reduced across the quad every tile either way;
//   - block_kv: kv tiles of 128 rows (K1) or 64, with a ring of 3 or 6 stages
//     at D = 128 (4 or 8 at D = 64), the same bytes in flight.
// The query tile keeps K1's height: 128 rows at D = 128 (two consumer
// warpgroups), 192 at D = 64. A block of one consumer warpgroup (256
// threads) could start with up to 255 registers a thread, and setmaxnreg
// may not then raise its consumers to 232; a third one at D = 128 would need
// 160 accumulator registers in 168. Neither is built.
//
// What bounds it: as K1 at the lab's shape ([1, 16384, 40/8, 128], ~2.75
// TFLOP causal), the tensor cores (989 TFLOP/s bf16 dense: ~2.78 ms).
//
// Only bf16 at D = 128 and 64 is built; D = 64 takes 128-row kv tiles only.

#include "flash_fwd_sm90.cuh"

namespace {

using namespace lvt;

template <int BN, bool Fast, bool Cheap, bool Wide>
struct LabPolicy {
  static constexpr int kBN = BN;
  static constexpr bool kFastpath = Fast;
  static constexpr bool kCheapMask = Cheap;
  static constexpr bool kWideMl = Wide;
  static constexpr bool kHeadMajor = true;
  static constexpr int stages(int d) { return (d == 128 ? 3 : 4) * (128 / BN); }
};

// bf16 head-major [B, H, S, D], contiguous, as the 4-d map (D, S, H, B) that
// the Hopper forward reads under LabPolicy (kHeadMajor: coordinates column,
// row, head, batch): boxes of 64 columns x `rows` rows of one head, the
// 128-byte swizzle, zeros past S
bool bhsd_map(CUtensorMap* map, const void* ptr, int b, int h, int s, int d, int rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const long long sh = (long long)s * d, sb = (long long)h * sh;
  cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)h, (cuuint64_t)b};
  cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int BN, bool Fast, bool Cheap, bool Wide>
cudaError_t launch_lab(const fwd90::Params& p, int batch, cudaStream_t st) {
  return fwd90::launch<D, true, false, false, LabPolicy<BN, Fast, Cheap, Wide>>(p, batch, st);
}

template <int D, int BN>
cudaError_t by_switches(const fwd90::Params& p, int batch, int fast, int cheap, int wide,
                        cudaStream_t st) {
  const int key = (fast ? 4 : 0) | (cheap ? 2 : 0) | (wide ? 1 : 0);
  switch (key) {
    case 0: return launch_lab<D, BN, false, false, false>(p, batch, st);
    case 1: return launch_lab<D, BN, false, false, true>(p, batch, st);
    case 2: return launch_lab<D, BN, false, true, false>(p, batch, st);
    case 3: return launch_lab<D, BN, false, true, true>(p, batch, st);
    case 4: return launch_lab<D, BN, true, false, false>(p, batch, st);
    case 5: return launch_lab<D, BN, true, false, true>(p, batch, st);
    case 6: return launch_lab<D, BN, true, true, false>(p, batch, st);
    default: return launch_lab<D, BN, true, true, true>(p, batch, st);
  }
}

}  // namespace

// q [B, Hq, S, D], k and v [B, Hkv, S, D] bf16, contiguous; o like q; lse
// [B, Hq, S] f32. block_kv 128 or 64 (64 at D = 128 only); fastpath,
// cheap_mask and wide_ml 0 or 1. Returns a cudaError_t (0 on success).
extern "C" int lvt_fwd_lab(const void* q, const void* k, const void* v, void* o, void* lse,
                           int batch, int hq, int hkv, int s, int d, int block_kv, int fastpath,
                           int cheap_mask, int wide_ml, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s <= 0 || batch <= 0) return (int)cudaSuccess;
  if ((d != 128 && d != 64) || (block_kv != 128 && block_kv != 64) ||
      (d == 64 && block_kv != 128) || hkv <= 0 || hq % hkv)
    return (int)cudaErrorInvalidValue;
  fwd90::Params p = {};
  const int bq = fwd90::block_q(d);
  if (!bhsd_map(&p.tq, q, batch, hq, s, d, bq)) return (int)cudaErrorInvalidValue;
  if (!bhsd_map(&p.tk, k, batch, hkv, s, d, block_kv)) return (int)cudaErrorInvalidValue;
  if (!bhsd_map(&p.tv, v, batch, hkv, s, d, block_kv)) return (int)cudaErrorInvalidValue;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.qseg = nullptr;
  p.seg_ranges = nullptr;
  p.meta = nullptr;  // offsets 0, kv_valid_len = S
  p.o_ss = d;
  p.o_sh = (long long)s * d;
  p.o_sb = (long long)hq * s * d;
  p.sq = s;
  p.skv = s;
  p.hq = hq;
  p.hkv = hkv;
  p.n_qt = (s + bq - 1) / bq;
  p.n_kt = (s + block_kv - 1) / block_kv;
  p.scale_log2 = scale * 1.4426950408889634f;
  if (d == 64) return (int)by_switches<64, 128>(p, batch, fastpath, cheap_mask, wide_ml, st);
  return (int)(block_kv == 128 ? by_switches<128, 128>(p, batch, fastpath, cheap_mask, wide_ml, st)
                               : by_switches<128, 64>(p, batch, fastpath, cheap_mask, wide_ml, st));
}

// Dynamic shared memory a block of the lab's forward takes (for the build
// report); 0 for a shape it does not build.
extern "C" int lvt_fwd_lab_smem_bytes(int d, int block_kv) {
  if (d == 128 && block_kv == 128)
    return fwd90::Smem<128, LabPolicy<128, true, true, false>>::alloc;
  if (d == 128 && block_kv == 64) return fwd90::Smem<128, LabPolicy<64, true, true, false>>::alloc;
  if (d == 64 && block_kv == 128) return fwd90::Smem<64, LabPolicy<128, true, true, false>>::alloc;
  return 0;
}
