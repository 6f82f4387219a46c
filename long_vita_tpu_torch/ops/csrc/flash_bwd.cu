// Flash-attention backward in one pass (K4) for Hopper (sm_90a), bound to
// Python through a plain C entry point (lvt_flash_bwd) and ctypes.
//
// Replaces: the Pallas TPU kernel `_bwd_fused_kernel`
// (long_vita_tpu/ops/flash_attention.py:588, launched by `_bwd_fused_impl`
// :696, pallas_call :815), the backward the JAX package takes while the
// dq partials fit FUSED_BWD_DQ_BYTES_CAP. What it computes is in
// flash_bwd_common.cuh: s, p, dP and dS are formed ONCE per (q tile, kv
// tile) pair and feed dV, dK and dQ.
//
// dQ: the Pallas kernel writes one bf16 dq partial per kv-major block (4096
// keys) and sums them outside the kernel, because a TPU grid cannot carry a
// sum across a non-innermost axis. Here every (q tile, kv tile) pair adds its
// [64 x D] dQ contribution by TMA reduce-adds into one f32 buffer [B, Sq,
// Hq, D] that the caller zeroes and casts to the input dtype afterwards:
// one buffer of 4 bytes an element whatever Skv is (the partials grow with
// Skv / 4096), and a single f32 rounding per addition instead of a bf16
// rounding per partial. The cost is summation in an order that changes from
// run to run (dQ is not bit-reproducible; dK and dV are) and L2 reduction
// traffic: 64 x D f32 adds per pair, against 10 x 64 x 128 x D tensor-core
// operations.
//
// bf16 inputs take the kv-major block of the Hopper backward
// (flash_bwd_sm90.cuh, kFused: wgmma products, TMA rings, the segment-range
// tile skip), where the design and what bounds it are set out; float32
// inputs take a plain CUDA-core kernel (flash_bwd_common.cuh), for
// completeness: training runs bf16.

#include "flash_bwd_common.cuh"
#include "flash_bwd_sm90.cuh"

// dtype: 0 = bfloat16, 1 = float32. dq: an f32 buffer [B, Sq, Hq, D] holding
// zeros. With segments, seg_ranges holds the (min, max) ids of the backward's
// tiles and tile_order (causal; else null) the kv tiles heaviest first
// (bwd90::Params; the f32 kernel reads neither), and kseg has a row stride
// kseg_sb that is a multiple of 4. Returns a cudaError_t (0 on
// success).
extern "C" int lvt_flash_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv,
    const void* qseg, const void* kseg, const void* seg_ranges,
    const void* tile_order, const void* meta,
    long long q_sb, long long q_ss, long long k_sb, long long k_ss,
    long long v_sb, long long v_ss, long long do_sb, long long do_ss,
    long long qseg_sb, long long kseg_sb,
    int batch, int sq, int skv, int hq, int hkv, int d, int causal,
    float scale, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (skv <= 0 || batch <= 0) return (int)cudaSuccess;
  if (d != 64 && d != 128) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (sq <= 0) {  // no q row: dK = dV = 0
      const size_t bytes = (size_t)batch * skv * hkv * d * 2;
      cudaError_t err = cudaMemsetAsync(dk, 0, bytes, st);
      return (int)(err != cudaSuccess ? err : cudaMemsetAsync(dv, 0, bytes, st));
    }
    lvt::bwd90::Params p;
    if (!lvt::bwd90::make_params(&p, q, k, v, dout, lse, delta, dq, dk, dv, qseg, kseg,
                                 seg_ranges, tile_order, meta, q_sb, q_ss, k_sb, k_ss, v_sb,
                                 v_ss, do_sb, do_ss, qseg_sb, kseg_sb, batch, sq, skv, hq, hkv,
                                 d, scale, true))
      return (int)cudaErrorInvalidValue;
    return (int)lvt::bwd90::launch_dkv_any<true>(p, batch, d, causal != 0, kseg != nullptr, st);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const lvt::BwdParams p = lvt::make_bwd_params(
      q, k, v, dout, lse, delta, dq, dk, dv, qseg, kseg, meta, q_sb, q_ss,
      k_sb, k_ss, v_sb, v_ss, do_sb, do_ss, qseg_sb, kseg_sb, sq, skv, hq, hkv,
      causal, scale);
  return (int)lvt::launch_kv_row_f32<true>(p, batch, d, st);
}

// Dynamic shared memory a block of the bf16 kv-major backward takes (for the
// build report): K4's (fused) or K5's first pass; 0 for another d.
extern "C" int lvt_flash_bwd_smem_bytes(int d, int fused) {
  using namespace lvt::bwd90;
  if (d == 128) return fused ? KvSmem<128, true>::alloc : KvSmem<128, false>::alloc;
  if (d == 64) return fused ? KvSmem<64, true>::alloc : KvSmem<64, false>::alloc;
  return 0;
}
