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
// [32 x D] dQ contribution with f32 atomics into one f32 buffer [B, Sq, Hq,
// D] that the caller zeroes and casts to the input dtype afterwards: one
// buffer of 4 bytes an element whatever Skv is (the partials grow with
// Skv / 4096), and a single f32 rounding per addition instead of a bf16
// rounding per partial. The cost is summation in an order that changes from
// run to run (dQ is not bit-reproducible) and L2 atomic traffic: 32 x D adds
// per pair, against 10 x 32 x 64 x D tensor-core FLOPs.
//
// What bounds it on the H100: at the training shapes (16K tokens, 40/8
// heads, D 128, causal; the ViT's 1025 tokens, 16 heads, D 64) the pair work
// is five m16n8k16 products per 32 x 64 pair on operands already in shared
// memory, so it is bound by tensor-core and instruction throughput; the
// design (in the shared header) keeps dK and dV for a warp's 16 kv rows in
// registers across the whole q sweep, reads the transposed B operands with ldmatrix .trans, and
// skips the masks on interior pairs. cp.async double-buffering of the Q/dO
// tiles, wgmma and TMA are left for later.

#include "flash_bwd_common.cuh"

// dtype: 0 = bfloat16, 1 = float32. dq: an f32 buffer [B, Sq, Hq, D] holding
// zeros. Returns a cudaError_t (0 on success).
extern "C" int lvt_flash_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv,
    const void* qseg, const void* kseg, const void* meta,
    long long q_sb, long long q_ss, long long k_sb, long long k_ss,
    long long v_sb, long long v_ss, long long do_sb, long long do_ss,
    long long qseg_sb, long long kseg_sb,
    int batch, int sq, int skv, int hq, int hkv, int d, int causal,
    float scale, int dtype, void* stream) {
  const lvt::BwdParams p = lvt::make_bwd_params(
      q, k, v, dout, lse, delta, dq, dk, dv, qseg, kseg, meta, q_sb, q_ss,
      k_sb, k_ss, v_sb, v_ss, do_sb, do_ss, qseg_sb, kseg_sb, sq, skv, hq, hkv,
      causal, scale);
  return (int)lvt::launch_kv_tile_any<true>(
      p, batch, d, dtype, static_cast<cudaStream_t>(stream));
}
