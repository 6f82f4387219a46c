// Flash-attention backward in two passes (K5) for Hopper (sm_90a), bound to
// Python through two plain C entry points (lvt_flash_bwd_dkv, lvt_flash_bwd_dq)
// and ctypes.
//
// Replaces: the Pallas TPU kernels `_bwd_dkv_kernel`
// (long_vita_tpu/ops/flash_attention.py:454, pallas_call :1013) and
// `_bwd_dq_kernel` (:530, pallas_call :1089), launched by `_bwd_impl` :924:
// the backward the JAX package takes when the one-pass kernel's dq partials
// would pass FUSED_BWD_DQ_BYTES_CAP (2 GiB), e.g. 32K-token training on one
// device. What both passes compute is in flash_bwd_common.cuh.
//
//   - lvt_flash_bwd_dkv: dK and dV per 128-row kv tile, accumulated in
//     registers over the GQA group's q heads and every q tile that can see
//     the tile (the kv-major block of flash_bwd_sm90.cuh without its dQ);
//   - lvt_flash_bwd_dq: dQ per 128-row q block, accumulated in registers over
//     the kv tiles up to the causal diagonal and kv_valid_len that share a
//     segment with the block (the q-major block of flash_bwd_sm90.cuh); s and
//     dP are formed again, which is the price of needing no memory that grows
//     with the number of kv blocks (the one-pass K4 adds into an f32 buffer).
//
// bf16 inputs take the Hopper backward (flash_bwd_sm90.cuh: TMA rings,
// wgmma, the segment-range tile skip), where the design and what bounds it
// are set out; float32 inputs take plain CUDA-core kernels, for
// completeness: training runs bf16.

#include "flash_bwd_common.cuh"
#include "flash_bwd_sm90.cuh"

namespace {

using namespace lvt;

// float32: one warp per (q row, q head, batch row), as K1's f32 kernel.
template <int D>
__global__ void __launch_bounds__(kBwdThreads) bwd_dq_row_f32(BwdParams p) {
  constexpr int E = D / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * (kBwdThreads / 32) + warp;
  const int h = blockIdx.y, b = blockIdx.z;
  if (i >= p.sq) return;
  const int hk = h / (p.hq / p.hkv);
  const long long q_off = p.meta[0], k_off = p.meta[1];
  const int kv_len = min(max(p.meta[2], 0), p.skv);
  long long end = kv_len;
  if (p.causal) end = min(end, max(0LL, q_off + i - k_off + 1));
  const int qs = p.qseg ? p.qseg[b * p.qseg_sb + i] : 0;
  const long long stat = ((long long)b * p.hq + h) * p.sq + i;
  const float lse = p.lse[stat], delta = p.delta[stat];

  const float* qrow = static_cast<const float*>(p.q) + b * p.q_sb + i * p.q_ss + (long long)h * D;
  const float* orow = static_cast<const float*>(p.dout) + b * p.do_sb + i * p.do_ss + (long long)h * D;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + (long long)hk * D;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + (long long)hk * D;
  float qv[E], ov[E], acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    qv[e] = qrow[lane + 32 * e];
    ov[e] = orow[lane + 32 * e];
    acc[e] = 0.f;
  }
  for (long long j = 0; j < end; ++j) {
    if (p.kseg && p.kseg[b * p.kseg_sb + j] != qs) continue;
    const float* kr = kg + j * p.k_ss;
    const float* vr = vg + j * p.v_ss;
    float kv[E], s = 0.f, dp = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      kv[e] = kr[lane + 32 * e];
      s += qv[e] * kv[e];
      dp += ov[e] * vr[lane + 32 * e];
    }
    s = warp_sum(s);
    dp = warp_sum(dp);
    const float pv = expf(s * p.scale - lse);
    const float ds = pv * (dp - delta) * p.scale;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] += ds * kv[e];
  }
  float* dqrow = static_cast<float*>(p.dq) + (((long long)b * p.sq + i) * p.hq + h) * D;
#pragma unroll
  for (int e = 0; e < E; ++e) dqrow[lane + 32 * e] = acc[e];
}

}  // namespace

using namespace lvt;

// dtype: 0 = bfloat16, 1 = float32. The two entry points share one argument
// list (lvt_flash_bwd's); lvt_flash_bwd_dkv ignores dq, lvt_flash_bwd_dq
// ignores dk and dv. Returns a cudaError_t (0 on success).
extern "C" int lvt_flash_bwd_dkv(
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
    bwd90::Params p;
    if (!bwd90::make_params(&p, q, k, v, dout, lse, delta, dq, dk, dv, qseg, kseg, seg_ranges,
                            tile_order, meta, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, do_sb, do_ss,
                            qseg_sb, kseg_sb, batch, sq, skv, hq, hkv, d, scale, false))
      return (int)cudaErrorInvalidValue;
    return (int)bwd90::launch_dkv_any<false>(p, batch, d, causal != 0, kseg != nullptr, st);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const BwdParams p = make_bwd_params(
      q, k, v, dout, lse, delta, dq, dk, dv, qseg, kseg, meta, q_sb, q_ss,
      k_sb, k_ss, v_sb, v_ss, do_sb, do_ss, qseg_sb, kseg_sb, sq, skv, hq, hkv,
      causal, scale);
  return (int)launch_kv_row_f32<false>(p, batch, d, st);
}

extern "C" int lvt_flash_bwd_dq(
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
  if (sq <= 0 || batch <= 0) return (int)cudaSuccess;
  if (d != 64 && d != 128) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (skv <= 0)  // no key: dQ = 0
      return (int)cudaMemsetAsync(dq, 0, (size_t)batch * sq * hq * d * 2, st);
    bwd90::Params p;
    if (!bwd90::make_params(&p, q, k, v, dout, lse, delta, dq, dk, dv, qseg, kseg, seg_ranges,
                            tile_order, meta, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, do_sb, do_ss,
                            qseg_sb, kseg_sb, batch, sq, skv, hq, hkv, d, scale, false))
      return (int)cudaErrorInvalidValue;
    return (int)bwd90::launch_dq_any(p, batch, d, causal != 0, kseg != nullptr, st);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const BwdParams p = make_bwd_params(
      q, k, v, dout, lse, delta, dq, dk, dv, qseg, kseg, meta, q_sb, q_ss,
      k_sb, k_ss, v_sb, v_ss, do_sb, do_ss, qseg_sb, kseg_sb, sq, skv, hq, hkv,
      causal, scale);
  const int rows = kBwdThreads / 32;
  dim3 grid((sq + rows - 1) / rows, hq, batch);
  if (d == 128) bwd_dq_row_f32<128><<<grid, kBwdThreads, 0, st>>>(p);
  else bwd_dq_row_f32<64><<<grid, kBwdThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// Dynamic shared memory a block of the bf16 dq pass takes (for the build
// report); 0 for another d.
extern "C" int lvt_flash_bwd_dq_smem_bytes(int d) {
  return d == 128 ? bwd90::QSmem<128>::alloc : d == 64 ? bwd90::QSmem<64>::alloc : 0;
}
