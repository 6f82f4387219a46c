// Flash attention forward for Hopper (sm_90a), bound to Python through a
// plain C entry point (lvt_flash_fwd) and ctypes.
//
// Replaces: the Pallas TPU kernel `_fwd_kernel` / `_fwd_kernel_noseg`
// (long_vita_tpu/ops/flash_attention.py:144 and :255, launched by `_fwd`
// :351, pallas_call :429). Same contract: s = q.k^T / sqrt(D) in f32,
// finite NEG_INF = -2^30 for masked logits and as the initial row max,
// online max/sum in f32, p cast to the value dtype before P.V with f32
// accumulation, o = acc / l and lse = m + log(l); a row with l == 0 gives
// o = 0 and lse = -2^30. Masks: causal (kv_off + j <= q_off + i), the
// kv_valid_len tail (j < kv_len) and optional segment ids. GQA: q head h
// reads kv head h / (Hq / Hkv). Masked logits contribute p = 0 exactly, so a
// row with no unmasked key is empty whatever the tiling.
//
// bf16 inputs take the Hopper forward of flash_fwd_sm90.cuh (one block of
// two consumer warpgroups and a TMA producer per 128 query rows; K/V tiles
// of 128 rows through a ring of shared-memory stages handed over by
// mbarriers; Q.K^T and P.V as wgmma with P kept in registers), where the
// design and what bounds it are set out. The wrapper's strides become TMA
// tensor maps, built here on the host, so a KV cache slice is never
// transposed or copied; segment ids come in by TMA beside each K tile, which
// needs their row stride (kseg_sb) to be a multiple of 4 ids when B > 1.
//
// float32 inputs take a simple CUDA-core kernel (one warp per query row) with
// the same masks and the same empty-row rule; it exists for completeness, the
// serving path runs bf16.

#include "flash_fwd_sm90.cuh"

namespace {

using namespace lvt;

constexpr int kThreads = 128;  // the f32 kernel: four query rows a block

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;          // [B, Hq, Sq]
  const int* qseg;     // [B, Sq] or null
  const int* kseg;     // [B, Skv] or null
  const int* meta;     // device int32 [q_offset, kv_offset, kv_valid_len]
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss;  // element strides
  long long qseg_sb, kseg_sb;
  int sq, skv, hq, hkv;
  int causal;
  float scale;
};

// float32: one warp per query row, each lane holding D/32 of its columns.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32_kernel(Params p) {
  constexpr int E = D / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qi = blockIdx.x * (kThreads / 32) + warp;
  const int h = blockIdx.y, b = blockIdx.z;
  if (qi >= p.sq) return;
  const int hk = h / (p.hq / p.hkv);
  const long long q_off = p.meta[0], k_off = p.meta[1];
  const int kv_len = min(max(p.meta[2], 0), p.skv);
  const long long qpos = q_off + qi;
  long long end = kv_len;
  if (p.causal) end = min(end, max(0LL, qpos - k_off + 1));
  const int qs = p.qseg ? p.qseg[b * p.qseg_sb + qi] : 0;

  const float* qrow = static_cast<const float*>(p.q) + b * p.q_sb + qi * p.q_ss + (long long)h * D;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + (long long)hk * D;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + (long long)hk * D;
  float qv[E], acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    qv[e] = qrow[lane + 32 * e];
    acc[e] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  for (long long j = 0; j < end; ++j) {
    if (p.kseg && p.kseg[b * p.kseg_sb + j] != qs) continue;
    const float* kr = kg + j * p.k_ss;
    const float* vr = vg + j * p.v_ss;
    float d = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) d += qv[e] * kr[lane + 32 * e];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
    const float s = d * p.scale;
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new), pj = expf(s - m_new);
    l = l * alpha + pj;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = acc[e] * alpha + pj * vr[lane + 32 * e];
    m = m_new;
  }
  const float div = l == 0.f ? 1.f : l;
  float* orow = static_cast<float*>(p.o) + b * p.o_sb + qi * p.o_ss + (long long)h * D;
#pragma unroll
  for (int e = 0; e < E; ++e) orow[lane + 32 * e] = acc[e] / div;
  if (lane == 0)
    p.lse[((long long)b * p.hq + h) * p.sq + qi] = l == 0.f ? kNegInf : m + logf(l);
}

template <int D>
cudaError_t launch_bf16(const fwd90::Params& p, int batch, bool causal, bool seg,
                        cudaStream_t stream) {
  if (causal && seg) return fwd90::launch<D, true, true>(p, batch, stream);
  if (causal) return fwd90::launch<D, true, false>(p, batch, stream);
  if (seg) return fwd90::launch<D, false, true>(p, batch, stream);
  return fwd90::launch<D, false, false>(p, batch, stream);
}

template <int D>
cudaError_t launch_f32(const Params& p, int batch, cudaStream_t stream) {
  const int rows = kThreads / 32;
  dim3 grid((p.sq + rows - 1) / rows, p.hq, batch);
  flash_fwd_f32_kernel<D><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. With segments, seg_ranges holds the
// (min, max) ids of every 128-row q block and kv tile (fwd90::Params; the
// f32 kernel does not read it). Returns a cudaError_t (0 on success).
extern "C" int lvt_flash_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* qseg, const void* kseg, const void* seg_ranges, const void* meta,
    long long q_sb, long long q_ss, long long k_sb, long long k_ss,
    long long v_sb, long long v_ss, long long o_sb, long long o_ss,
    long long qseg_sb, long long kseg_sb,
    int batch, int sq, int skv, int hq, int hkv, int d, int causal,
    float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sq <= 0 || batch <= 0) return (int)cudaSuccess;
  if (d != 64 && d != 128) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    lvt::fwd90::Params p;
    if (!lvt::fwd90::make_params(&p, q, k, v, o, lse, qseg, kseg, seg_ranges, meta, q_sb,
                                 q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, qseg_sb, kseg_sb,
                                 batch, sq, skv, hq, hkv, d, scale))
      return (int)cudaErrorInvalidValue;
    const bool seg = kseg != nullptr;
    return (int)(d == 128 ? launch_bf16<128>(p, batch, causal != 0, seg, st)
                          : launch_bf16<64>(p, batch, causal != 0, seg, st));
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.meta = static_cast<const int*>(meta);
  p.q_sb = q_sb;
  p.q_ss = q_ss;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.o_sb = o_sb;
  p.o_ss = o_ss;
  p.qseg_sb = qseg_sb;
  p.kseg_sb = kseg_sb;
  p.sq = sq;
  p.skv = skv;
  p.hq = hq;
  p.hkv = hkv;
  p.causal = causal;
  p.scale = scale;
  return (int)(d == 128 ? launch_f32<128>(p, batch, st) : launch_f32<64>(p, batch, st));
}

// Dynamic shared memory a block of the bf16 forward takes at head dim d (for
// the build report); 0 for another d.
extern "C" int lvt_flash_fwd_smem_bytes(int d) {
  return d == 128 ? lvt::fwd90::Smem<128>::alloc : d == 64 ? lvt::fwd90::Smem<64>::alloc : 0;
}
