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
// What bounds it on the H100: at the serving chunk shape (2048 query rows
// against a cache of up to 16K slots, 40 q heads, D = 128) the kernel does
// ~4*Sq*Skv*Hq*D FLOPs on operands it reads once per q tile, far above the
// card's ~295 FLOP/byte ridge, so it is tensor-core bound. The design:
//   - one thread block (4 warps) per (q tile of 64 rows, q head, batch row);
//     the Pallas grid's sequential kv axis becomes a loop inside the block;
//   - the loop stops at min(causal diagonal, kv_len), so a chunk never walks
//     the unwritten tail of a preallocated cache;
//   - Q is held in registers as mma fragments; K and V tiles of 64 rows are
//     staged in padded shared memory (conflict-free 32-bit fragment reads);
//   - Q.K^T and P.V run on the tensor cores as mma.sync m16n8k16 bf16 with
//     f32 accumulators; P never leaves registers (the S accumulator layout is
//     the A-operand layout of the P.V product);
//   - tiles strictly inside kv_len and below the diagonal skip the mask;
//   - K/V are read in the model's [B, S, H, D] layout through strides, so a
//     KV cache slice is never transposed or copied.
// wgmma, TMA, cp.async pipelining and warp specialisation are left for later.
//
// float32 inputs take a simple CUDA-core kernel (one warp per query row) with
// the same masks and the same empty-row rule; it exists for completeness, the
// serving path runs bf16.

#include "mma_util.cuh"

namespace {

using namespace lvt;

constexpr int kBM = 64;                    // query rows per block (4 warps x 16)
constexpr int kBN = 64;                    // kv rows per tile
constexpr int kThreads = 128;

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

template <int D>
constexpr int bf16_smem_bytes() {
  return (kBM + 2 * kBN) * (D + 8) * 2 + kBN * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(Params p) {
  constexpr int LD = D + 8;       // padded smem row (elements): 16-byte aligned
  constexpr int VPR = D / 8;      // 16-byte vectors per row
  constexpr int NT = kBN / 8;     // n-tiles of the S accumulator
  constexpr int DT = D / 8;       // n-tiles of the O accumulator
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + kBM * LD;
  __nv_bfloat16* sV = sK + kBN * LD;
  int* sKseg = reinterpret_cast<int*>(sV + kBN * LD);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kBM;

  const long long q_off = p.meta[0], k_off = p.meta[1];
  const int kv_len = min(max(p.meta[2], 0), p.skv);

  int n_tiles = (kv_len + kBN - 1) / kBN;
  if (p.causal) {
    // last kv index the block's last real row may see
    const long long diag = q_off + min(q0 + kBM, p.sq) - 1 - k_off;
    n_tiles = diag < 0 ? 0 : (int)min((long long)n_tiles, diag / kBN + 1);
  }

  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + (long long)h * D;
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + (long long)hk * D;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + (long long)hk * D;

  for (int i = tid; i < kBM * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < p.sq)
      val = *reinterpret_cast<const uint4*>(qg + (q0 + r) * p.q_ss + c);
    *reinterpret_cast<uint4*>(sQ + r * LD + c) = val;
  }

  const int r_lo = warp * 16 + g;  // this thread's two rows in the tile
  const int qi_lo = q0 + r_lo, qi_hi = qi_lo + 8;
  const long long qpos_lo = q_off + qi_lo, qpos_hi = q_off + qi_hi;
  int qs_lo = 0, qs_hi = 0;
  if (p.qseg) {
    qs_lo = qi_lo < p.sq ? p.qseg[b * p.qseg_sb + qi_lo] : -1;
    qs_hi = qi_hi < p.sq ? p.qseg[b * p.qseg_sb + qi_hi] : -1;
  }
  __syncthreads();

  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* base = sQ + r_lo * LD + kk * 16 + t * 2;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(base);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(base + 8 * LD);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(base + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(base + 8 * LD + 8);
  }

  float acc[DT][4];
#pragma unroll
  for (int dn = 0; dn < DT; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBN;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < kBN * VPR; i += kThreads) {
      const int r = i / VPR, c = (i % VPR) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + r < kv_len) {
        kv = *reinterpret_cast<const uint4*>(kg + (k0 + r) * p.k_ss + c);
        vv = *reinterpret_cast<const uint4*>(vg + (k0 + r) * p.v_ss + c);
      }
      *reinterpret_cast<uint4*>(sK + r * LD + c) = kv;
      *reinterpret_cast<uint4*>(sV + r * LD + c) = vv;
    }
    if (p.kseg && tid < kBN)
      sKseg[tid] = k0 + tid < kv_len ? p.kseg[b * p.kseg_sb + k0 + tid] : 0;
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const __nv_bfloat16* kb = sK + (n * 8 + g) * LD + kk * 16 + t * 2;
        mma_bf16(s[n], qf[kk], *reinterpret_cast<const uint32_t*>(kb),
                 *reinterpret_cast<const uint32_t*>(kb + 8));
      }
    }

    // interior tiles: fully inside kv_len and strictly below the diagonal
    const bool interior =
        p.kseg == nullptr && k0 + kBN <= kv_len &&
        (!p.causal || k_off + k0 + kBN - 1 <= q_off + q0);
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * p.scale;
        if (!interior) {
          const int col = k0 + n * 8 + t * 2 + (e & 1);
          bool ok = col < kv_len;
          if (p.causal) ok = ok && k_off + col <= (e < 2 ? qpos_lo : qpos_hi);
          if (p.kseg) ok = ok && sKseg[col - k0] == (e < 2 ? qs_lo : qs_hi);
          if (!ok) x = kNegInf;
        }
        s[n][e] = x;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
    }
    mx_lo = quad_max(mx_lo);
    mx_hi = quad_max(mx_hi);
    const float alpha_lo = __expf(m_lo - mx_lo), alpha_hi = __expf(m_hi - mx_hi);
    m_lo = mx_lo;
    m_hi = mx_hi;
    // a row whose max is still NEG_INF has seen no unmasked key: p = 0
    const bool dead_lo = m_lo == kNegInf, dead_hi = m_hi == kNegInf;

    uint32_t pf[kBN / 16][4];
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float p0 = dead_lo ? 0.f : __expf(s[n][0] - m_lo);
      const float p1 = dead_lo ? 0.f : __expf(s[n][1] - m_lo);
      const float p2 = dead_hi ? 0.f : __expf(s[n][2] - m_hi);
      const float p3 = dead_hi ? 0.f : __expf(s[n][3] - m_hi);
      sum_lo += p0 + p1;
      sum_hi += p2 + p3;
      pf[n / 2][(n & 1) * 2 + 0] = pack_f32(p0, p1);
      pf[n / 2][(n & 1) * 2 + 1] = pack_f32(p2, p3);
    }
    // per-thread partial sums; the quad reduction happens once at the end
    l_lo = l_lo * alpha_lo + sum_lo;
    l_hi = l_hi * alpha_hi + sum_hi;
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      acc[dn][0] *= alpha_lo;
      acc[dn][1] *= alpha_lo;
      acc[dn][2] *= alpha_hi;
      acc[dn][3] *= alpha_hi;
    }
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
      for (int dn = 0; dn < DT; ++dn) {
        const __nv_bfloat16* vb = sV + (kk * 16 + t * 2) * LD + dn * 8 + g;
        mma_bf16(acc[dn], pf[kk], pack_bf16(vb[0], vb[LD]),
                 pack_bf16(vb[8 * LD], vb[9 * LD]));
      }
    }
  }

  l_lo = quad_sum(l_lo);
  l_hi = quad_sum(l_hi);
  const float div_lo = l_lo == 0.f ? 1.f : l_lo;
  const float div_hi = l_hi == 0.f ? 1.f : l_hi;
  __nv_bfloat16* og =
      static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + (long long)h * D;
#pragma unroll
  for (int dn = 0; dn < DT; ++dn) {
    const int c = dn * 8 + t * 2;
    if (qi_lo < p.sq)
      *reinterpret_cast<uint32_t*>(og + qi_lo * p.o_ss + c) =
          pack_f32(acc[dn][0] / div_lo, acc[dn][1] / div_lo);
    if (qi_hi < p.sq)
      *reinterpret_cast<uint32_t*>(og + qi_hi * p.o_ss + c) =
          pack_f32(acc[dn][2] / div_hi, acc[dn][3] / div_hi);
  }
  if (t == 0) {
    float* lg = p.lse + ((long long)b * p.hq + h) * p.sq;
    if (qi_lo < p.sq) lg[qi_lo] = l_lo == 0.f ? kNegInf : m_lo + logf(l_lo);
    if (qi_hi < p.sq) lg[qi_hi] = l_hi == 0.f ? kNegInf : m_hi + logf(l_hi);
  }
}

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
cudaError_t launch_bf16(const Params& p, int batch, cudaStream_t stream) {
  constexpr int smem = bf16_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.sq + kBM - 1) / kBM, p.hq, batch);
  flash_fwd_bf16_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Params& p, int batch, cudaStream_t stream) {
  const int rows = kThreads / 32;
  dim3 grid((p.sq + rows - 1) / rows, p.hq, batch);
  flash_fwd_f32_kernel<D><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. Returns a cudaError_t (0 on success).
extern "C" int lvt_flash_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* qseg, const void* kseg, const void* meta,
    long long q_sb, long long q_ss, long long k_sb, long long k_ss,
    long long v_sb, long long v_ss, long long o_sb, long long o_ss,
    long long qseg_sb, long long kseg_sb,
    int batch, int sq, int skv, int hq, int hkv, int d, int causal,
    float scale, int dtype, void* stream) {
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sq <= 0 || batch <= 0) return (int)cudaSuccess;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && d == 128) err = launch_bf16<128>(p, batch, st);
  else if (dtype == 0 && d == 64) err = launch_bf16<64>(p, batch, st);
  else if (dtype == 1 && d == 128) err = launch_f32<128>(p, batch, st);
  else if (dtype == 1 && d == 64) err = launch_f32<64>(p, batch, st);
  return (int)err;
}
