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
//   - lvt_flash_bwd_dkv: dK and dV per 64-row kv tile, accumulated in
//     registers over the GQA group's q heads and every q tile that can see
//     the tile (the kv-tile kernel of the shared header without its dQ part);
//   - lvt_flash_bwd_dq: dQ per 64-row q tile, accumulated in registers over
//     the kv tiles up to the causal diagonal and kv_valid_len; s and dP are
//     formed again, which is the price of needing no memory that grows with
//     the number of kv blocks (the one-pass K4 adds into an f32 buffer).
//
// What bounds it on the H100: at 32K tokens, 40/8 heads, D 128, causal, both
// passes are bound by tensor-core and instruction throughput (4 and 3
// m16n8k16 products per element pair on operands in shared memory). The dq pass mirrors the
// forward kernel K1: Q and dO stay in the block (dO as mma fragments in
// registers), K and V stream through shared memory in 64-row tiles, dS.K
// reads K transposed through ldmatrix .trans, interior tiles skip the masks,
// and the q tiles are walked from the end so the longest causal rows start
// first. cp.async double-buffering, wgmma and TMA are left for later.

#include "flash_bwd_common.cuh"

namespace {

using namespace lvt;

constexpr int kDqRows = 64;  // q rows of a dq block (4 warps x 16)

template <int D>
constexpr int dq_smem_bytes() {
  return 2 * (kDqRows + kKvTile) * (D + 8) * 2 + kKvTile * 4;
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads) bwd_dq_bf16(BwdParams p) {
  constexpr int LD = D + 8;
  constexpr int VPR = D / 8;
  constexpr int DT = D / 8;        // n-tiles of the dQ accumulator
  constexpr int NT = kKvTile / 8;  // n-tiles of S and dP
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + kDqRows * LD;
  bf16* sK = sdO + kDqRows * LD;
  bf16* sV = sK + kKvTile * LD;
  int* sKseg = reinterpret_cast<int*>(sV + kKvTile * LD);

  // the last q tiles see the most keys under the causal mask: start them first
  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kDqRows;

  const long long q_off = p.meta[0], k_off = p.meta[1];
  const int kv_len = min(max(p.meta[2], 0), p.skv);
  int n_tiles = (kv_len + kKvTile - 1) / kKvTile;
  if (p.causal) {
    const long long diag = q_off + min(q0 + kDqRows, p.sq) - 1 - k_off;
    n_tiles = diag < 0 ? 0 : (int)min((long long)n_tiles, diag / kKvTile + 1);
  }

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + (long long)h * D;
  const bf16* dog = static_cast<const bf16*>(p.dout) + b * p.do_sb + (long long)h * D;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + (long long)hk * D;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + (long long)hk * D;
  for (int i = tid; i < kDqRows * VPR; i += kBwdThreads) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 qv = make_uint4(0u, 0u, 0u, 0u), ov = qv;
    if (q0 + r < p.sq) {
      qv = *reinterpret_cast<const uint4*>(qg + (q0 + r) * p.q_ss + c);
      ov = *reinterpret_cast<const uint4*>(dog + (q0 + r) * p.do_ss + c);
    }
    *reinterpret_cast<uint4*>(sQ + r * LD + c) = qv;
    *reinterpret_cast<uint4*>(sdO + r * LD + c) = ov;
  }

  const int r_lo = warp * 16 + g;  // this thread's two rows in the q tile
  const int qi_lo = q0 + r_lo, qi_hi = qi_lo + 8;
  const long long qpos_lo = q_off + qi_lo, qpos_hi = q_off + qi_hi;
  const long long stat = ((long long)b * p.hq + h) * p.sq;
  // rows past Sq get lse = +inf, so p = exp(s - inf) = 0 even unmasked
  const float lse_lo = qi_lo < p.sq ? p.lse[stat + qi_lo] : INFINITY;
  const float lse_hi = qi_hi < p.sq ? p.lse[stat + qi_hi] : INFINITY;
  const float del_lo = qi_lo < p.sq ? p.delta[stat + qi_lo] : 0.f;
  const float del_hi = qi_hi < p.sq ? p.delta[stat + qi_hi] : 0.f;
  int qs_lo = 0, qs_hi = 0;
  if (p.qseg) {
    qs_lo = qi_lo < p.sq ? p.qseg[b * p.qseg_sb + qi_lo] : -1;
    qs_hi = qi_hi < p.sq ? p.qseg[b * p.qseg_sb + qi_hi] : -1;
  }
  __syncthreads();

  uint32_t of[D / 16][4];  // dO as A fragments, held for the whole kv sweep
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* base = sdO + r_lo * LD + kk * 16 + t * 2;
    of[kk][0] = *reinterpret_cast<const uint32_t*>(base);
    of[kk][1] = *reinterpret_cast<const uint32_t*>(base + 8 * LD);
    of[kk][2] = *reinterpret_cast<const uint32_t*>(base + 8);
    of[kk][3] = *reinterpret_cast<const uint32_t*>(base + 8 * LD + 8);
  }

  float acc[DT][4];
#pragma unroll
  for (int dn = 0; dn < DT; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kKvTile;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < kKvTile * VPR; i += kBwdThreads) {
      const int r = i / VPR, c = (i % VPR) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + r < kv_len) {
        kv = *reinterpret_cast<const uint4*>(kg + (k0 + r) * p.k_ss + c);
        vv = *reinterpret_cast<const uint4*>(vg + (k0 + r) * p.v_ss + c);
      }
      *reinterpret_cast<uint4*>(sK + r * LD + c) = kv;
      *reinterpret_cast<uint4*>(sV + r * LD + c) = vv;
    }
    if (p.kseg && tid < kKvTile)
      sKseg[tid] = k0 + tid < kv_len ? p.kseg[b * p.kseg_sb + k0 + tid] : -2;
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4];
      const bf16* base = sQ + r_lo * LD + kk * 16 + t * 2;
      aq[0] = *reinterpret_cast<const uint32_t*>(base);
      aq[1] = *reinterpret_cast<const uint32_t*>(base + 8 * LD);
      aq[2] = *reinterpret_cast<const uint32_t*>(base + 8);
      aq[3] = *reinterpret_cast<const uint32_t*>(base + 8 * LD + 8);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const bf16* kb = sK + (n * 8 + g) * LD + kk * 16 + t * 2;
        const bf16* vb = sV + (n * 8 + g) * LD + kk * 16 + t * 2;
        mma_bf16(s[n], aq, *reinterpret_cast<const uint32_t*>(kb),
                 *reinterpret_cast<const uint32_t*>(kb + 8));
        mma_bf16(dp[n], of[kk], *reinterpret_cast<const uint32_t*>(vb),
                 *reinterpret_cast<const uint32_t*>(vb + 8));
      }
    }

    const bool interior =
        p.kseg == nullptr && k0 + kKvTile <= kv_len &&
        (!p.causal || k_off + k0 + kKvTile - 1 <= q_off + q0);
    uint32_t df[NT / 2][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e < 2;
        bool ok = true;
        if (!interior) {
          const int col = k0 + n * 8 + t * 2 + (e & 1);
          ok = col < kv_len;
          if (p.causal) ok = ok && k_off + col <= (lo ? qpos_lo : qpos_hi);
          if (p.kseg) ok = ok && sKseg[col - k0] == (lo ? qs_lo : qs_hi);
        }
        const float pv = ok ? __expf(s[n][e] * p.scale - (lo ? lse_lo : lse_hi)) : 0.f;
        ds[e] = pv * (dp[n][e] - (lo ? del_lo : del_hi)) * p.scale;
      }
      df[n / 2][(n & 1) * 2 + 0] = pack_f32(ds[0], ds[1]);
      df[n / 2][(n & 1) * 2 + 1] = pack_f32(ds[2], ds[3]);
    }

    // dQ += dS.K (contraction over the kv tile; K read transposed)
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
      for (int dn = 0; dn < DT; dn += 2) {
        uint32_t bk[4];
        ldsm_x4_trans(bk, sK + (kk * 16 + (lane & 15)) * LD + dn * 8 + (lane >> 4) * 8);
        mma_bf16(acc[dn], df[kk], bk[0], bk[1]);
        mma_bf16(acc[dn + 1], df[kk], bk[2], bk[3]);
      }
    }
  }

  const long long row_stride = (long long)p.hq * D;
  bf16* dqg = static_cast<bf16*>(p.dq) + (long long)b * p.sq * row_stride + (long long)h * D;
#pragma unroll
  for (int dn = 0; dn < DT; ++dn) {
    const int c = dn * 8 + t * 2;
    if (qi_lo < p.sq)
      *reinterpret_cast<uint32_t*>(dqg + qi_lo * row_stride + c) = pack_f32(acc[dn][0], acc[dn][1]);
    if (qi_hi < p.sq)
      *reinterpret_cast<uint32_t*>(dqg + qi_hi * row_stride + c) = pack_f32(acc[dn][2], acc[dn][3]);
  }
}

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

template <int D>
cudaError_t launch_dq(const BwdParams& p, int batch, int dtype, cudaStream_t stream) {
  if (dtype == 0) {
    constexpr int smem = dq_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        bwd_dq_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((p.sq + kDqRows - 1) / kDqRows, p.hq, batch);
    bwd_dq_bf16<D><<<grid, kBwdThreads, smem, stream>>>(p);
  } else {
    const int rows = kBwdThreads / 32;
    dim3 grid((p.sq + rows - 1) / rows, p.hq, batch);
    bwd_dq_row_f32<D><<<grid, kBwdThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. The two entry points share one argument
// list; lvt_flash_bwd_dkv ignores dq, lvt_flash_bwd_dq ignores dk and dv.
// Returns a cudaError_t (0 on success).
extern "C" int lvt_flash_bwd_dkv(
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
  return (int)lvt::launch_kv_tile_any<false>(p, batch, d, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int lvt_flash_bwd_dq(
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sq <= 0 || batch <= 0) return (int)cudaSuccess;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (d == 128) return (int)launch_dq<128>(p, batch, dtype, st);
  if (d == 64) return (int)launch_dq<64>(p, batch, dtype, st);
  return (int)cudaErrorInvalidValue;
}
