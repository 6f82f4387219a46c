// Non-causal attention over short sequences (the InternViT's 1025 tokens a
// tile), forward only, for Hopper (sm_90a), bound to Python through a plain C
// entry point (lvt_short_attn) and ctypes.
//
// Replaces: the Pallas TPU kernel `_short_nc_kernel`
// (long_vita_tpu/ops/flash_attention.py:1192, launched by
// `_short_attention_impl` :1285, pallas_call :1327; `short_attention` :1227
// is its public, differentiable wrapper). What it computes: for every tile,
// head and query row, s = q.k^T / sqrt(D) in f32 over all S keys of the tile
// (no causal mask, no offsets, no segments), p = exp(s - m), the P.V product
// with p rounded to the value dtype and f32 accumulation, the divide by
// l = sum(p) after P.V, o = acc / max(l, 1e-30) and lse = m + log(max(l,
// 1e-30)). GQA: q head h reads kv head h / (Hq / Hkv).
//
// What bounds it on the H100: at the encode shape (64 tiles x 16 heads x
// 1025 tokens, D = 64) a block does ~4*1025*1025*64 FLOPs on 0.26 MB of K/V
// that L2 serves to the tile's 17 q blocks: tensor-core bound, with the
// softmax's exp and reductions as the next cost. The TPU kernel holds one
// head's whole K and V in VMEM and does one plain softmax; at this shape that
// is 1025 x 64 x 2 B = 131 KB each, over a block's 227 KB of shared memory
// with Q beside them, so the design streams instead:
//   - one thread block (4 warps) per (64-row q block, head, tile);
//   - K and V streamed through shared memory in 64-row tiles with an online
//     max/sum in f32; only the last tile is masked (1025 = 16 x 64 + 1), with
//     its rows past S zero-filled;
//   - Q.K^T and P.V as mma.sync m16n8k16 bf16 with f32 accumulators, P kept
//     in registers; D is fixed at 64, so every loop is unrolled.
// cp.async or TMA double-buffering and wgmma are left for later.

#include "mma_util.cuh"

namespace {

using namespace lvt;

constexpr int D = 64;
constexpr int kBM = 64;  // query rows per block (4 warps x 16)
constexpr int kBN = 64;  // kv rows per tile
constexpr int kThreads = 128;
constexpr int LD = D + 8;  // padded smem row (bf16 elements), 16-byte aligned
constexpr int kSmem = (kBM + 2 * kBN) * LD * 2;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;  // [N, Hq, S]
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss;  // element strides
  int s, hq, hkv;
  float scale;
};

__global__ void __launch_bounds__(kThreads) short_attn_kernel(Params p) {
  constexpr int VPR = D / 8;   // 16-byte vectors per row
  constexpr int NT = kBN / 8;  // n-tiles of the S accumulator
  constexpr int DT = D / 8;    // n-tiles of the O accumulator
  __shared__ __align__(16) unsigned char smem[kSmem];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + kBM * LD;
  __nv_bfloat16* sV = sK + kBN * LD;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kBM;
  const int n_tiles = (p.s + kBN - 1) / kBN;

  const __nv_bfloat16* qg = p.q + b * p.q_sb + (long long)h * D;
  const __nv_bfloat16* kg = p.k + b * p.k_sb + (long long)hk * D;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + (long long)hk * D;

  for (int i = tid; i < kBM * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < p.s)
      val = *reinterpret_cast<const uint4*>(qg + (q0 + r) * p.q_ss + c);
    *reinterpret_cast<uint4*>(sQ + r * LD + c) = val;
  }
  const int r_lo = warp * 16 + g;  // this thread's two rows in the tile
  const int qi_lo = q0 + r_lo, qi_hi = qi_lo + 8;
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
  // every row has at least one key (S >= 1), so m is finite after tile 0
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBN;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < kBN * VPR; i += kThreads) {
      const int r = i / VPR, c = (i % VPR) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + r < p.s) {
        kv = *reinterpret_cast<const uint4*>(kg + (k0 + r) * p.k_ss + c);
        vv = *reinterpret_cast<const uint4*>(vg + (k0 + r) * p.v_ss + c);
      }
      *reinterpret_cast<uint4*>(sK + r * LD + c) = kv;
      *reinterpret_cast<uint4*>(sV + r * LD + c) = vv;
    }
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

    const bool ragged = k0 + kBN > p.s;  // only the last tile can be
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * p.scale;
        if (ragged && k0 + n * 8 + t * 2 + (e & 1) >= p.s) x = kNegInf;
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

    uint32_t pf[kBN / 16][4];
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      // a masked logit is -2^30 below a finite max: exp underflows to 0
      const float p0 = __expf(s[n][0] - m_lo), p1 = __expf(s[n][1] - m_lo);
      const float p2 = __expf(s[n][2] - m_hi), p3 = __expf(s[n][3] - m_hi);
      sum_lo += p0 + p1;
      sum_hi += p2 + p3;
      pf[n / 2][(n & 1) * 2 + 0] = pack_f32(p0, p1);
      pf[n / 2][(n & 1) * 2 + 1] = pack_f32(p2, p3);
    }
    l_lo = l_lo * alpha_lo + sum_lo;  // per-thread partial; quad sum at the end
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

  l_lo = fmaxf(quad_sum(l_lo), 1e-30f);
  l_hi = fmaxf(quad_sum(l_hi), 1e-30f);
  __nv_bfloat16* og = p.o + b * p.o_sb + (long long)h * D;
#pragma unroll
  for (int dn = 0; dn < DT; ++dn) {
    const int c = dn * 8 + t * 2;
    if (qi_lo < p.s)
      *reinterpret_cast<uint32_t*>(og + qi_lo * p.o_ss + c) =
          pack_f32(acc[dn][0] / l_lo, acc[dn][1] / l_lo);
    if (qi_hi < p.s)
      *reinterpret_cast<uint32_t*>(og + qi_hi * p.o_ss + c) =
          pack_f32(acc[dn][2] / l_hi, acc[dn][3] / l_hi);
  }
  if (t == 0) {
    float* lg = p.lse + ((long long)b * p.hq + h) * p.s;
    if (qi_lo < p.s) lg[qi_lo] = m_lo + logf(l_lo);
    if (qi_hi < p.s) lg[qi_hi] = m_hi + logf(l_hi);
  }
}

}  // namespace

// q, k, v, o bf16 [N, S, H, 64]; lse f32 [N, Hq, S]. Returns a cudaError_t
// (0 on success).
extern "C" int lvt_short_attn(
    const void* q, const void* k, const void* v, void* o, void* lse,
    long long q_sb, long long q_ss, long long k_sb, long long k_ss,
    long long v_sb, long long v_ss, long long o_sb, long long o_ss,
    int batch, int s, int hq, int hkv, float scale, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.q_sb = q_sb;
  p.q_ss = q_ss;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.o_sb = o_sb;
  p.o_ss = o_ss;
  p.s = s;
  p.hq = hq;
  p.hkv = hkv;
  p.scale = scale;
  if (s <= 0 || batch <= 0) return (int)cudaSuccess;
  dim3 grid((s + kBM - 1) / kBM, hq, batch);
  short_attn_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
