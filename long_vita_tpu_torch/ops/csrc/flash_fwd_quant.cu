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
// lse = -2^30. GQA: q head h reads kv head h / (Hq / Hkv).
//
// What bounds it on the H100: a serving prefill chunk (2048 query rows, 40 q
// heads, D = 128) against a cache of 16K written slots does ~4*Sq*Skv*Hq*D
// FLOPs on a cache it reads once per q tile, far above the card's ~295
// FLOP/byte ridge: it is tensor-core bound, like K1 (flash_fwd.cu). The int8
// cache halves the bytes per tile, which matters for the cache's size on the
// card (about 1.9x the tokens of a bf16 cache) more than for this kernel's
// time. The design is K1's:
//   - one thread block (4 warps) per (q tile of 64 rows, q head, batch row),
//     looping over kv tiles of 64 rows up to min(causal diagonal, kv_len);
//   - the int8 K and V tiles are read from device memory at half of K1's
//     bytes (16-byte vector loads, 16 codes each) and widened to bf16 (exact
//     for |x| <= 127) once per block as they are staged in shared memory, so
//     the mma fragments are built as in K1; the tile's 64 k and v scales are
//     staged beside them. (A first version staged the codes as int8 and
//     widened them while building the fragments: each of the 4 warps then
//     converted the whole tile again, and the kernel needed 255 registers.
//     On the H100 it ran at 71 TFLOP/s at the serving shape, against K1's
//     105; see PERF.md.)
//   - Q.K^T and P.V run as mma.sync m16n8k16 bf16 with f32 accumulators; P
//     never leaves registers and picks up v_scale as it is rounded to bf16;
//   - the scales are read in the model layout [B, Smax, Hkv, 1] through
//     strides (the Pallas wrapper transposes them to rows for the TPU's
//     tiling; here no copy is made per call), K/V in [B, S, Hkv, D];
//   - q_offset, kv_offset and kv_valid_len are read on the device, so a
//     layer's launch needs no host sync.
// wgmma, TMA and a pipelined K/V ring are left for later.

#include "mma_util.cuh"

namespace {

using namespace lvt;

constexpr int kBM = 64;  // query rows per block (4 warps x 16)
constexpr int kBN = 64;  // kv rows per tile
constexpr int kThreads = 128;

struct Params {
  const __nv_bfloat16* q;
  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
  __nv_bfloat16* o;
  float* lse;       // [B, Hq, Sq]
  const int* meta;  // device int32 [q_offset, kv_offset, kv_valid_len]
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss;  // element strides
  long long ks_sb, ks_ss, ks_sh, vs_sb, vs_ss, vs_sh;
  int sq, skv, hq, hkv;
  float scale;
};

template <int D>
constexpr int smem_bytes() {
  return (kBM + 2 * kBN) * (D + 8) * 2 + 2 * kBN * 4;
}

// four int8 codes (little endian) -> two registers of two bf16 each
__device__ __forceinline__ void widen4(uint32_t w, uint32_t* out) {
  out[0] = pack_f32(static_cast<float>(static_cast<int8_t>(w)),
                    static_cast<float>(static_cast<int8_t>(w >> 8)));
  out[1] = pack_f32(static_cast<float>(static_cast<int8_t>(w >> 16)),
                    static_cast<float>(static_cast<int8_t>(w >> 24)));
}

// 16 int8 codes -> 16 bf16 at dst (32 bytes, 16-byte aligned)
__device__ __forceinline__ void store_widened(__nv_bfloat16* dst, uint4 v) {
  uint32_t o[8];
  widen4(v.x, o);
  widen4(v.y, o + 2);
  widen4(v.z, o + 4);
  widen4(v.w, o + 6);
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_quant_kernel(Params p) {
  constexpr int LD = D + 8;    // padded smem row (bf16 elements), 16-byte aligned
  constexpr int QV = D / 8;    // 16-byte vectors per q row
  constexpr int KV = D / 16;   // 16-byte vectors per int8 row
  constexpr int NT = kBN / 8;  // n-tiles of the S accumulator
  constexpr int DT = D / 8;    // n-tiles of the O accumulator
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + kBM * LD;
  __nv_bfloat16* sV = sK + kBN * LD;
  float* sKs = reinterpret_cast<float*>(sV + kBN * LD);
  float* sVs = sKs + kBN;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kBM;

  const long long q_off = p.meta[0], k_off = p.meta[1];
  const int kv_len = min(max(p.meta[2], 0), p.skv);
  int n_tiles = (kv_len + kBN - 1) / kBN;
  {
    // last kv index the block's last real row may see
    const long long diag = q_off + min(q0 + kBM, p.sq) - 1 - k_off;
    n_tiles = diag < 0 ? 0 : (int)min((long long)n_tiles, diag / kBN + 1);
  }

  const __nv_bfloat16* qg = p.q + b * p.q_sb + (long long)h * D;
  const int8_t* kg = p.k + b * p.k_sb + (long long)hk * D;
  const int8_t* vg = p.v + b * p.v_sb + (long long)hk * D;
  const float* ksg = p.ks + b * p.ks_sb + hk * p.ks_sh;
  const float* vsg = p.vs + b * p.vs_sb + hk * p.vs_sh;

  for (int i = tid; i < kBM * QV; i += kThreads) {
    const int r = i / QV, c = (i % QV) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < p.sq)
      val = *reinterpret_cast<const uint4*>(qg + (q0 + r) * p.q_ss + c);
    *reinterpret_cast<uint4*>(sQ + r * LD + c) = val;
  }
  const int r_lo = warp * 16 + g;  // this thread's two rows in the tile
  const int qi_lo = q0 + r_lo, qi_hi = qi_lo + 8;
  const long long qpos_lo = q_off + qi_lo, qpos_hi = q_off + qi_hi;
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
    for (int i = tid; i < kBN * KV; i += kThreads) {
      const int r = i / KV, c = (i % KV) * 16;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + r < kv_len) {
        kv = *reinterpret_cast<const uint4*>(kg + (k0 + r) * p.k_ss + c);
        vv = *reinterpret_cast<const uint4*>(vg + (k0 + r) * p.v_ss + c);
      }
      store_widened(sK + r * LD + c, kv);
      store_widened(sV + r * LD + c, vv);
    }
    if (tid < kBN) {
      sKs[tid] = k0 + tid < kv_len ? ksg[(k0 + tid) * p.ks_ss] : 0.f;
    } else if (tid < 2 * kBN) {
      const int r = tid - kBN;
      sVs[r] = k0 + r < kv_len ? vsg[(k0 + r) * p.vs_ss] : 0.f;
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

    // interior tiles: fully inside kv_len and strictly below the diagonal
    const bool interior =
        k0 + kBN <= kv_len && k_off + k0 + kBN - 1 <= q_off + q0;
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = n * 8 + t * 2 + (e & 1);  // column within the tile
        float x = s[n][e] * p.scale * sKs[cl];
        if (!interior) {
          const int col = k0 + cl;
          const bool ok =
              col < kv_len && k_off + col <= (e < 2 ? qpos_lo : qpos_hi);
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
      const int cl = n * 8 + t * 2;
      const float p0 = dead_lo ? 0.f : __expf(s[n][0] - m_lo);
      const float p1 = dead_lo ? 0.f : __expf(s[n][1] - m_lo);
      const float p2 = dead_hi ? 0.f : __expf(s[n][2] - m_hi);
      const float p3 = dead_hi ? 0.f : __expf(s[n][3] - m_hi);
      sum_lo += p0 + p1;
      sum_hi += p2 + p3;
      const float vs0 = sVs[cl], vs1 = sVs[cl + 1];
      pf[n / 2][(n & 1) * 2 + 0] = pack_f32(p0 * vs0, p1 * vs1);
      pf[n / 2][(n & 1) * 2 + 1] = pack_f32(p2 * vs0, p3 * vs1);
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
  __nv_bfloat16* og = p.o + b * p.o_sb + (long long)h * D;
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

template <int D>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_quant_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.sq + kBM - 1) / kBM, p.hq, batch);
  flash_fwd_quant_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
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
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const int8_t*>(k);
  p.v = static_cast<const int8_t*>(v);
  p.ks = static_cast<const float*>(k_scale);
  p.vs = static_cast<const float*>(v_scale);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.meta = static_cast<const int*>(meta);
  p.q_sb = q_sb;
  p.q_ss = q_ss;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.o_sb = o_sb;
  p.o_ss = o_ss;
  p.ks_sb = ks_sb;
  p.ks_ss = ks_ss;
  p.ks_sh = ks_sh;
  p.vs_sb = vs_sb;
  p.vs_ss = vs_ss;
  p.vs_sh = vs_sh;
  p.sq = sq;
  p.skv = skv;
  p.hq = hq;
  p.hkv = hkv;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sq <= 0 || batch <= 0) return (int)cudaSuccess;
  if (d == 128) return (int)launch<128>(p, batch, st);
  if (d == 64) return (int)launch<64>(p, batch, st);
  return (int)cudaErrorInvalidValue;
}
