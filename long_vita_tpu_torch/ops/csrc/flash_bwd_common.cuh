// The flash-attention backward pieces shared by the one-pass kernel K4
// (flash_bwd.cu) and the two-pass kernels K5 (flash_bwd_2pass.cu): the
// argument block, the kv-tile kernel that accumulates dK and dV (and, in the
// one-pass form, adds dQ into an f32 buffer), and its float32 CUDA-core
// counterpart.
//
// Contract, as the Pallas backward kernels (long_vita_tpu/ops/
// flash_attention.py:454-693) and the plain flash_attention_bwd_reference:
// s = q.k^T * scale in f32; p = exp(s - lse) where the key is unmasked, else
// 0 (the forward's masks: causal kv_off + j <= q_off + i, j < kv_valid_len,
// equal segment ids); dV = p^T.dO with p rounded to the input dtype; dP =
// dO.V^T in f32; dS = p * (dP - delta) * scale with delta = rowsum(dO * O)
// (computed by the caller); dK = dS^T.Q and dQ = dS.K with dS rounded to the
// input dtype; f32 accumulation throughout. GQA: q head h reads kv head
// h / (Hq / Hkv), and dK, dV of a kv head sum over its group. Rows of dK and
// dV at or past kv_valid_len are 0.
#pragma once

#include "mma_util.cuh"

namespace lvt {

constexpr int kBwdThreads = 128;  // 4 warps
constexpr int kKvTile = 64;       // kv rows of a kv-tile block (4 warps x 16)
constexpr int kQTile = 32;        // q rows of one inner step of a kv-tile block

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, Hq, Sq]
  const float* delta;  // [B, Hq, Sq]
  void* dq;            // [B, Sq, Hq, D]: f32 sums (one pass) or input dtype (dq pass)
  void* dk;            // [B, Skv, Hkv, D], input dtype
  void* dv;
  const int* qseg;     // [B, Sq] or null
  const int* kseg;     // [B, Skv] or null
  const int* meta;     // device int32 [q_offset, kv_offset, kv_valid_len]
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, do_sb, do_ss;  // element strides
  long long qseg_sb, kseg_sb;
  int sq, skv, hq, hkv;
  int causal;
  float scale;
};

inline BwdParams make_bwd_params(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv,
    const void* qseg, const void* kseg, const void* meta,
    long long q_sb, long long q_ss, long long k_sb, long long k_ss,
    long long v_sb, long long v_ss, long long do_sb, long long do_ss,
    long long qseg_sb, long long kseg_sb, int sq, int skv, int hq, int hkv,
    int causal, float scale) {
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.meta = static_cast<const int*>(meta);
  p.q_sb = q_sb;
  p.q_ss = q_ss;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.do_sb = do_sb;
  p.do_ss = do_ss;
  p.qseg_sb = qseg_sb;
  p.kseg_sb = kseg_sb;
  p.sq = sq;
  p.skv = skv;
  p.hq = hq;
  p.hkv = hkv;
  p.causal = causal;
  p.scale = scale;
  return p;
}

template <int D>
constexpr int kv_tile_smem_bytes() {
  // sK, sV [64][D + 8]; sQ, sdO [32][D + 8]; sdS [32][64 + 8] (bf16);
  // lse, delta, q segment ids [32]; kv segment ids [64]
  return (2 * kKvTile + 2 * kQTile) * (D + 8) * 2 + kQTile * (kKvTile + 8) * 2 +
         (3 * kQTile + kKvTile) * 4;
}

// One block per (64-row kv tile, kv head, batch row); the block walks the q
// heads of the GQA group and, for each, the 32-row q tiles that can see the
// tile (from the causal diagonal on). Each warp owns 16 kv rows and keeps
// their dK and dV in f32 registers; K, V and the current Q, dO tiles sit in
// padded shared memory. Per (q tile, kv tile) pair the warp forms S^T and
// dP^T (kv rows x q columns) with mma.sync, then P^T and dS^T in registers,
// whose accumulator layout is the A-operand layout of dV += P^T.dO and
// dK += dS^T.Q; the B operands come from shared memory through ldmatrix
// .trans. kFused (K4) also writes dS to shared memory and forms the
// [32 x D] dQ contribution of the pair, added with f32 atomics into p.dq.
template <int D, bool kFused>
__global__ void __launch_bounds__(kBwdThreads) bwd_kv_tile_bf16(BwdParams p) {
  constexpr int LD = D + 8;         // padded row (elements): 16-byte aligned
  constexpr int LDS = kKvTile + 8;  // padded dS row
  constexpr int VPR = D / 8;        // 16-byte vectors per row
  constexpr int DT = D / 8;         // n-tiles over D
  constexpr int NQ = kQTile / 8;    // n-tiles of S^T (q columns)
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kKvTile * LD;
  bf16* sQ = sV + kKvTile * LD;
  bf16* sdO = sQ + kQTile * LD;
  bf16* sdS = sdO + kQTile * LD;
  float* sLse = reinterpret_cast<float*>(sdS + kQTile * LDS);
  float* sDelta = sLse + kQTile;
  int* sQseg = reinterpret_cast<int*>(sDelta + kQTile);
  int* sKseg = sQseg + kQTile;

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = p.hq / p.hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = kt * kKvTile;
  const int r0 = warp * 16;  // this warp's first kv row in the tile

  const long long q_off = p.meta[0], k_off = p.meta[1];
  const int kv_len = min(max(p.meta[2], 0), p.skv);

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int dn = 0; dn < DT; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dn][e] = dv[dn][e] = 0.f;

  if (k0 < kv_len) {
    const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + (long long)hk * D;
    const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + (long long)hk * D;
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

    // first q row whose position reaches the tile's first key
    int i_begin = 0;
    if (p.causal) {
      const long long first = k_off + k0 - q_off;
      i_begin = first <= 0 ? 0 : (int)min(first, (long long)p.sq);
    }
    const int qt_begin = i_begin / kQTile;
    const int n_qt = (p.sq + kQTile - 1) / kQTile;

    for (int hh = 0; hh < group; ++hh) {
      const int h = hk * group + hh;
      const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + (long long)h * D;
      const bf16* dog = static_cast<const bf16*>(p.dout) + b * p.do_sb + (long long)h * D;
      const long long stat = ((long long)b * p.hq + h) * p.sq;

      for (int qt = qt_begin; qt < n_qt; ++qt) {
        const int q0 = qt * kQTile;
        __syncthreads();  // the previous step is done with sQ, sdO and sdS
        for (int i = tid; i < kQTile * VPR; i += kBwdThreads) {
          const int r = i / VPR, c = (i % VPR) * 8;
          uint4 qv = make_uint4(0u, 0u, 0u, 0u), ov = qv;
          if (q0 + r < p.sq) {
            qv = *reinterpret_cast<const uint4*>(qg + (q0 + r) * p.q_ss + c);
            ov = *reinterpret_cast<const uint4*>(dog + (q0 + r) * p.do_ss + c);
          }
          *reinterpret_cast<uint4*>(sQ + r * LD + c) = qv;
          *reinterpret_cast<uint4*>(sdO + r * LD + c) = ov;
        }
        if (tid < kQTile) {
          const bool in = q0 + tid < p.sq;
          sLse[tid] = in ? p.lse[stat + q0 + tid] : 0.f;
          sDelta[tid] = in ? p.delta[stat + q0 + tid] : 0.f;
          if (p.qseg) sQseg[tid] = in ? p.qseg[b * p.qseg_sb + q0 + tid] : -1;
        }
        __syncthreads();

        // S^T = K.Q^T and dP^T = V.dO^T for this warp's 16 kv rows
        float st[NQ][4], dpt[NQ][4];
#pragma unroll
        for (int n = 0; n < NQ; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t ak[4], av[4];
          const bf16* kb = sK + (r0 + g) * LD + kk * 16 + t * 2;
          const bf16* vb = sV + (r0 + g) * LD + kk * 16 + t * 2;
          ak[0] = *reinterpret_cast<const uint32_t*>(kb);
          ak[1] = *reinterpret_cast<const uint32_t*>(kb + 8 * LD);
          ak[2] = *reinterpret_cast<const uint32_t*>(kb + 8);
          ak[3] = *reinterpret_cast<const uint32_t*>(kb + 8 * LD + 8);
          av[0] = *reinterpret_cast<const uint32_t*>(vb);
          av[1] = *reinterpret_cast<const uint32_t*>(vb + 8 * LD);
          av[2] = *reinterpret_cast<const uint32_t*>(vb + 8);
          av[3] = *reinterpret_cast<const uint32_t*>(vb + 8 * LD + 8);
#pragma unroll
          for (int n = 0; n < NQ; ++n) {
            const bf16* qb = sQ + (n * 8 + g) * LD + kk * 16 + t * 2;
            const bf16* ob = sdO + (n * 8 + g) * LD + kk * 16 + t * 2;
            mma_bf16(st[n], ak, *reinterpret_cast<const uint32_t*>(qb),
                     *reinterpret_cast<const uint32_t*>(qb + 8));
            mma_bf16(dpt[n], av, *reinterpret_cast<const uint32_t*>(ob),
                     *reinterpret_cast<const uint32_t*>(ob + 8));
          }
        }

        // P^T and dS^T; interior pairs (every key of the tile visible to
        // every q row) skip the masks
        const bool interior =
            p.kseg == nullptr && k0 + kKvTile <= kv_len && q0 + kQTile <= p.sq &&
            (!p.causal || k_off + k0 + kKvTile - 1 <= q_off + q0);
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int jr = r0 + g + ((e >> 1) << 3);  // kv row in the tile
            const int ic = n * 8 + t * 2 + (e & 1);   // q row in the q tile
            bool ok = true;
            if (!interior) {
              const int j = k0 + jr, i = q0 + ic;
              ok = j < kv_len && i < p.sq;
              if (p.causal) ok = ok && k_off + j <= q_off + i;
              if (p.kseg) ok = ok && sKseg[jr] == sQseg[ic];
            }
            const float pv = ok ? __expf(st[n][e] * p.scale - sLse[ic]) : 0.f;
            dpt[n][e] = pv * (dpt[n][e] - sDelta[ic]) * p.scale;
            st[n][e] = pv;
          }
        }
        uint32_t pf[NQ / 2][4], df[NQ / 2][4];
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          pf[n / 2][(n & 1) * 2 + 0] = pack_f32(st[n][0], st[n][1]);
          pf[n / 2][(n & 1) * 2 + 1] = pack_f32(st[n][2], st[n][3]);
          df[n / 2][(n & 1) * 2 + 0] = pack_f32(dpt[n][0], dpt[n][1]);
          df[n / 2][(n & 1) * 2 + 1] = pack_f32(dpt[n][2], dpt[n][3]);
        }

        // dV += P^T.dO and dK += dS^T.Q (contraction over the q tile)
#pragma unroll
        for (int kk = 0; kk < NQ / 2; ++kk) {
#pragma unroll
          for (int dn = 0; dn < DT; dn += 2) {
            const int off = (kk * 16 + (lane & 15)) * LD + dn * 8 + (lane >> 4) * 8;
            uint32_t bo[4], bq[4];
            ldsm_x4_trans(bo, sdO + off);
            ldsm_x4_trans(bq, sQ + off);
            mma_bf16(dv[dn], pf[kk], bo[0], bo[1]);
            mma_bf16(dv[dn + 1], pf[kk], bo[2], bo[3]);
            mma_bf16(dk[dn], df[kk], bq[0], bq[1]);
            mma_bf16(dk[dn + 1], df[kk], bq[2], bq[3]);
          }
        }

        if constexpr (kFused) {
          // dS to shared memory as [q row][kv row], then dQ[32 x D] += dS.K:
          // warp w forms rows 16 (w & 1).. and columns (w >> 1) D/2..
#pragma unroll
          for (int n = 0; n < NQ; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sdS[(n * 8 + t * 2 + (e & 1)) * LDS + r0 + g + ((e >> 1) << 3)] =
                  __float2bfloat16_rn(dpt[n][e]);
          __syncthreads();
          constexpr int CT = D / 16;  // n-tiles of a warp's dQ columns
          const int m0 = (warp & 1) * 16, c0 = (warp >> 1) * (D / 2);
          float dqa[CT][4];
#pragma unroll
          for (int dn = 0; dn < CT; ++dn)
#pragma unroll
            for (int e = 0; e < 4; ++e) dqa[dn][e] = 0.f;
#pragma unroll
          for (int kk = 0; kk < kKvTile / 16; ++kk) {
            uint32_t a[4];
            const bf16* sb = sdS + (m0 + g) * LDS + kk * 16 + t * 2;
            a[0] = *reinterpret_cast<const uint32_t*>(sb);
            a[1] = *reinterpret_cast<const uint32_t*>(sb + 8 * LDS);
            a[2] = *reinterpret_cast<const uint32_t*>(sb + 8);
            a[3] = *reinterpret_cast<const uint32_t*>(sb + 8 * LDS + 8);
#pragma unroll
            for (int dn = 0; dn < CT; dn += 2) {
              uint32_t bk[4];
              ldsm_x4_trans(bk, sK + (kk * 16 + (lane & 15)) * LD + c0 + dn * 8 +
                                    (lane >> 4) * 8);
              mma_bf16(dqa[dn], a, bk[0], bk[1]);
              mma_bf16(dqa[dn + 1], a, bk[2], bk[3]);
            }
          }
          const long long row_stride = (long long)p.hq * D;
          float* dqg = static_cast<float*>(p.dq) +
                       ((long long)b * p.sq + q0) * row_stride + (long long)h * D + c0;
          const int lo = m0 + g, hi = lo + 8;
#pragma unroll
          for (int dn = 0; dn < CT; ++dn) {
            const int c = dn * 8 + t * 2;
            if (q0 + lo < p.sq) {
              atomicAdd(dqg + lo * row_stride + c, dqa[dn][0]);
              atomicAdd(dqg + lo * row_stride + c + 1, dqa[dn][1]);
            }
            if (q0 + hi < p.sq) {
              atomicAdd(dqg + hi * row_stride + c, dqa[dn][2]);
              atomicAdd(dqg + hi * row_stride + c + 1, dqa[dn][3]);
            }
          }
        }
      }
    }
  }

  // dK, dV rows of the tile (zeros past kv_valid_len)
  const long long row_stride = (long long)p.hkv * D;
  bf16* dkg = static_cast<bf16*>(p.dk) + (long long)b * p.skv * row_stride + (long long)hk * D;
  bf16* dvg = static_cast<bf16*>(p.dv) + (long long)b * p.skv * row_stride + (long long)hk * D;
  const int j_lo = k0 + r0 + g, j_hi = j_lo + 8;
#pragma unroll
  for (int dn = 0; dn < DT; ++dn) {
    const int c = dn * 8 + t * 2;
    if (j_lo < p.skv) {
      *reinterpret_cast<uint32_t*>(dkg + j_lo * row_stride + c) = pack_f32(dk[dn][0], dk[dn][1]);
      *reinterpret_cast<uint32_t*>(dvg + j_lo * row_stride + c) = pack_f32(dv[dn][0], dv[dn][1]);
    }
    if (j_hi < p.skv) {
      *reinterpret_cast<uint32_t*>(dkg + j_hi * row_stride + c) = pack_f32(dk[dn][2], dk[dn][3]);
      *reinterpret_cast<uint32_t*>(dvg + j_hi * row_stride + c) = pack_f32(dv[dn][2], dv[dn][3]);
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// float32: one warp per (kv row, kv head, batch row), each lane holding D/32
// of the row's columns; the warp walks every q row of the group that can see
// the key. kFused also adds ds * k into the f32 dQ buffer with atomics. A
// plain CUDA-core kernel for completeness: training runs bf16.
template <int D, bool kFused>
__global__ void __launch_bounds__(kBwdThreads) bwd_kv_row_f32(BwdParams p) {
  constexpr int E = D / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x * (kBwdThreads / 32) + warp;
  const int hk = blockIdx.y, b = blockIdx.z;
  if (j >= p.skv) return;
  const int group = p.hq / p.hkv;
  const long long q_off = p.meta[0], k_off = p.meta[1];
  const int kv_len = min(max(p.meta[2], 0), p.skv);

  float dk[E], dv[E], kr[E], vr[E];
#pragma unroll
  for (int e = 0; e < E; ++e) dk[e] = dv[e] = 0.f;
  if (j < kv_len) {
    const float* krow = static_cast<const float*>(p.k) + b * p.k_sb + j * p.k_ss + (long long)hk * D;
    const float* vrow = static_cast<const float*>(p.v) + b * p.v_sb + j * p.v_ss + (long long)hk * D;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      kr[e] = krow[lane + 32 * e];
      vr[e] = vrow[lane + 32 * e];
    }
    const int ks = p.kseg ? p.kseg[b * p.kseg_sb + j] : 0;
    int i_begin = 0;
    if (p.causal) {
      const long long first = k_off + j - q_off;
      i_begin = first <= 0 ? 0 : (int)min(first, (long long)p.sq);
    }
    for (int hh = 0; hh < group; ++hh) {
      const int h = hk * group + hh;
      const long long stat = ((long long)b * p.hq + h) * p.sq;
      for (int i = i_begin; i < p.sq; ++i) {
        if (p.qseg && p.qseg[b * p.qseg_sb + i] != ks) continue;
        const float* qrow = static_cast<const float*>(p.q) + b * p.q_sb + i * p.q_ss + (long long)h * D;
        const float* orow = static_cast<const float*>(p.dout) + b * p.do_sb + i * p.do_ss + (long long)h * D;
        float qv[E], ov[E], s = 0.f, dp = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          qv[e] = qrow[lane + 32 * e];
          ov[e] = orow[lane + 32 * e];
          s += qv[e] * kr[e];
          dp += ov[e] * vr[e];
        }
        s = warp_sum(s);
        dp = warp_sum(dp);
        const float pv = expf(s * p.scale - p.lse[stat + i]);
        const float ds = pv * (dp - p.delta[stat + i]) * p.scale;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          dv[e] += pv * ov[e];
          dk[e] += ds * qv[e];
        }
        if constexpr (kFused) {
          float* dqrow = static_cast<float*>(p.dq) + (((long long)b * p.sq + i) * p.hq + h) * D;
#pragma unroll
          for (int e = 0; e < E; ++e) atomicAdd(dqrow + lane + 32 * e, ds * kr[e]);
        }
      }
    }
  }
  const long long out = (((long long)b * p.skv + j) * p.hkv + hk) * D;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    static_cast<float*>(p.dk)[out + lane + 32 * e] = dk[e];
    static_cast<float*>(p.dv)[out + lane + 32 * e] = dv[e];
  }
}

template <int D, bool kFused>
cudaError_t launch_kv_tile(const BwdParams& p, int batch, int dtype, cudaStream_t stream) {
  if (dtype == 0) {
    constexpr int smem = kv_tile_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        bwd_kv_tile_bf16<D, kFused>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((p.skv + kKvTile - 1) / kKvTile, p.hkv, batch);
    bwd_kv_tile_bf16<D, kFused><<<grid, kBwdThreads, smem, stream>>>(p);
  } else {
    const int rows = kBwdThreads / 32;
    dim3 grid((p.skv + rows - 1) / rows, p.hkv, batch);
    bwd_kv_row_f32<D, kFused><<<grid, kBwdThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

// dtype: 0 = bfloat16, 1 = float32; D: 64 or 128.
template <bool kFused>
cudaError_t launch_kv_tile_any(const BwdParams& p, int batch, int d, int dtype,
                               cudaStream_t stream) {
  if (p.skv <= 0 || batch <= 0) return cudaSuccess;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (d == 128) return launch_kv_tile<128, kFused>(p, batch, dtype, stream);
  if (d == 64) return launch_kv_tile<64, kFused>(p, batch, dtype, stream);
  return cudaErrorInvalidValue;
}

}  // namespace lvt
