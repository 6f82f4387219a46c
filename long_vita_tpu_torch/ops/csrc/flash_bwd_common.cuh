// The flash-attention backward pieces shared by the one-pass kernel K4
// (flash_bwd.cu) and the two-pass kernels K5 (flash_bwd_2pass.cu): the
// contract both compute, and the float32 CUDA-core kernels' argument block
// and kv-row kernel (dK and dV, and in the one-pass form dQ added into an f32
// buffer). The bf16 kernels are the Hopper backward of flash_bwd_sm90.cuh.
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

constexpr int kBwdThreads = 128;  // the f32 kernels: 4 warps

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

// the float32 kv-row kernel (kFused: K4's, adding into the f32 dQ sums); D: 64 or 128
template <bool kFused>
cudaError_t launch_kv_row_f32(const BwdParams& p, int batch, int d, cudaStream_t stream) {
  const int rows = kBwdThreads / 32;
  dim3 grid((p.skv + rows - 1) / rows, p.hkv, batch);
  if (d == 128) bwd_kv_row_f32<128, kFused><<<grid, kBwdThreads, 0, stream>>>(p);
  else if (d == 64) bwd_kv_row_f32<64, kFused><<<grid, kBwdThreads, 0, stream>>>(p);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace lvt
