// w4a16 matrix product (K6) for Hopper (sm_90a), bound to Python through a
// plain C entry point (lvt_w4_matmul) and ctypes.
//
// Replaces: the Pallas TPU kernels `_w4_matmul_pallas_u`
// (long_vita_tpu/ops/quant_matmul.py:132, pallas_call :173) and
// `_w4_matmul_pallas` (:187, pallas_call :237), two tilings of one function
// that `w4_matmul` (:259) routes row counts <= 512 to. What it computes:
// out = sum_g s_g * (x_g @ q_g) for x [rows, in] (bf16, or f32), q the int4
// weight [in, out] packed split-half into int8 [in/2, out] (the low nibble of
// byte p holds row p, the high nibble row in/2 + p) and f32 scales
// [in/128, out], one per (128-row input group, output column); each group's
// dot is taken with f32 accumulation and scaled after it (the top-half group
// g and the bottom-half group G/2 + g, as at :168-170), the sum is f32 and is
// cast once to the output dtype (bf16 for the projections, f32 for the head).
//
// What bounds it on the H100: at decode row counts (1-8 rows) the packed
// weight is read once and used for a handful of products, so the kernel is
// bound by bytes: q_proj at one row reads 13.1 MB of codes and 0.8 MB of
// scales, 4.2 us at 3.35 TB/s; one decode step's projections and head read
// 7.43 GB, a floor of 2.2 ms. From about 74 rows up the tensor cores bound
// it. The design:
//   - every packed byte is read from device memory once per 64-row block of
//     x, as 16-byte loads along the output dimension (coalesced), and split
//     into its two nibbles in registers with a byte permute, a mask and one
//     bf16x2 subtract (0x4300 | (n ^ 8) is the bf16 of 136 + n);
//   - the unpacked group (128 rows of each half, 64 columns) is staged in
//     shared memory as bf16 [k][n], from which ldmatrix .trans gives the B
//     fragments of mma.sync m16n8k16 (bf16, f32 accumulators); x's A
//     fragments are read from device memory (x is small and cached);
//   - a block owns 64 output columns, its 4 warps 16 each, and a range of
//     groups: the wrapper splits the groups over ksplit blocks so that even
//     k_proj (out 1024, 16 column tiles) puts several blocks on every SM.
//     Split blocks write f32 partials and a second kernel adds them in a
//     fixed order, so two runs give the same bits (no atomics);
//   - the next group's packed bytes are loaded into registers while the
//     current group's products run.
// f32 activations take a CUDA-core kernel (f32 products, the same group
// order); it exists for the checks against the f32 plain version.
// TMA, wgmma and a deeper shared-memory pipeline are left for later.

#include "mma_util.cuh"

namespace {

using namespace lvt;

constexpr int kGroup = 128;  // input rows per scale group
constexpr int kBN = 64;      // output columns per block
constexpr int kBM = 64;      // x rows per block (4 row tiles of 16)
constexpr int kWarps = 4;    // warp w owns columns 16w .. 16w + 15 of the block
constexpr int kThreads = kWarps * 32;
constexpr int LDS = kBN + 8;  // padded shared row (bf16), 144 bytes
constexpr int kVecPerRow = kBN / 16;                          // 16-byte packed vectors per row
constexpr int kVecPerThread = kGroup * kVecPerRow / kThreads;  // 4

__device__ __forceinline__ uint32_t nibbles_to_bf16x2(uint32_t v) {
  // v holds two nibbles at bits 0-3 and 16-19 (two's complement int4):
  // (n ^ 8) | 0x4300 is the bf16 of 128 + (n + 8); minus 136 gives n exactly
  const uint32_t biased = (v & 0x000F000Fu) ^ 0x43084308u;
  __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&biased);
  const __nv_bfloat162 off = __floats2bfloat162_rn(136.f, 136.f);
  b = __hsub2(b, off);
  return *reinterpret_cast<uint32_t*>(&b);
}

// 16 packed bytes (columns c .. c + 15 of one packed row) -> 16 top-half and
// 16 bottom-half bf16 values, in column order, stored to two shared rows
__device__ __forceinline__ void unpack_store(const uint4& pk, __nv_bfloat16* top,
                                             __nv_bfloat16* bot) {
  const uint32_t w[4] = {pk.x, pk.y, pk.z, pk.w};
  uint32_t t[8], b[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = __byte_perm(w[i], 0u, 0x4140);  // bytes 0, 1 -> halves 0, 1
    const uint32_t hi = __byte_perm(w[i], 0u, 0x4342);  // bytes 2, 3 -> halves 0, 1
    t[2 * i] = nibbles_to_bf16x2(lo);
    t[2 * i + 1] = nibbles_to_bf16x2(hi);
    b[2 * i] = nibbles_to_bf16x2(lo >> 4);
    b[2 * i + 1] = nibbles_to_bf16x2(hi >> 4);
  }
  reinterpret_cast<uint4*>(top)[0] = make_uint4(t[0], t[1], t[2], t[3]);
  reinterpret_cast<uint4*>(top)[1] = make_uint4(t[4], t[5], t[6], t[7]);
  reinterpret_cast<uint4*>(bot)[0] = make_uint4(b[0], b[1], b[2], b[3]);
  reinterpret_cast<uint4*>(bot)[1] = make_uint4(b[4], b[5], b[6], b[7]);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_f32(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) { *p = __float2bfloat16_rn(a); }

__device__ __forceinline__ void store1(float* p, float a) { *p = a; }

struct Params {
  const __nv_bfloat16* x;  // [rows, n_in]
  const int8_t* packed;    // [n_in / 2, n_out]
  const float* scales;     // [n_in / 128, n_out]
  void* out;               // [rows, n_out], OutT
  float* ws;               // [ksplit, rows, n_out] partials when ksplit > 1
  int rows, n_in, n_out, ksplit;
};

// A fragment (16 rows x 16 columns at column kc) of x; rows past `rows` are 0
__device__ __forceinline__ void load_a(uint32_t a[4], const __nv_bfloat16* x, int n_in,
                                       int rows, int r0, int kc, int g, int t) {
  const int ra = r0 + g, rb = r0 + g + 8;
  const __nv_bfloat16* pa = x + (long long)ra * n_in + kc + 2 * t;
  const __nv_bfloat16* pb = x + (long long)rb * n_in + kc + 2 * t;
  a[0] = ra < rows ? __ldg(reinterpret_cast<const unsigned int*>(pa)) : 0u;
  a[1] = rb < rows ? __ldg(reinterpret_cast<const unsigned int*>(pb)) : 0u;
  a[2] = ra < rows ? __ldg(reinterpret_cast<const unsigned int*>(pa + 8)) : 0u;
  a[3] = rb < rows ? __ldg(reinterpret_cast<const unsigned int*>(pb + 8)) : 0u;
}

// this thread's share of one group's packed rows [grp * 128, grp * 128 + 128)
// x the block's 64 columns, as 16-byte vectors
__device__ __forceinline__ void load_group(uint4 (&pre)[kVecPerThread], const Params& p,
                                           int grp, int n0, int tid) {
#pragma unroll
  for (int i = 0; i < kVecPerThread; ++i) {
    const int v = tid + i * kThreads;
    const int r = v / kVecPerRow, c = (v % kVecPerRow) * 16;
    pre[i] = __ldg(reinterpret_cast<const uint4*>(
        p.packed + (long long)(grp * kGroup + r) * p.n_out + n0 + c));
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads, 3) w4_mma_kernel(Params p) {
  __shared__ __align__(16) __nv_bfloat16 sTop[kGroup * LDS];
  __shared__ __align__(16) __nv_bfloat16 sBot[kGroup * LDS];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kBN;
  const int split = blockIdx.y;
  const int r_base = blockIdx.z * kBM;
  const int half = p.n_in / 2;
  const int half_groups = half / kGroup;
  const int g0 = split * half_groups / p.ksplit;
  const int g1 = (split + 1) * half_groups / p.ksplit;
  const int mt = min(kBM, p.rows - r_base + 15) / 16;  // active row tiles (<= 4)
  const int wc = warp * 16;                            // the warp's columns in the block

  float acc[4][2][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  uint4 pre[kVecPerThread];
  if (g0 < g1) load_group(pre, p, g0, n0, tid);

  for (int grp = g0; grp < g1; ++grp) {
    __syncthreads();  // the previous group's products are done with the tiles
#pragma unroll
    for (int i = 0; i < kVecPerThread; ++i) {
      const int v = tid + i * kThreads;
      const int r = v / kVecPerRow, c = (v % kVecPerRow) * 16;
      unpack_store(pre[i], sTop + r * LDS + c, sBot + r * LDS + c);
    }
    if (grp + 1 < g1) load_group(pre, p, grp + 1, n0, tid);  // in flight during the products
    float2 st[2], sb[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + wc + j * 8 + 2 * t;
      st[j] = *reinterpret_cast<const float2*>(p.scales + (long long)grp * p.n_out + col);
      sb[j] = *reinterpret_cast<const float2*>(
          p.scales + (long long)(half_groups + grp) * p.n_out + col);
    }
    __syncthreads();

    const int kc_top = grp * kGroup, kc_bot = half + grp * kGroup;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if (m >= mt) break;
      float pt[2][4] = {}, pb[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < kGroup / 16; ++kk) {
        const int srow = kk * 16 + (lane & 15), scol = wc + (lane >> 4) * 8;
        uint32_t a[4], b[4];
        load_a(a, p.x, p.n_in, p.rows, r_base + 16 * m, kc_top + kk * 16, g, t);
        ldsm_x4_trans(b, sTop + srow * LDS + scol);
        mma_bf16(pt[0], a, b[0], b[1]);
        mma_bf16(pt[1], a, b[2], b[3]);
        load_a(a, p.x, p.n_in, p.rows, r_base + 16 * m, kc_bot + kk * 16, g, t);
        ldsm_x4_trans(b, sBot + srow * LDS + scol);
        mma_bf16(pb[0], a, b[0], b[1]);
        mma_bf16(pb[1], a, b[2], b[3]);
      }
      // the group's dots, scaled after the dot and added in the plain
      // version's order: acc + pt * s_top + pb * s_bottom
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        acc[m][j][0] = acc[m][j][0] + pt[j][0] * st[j].x + pb[j][0] * sb[j].x;
        acc[m][j][1] = acc[m][j][1] + pt[j][1] * st[j].y + pb[j][1] * sb[j].y;
        acc[m][j][2] = acc[m][j][2] + pt[j][2] * st[j].x + pb[j][2] * sb[j].x;
        acc[m][j][3] = acc[m][j][3] + pt[j][3] * st[j].y + pb[j][3] * sb[j].y;
      }
    }
  }

#pragma unroll
  for (int m = 0; m < 4; ++m) {
    if (m >= mt) break;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + wc + j * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r_base + 16 * m + g + 8 * h;
        if (row >= p.rows) continue;
        const float v0 = acc[m][j][2 * h], v1 = acc[m][j][2 * h + 1];
        if (p.ksplit == 1) {
          store2(static_cast<OutT*>(p.out) + (long long)row * p.n_out + col, v0, v1);
        } else {
          store2(p.ws + ((long long)split * p.rows + row) * p.n_out + col, v0, v1);
        }
      }
    }
  }
}

// out[i] = sum over s = 0 .. ksplit - 1 of ws[s][i], in that order
template <typename OutT>
__global__ void w4_reduce_kernel(const float* ws, OutT* out, int ksplit, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = ws[i];
    for (int k = 1; k < ksplit; ++k) s += ws[k * n + i];
    store1(out + i, s);
  }
}

// f32 activations: one thread per output column and 8 rows, f32 products,
// the groups in the plain version's order
constexpr int kF32Rows = 8;

template <typename OutT>
__global__ void w4_f32_kernel(const float* x, const int8_t* packed, const float* scales,
                              OutT* out, int rows, int n_in, int n_out) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int r0 = blockIdx.y * kF32Rows;
  if (col >= n_out) return;
  const int nr = min(kF32Rows, rows - r0);
  const int half = n_in / 2, half_groups = half / kGroup;
  float acc[kF32Rows] = {};
  for (int grp = 0; grp < half_groups; ++grp) {
    float pt[kF32Rows] = {}, pb[kF32Rows] = {};
    for (int k = 0; k < kGroup; ++k) {
      const int kr = grp * kGroup + k;
      const int v = packed[(long long)kr * n_out + col];  // sign-extended byte
      const float top = (float)(((v & 0xF) ^ 8) - 8);
      const float bot = (float)((((v >> 4) & 0xF) ^ 8) - 8);
#pragma unroll
      for (int r = 0; r < kF32Rows; ++r) {
        if (r < nr) {
          const float* xr = x + (long long)(r0 + r) * n_in;
          pt[r] += xr[kr] * top;
          pb[r] += xr[half + kr] * bot;
        }
      }
    }
    const float st = scales[(long long)grp * n_out + col];
    const float sb = scales[(long long)(half_groups + grp) * n_out + col];
#pragma unroll
    for (int r = 0; r < kF32Rows; ++r) acc[r] = acc[r] + pt[r] * st + pb[r] * sb;
  }
  for (int r = 0; r < nr; ++r) store1(out + (long long)(r0 + r) * n_out + col, acc[r]);
}

template <typename OutT>
int launch(const void* x, const int8_t* packed, const float* scales, void* out, float* ws,
           int rows, int n_in, int n_out, int ksplit, int x_f32, cudaStream_t stream) {
  if (x_f32) {
    dim3 grid((n_out + 127) / 128, (rows + kF32Rows - 1) / kF32Rows);
    w4_f32_kernel<OutT><<<grid, 128, 0, stream>>>(
        static_cast<const float*>(x), packed, scales, static_cast<OutT*>(out), rows, n_in, n_out);
    return (int)cudaGetLastError();
  }
  Params p{static_cast<const __nv_bfloat16*>(x), packed, scales, out, ws, rows, n_in, n_out, ksplit};
  dim3 grid(n_out / kBN, ksplit, (rows + kBM - 1) / kBM);
  w4_mma_kernel<OutT><<<grid, kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ksplit == 1) return (int)err;
  const long long n = (long long)rows * n_out;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  w4_reduce_kernel<OutT><<<blocks, 256, 0, stream>>>(ws, static_cast<OutT*>(out), ksplit, n);
  return (int)cudaGetLastError();
}

}  // namespace

// x [rows, n_in] (bf16, or f32 when x_f32), packed int8 [n_in / 2, n_out],
// scales f32 [n_in / 128, n_out], out [rows, n_out] (bf16, or f32 when
// out_f32), ws f32 [ksplit, rows, n_out] (unused when ksplit == 1 or x_f32).
// All contiguous; n_in % 256 == 0, n_out % 64 == 0, 1 <= ksplit <= n_in / 256.
// The bf16 path launches the product kernel and, when ksplit > 1, the
// reduction; returns the first CUDA error (0 when both launched).
extern "C" int lvt_w4_matmul(const void* x, const void* packed, const void* scales, void* out,
                             void* ws, int rows, int n_in, int n_out, int ksplit, int x_f32,
                             int out_f32, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  if (n_in % (2 * kGroup) || n_out % kBN || ksplit < 1 || ksplit > n_in / (2 * kGroup) ||
      (ksplit > 1 && ws == nullptr && !x_f32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* pk = static_cast<const int8_t*>(packed);
  const float* sc = static_cast<const float*>(scales);
  float* w = static_cast<float*>(ws);
  return out_f32 ? launch<float>(x, pk, sc, out, w, rows, n_in, n_out, ksplit, x_f32, s)
                 : launch<__nv_bfloat16>(x, pk, sc, out, w, rows, n_in, n_out, ksplit, x_f32, s);
}
