// Host-side image preprocessing feedworker: the port's own copy of
// native/preprocess.cpp (the JAX package's), the same code.
//
// Replaces the reference's in-dataloader decode+resize path (SURVEY.md
// N6: decord/PIL/cv2 inside dataloader workers,
// long_vita/data/processor/image_processor.py:180-223). At 4096 frames per
// sample the Python per-frame overhead and the GIL cap ingestion well below
// what a 1M-token prefill needs; this library batch-processes decoded RGB
// frames with its own thread pool:
//
//   uint8 [N, H, W, 3] -> expand2square (mean color) -> antialiased bicubic
//   resize to [S, S] -> scale to [0,1] -> normalize (mean/std)
//   -> float32 [N, S, S, 3] (NHWC)
//
// The resampler matches PIL.Image.resize(BICUBIC) float-mode semantics
// exactly (separable Keys cubic a=-0.5 with filter support scaled by the
// reduction ratio); uint8-mode PIL additionally quantizes weights to 8-bit
// fixed point, so outputs agree with the reference Python path to ~1 LSB.
//
// The square padding is folded into the filter tables algebraically: taps
// that fall into the padded border contribute weight * mean-color, so the
// padded image is never materialized and no arithmetic is spent on it.
//
// Built by long_vita_tpu_torch/data/native.py at first use (g++, no deps).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Keys cubic kernel, a = -0.5 (PIL's bicubic filter).
inline double cubic(double x) {
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

// Per-output-pixel taps over a virtual padded axis of length `padded`,
// where the real data spans [off, off + real). Taps outside the real span
// collapse into bg_weight (they hit the constant pad color).
struct PaddedFilter {
  int ksize;
  std::vector<int> bounds;      // [out] first REAL input index
  std::vector<int> counts;      // [out] number of real taps
  std::vector<float> coef;      // [out * ksize]
  std::vector<float> bg_weight; // [out] weight hitting the pad color
};

PaddedFilter make_filter(int padded, int out_size, int off, int real) {
  const double scale = static_cast<double>(padded) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 2.0 * filterscale;  // bicubic support
  const int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;

  PaddedFilter f;
  f.ksize = ksize;
  f.bounds.resize(out_size);
  f.counts.resize(out_size);
  f.coef.assign(static_cast<size_t>(out_size) * ksize, 0.0f);
  f.bg_weight.assign(out_size, 0.0f);

  std::vector<double> w(ksize);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > padded) xmax = padded;
    const int n = xmax - xmin;

    double total = 0.0;
    for (int i = 0; i < n; ++i) {
      w[i] = cubic((xmin + i - center + 0.5) / filterscale);
      total += w[i];
    }
    if (total == 0.0) total = 1.0;

    // split taps into real-span vs padding
    const int lo = std::max(xmin, off);
    const int hi = std::min(xmax, off + real);
    double bg = 0.0;
    for (int i = 0; i < n; ++i) {
      const int xi = xmin + i;
      if (xi < lo || xi >= hi) bg += w[i];
    }
    f.bounds[xx] = std::max(lo - off, 0);
    f.counts[xx] = std::max(hi - lo, 0);
    float* dst = &f.coef[static_cast<size_t>(xx) * ksize];
    for (int i = 0; i < f.counts[xx]; ++i) {
      dst[i] = static_cast<float>(w[(lo - xmin) + i] / total);
    }
    f.bg_weight[xx] = static_cast<float>(bg / total);
  }
  return f;
}

// ---- fixed-point (PIL uint8-mode) resampler -------------------------------
//
// PIL's uint8 path quantizes filter weights to int32 at 2^22 scale
// (Resample.c PRECISION_BITS = 32-8-2), accumulates in int32 with a
// rounding bias, and CLIPS THE INTERMEDIATE image to uint8 between the
// horizontal and vertical passes. Reproducing those three choices exactly
// makes this path BIT-EXACT against the reference's actual pipeline
// (PIL.Image.resize(BICUBIC) on uint8, image_processor.py:180-223) — the
// float path above matches PIL's float mode instead (~1 LSB off uint8 PIL).
// It is also the fast path: uint8 intermediates halve memory traffic and
// the int32 inner loops autovectorize.

constexpr int kPrecisionBits = 22;  // PIL: 32 - 8 - 2
constexpr int32_t kRound = 1 << (kPrecisionBits - 1);

inline uint8_t clip8(int32_t in) {
  if (in >= (255 << kPrecisionBits)) return 255;
  if (in <= 0) return 0;
  return static_cast<uint8_t>(in >> kPrecisionBits);
}

struct PaddedFilterI32 {
  int ksize;
  std::vector<int> bounds;        // [out] first REAL input index
  std::vector<int> counts;        // [out] number of real taps
  std::vector<int32_t> coef;      // [out * ksize] quantized real taps
  std::vector<int32_t> bg_coef;   // [out] quantized pad-tap sum
  std::vector<int32_t> all_coef;  // [out] quantized sum of ALL taps
};

// Same tap geometry as make_filter, but with PIL's per-tap int32
// quantization. bg_coef folds the taps that hit the expand2square border
// (their quantized sum times the pad color is bit-identical to PIL
// resizing the materialized padded image); all_coef reproduces a fully
// padded row/column.
PaddedFilterI32 make_filter_i32(int padded, int out_size, int off, int real) {
  const double scale = static_cast<double>(padded) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 2.0 * filterscale;
  const int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;

  PaddedFilterI32 f;
  f.ksize = ksize;
  f.bounds.resize(out_size);
  f.counts.resize(out_size);
  f.coef.assign(static_cast<size_t>(out_size) * ksize, 0);
  f.bg_coef.assign(out_size, 0);
  f.all_coef.assign(out_size, 0);

  std::vector<double> w(ksize);
  std::vector<int32_t> q(ksize);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > padded) xmax = padded;
    const int n = xmax - xmin;

    double total = 0.0;
    for (int i = 0; i < n; ++i) {
      w[i] = cubic((xmin + i - center + 0.5) / filterscale);
      total += w[i];
    }
    if (total == 0.0) total = 1.0;
    int32_t all = 0;
    for (int i = 0; i < n; ++i) {
      const double v = w[i] / total * (1 << kPrecisionBits);
      q[i] = static_cast<int32_t>(v < 0 ? v - 0.5 : v + 0.5);  // PIL rounding
      all += q[i];
    }

    const int lo = std::max(xmin, off);
    const int hi = std::min(xmax, off + real);
    int32_t bg = 0;
    for (int i = 0; i < n; ++i) {
      const int xi = xmin + i;
      if (xi < lo || xi >= hi) bg += q[i];
    }
    f.bounds[xx] = std::max(lo - off, 0);
    f.counts[xx] = std::max(hi - lo, 0);
    int32_t* dst = &f.coef[static_cast<size_t>(xx) * ksize];
    for (int i = 0; i < f.counts[xx]; ++i) dst[i] = q[(lo - xmin) + i];
    f.bg_coef[xx] = bg;
    f.all_coef[xx] = all;
  }
  return f;
}

}  // namespace

extern "C" {

// frames: uint8 [n, h, w, 3]; out: float32 [n, out_size, out_size, 3].
// mean/std: per-channel (0..1 scale). num_threads <= 0 -> hardware.
// square_pad != 0: expand2square with the mean color before resizing
// (reference image_processor.py:190-201 semantics).
void preprocess_frames(const uint8_t* frames, int n, int h, int w,
                       float* out, int out_size, const float* mean,
                       const float* stddev, int num_threads,
                       int square_pad) {
  const bool pad = square_pad != 0 && h != w;
  const int side = pad ? std::max(h, w) : 0;
  const int off_x = pad ? (side - w) / 2 : 0;
  const int off_y = pad ? (side - h) / 2 : 0;
  const PaddedFilter fh = make_filter(pad ? side : w, out_size, off_x, w);
  const PaddedFilter fv = make_filter(pad ? side : h, out_size, off_y, h);

  // pad color in PIL is uint8-quantized mean*255
  float bg[3];
  float scale[3], shift[3];
  for (int c = 0; c < 3; ++c) {
    bg[c] = static_cast<float>(static_cast<uint8_t>(mean[c] * 255.0));
    scale[c] = (1.0f / 255.0f) / stddev[c];
    shift[c] = -mean[c] / stddev[c];
  }

  int threads = num_threads > 0
                    ? num_threads
                    : static_cast<int>(std::thread::hardware_concurrency());
  threads = std::max(1, std::min(threads, n));

  std::atomic<int> next(0);
  auto worker = [&]() {
    // planar buffers keep every inner loop contiguous (vectorizable):
    // deinterleave -> vertical (real rows) -> horizontal -> interleave
    std::vector<float> plane(static_cast<size_t>(h) * w);         // one channel
    std::vector<float> vpass(static_cast<size_t>(out_size) * w);  // [out, w]
    std::vector<float> hout(static_cast<size_t>(out_size) * out_size);
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      const uint8_t* src = frames + static_cast<size_t>(i) * h * w * 3;
      float* dst = out + static_cast<size_t>(i) * out_size * out_size * 3;

      for (int c = 0; c < 3; ++c) {
        // ---- deinterleave channel c to float
        const size_t npx = static_cast<size_t>(h) * w;
        for (size_t p = 0; p < npx; ++p) plane[p] = src[p * 3 + c];

        // ---- vertical resample: [h, w] -> [out, w], contiguous over x
        for (int y = 0; y < out_size; ++y) {
          const float* wgt = &fv.coef[static_cast<size_t>(y) * fv.ksize];
          const int y0 = fv.bounds[y];
          const int cnt = fv.counts[y];
          float* __restrict orow = &vpass[static_cast<size_t>(y) * w];
          const float init = fv.bg_weight[y] * bg[c];
          for (int x = 0; x < w; ++x) orow[x] = init;
          for (int t = 0; t < cnt; ++t) {
            const float cw = wgt[t];
            const float* __restrict irow = &plane[static_cast<size_t>(y0 + t) * w];
            for (int x = 0; x < w; ++x) orow[x] += cw * irow[x];
          }
        }

        // ---- horizontal resample: [out, w] -> [out, out]
        for (int y = 0; y < out_size; ++y) {
          const float* irow = &vpass[static_cast<size_t>(y) * w];
          float* orow = &hout[static_cast<size_t>(y) * out_size];
          for (int x = 0; x < out_size; ++x) {
            const float* wgt = &fh.coef[static_cast<size_t>(x) * fh.ksize];
            const float* p = irow + fh.bounds[x];
            const int cnt = fh.counts[x];
            float acc = fh.bg_weight[x] * bg[c];
            for (int t = 0; t < cnt; ++t) acc += wgt[t] * p[t];
            orow[x] = acc;
          }
        }

        // ---- interleave + normalize
        const size_t opx = static_cast<size_t>(out_size) * out_size;
        const float sc = scale[c], sh = shift[c];
        for (size_t p = 0; p < opx; ++p) dst[p * 3 + c] = hout[p] * sc + sh;
      }
    }
  };

  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
}

// Fixed-point variant of preprocess_frames: BIT-EXACT against the
// reference's uint8 PIL pipeline (expand2square -> Image.resize(BICUBIC)
// -> /255 -> normalize) and faster (uint8 intermediates, int32 SIMD-able
// inner loops). Same signature/semantics as preprocess_frames otherwise.
// PIL resamples horizontal-then-vertical with a uint8-clipped intermediate;
// this does the same, with the padded border folded into the filter tables.
void preprocess_frames_u8(const uint8_t* frames, int n, int h, int w,
                          float* out, int out_size, const float* mean,
                          const float* stddev, int num_threads,
                          int square_pad) {
  const bool pad = square_pad != 0 && h != w;
  const int side = pad ? std::max(h, w) : 0;
  const int off_x = pad ? (side - w) / 2 : 0;
  const int off_y = pad ? (side - h) / 2 : 0;
  const PaddedFilterI32 fh = make_filter_i32(pad ? side : w, out_size, off_x, w);
  const PaddedFilterI32 fv = make_filter_i32(pad ? side : h, out_size, off_y, h);

  int32_t bgi[3];
  float scale[3], shift[3];
  for (int c = 0; c < 3; ++c) {
    bgi[c] = static_cast<int32_t>(static_cast<uint8_t>(mean[c] * 255.0));
    scale[c] = (1.0f / 255.0f) / stddev[c];
    shift[c] = -mean[c] / stddev[c];
  }

  // a fully-padded row after the horizontal pass (what PIL gets from
  // horizontally resampling an all-background row of the padded image)
  std::vector<uint8_t> hrow_bg(static_cast<size_t>(out_size) * 3);
  for (int x = 0; x < out_size; ++x) {
    for (int c = 0; c < 3; ++c) {
      hrow_bg[static_cast<size_t>(x) * 3 + c] =
          clip8(kRound + fh.all_coef[x] * bgi[c]);
    }
  }

  int threads = num_threads > 0
                    ? num_threads
                    : static_cast<int>(std::thread::hardware_concurrency());
  threads = std::max(1, std::min(threads, n));

  std::atomic<int> next(0);
  auto worker = [&]() {
    // horizontal intermediate: real rows only, interleaved RGB uint8
    std::vector<uint8_t> hbuf(static_cast<size_t>(h) * out_size * 3);
    std::vector<int32_t> acc(static_cast<size_t>(out_size) * 3);
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      const uint8_t* src = frames + static_cast<size_t>(i) * h * w * 3;
      float* dst = out + static_cast<size_t>(i) * out_size * out_size * 3;

      // ---- horizontal: [h, w, 3] -> [h, out, 3]
      for (int y = 0; y < h; ++y) {
        const uint8_t* irow = src + static_cast<size_t>(y) * w * 3;
        uint8_t* orow = &hbuf[static_cast<size_t>(y) * out_size * 3];
        for (int x = 0; x < out_size; ++x) {
          const int32_t* wgt = &fh.coef[static_cast<size_t>(x) * fh.ksize];
          const uint8_t* p = irow + static_cast<size_t>(fh.bounds[x]) * 3;
          const int cnt = fh.counts[x];
          int32_t a0 = kRound + fh.bg_coef[x] * bgi[0];
          int32_t a1 = kRound + fh.bg_coef[x] * bgi[1];
          int32_t a2 = kRound + fh.bg_coef[x] * bgi[2];
          for (int t = 0; t < cnt; ++t) {
            const int32_t k = wgt[t];
            a0 += k * p[t * 3 + 0];
            a1 += k * p[t * 3 + 1];
            a2 += k * p[t * 3 + 2];
          }
          orow[x * 3 + 0] = clip8(a0);
          orow[x * 3 + 1] = clip8(a1);
          orow[x * 3 + 2] = clip8(a2);
        }
      }

      // ---- vertical: [h, out, 3] (+ bg rows) -> [out, out, 3] + normalize
      const int row_elems = out_size * 3;
      for (int y = 0; y < out_size; ++y) {
        const int32_t bgw = fv.bg_coef[y];
        const uint8_t* __restrict bgrow = hrow_bg.data();
        for (int j = 0; j < row_elems; ++j) acc[j] = kRound + bgw * bgrow[j];
        const int32_t* wgt = &fv.coef[static_cast<size_t>(y) * fv.ksize];
        const int y0 = fv.bounds[y];
        const int cnt = fv.counts[y];
        for (int t = 0; t < cnt; ++t) {
          const int32_t k = wgt[t];
          const uint8_t* __restrict irow =
              &hbuf[static_cast<size_t>(y0 + t) * row_elems];
          int32_t* __restrict a = acc.data();
          for (int j = 0; j < row_elems; ++j) a[j] += k * irow[j];
        }
        float* orow = dst + static_cast<size_t>(y) * row_elems;
        for (int x = 0; x < out_size; ++x) {
          for (int c = 0; c < 3; ++c) {
            orow[x * 3 + c] =
                clip8(acc[static_cast<size_t>(x) * 3 + c]) * scale[c] +
                shift[c];
          }
        }
      }
    }
  };

  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
}

// Crop tiles from a resized grid image and normalize each tile.
// img: uint8 [gh*tile, gw*tile, 3]; out: float32 [gh*gw, tile, tile, 3].
void crop_tiles(const uint8_t* img, int grid_h, int grid_w, int tile,
                float* out, const float* mean, const float* stddev) {
  const int w = grid_w * tile;
  float scale[3], shift[3];
  for (int c = 0; c < 3; ++c) {
    scale[c] = (1.0f / 255.0f) / stddev[c];
    shift[c] = -mean[c] / stddev[c];
  }
  for (int gy = 0; gy < grid_h; ++gy) {
    for (int gx = 0; gx < grid_w; ++gx) {
      float* dst =
          out + (static_cast<size_t>(gy) * grid_w + gx) * tile * tile * 3;
      for (int y = 0; y < tile; ++y) {
        const uint8_t* row = img + (static_cast<size_t>(gy * tile + y) * w +
                                    static_cast<size_t>(gx) * tile) *
                                       3;
        for (int x = 0; x < tile; ++x) {
          for (int c = 0; c < 3; ++c) {
            dst[(static_cast<size_t>(y) * tile + x) * 3 + c] =
                row[x * 3 + c] * scale[c] + shift[c];
          }
        }
      }
    }
  }
}

}  // extern "C"
