// PIL's resampler on uint8 RGB, for the port's host data path.
//
// The port's own copy of the resampler of native/vtc_preproc.cpp: PIL's
// bicubic and bilinear filters, the per-output-pixel coefficient tables
// (antialiased on a downscale), the coefficients quantized to fixed point
// and the two passes with a uint8 clip between them (Imaging/Resample.c),
// so the output equals Image.resize bit for bit. vtc_resize_batch resizes a
// batch on a small thread pool.
//
// Built at first use by vtc_tpu_torch/ops/_build.py (g++ -O3 -shared -fPIC,
// no -march: the double-precision coefficient tables must not be contracted
// into FMAs, which PIL's build does not use), loaded with ctypes.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

// PIL-compatible filters (Imaging/Resample.c semantics).
struct Filter {
  double support;
  double (*fn)(double);
};

double bicubic_kernel(double x) {
  // Catmull-Rom style cubic with a = -0.5 (PIL's BICUBIC)
  constexpr double a = -0.5;
  x = std::abs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

double bilinear_kernel(double x) {
  x = std::abs(x);
  return x < 1.0 ? 1.0 - x : 0.0;
}

// Precomputed per-output-pixel coefficient table (PIL precompute_coeffs).
struct Coeffs {
  int ksize;
  std::vector<int> bounds;      // [out_size * 2] : (xmin, xcount)
  std::vector<double> values;   // [out_size * ksize]
};

Coeffs precompute(int in_size, int out_size, const Filter& f) {
  Coeffs c;
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = std::max(scale, 1.0);  // antialias on downscale
  double support = f.support * filterscale;
  int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;

  c.ksize = ksize;
  c.bounds.resize(out_size * 2);
  c.values.assign(static_cast<size_t>(out_size) * ksize, 0.0);

  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(std::max(0.0, std::floor(center - support)));
    int xmax = static_cast<int>(std::min(static_cast<double>(in_size),
                                         std::ceil(center + support)));
    xmax -= xmin;
    double* k = &c.values[static_cast<size_t>(xx) * ksize];
    for (int x = 0; x < xmax; ++x) {
      double w = f.fn((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    if (ww != 0.0)
      for (int x = 0; x < xmax; ++x) k[x] /= ww;
    c.bounds[xx * 2 + 0] = xmin;
    c.bounds[xx * 2 + 1] = xmax;
  }
  return c;
}

// PIL 8-bit fixed-point path (Resample.c): coefficients quantized to int32
// with PRECISION_BITS, uint8 clip between the horizontal and vertical
// passes — bit-exact with Image.resize on uint8 RGB.
constexpr int kPrecisionBits = 32 - 8 - 2;

inline uint8_t clip8(int64_t in) {
  in >>= kPrecisionBits;
  if (in < 0) return 0;
  if (in > 255) return 255;
  return static_cast<uint8_t>(in);
}

std::vector<int32_t> quantize_coeffs(const Coeffs& c, int out_size) {
  std::vector<int32_t> k(static_cast<size_t>(out_size) * c.ksize);
  for (size_t i = 0; i < k.size(); ++i) {
    double v = c.values[i];
    k[i] = static_cast<int32_t>(
        v < 0 ? -0.5 + v * (1 << kPrecisionBits)
              : 0.5 + v * (1 << kPrecisionBits));
  }
  return k;
}

// uint8 [in_h, in_w, 3] -> uint8 [out_h, out_w, 3], PIL-exact.
void resample_rgb_u8(const uint8_t* in, int in_h, int in_w, uint8_t* out,
                     int out_h, int out_w, const Filter& f) {
  Coeffs ch = precompute(in_w, out_w, f);
  Coeffs cv = precompute(in_h, out_h, f);
  std::vector<int32_t> kh = quantize_coeffs(ch, out_w);
  std::vector<int32_t> kv = quantize_coeffs(cv, out_h);

  // horizontal pass: [in_h, out_w, 3] uint8
  std::vector<uint8_t> tmp(static_cast<size_t>(in_h) * out_w * 3);
  for (int y = 0; y < in_h; ++y) {
    const uint8_t* row = in + static_cast<size_t>(y) * in_w * 3;
    uint8_t* trow = tmp.data() + static_cast<size_t>(y) * out_w * 3;
    for (int xx = 0; xx < out_w; ++xx) {
      int xmin = ch.bounds[xx * 2 + 0];
      int xcount = ch.bounds[xx * 2 + 1];
      const int32_t* k = &kh[static_cast<size_t>(xx) * ch.ksize];
      int64_t s0 = 1 << (kPrecisionBits - 1);
      int64_t s1 = s0, s2 = s0;
      for (int x = 0; x < xcount; ++x) {
        const uint8_t* px = row + static_cast<size_t>(xmin + x) * 3;
        s0 += static_cast<int64_t>(px[0]) * k[x];
        s1 += static_cast<int64_t>(px[1]) * k[x];
        s2 += static_cast<int64_t>(px[2]) * k[x];
      }
      trow[xx * 3 + 0] = clip8(s0);
      trow[xx * 3 + 1] = clip8(s1);
      trow[xx * 3 + 2] = clip8(s2);
    }
  }

  // vertical pass
  for (int yy = 0; yy < out_h; ++yy) {
    int ymin = cv.bounds[yy * 2 + 0];
    int ycount = cv.bounds[yy * 2 + 1];
    const int32_t* k = &kv[static_cast<size_t>(yy) * cv.ksize];
    uint8_t* orow = out + static_cast<size_t>(yy) * out_w * 3;
    for (int xx = 0; xx < out_w * 3; ++xx) {
      int64_t s = 1 << (kPrecisionBits - 1);
      for (int y = 0; y < ycount; ++y)
        s += static_cast<int64_t>(
                 tmp[static_cast<size_t>(ymin + y) * out_w * 3 + xx]) *
             k[y];
      orow[xx] = clip8(s);
    }
  }
}

void parallel_for_impl(int n, int nthreads,
                       const std::function<void(int)>& body) {
  nthreads = std::max(1, std::min(nthreads, n));
  if (nthreads == 1) {
    for (int i = 0; i < n; ++i) body(i);
    return;
  }
  std::atomic<int> next(0);
  std::vector<std::thread> threads;
  threads.reserve(nthreads);
  for (int t = 0; t < nthreads; ++t) {
    threads.emplace_back([&] {
      int i;
      while ((i = next.fetch_add(1)) < n) body(i);
    });
  }
  for (auto& th : threads) th.join();
}
}  // namespace

extern "C" {

// Plain antialiased resize: uint8 [n, h, w, 3] -> uint8 [n, oh, ow, 3].
void vtc_resize_batch(const uint8_t* frames, int n, int h, int w, uint8_t* out,
                      int oh, int ow, int filter, int num_threads) {
  Filter f = filter == 1 ? Filter{1.0, bilinear_kernel}
                         : Filter{2.0, bicubic_kernel};
  size_t in_stride = static_cast<size_t>(h) * w * 3;
  size_t out_stride = static_cast<size_t>(oh) * ow * 3;
  parallel_for_impl(n, num_threads, [&](int i) {
    resample_rgb_u8(frames + i * in_stride, h, w, out + i * out_stride, oh,
                    ow, f);
  });
}

}  // extern "C"
