// Native image preprocessing: separable bicubic resize (antialiased on
// downscale, PIL-style) + rescale(1/255) + normalize(mean=std=0.5) + HWC->CHW,
// parallelized with a thread pool.
//
// The reference does this per-image in Python/PIL/numpy on the host
// (ref: processing_paligemma.py:38-73); at serving rates the Python path
// becomes the bottleneck feeding prefill. This library processes a batch of
// uint8 HWC frames into the model's (B, 3, S, S) float32 layout off the GIL.
//
// Exposed C ABI (ctypes):
//   preprocess_batch(src, n, in_h, in_w, dst, out_size, num_threads)
//     src: n * in_h * in_w * 3 uint8, RGB
//     dst: n * 3 * out_size * out_size float32

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Catmull-Rom bicubic kernel (a = -0.5), the convention PIL uses.
inline double cubic(double x) {
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

// Precomputed sampling weights for one output axis (PIL-style: kernel
// support is scaled by the downscale factor => antialiasing).
struct AxisWeights {
  std::vector<int> starts;          // first source index per output pixel
  std::vector<int> sizes;           // taps per output pixel
  std::vector<std::vector<double>> weights;
};

AxisWeights compute_weights(int in_size, int out_size) {
  AxisWeights aw;
  aw.starts.resize(out_size);
  aw.sizes.resize(out_size);
  aw.weights.resize(out_size);
  const double scale = static_cast<double>(in_size) / out_size;
  const double filter_scale = std::max(scale, 1.0);
  const double support = 2.0 * filter_scale;

  for (int i = 0; i < out_size; ++i) {
    const double center = (i + 0.5) * scale;
    int lo = static_cast<int>(std::floor(center - support + 0.5));
    int hi = static_cast<int>(std::floor(center + support + 0.5));
    lo = std::max(lo, 0);
    hi = std::min(hi, in_size);
    aw.starts[i] = lo;
    aw.sizes[i] = hi - lo;
    auto& w = aw.weights[i];
    w.resize(hi - lo);
    double total = 0.0;
    for (int j = lo; j < hi; ++j) {
      const double v = cubic((j - center + 0.5) / filter_scale);
      w[j - lo] = v;
      total += v;
    }
    if (total != 0.0) {
      for (auto& v : w) v /= total;
    }
  }
  return aw;
}

void process_one(const uint8_t* src, int in_h, int in_w, float* dst,
                 int out, const AxisWeights& wx, const AxisWeights& wy) {
  // horizontal pass: (in_h, in_w, 3) u8 -> (in_h, out, 3) double
  std::vector<double> tmp(static_cast<size_t>(in_h) * out * 3);
  for (int y = 0; y < in_h; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * in_w * 3;
    double* trow = tmp.data() + static_cast<size_t>(y) * out * 3;
    for (int x = 0; x < out; ++x) {
      const int s = wx.starts[x];
      const auto& w = wx.weights[x];
      double acc[3] = {0, 0, 0};
      for (int k = 0; k < wx.sizes[x]; ++k) {
        const uint8_t* px = row + static_cast<size_t>(s + k) * 3;
        acc[0] += w[k] * px[0];
        acc[1] += w[k] * px[1];
        acc[2] += w[k] * px[2];
      }
      trow[x * 3 + 0] = acc[0];
      trow[x * 3 + 1] = acc[1];
      trow[x * 3 + 2] = acc[2];
    }
  }
  // vertical pass + rescale/normalize + CHW
  const size_t plane = static_cast<size_t>(out) * out;
  for (int y = 0; y < out; ++y) {
    const int s = wy.starts[y];
    const auto& w = wy.weights[y];
    for (int x = 0; x < out; ++x) {
      double acc[3] = {0, 0, 0};
      for (int k = 0; k < wy.sizes[y]; ++k) {
        const double* px =
            tmp.data() + (static_cast<size_t>(s + k) * out + x) * 3;
        acc[0] += w[k] * px[0];
        acc[1] += w[k] * px[1];
        acc[2] += w[k] * px[2];
      }
      for (int c = 0; c < 3; ++c) {
        // clamp like PIL's uint8 rounding, then x/255 -> (v - .5)/.5
        double v = std::min(255.0, std::max(0.0, acc[c]));
        v = std::round(v);  // PIL resize returns uint8 before numpy conversion
        const float normed = static_cast<float>((v / 255.0 - 0.5) / 0.5);
        dst[c * plane + static_cast<size_t>(y) * out + x] = normed;
      }
    }
  }
}

}  // namespace

extern "C" {

void preprocess_batch(const uint8_t* src, int n, int in_h, int in_w,
                      float* dst, int out_size, int num_threads) {
  const AxisWeights wx = compute_weights(in_w, out_size);
  const AxisWeights wy = compute_weights(in_h, out_size);
  const size_t in_stride = static_cast<size_t>(in_h) * in_w * 3;
  const size_t out_stride = static_cast<size_t>(out_size) * out_size * 3;

  if (num_threads <= 1 || n == 1) {
    for (int i = 0; i < n; ++i) {
      process_one(src + i * in_stride, in_h, in_w, dst + i * out_stride,
                  out_size, wx, wy);
    }
    return;
  }
  std::atomic<int> next(0);
  auto worker = [&]() {
    while (true) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      process_one(src + i * in_stride, in_h, in_w, dst + i * out_stride,
                  out_size, wx, wy);
    }
  };
  std::vector<std::thread> pool;
  const int t = std::min(num_threads, n);
  pool.reserve(t);
  for (int i = 0; i < t; ++i) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // extern "C"
