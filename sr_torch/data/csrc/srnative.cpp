// srnative — native host-side data prep for sr_torch's eval harness.
//
// The port's own copy of the JAX package's native/srnative.cpp: a bit-exact
// replica of Pillow's fixed-point bicubic resampler (the eval degradation)
// and the MSE of two uint8 planes, so eval prep of a corpus pays no numpy
// overhead. Loaded with ctypes by sr_torch/data/native.py, which
// builds it at first use and falls back to numpy when no compiler exists.
//
// Algorithm parity: libImaging/Resample.c of Pillow >= 2.7 — horizontal
// pass then vertical, PRECISION_BITS = 32-8-2 coefficient quantization
// with ROUND_UP, accumulator pre-seeded with 1<<(PRECISION_BITS-1), and
// per-pass clip to [0,255]. Held bit for bit against Pillow and the numpy
// path by tests/test_torch_eval_metrics.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;

inline double bicubic_filter(double x) {
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

inline int round_up(double v) {
  return static_cast<int>(v >= 0.0 ? v + 0.5 : v - 0.5);
}

inline uint8_t clip8(int64_t v) {
  v >>= kPrecisionBits;
  return static_cast<uint8_t>(std::min<int64_t>(255, std::max<int64_t>(0, v)));
}

// Pillow-parity tap computation for one axis.
void precompute(int in_size, int out_size, std::vector<int>& bounds_min,
                std::vector<int>& bounds_len, std::vector<int32_t>& kk,
                int& ksize) {
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 2.0 * filterscale;
  const double ss = 1.0 / filterscale;
  ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  bounds_min.resize(out_size);
  bounds_len.resize(out_size);
  kk.assign(static_cast<size_t>(out_size) * ksize, 0);
  std::vector<double> w(ksize);
  for (int o = 0; o < out_size; ++o) {
    const double center = (o + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    const int n = xmax - xmin;
    double wsum = 0.0;
    for (int k = 0; k < n; ++k) {
      w[k] = bicubic_filter((k + xmin - center + 0.5) * ss);
      wsum += w[k];
    }
    for (int k = 0; k < n; ++k) {
      const double norm = wsum != 0.0 ? w[k] / wsum : 0.0;
      kk[static_cast<size_t>(o) * ksize + k] =
          round_up(norm * (1 << kPrecisionBits));
    }
    bounds_min[o] = xmin;
    bounds_len[o] = n;
  }
}

// One resample pass along the W axis of an (H, W, C) interleaved image.
void pass_horizontal(const uint8_t* in, int h, int w, int c, uint8_t* out,
                     int ow) {
  std::vector<int> bmin, blen;
  std::vector<int32_t> kk;
  int ksize;
  precompute(w, ow, bmin, blen, kk, ksize);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = in + static_cast<size_t>(y) * w * c;
    uint8_t* orow = out + static_cast<size_t>(y) * ow * c;
    for (int o = 0; o < ow; ++o) {
      const int32_t* k = kk.data() + static_cast<size_t>(o) * ksize;
      const int xmin = bmin[o], n = blen[o];
      for (int ch = 0; ch < c; ++ch) {
        int64_t acc = 1 << (kPrecisionBits - 1);
        const uint8_t* p = row + static_cast<size_t>(xmin) * c + ch;
        for (int t = 0; t < n; ++t) acc += static_cast<int64_t>(p[t * c]) * k[t];
        orow[static_cast<size_t>(o) * c + ch] = clip8(acc);
      }
    }
  }
}

// One resample pass along the H axis of an (H, W, C) interleaved image.
void pass_vertical(const uint8_t* in, int h, int w, int c, uint8_t* out,
                   int oh) {
  std::vector<int> bmin, blen;
  std::vector<int32_t> kk;
  int ksize;
  precompute(h, oh, bmin, blen, kk, ksize);
  const size_t row_stride = static_cast<size_t>(w) * c;
  for (int o = 0; o < oh; ++o) {
    const int32_t* k = kk.data() + static_cast<size_t>(o) * ksize;
    const int ymin = bmin[o], n = blen[o];
    uint8_t* orow = out + static_cast<size_t>(o) * row_stride;
    for (size_t x = 0; x < row_stride; ++x) {
      int64_t acc = 1 << (kPrecisionBits - 1);
      const uint8_t* p = in + static_cast<size_t>(ymin) * row_stride + x;
      for (int t = 0; t < n; ++t)
        acc += static_cast<int64_t>(p[static_cast<size_t>(t) * row_stride]) * k[t];
      orow[x] = clip8(acc);
    }
  }
}

}  // namespace

extern "C" {

// Pillow-exact bicubic resize of an (h, w, c) uint8 interleaved image to
// (oh, ow, c). Returns 0 on success.
int sr_resize_bicubic_u8(const uint8_t* in, int h, int w, int c,
                         uint8_t* out, int oh, int ow) {
  if (!in || !out || h <= 0 || w <= 0 || c <= 0 || oh <= 0 || ow <= 0)
    return 1;
  if (w == ow && h == oh) {
    std::memcpy(out, in, static_cast<size_t>(h) * w * c);
    return 0;
  }
  if (h == oh) {  // horizontal only
    pass_horizontal(in, h, w, c, out, ow);
    return 0;
  }
  if (w == ow) {  // vertical only
    pass_vertical(in, h, w, c, out, oh);
    return 0;
  }
  std::vector<uint8_t> tmp(static_cast<size_t>(h) * ow * c);
  pass_horizontal(in, h, w, c, tmp.data(), ow);
  pass_vertical(tmp.data(), h, ow, c, out, oh);
  return 0;
}

// Mean squared error of two (h, w) uint8 planes after shaving ``border``
// pixels from every edge; NaN when nothing is left (numpy's mean of an
// empty array). The squared differences are integers and their sum stays
// below 2^53, so the sum is exact in any order and the result equals
// numpy's mean bit for bit; the caller finishes PSNR in numpy.
double sr_mse_y_u8(const uint8_t* a, const uint8_t* b, int h, int w,
                   int border) {
  double acc = 0.0;
  int64_t n = 0;
  for (int y = border; y < h - border; ++y)
    for (int x = border; x < w - border; ++x) {
      const size_t i = static_cast<size_t>(y) * w + x;
      const double d = static_cast<double>(a[i]) - static_cast<double>(b[i]);
      acc += d * d;
      ++n;
    }
  if (n == 0) return std::numeric_limits<double>::quiet_NaN();
  return acc / static_cast<double>(n);
}

int sr_native_abi_version() { return 2; }

}  // extern "C"
