// imageio — host image library of relpose_gnn_tpu_torch: the loops of the
// colour- and depth-frame paths that are too slow in numpy, bound to Python
// with ctypes (data/image_io.py builds this file with g++ into the package's
// _build/ directory on first use).  Host code only.
//
// API (all C linkage):
//   png_unfilter(raw*, raw_len, rows, stride, bpp, out*)
//       undo the PNG per-row filters of an inflated, non-interlaced image:
//       `raw` holds `rows` lines of one filter byte and `stride` bytes,
//       `bpp` bytes make one pixel; `out` gets rows x stride bytes.
//       Returns 0, or -(row + 1) for a row with an unknown filter type.
//   resize_bilinear_u8(in*, h, w, c, out*, out_h, out_w)
//       separable bilinear resample of a [h, w, c] uint8 image to
//       [out_h, out_w, c], in fixed point with 22 fractional bits, the
//       horizontal pass first over only the rows the vertical pass reads.
//       Returns 0, or -1 for a size below 1.
//   resize_bilinear_u16(in*, h, w, out*, out_h, out_w)
//       the same resample of a [h, w] uint16 image (Pillow's mode I;16):
//       the normalised weights stay doubles, each pass sums in double and
//       rounds half up to uint16.  Returns 0, or -1 for a size below 1.
//
// Sizes are checked on the Python side before a pointer reaches this file.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// PNG filter types (PNG specification, section 9.2)
inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

constexpr int kPrecisionBits = 22;

// Weights of one axis: for output index i, taps [first[i], first[i] +
// count[i]) of the input, normalised weights at w[i * ksize + t] and the
// same in fixed point at k[i * ksize + t].
struct Axis {
  int ksize = 0;
  std::vector<int> first, count;
  std::vector<double> w;
  std::vector<int32_t> k;
};

inline double triangle(double x) {
  if (x < 0.0) x = -x;
  return x < 1.0 ? 1.0 - x : 0.0;
}

Axis precompute(int in_size, int out_size) {
  Axis ax;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 1.0 * filterscale;  // the triangle's support is 1
  ax.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  ax.first.resize(out_size);
  ax.count.resize(out_size);
  ax.w.assign(static_cast<size_t>(out_size) * ax.ksize, 0.0);
  ax.k.assign(static_cast<size_t>(out_size) * ax.ksize, 0);
  for (int i = 0; i < out_size; ++i) {
    const double center = (i + 0.5) * scale;
    const double ss = 1.0 / filterscale;
    int lo = static_cast<int>(center - support + 0.5);  // truncates
    if (lo < 0) lo = 0;
    int hi = static_cast<int>(center + support + 0.5);
    if (hi > in_size) hi = in_size;
    const int n = hi - lo;
    double *w = &ax.w[static_cast<size_t>(i) * ax.ksize];
    double sum = 0.0;
    for (int t = 0; t < n; ++t) {
      w[t] = triangle((t + lo - center + 0.5) * ss);
      sum += w[t];
    }
    for (int t = 0; t < n; ++t) {
      if (sum != 0.0) w[t] /= sum;
      const double f = w[t] * (1 << kPrecisionBits);
      // rounded half away from zero
      ax.k[static_cast<size_t>(i) * ax.ksize + t] =
          static_cast<int32_t>(f < 0 ? -0.5 + f : 0.5 + f);
    }
    ax.first[i] = lo;
    ax.count[i] = n;
  }
  return ax;
}

// a double sum rounded half up (Pillow's ROUND_UP), within uint16
inline uint16_t round16(double ss) {
  const int v = static_cast<int>(ss >= 0.0 ? ss + 0.5f : ss - 0.5f);
  return static_cast<uint16_t>(v < 0 ? 0 : (v > 65535 ? 65535 : v));
}

inline uint8_t clip8(int32_t v) {
  if (v >= (1 << kPrecisionBits << 8)) return 255;
  if (v <= 0) return 0;
  return static_cast<uint8_t>(v >> kPrecisionBits);
}

}  // namespace

extern "C" {

int png_unfilter(const uint8_t *raw, int64_t raw_len, int rows, int stride,
                 int bpp, uint8_t *out) {
  if (raw_len < static_cast<int64_t>(rows) * (stride + 1)) return -1;
  const std::vector<uint8_t> zeros(stride, 0);
  for (int r = 0; r < rows; ++r) {
    const uint8_t *line = raw + static_cast<int64_t>(r) * (stride + 1);
    const uint8_t type = line[0];
    const uint8_t *src = line + 1;
    uint8_t *cur = out + static_cast<int64_t>(r) * stride;
    const uint8_t *up = r ? cur - stride : zeros.data();
    switch (type) {
      case 0:
        std::memcpy(cur, src, stride);
        break;
      case 1:
        for (int i = 0; i < stride; ++i)
          cur[i] = src[i] + (i >= bpp ? cur[i - bpp] : 0);
        break;
      case 2:
        for (int i = 0; i < stride; ++i) cur[i] = src[i] + up[i];
        break;
      case 3:
        for (int i = 0; i < stride; ++i)
          cur[i] = src[i] + ((i >= bpp ? cur[i - bpp] : 0) + up[i]) / 2;
        break;
      case 4:
        for (int i = 0; i < stride; ++i)
          cur[i] = src[i] + (i >= bpp ? paeth(cur[i - bpp], up[i],
                                              up[i - bpp])
                                      : paeth(0, up[i], 0));
        break;
      default:
        return -(r + 1);
    }
  }
  return 0;
}

int resize_bilinear_u8(const uint8_t *in, int h, int w, int c, uint8_t *out,
                       int out_h, int out_w) {
  if (h < 1 || w < 1 || c < 1 || out_h < 1 || out_w < 1) return -1;
  if (h == out_h && w == out_w) {
    std::memcpy(out, in, static_cast<size_t>(h) * w * c);
    return 0;
  }
  const Axis ax = precompute(w, out_w);
  const Axis ay = precompute(h, out_h);
  // rows of the input the vertical pass reads
  const int row0 = ay.first[0];
  const int row1 = ay.first[out_h - 1] + ay.count[out_h - 1];

  const uint8_t *src = in;
  int src_w = w;
  int shift = 0;
  std::vector<uint8_t> tmp;
  if (w != out_w) {
    tmp.resize(static_cast<size_t>(row1 - row0) * out_w * c);
    for (int y = row0; y < row1; ++y) {
      const uint8_t *line = in + static_cast<size_t>(y) * w * c;
      uint8_t *dst = tmp.data() + static_cast<size_t>(y - row0) * out_w * c;
      for (int x = 0; x < out_w; ++x) {
        const int32_t *k = &ax.k[static_cast<size_t>(x) * ax.ksize];
        const int lo = ax.first[x], n = ax.count[x];
        for (int ch = 0; ch < c; ++ch) {
          int32_t acc = 1 << (kPrecisionBits - 1);
          for (int t = 0; t < n; ++t)
            acc += line[static_cast<size_t>(lo + t) * c + ch] * k[t];
          dst[static_cast<size_t>(x) * c + ch] = clip8(acc);
        }
      }
    }
    src = tmp.data();
    src_w = out_w;
    shift = row0;
  }
  if (h == out_h) {
    std::memcpy(out, src, static_cast<size_t>(h) * src_w * c);
    return 0;
  }
  const size_t row_bytes = static_cast<size_t>(src_w) * c;
  for (int y = 0; y < out_h; ++y) {
    const int32_t *k = &ay.k[static_cast<size_t>(y) * ay.ksize];
    const int lo = ay.first[y] - shift, n = ay.count[y];
    uint8_t *dst = out + static_cast<size_t>(y) * row_bytes;
    for (size_t i = 0; i < row_bytes; ++i) {
      int32_t acc = 1 << (kPrecisionBits - 1);
      for (int t = 0; t < n; ++t) acc += src[(lo + t) * row_bytes + i] * k[t];
      dst[i] = clip8(acc);
    }
  }
  return 0;
}

int resize_bilinear_u16(const uint16_t *in, int h, int w, uint16_t *out,
                        int out_h, int out_w) {
  if (h < 1 || w < 1 || out_h < 1 || out_w < 1) return -1;
  if (h == out_h && w == out_w) {
    std::memcpy(out, in, static_cast<size_t>(h) * w * sizeof(uint16_t));
    return 0;
  }
  const Axis ax = precompute(w, out_w);
  const Axis ay = precompute(h, out_h);
  const int row0 = ay.first[0];
  const int row1 = ay.first[out_h - 1] + ay.count[out_h - 1];

  const uint16_t *src = in;
  int src_w = w;
  int shift = 0;
  std::vector<uint16_t> tmp;
  if (w != out_w) {
    tmp.resize(static_cast<size_t>(row1 - row0) * out_w);
    for (int y = row0; y < row1; ++y) {
      const uint16_t *line = in + static_cast<size_t>(y) * w;
      uint16_t *dst = tmp.data() + static_cast<size_t>(y - row0) * out_w;
      for (int x = 0; x < out_w; ++x) {
        const double *k = &ax.w[static_cast<size_t>(x) * ax.ksize];
        const int lo = ax.first[x], n = ax.count[x];
        double ss = 0.0;
        for (int t = 0; t < n; ++t) ss += line[lo + t] * k[t];
        dst[x] = round16(ss);
      }
    }
    src = tmp.data();
    src_w = out_w;
    shift = row0;
  }
  if (h == out_h) {
    std::memcpy(out, src, static_cast<size_t>(h) * src_w * sizeof(uint16_t));
    return 0;
  }
  for (int y = 0; y < out_h; ++y) {
    const double *k = &ay.w[static_cast<size_t>(y) * ay.ksize];
    const int lo = ay.first[y] - shift, n = ay.count[y];
    uint16_t *dst = out + static_cast<size_t>(y) * src_w;
    for (int i = 0; i < src_w; ++i) {
      double ss = 0.0;
      for (int t = 0; t < n; ++t) ss += src[(lo + t) * src_w + i] * k[t];
      dst[i] = round16(ss);
    }
  }
  return 0;
}

}  // extern "C"
