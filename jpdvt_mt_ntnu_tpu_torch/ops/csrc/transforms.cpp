// Host image transforms of the datasets, with Pillow's 8-bit arithmetic.
//
// The JAX package's datasets transform PIL images
// (jpdvt_mt_ntnu_tpu/data/transforms.py); the port works on uint8 HWC RGB
// arrays and has no PIL, so the operations that compute new pixel values
// are written here after Pillow's C code, rounding for rounding:
//
// - jp_resample: Image.resize (libImaging/Resample.c). Coefficients of the
//   BOX, BILINEAR, BICUBIC (a = -0.5) or LANCZOS (a = 3) filter in double,
//   scaled by the downscale factor, normalised, then turned into fixed
//   point with 22 fractional bits; a horizontal pass over only the rows
//   the vertical pass reads, a clamp to uint8, then the vertical pass.
//   A source box with float corners, as Image.resize(box=...) takes.
// - jp_reduce: Image.reduce (libImaging/Reduce.c), the integer box
//   average that Image.thumbnail runs before its LANCZOS resize
//   (reducing_gap): ((sum + n / 2) * floor(2^32 / (256 n))) >> 24 over
//   each block, the partial last column and row averaged over what they hold.
// - jp_blend: Image.blend (libImaging/Blend.c), a + alpha * (b - a) in
//   float, truncated towards zero; clamped to [0, 255] outside [0, 1].
// - jp_rgb_to_l: convert("L"), (R 19595 + G 38470 + B 7471 + 0x8000) >> 16.
// - jp_rgb_to_hsv, jp_hsv_to_rgb: convert("HSV") and back (Convert.c).
//
// No header beyond the C++ standard library; built by g++ at first use
// (ops/_build.py). Every function takes and returns tightly packed arrays.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;

double box_filter(double x) { return (x > -0.5 && x <= 0.5) ? 1.0 : 0.0; }

double bilinear_filter(double x) {
  if (x < 0.0) x = -x;
  return x < 1.0 ? 1.0 - x : 0.0;
}

double bicubic_filter(double x) {
  const double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

double sinc_filter(double x) {
  if (x == 0.0) return 1.0;
  x = x * M_PI;
  return std::sin(x) / x;
}

double lanczos_filter(double x) {
  if (-3.0 <= x && x < 3.0) return sinc_filter(x) * sinc_filter(x / 3);
  return 0.0;
}

struct Filter {
  double (*fn)(double);
  double support;
};

// Pillow's Resampling enum: LANCZOS 1, BILINEAR 2, BICUBIC 3, BOX 4.
bool filter_of(int id, Filter* f) {
  switch (id) {
    case 1: *f = {lanczos_filter, 3.0}; return true;
    case 2: *f = {bilinear_filter, 1.0}; return true;
    case 3: *f = {bicubic_filter, 2.0}; return true;
    case 4: *f = {box_filter, 0.5}; return true;
    default: return false;
  }
}

// precompute_coeffs, then normalize_coeffs_8bpc: per output pixel its first
// source pixel, its count, and ksize fixed-point weights.
int coefficients(int in_size, float in0, float in1, int out_size, const Filter& f,
                 std::vector<int>* bounds, std::vector<int32_t>* kk) {
  double scale = static_cast<double>(in1 - in0) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = f.support * filterscale;
  int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  std::vector<double> pre(static_cast<size_t>(out_size) * ksize, 0.0);
  bounds->assign(static_cast<size_t>(out_size) * 2, 0);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = in0 + (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &pre[static_cast<size_t>(xx) * ksize];
    for (int x = 0; x < xmax; ++x) {
      double w = f.fn((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; ++x)
      if (ww != 0.0) k[x] /= ww;
    (*bounds)[xx * 2] = xmin;
    (*bounds)[xx * 2 + 1] = xmax;
  }
  kk->resize(pre.size());
  for (size_t i = 0; i < pre.size(); ++i)
    (*kk)[i] = pre[i] < 0 ? static_cast<int>(-0.5 + pre[i] * (1 << kPrecisionBits))
                          : static_cast<int>(0.5 + pre[i] * (1 << kPrecisionBits));
  return ksize;
}

inline uint8_t clip8(int in) {
  int v = in >> kPrecisionBits;
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// Rows [offset, offset + out_h) of `in` (width in_w) resampled to out_w.
void horizontal(const uint8_t* in, int in_w, int offset, int out_w, int out_h, int ksize,
                const std::vector<int>& bounds, const std::vector<int32_t>& kk,
                uint8_t* out) {
  for (int yy = 0; yy < out_h; ++yy) {
    const uint8_t* row = in + static_cast<size_t>(yy + offset) * in_w * 3;
    uint8_t* o = out + static_cast<size_t>(yy) * out_w * 3;
    for (int xx = 0; xx < out_w; ++xx) {
      int xmin = bounds[xx * 2], xmax = bounds[xx * 2 + 1];
      const int32_t* k = &kk[static_cast<size_t>(xx) * ksize];
      int ss0 = 1 << (kPrecisionBits - 1), ss1 = ss0, ss2 = ss0;
      for (int x = 0; x < xmax; ++x) {
        const uint8_t* p = row + (x + xmin) * 3;
        ss0 += p[0] * k[x];
        ss1 += p[1] * k[x];
        ss2 += p[2] * k[x];
      }
      o[xx * 3] = clip8(ss0);
      o[xx * 3 + 1] = clip8(ss1);
      o[xx * 3 + 2] = clip8(ss2);
    }
  }
}

void vertical(const uint8_t* in, int w, int out_h, int ksize, const std::vector<int>& bounds,
              const std::vector<int32_t>& kk, uint8_t* out) {
  for (int yy = 0; yy < out_h; ++yy) {
    const int32_t* k = &kk[static_cast<size_t>(yy) * ksize];
    int ymin = bounds[yy * 2], ymax = bounds[yy * 2 + 1];
    uint8_t* o = out + static_cast<size_t>(yy) * w * 3;
    for (int xx = 0; xx < w; ++xx) {
      int ss0 = 1 << (kPrecisionBits - 1), ss1 = ss0, ss2 = ss0;
      for (int y = 0; y < ymax; ++y) {
        const uint8_t* p = in + (static_cast<size_t>(y + ymin) * w + xx) * 3;
        ss0 += p[0] * k[y];
        ss1 += p[1] * k[y];
        ss2 += p[2] * k[y];
      }
      o[xx * 3] = clip8(ss0);
      o[xx * 3 + 1] = clip8(ss1);
      o[xx * 3 + 2] = clip8(ss2);
    }
  }
}

uint32_t division_u32(int divider, int result_bits) {
  uint32_t max_dividend = (1u << result_bits) * static_cast<uint32_t>(divider);
  float max_int = (1 << 30) * 4.0;
  return static_cast<uint32_t>(max_int / max_dividend);
}

// The average of the block [x0, x1) x [y0, y1) of `in` (width w) into `o`.
void reduce_block(const uint8_t* in, int w, int x0, int x1, int y0, int y1, uint8_t* o) {
  int n = (x1 - x0) * (y1 - y0);
  uint32_t multiplier = division_u32(n, 8);
  uint32_t amend = static_cast<uint32_t>(n / 2);
  uint32_t ss[3] = {amend, amend, amend};
  for (int y = y0; y < y1; ++y) {
    const uint8_t* row = in + static_cast<size_t>(y) * w * 3;
    for (int x = x0; x < x1; ++x)
      for (int c = 0; c < 3; ++c) ss[c] += row[x * 3 + c];
  }
  for (int c = 0; c < 3; ++c) o[c] = static_cast<uint8_t>((ss[c] * multiplier) >> 24);
}

}  // namespace

extern "C" {

// Image.resize(size, filter, box) of an RGB image (w, h) to (out_w, out_h):
// `box` is the source region (x0, y0, x1, y1) in float, as Pillow parses it.
// 0 on success, -1 for an unknown filter, -2 for a bad size or box.
int jp_resample(const uint8_t* in, int w, int h, float x0, float y0, float x1, float y1,
                int out_w, int out_h, int filter, uint8_t* out) {
  Filter f;
  if (!filter_of(filter, &f)) return -1;
  if (w < 1 || h < 1 || out_w < 1 || out_h < 1 || x0 < 0 || y0 < 0 || x1 > w || y1 > h ||
      x1 - x0 < 0 || y1 - y0 < 0)
    return -2;
  // An integer box of the output's size is a crop (_imaging.c _resize).
  if (x0 - static_cast<int>(x0) == 0 && x1 - x0 == out_w && y0 - static_cast<int>(y0) == 0 &&
      y1 - y0 == out_h) {
    for (int y = 0; y < out_h; ++y)
      std::memcpy(out + static_cast<size_t>(y) * out_w * 3,
                  in + (static_cast<size_t>(y + static_cast<int>(y0)) * w +
                        static_cast<int>(x0)) * 3,
                  static_cast<size_t>(out_w) * 3);
    return 0;
  }
  bool need_h = out_w != w || x0 != 0 || x1 != out_w;
  bool need_v = out_h != h || y0 != 0 || y1 != out_h;
  std::vector<int> bounds_h, bounds_v;
  std::vector<int32_t> kk_h, kk_v;
  int ksize_h = coefficients(w, x0, x1, out_w, f, &bounds_h, &kk_h);
  int ksize_v = coefficients(h, y0, y1, out_h, f, &bounds_v, &kk_v);
  int ybox_first = bounds_v[0];
  int ybox_last = bounds_v[out_h * 2 - 2] + bounds_v[out_h * 2 - 1];
  const uint8_t* cur = in;
  int cur_w = w, cur_h = h;
  std::vector<uint8_t> tmp;
  if (need_h) {
    for (int i = 0; i < out_h; ++i) bounds_v[i * 2] -= ybox_first;
    cur_h = ybox_last - ybox_first;
    tmp.resize(static_cast<size_t>(out_w) * cur_h * 3);
    horizontal(in, w, ybox_first, out_w, cur_h, ksize_h, bounds_h, kk_h, tmp.data());
    cur = tmp.data();
    cur_w = out_w;
  }
  if (need_v) {
    vertical(cur, cur_w, out_h, ksize_v, bounds_v, kk_v, out);
  } else {
    std::memcpy(out, cur, static_cast<size_t>(cur_w) * cur_h * 3);
  }
  return 0;
}

// Image.reduce((fx, fy), box) of an RGB image of width w: the box
// (bx, by, bw, bh) in pixels; `out` is ceil(bw / fx) x ceil(bh / fy).
int jp_reduce(const uint8_t* in, int w, int h, int fx, int fy, int bx, int by, int bw, int bh,
              uint8_t* out) {
  if (fx < 1 || fy < 1 || bx < 0 || by < 0 || bw < 1 || bh < 1 || bx + bw > w || by + bh > h)
    return -2;
  int out_w = (bw + fx - 1) / fx, out_h = (bh + fy - 1) / fy;
  for (int y = 0; y < out_h; ++y) {
    int y0 = by + y * fy, y1 = std::min(y0 + fy, by + bh);
    for (int x = 0; x < out_w; ++x) {
      int x0 = bx + x * fx, x1 = std::min(x0 + fx, bx + bw);
      reduce_block(in, w, x0, x1, y0, y1, out + (static_cast<size_t>(y) * out_w + x) * 3);
    }
  }
  return 0;
}

// Image.blend(a, b, alpha) over n bytes.
void jp_blend(const uint8_t* a, const uint8_t* b, long n, float alpha, uint8_t* out) {
  if (alpha == 0.0f) {
    std::memcpy(out, a, static_cast<size_t>(n));
  } else if (alpha == 1.0f) {
    std::memcpy(out, b, static_cast<size_t>(n));
  } else if (alpha >= 0 && alpha <= 1.0f) {
    for (long i = 0; i < n; ++i)
      out[i] = static_cast<uint8_t>(static_cast<int>(a[i]) +
                                    alpha * (static_cast<int>(b[i]) - static_cast<int>(a[i])));
  } else {
    for (long i = 0; i < n; ++i) {
      float t = static_cast<float>(static_cast<int>(a[i]) +
                                   alpha * (static_cast<int>(b[i]) - static_cast<int>(a[i])));
      out[i] = t <= 0.0f ? 0 : (t >= 255.0f ? 255 : static_cast<uint8_t>(t));
    }
  }
}

// convert("L") of n RGB pixels.
void jp_rgb_to_l(const uint8_t* rgb, long n, uint8_t* out) {
  for (long i = 0; i < n; ++i) {
    const uint8_t* p = rgb + i * 3;
    out[i] = static_cast<uint8_t>((p[0] * 19595 + p[1] * 38470 + p[2] * 7471 + 0x8000) >> 16);
  }
}

// convert("HSV") of n RGB pixels (Convert.c rgb2hsv_row).
void jp_rgb_to_hsv(const uint8_t* rgb, long n, uint8_t* out) {
  for (long i = 0; i < n; ++i) {
    const uint8_t* in = rgb + i * 3;
    uint8_t* o = out + i * 3;
    uint8_t r = in[0], g = in[1], b = in[2];
    uint8_t maxc = std::max(r, std::max(g, b));
    uint8_t minc = std::min(r, std::min(g, b));
    uint8_t uh, us;
    if (minc == maxc) {
      uh = 0;
      us = 0;
    } else {
      float h, s, rc, gc, bc, cr;
      cr = static_cast<float>(maxc - minc);
      s = cr / static_cast<float>(maxc);
      rc = static_cast<float>(maxc - r) / cr;
      gc = static_cast<float>(maxc - g) / cr;
      bc = static_cast<float>(maxc - b) / cr;
      if (r == maxc) {
        h = bc - gc;
      } else if (g == maxc) {
        h = 2.0 + rc - bc;
      } else {
        h = 4.0 + gc - rc;
      }
      h = std::fmod((h / 6.0 + 1.0), 1.0);
      int hi = static_cast<int>(h * 255.0), si = static_cast<int>(s * 255.0);
      uh = static_cast<uint8_t>(hi < 0 ? 0 : (hi > 255 ? 255 : hi));
      us = static_cast<uint8_t>(si < 0 ? 0 : (si > 255 ? 255 : si));
    }
    o[0] = uh;
    o[1] = us;
    o[2] = maxc;
  }
}

// convert("RGB") of n HSV pixels (Convert.c hsv2rgb).
void jp_hsv_to_rgb(const uint8_t* hsv, long n, uint8_t* out) {
  auto clip = [](int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); };
  for (long i = 0; i < n; ++i) {
    const uint8_t* in = hsv + i * 3;
    uint8_t* o = out + i * 3;
    uint8_t h = in[0], s = in[1], v = in[2];
    if (s == 0) {
      o[0] = o[1] = o[2] = v;
      continue;
    }
    int hi = static_cast<int>(std::floor(static_cast<float>(h) * 6.0 / 255.0));
    float f = static_cast<float>(h) * 6.0 / 255.0 - static_cast<float>(hi);
    float fs = static_cast<float>(s) / 255.0;
    int p = static_cast<int>(std::round(static_cast<float>(v) * (1.0 - fs)));
    int q = static_cast<int>(std::round(static_cast<float>(v) * (1.0 - fs * f)));
    int t = static_cast<int>(std::round(static_cast<float>(v) * (1.0 - fs * (1.0 - f))));
    uint8_t up = clip(p), uq = clip(q), ut = clip(t);
    switch (hi % 6) {
      case 0: o[0] = v; o[1] = ut; o[2] = up; break;
      case 1: o[0] = uq; o[1] = v; o[2] = up; break;
      case 2: o[0] = up; o[1] = v; o[2] = ut; break;
      case 3: o[0] = up; o[1] = uq; o[2] = v; break;
      case 4: o[0] = ut; o[1] = up; o[2] = v; break;
      default: o[0] = v; o[1] = up; o[2] = uq; break;
    }
  }
}

}  // extern "C"
