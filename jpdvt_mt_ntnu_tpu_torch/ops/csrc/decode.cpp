// Image decode for the port's service, eval harness and datasets: PNG
// scanline filters, the ADM center crop with [-1, 1] output and, where
// libjpeg is on the machine that builds this file, JPEG decode (to RGB
// whole, jp_jpeg_decode, or through the crop).
//
// The port's copy of native/src/decode.cpp, split so that its ADM part
// compiles with no external header: the PNG container (chunks, zlib) is
// read in Python (ops/native.py) and only its five scanline filters are
// undone here (jp_png_unfilter); jp_center_crop takes the raw 8-bit grey,
// grey + alpha, RGB or RGBA pixels. JPEG needs libjpeg: ops/_build.py
// defines JP_WITH_LIBJPEG and links -ljpeg when g++ finds it, and
// jp_formats() reports which formats the built library decodes.
//
// The ADM preprocessing (reference image_model/inference.py:95-111):
// iterative 2x BOX halving while the short side is >= 2 * target, a
// PIL-style filtered BICUBIC resize of the short side to the target (Keys
// cubic, a = -0.5, support scaled by the downscale factor, normalised
// weights), then the center crop. Output is within two 8-bit levels of
// PIL's where it resamples (the two round differently), and exactly PIL's
// where it does not.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#ifdef JP_WITH_LIBJPEG
#include <csetjmp>
#include <cstdio>

#include <jpeglib.h>
#endif

namespace {

struct ImageU8 {
  int w = 0, h = 0;
  std::vector<uint8_t> rgb;  // h*w*3
};

#ifdef JP_WITH_LIBJPEG
struct JErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jerr_exit(j_common_ptr cinfo) {
  JErr* e = reinterpret_cast<JErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

// Decodes to RGB; with header_only, stops after the header (w, h set).
bool decode_jpeg(const uint8_t* data, size_t len, ImageU8* out, bool header_only) {
  jpeg_decompress_struct cinfo;
  JErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jerr_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  if (header_only) {
    out->w = cinfo.image_width;
    out->h = cinfo.image_height;
    jpeg_destroy_decompress(&cinfo);
    return true;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->rgb.resize(static_cast<size_t>(out->w) * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->rgb.data() + static_cast<size_t>(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}
#endif

// --------------------------- resampling ----------------------------------

void box_halve(ImageU8* img) {
  int nw = img->w / 2, nh = img->h / 2;
  std::vector<uint8_t> out(static_cast<size_t>(nw) * nh * 3);
  for (int y = 0; y < nh; ++y) {
    const uint8_t* r0 = img->rgb.data() + static_cast<size_t>(2 * y) * img->w * 3;
    const uint8_t* r1 = r0 + static_cast<size_t>(img->w) * 3;
    uint8_t* o = out.data() + static_cast<size_t>(y) * nw * 3;
    for (int x = 0; x < nw; ++x) {
      for (int c = 0; c < 3; ++c) {
        int s = r0[(2 * x) * 3 + c] + r0[(2 * x + 1) * 3 + c] +
                r1[(2 * x) * 3 + c] + r1[(2 * x + 1) * 3 + c];
        o[x * 3 + c] = static_cast<uint8_t>((s + 2) >> 2);
      }
    }
  }
  img->rgb.swap(out);
  img->w = nw;
  img->h = nh;
}

double cubic(double x) {  // Keys a = -0.5 (PIL BICUBIC)
  x = std::fabs(x);
  if (x < 1.0) return ((1.5 * x - 2.5) * x) * x + 1.0;
  if (x < 2.0) return (((-0.5 * x) + 2.5) * x - 4.0) * x + 2.0;
  return 0.0;
}

// PIL-style separable filtered resize along one axis.
void resample_axis(const std::vector<float>& in, int in_len, int other,
                   int out_len, std::vector<float>* out) {
  out->assign(static_cast<size_t>(out_len) * other * 3, 0.f);
  double scale = static_cast<double>(in_len) / out_len;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 2.0 * filterscale;
  for (int xo = 0; xo < out_len; ++xo) {
    double center = (xo + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_len) xmax = in_len;
    std::vector<double> w(xmax - xmin);
    double wsum = 0;
    for (int x = xmin; x < xmax; ++x) {
      double v = cubic((x + 0.5 - center) / filterscale);
      w[x - xmin] = v;
      wsum += v;
    }
    if (wsum != 0)
      for (double& v : w) v /= wsum;
    for (int y = 0; y < other; ++y) {
      for (int c = 0; c < 3; ++c) {
        double acc = 0;
        for (int x = xmin; x < xmax; ++x)
          acc += w[x - xmin] *
                 in[(static_cast<size_t>(y) * in_len + x) * 3 + c];
        (*out)[(static_cast<size_t>(y) * out_len + xo) * 3 + c] =
            static_cast<float>(acc);
      }
    }
  }
}

// Full bicubic resize (w,h) -> (nw,nh), float intermediate.
void bicubic_resize(ImageU8* img, int nw, int nh) {
  size_t n = static_cast<size_t>(img->w) * img->h * 3;
  std::vector<float> f(n);
  for (size_t i = 0; i < n; ++i) f[i] = img->rgb[i];
  // horizontal: rows stay, width changes (in row-major, x is fastest)
  std::vector<float> tmp;
  resample_axis(f, img->w, img->h, nw, &tmp);
  // vertical: transpose, resample, transpose back
  std::vector<float> t(static_cast<size_t>(nw) * img->h * 3);
  for (int y = 0; y < img->h; ++y)
    for (int x = 0; x < nw; ++x)
      for (int c = 0; c < 3; ++c)
        t[(static_cast<size_t>(x) * img->h + y) * 3 + c] =
            tmp[(static_cast<size_t>(y) * nw + x) * 3 + c];
  std::vector<float> t2;
  resample_axis(t, img->h, nw, nh, &t2);
  img->rgb.resize(static_cast<size_t>(nw) * nh * 3);
  for (int y = 0; y < nh; ++y)
    for (int x = 0; x < nw; ++x)
      for (int c = 0; c < 3; ++c) {
        float v = t2[(static_cast<size_t>(x) * nh + y) * 3 + c];
        v = v < 0.f ? 0.f : (v > 255.f ? 255.f : v);
        img->rgb[(static_cast<size_t>(y) * nw + x) * 3 + c] =
            static_cast<uint8_t>(v + 0.5f);
      }
  img->w = nw;
  img->h = nh;
}

// ADM center crop of an RGB image to image_size, float32 HWC in [-1, 1].
int adm_center_crop(ImageU8* img, int image_size, float* out) {
  if (img->w < 1 || img->h < 1 || image_size < 1) return -2;
  while (std::min(img->w, img->h) >= 2 * image_size) box_halve(img);
  double scale = static_cast<double>(image_size) / std::min(img->w, img->h);
  int nw = static_cast<int>(std::lround(img->w * scale));
  int nh = static_cast<int>(std::lround(img->h * scale));
  if (nw != img->w || nh != img->h) bicubic_resize(img, nw, nh);
  int cy = (img->h - image_size) / 2;
  int cx = (img->w - image_size) / 2;
  if (cy < 0 || cx < 0) return -3;
  for (int y = 0; y < image_size; ++y) {
    const uint8_t* row =
        img->rgb.data() + (static_cast<size_t>(cy + y) * img->w + cx) * 3;
    float* o = out + static_cast<size_t>(y) * image_size * 3;
    // normalize(to_array(.)) of the JAX package's transforms, op for op, so
    // that the floats (and the PNGs written from them) are the same bits.
    for (int i = 0; i < image_size * 3; ++i)
      o[i] = static_cast<float>(row[i]) / 255.0f * 2.0f - 1.0f;
  }
  return 0;
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

}  // namespace

extern "C" {

// Bit 0: PNG (always: this file and ops/native.py); bit 1: JPEG (libjpeg).
int jp_formats() {
#ifdef JP_WITH_LIBJPEG
  return 3;
#else
  return 1;
#endif
}

// Undo the PNG scanline filters of an inflated 8-bit image: `in` holds
// height rows of (1 filter byte + width * bpp bytes); `out` receives
// height * width * bpp bytes. 0 on success, -5 on short data, -6 on an
// unknown filter type.
int jp_png_unfilter(const uint8_t* in, long len, int width, int height, int bpp,
                    uint8_t* out) {
  size_t stride = static_cast<size_t>(width) * bpp;
  if (width < 1 || height < 1 || bpp < 1 ||
      static_cast<size_t>(len) < (stride + 1) * height)
    return -5;
  for (int y = 0; y < height; ++y) {
    const uint8_t* src = in + static_cast<size_t>(y) * (stride + 1);
    int ft = src[0];
    ++src;
    uint8_t* row = out + static_cast<size_t>(y) * stride;
    const uint8_t* prev = y ? row - stride : nullptr;
    for (size_t i = 0; i < stride; ++i) {
      int a = i >= static_cast<size_t>(bpp) ? row[i - bpp] : 0;
      int b = prev ? prev[i] : 0;
      int c = prev && i >= static_cast<size_t>(bpp) ? prev[i - bpp] : 0;
      int v;
      switch (ft) {
        case 0: v = src[i]; break;
        case 1: v = src[i] + a; break;
        case 2: v = src[i] + b; break;
        case 3: v = src[i] + ((a + b) >> 1); break;
        case 4: v = src[i] + paeth(a, b, c); break;
        default: return -6;
      }
      row[i] = static_cast<uint8_t>(v);
    }
  }
  return 0;
}

// ADM center crop of raw 8-bit pixels (channels 1 grey, 2 grey + alpha,
// 3 RGB, 4 RGBA; alpha is dropped) to image_size, float32 HWC in [-1, 1].
// 0 on success, negative error codes otherwise.
int jp_center_crop(const uint8_t* px, int width, int height, int channels,
                   int image_size, float* out) {
  if (channels < 1 || channels > 4) return -4;
  ImageU8 img;
  img.w = width;
  img.h = height;
  if (width < 1 || height < 1) return -2;
  size_t n = static_cast<size_t>(width) * height;
  img.rgb.resize(n * 3);
  for (size_t i = 0; i < n; ++i) {
    const uint8_t* p = px + i * channels;
    bool grey = channels < 3;
    for (int c = 0; c < 3; ++c) img.rgb[i * 3 + c] = grey ? p[0] : p[c];
  }
  return adm_center_crop(&img, image_size, out);
}

#ifdef JP_WITH_LIBJPEG
// Decode a JPEG and ADM-center-crop it, as jp_center_crop. -1 when
// libjpeg refuses the data.
int jp_jpeg_center_crop(const uint8_t* data, long len, int image_size, float* out) {
  ImageU8 img;
  if (!decode_jpeg(data, static_cast<size_t>(len), &img, false)) return -1;
  return adm_center_crop(&img, image_size, out);
}

// Decode a JPEG to RGB into `out`, which holds w * h * 3 bytes for the
// (w, h) that jp_jpeg_probe gave. -1 when libjpeg refuses the data, -7
// when the decoded size is not (w, h).
int jp_jpeg_decode(const uint8_t* data, long len, int w, int h, uint8_t* out) {
  ImageU8 img;
  if (!decode_jpeg(data, static_cast<size_t>(len), &img, false)) return -1;
  if (img.w != w || img.h != h) return -7;
  std::memcpy(out, img.rgb.data(), img.rgb.size());
  return 0;
}

// A JPEG's width and height from its header (-1 on failure).
int jp_jpeg_probe(const uint8_t* data, long len, int* w, int* h) {
  ImageU8 img;
  if (!decode_jpeg(data, static_cast<size_t>(len), &img, true)) return -1;
  *w = img.w;
  *h = img.h;
  return 0;
}
#endif

}  // extern "C"
