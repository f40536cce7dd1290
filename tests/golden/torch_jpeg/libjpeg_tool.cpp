// The libjpeg side of the JPEG fixtures in this directory, for machines
// that have libjpeg (tests/test_torch_jpeg.py builds it with g++ -ljpeg
// when it regenerates the fixtures):
//
//   libjpeg_tool encode <rgb.raw> <w> <h> <h0v0,h1v1,h2v2> <quality>
//                       <progressive 0|1> <arithmetic 0|1> <out.jpg>
//       writes the raw RGB pixels as a YCbCr JPEG with the given sampling
//       factors per component (e.g. 12,11,11 is 4:4:0 and 41,11,11 4:1:1,
//       which PIL cannot write);
//   libjpeg_tool decode <in.jpg> <out.raw>
//       decodes with libjpeg's default settings and out_color_space JCS_RGB,
//       writing the width and height (two int32) and the RGB pixels.

#include <cstdio>
#include <cstdlib>
#include <string_view>
#include <vector>

#include <jpeglib.h>

static int encode(char** a) {
  int w = std::atoi(a[3]), h = std::atoi(a[4]);
  std::vector<unsigned char> px(static_cast<size_t>(w) * h * 3);
  FILE* f = std::fopen(a[2], "rb");
  if (!f || std::fread(px.data(), 1, px.size(), f) != px.size()) return 2;
  std::fclose(f);
  jpeg_compress_struct c;
  jpeg_error_mgr e;
  c.err = jpeg_std_error(&e);
  jpeg_create_compress(&c);
  FILE* out = std::fopen(a[9], "wb");
  if (!out) return 2;
  jpeg_stdio_dest(&c, out);
  c.image_width = w;
  c.image_height = h;
  c.input_components = 3;
  c.in_color_space = JCS_RGB;
  jpeg_set_defaults(&c);
  jpeg_set_quality(&c, std::atoi(a[6]), TRUE);
  int hv[3][2];
  if (std::sscanf(a[5], "%1d%1d,%1d%1d,%1d%1d", &hv[0][0], &hv[0][1], &hv[1][0], &hv[1][1],
                  &hv[2][0], &hv[2][1]) != 6)
    return 3;
  for (int i = 0; i < 3; ++i) {
    c.comp_info[i].h_samp_factor = hv[i][0];
    c.comp_info[i].v_samp_factor = hv[i][1];
  }
  if (std::atoi(a[7])) jpeg_simple_progression(&c);
  c.arith_code = std::atoi(a[8]) ? TRUE : FALSE;
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = px.data() + static_cast<size_t>(c.next_scanline) * w * 3;
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  std::fclose(out);
  return 0;
}

static int decode(char** a) {
  FILE* f = std::fopen(a[2], "rb");
  if (!f) return 2;
  jpeg_decompress_struct c;
  jpeg_error_mgr e;
  c.err = jpeg_std_error(&e);
  jpeg_create_decompress(&c);
  jpeg_stdio_src(&c, f);
  jpeg_read_header(&c, TRUE);
  c.out_color_space = JCS_RGB;
  jpeg_start_decompress(&c);
  int wh[2] = {static_cast<int>(c.output_width), static_cast<int>(c.output_height)};
  std::vector<unsigned char> px(static_cast<size_t>(wh[0]) * wh[1] * 3);
  while (c.output_scanline < c.output_height) {
    JSAMPROW row = px.data() + static_cast<size_t>(c.output_scanline) * wh[0] * 3;
    jpeg_read_scanlines(&c, &row, 1);
  }
  jpeg_finish_decompress(&c);
  jpeg_destroy_decompress(&c);
  std::fclose(f);
  FILE* out = std::fopen(a[3], "wb");
  if (!out) return 2;
  std::fwrite(wh, sizeof(int), 2, out);
  std::fwrite(px.data(), 1, px.size(), out);
  std::fclose(out);
  return 0;
}

int main(int argc, char** argv) {
  if (argc == 10 && std::string_view(argv[1]) == "encode") return encode(argv);
  if (argc == 4 && std::string_view(argv[1]) == "decode") return decode(argv);
  std::fprintf(stderr, "usage: see the comment at the top of libjpeg_tool.cpp\n");
  return 1;
}
