// The libjpeg side of the JPEG fixtures in this directory, for machines
// that have libjpeg (tests/test_torch_jpeg.py builds it with g++ -ljpeg
// when it regenerates the fixtures):
//
//   libjpeg_tool encode <rgb.raw> <w> <h> <h0v0,h1v1,h2v2> <quality>
//                       <progressive 0|1> <arithmetic 0|1> <out.jpg> [options]
//       writes the raw RGB pixels as a YCbCr JPEG with the given sampling
//       factors per component (e.g. 12,11,11 is 4:4:0 and 41,11,11 4:1:1,
//       which PIL cannot write). Options:
//         colorspace=ycck|cmyk  the raw pixels are CMYK (4 bytes a pixel),
//                               written as YCCK or CMYK (4 sampling factors);
//         restart=N             a restart marker every N MCUs;
//         dac=L,U,K             arithmetic conditioning of every table;
//   libjpeg_tool decode <in.jpg> <out.raw>
//       decodes with libjpeg's default settings, writing the width, height
//       and channels (three int32) and the pixels: RGB (out_color_space
//       JCS_RGB), or CMYK as libjpeg gives it for a 4-component stream.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string_view>
#include <vector>

#include <jpeglib.h>

static int encode(int argc, char** a) {
  int w = std::atoi(a[3]), h = std::atoi(a[4]);
  J_COLOR_SPACE space = JCS_YCbCr;
  int restart = 0, dac[3] = {-1, -1, -1};
  for (int i = 10; i < argc; ++i) {
    if (!std::strcmp(a[i], "colorspace=ycck")) space = JCS_YCCK;
    else if (!std::strcmp(a[i], "colorspace=cmyk")) space = JCS_CMYK;
    else if (std::sscanf(a[i], "restart=%d", &restart) == 1) {}
    else if (std::sscanf(a[i], "dac=%d,%d,%d", &dac[0], &dac[1], &dac[2]) == 3) {}
    else return 3;
  }
  const int nc = space == JCS_YCbCr ? 3 : 4;
  std::vector<unsigned char> px(static_cast<size_t>(w) * h * nc);
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
  c.input_components = nc;
  c.in_color_space = nc == 3 ? JCS_RGB : JCS_CMYK;
  jpeg_set_defaults(&c);
  jpeg_set_colorspace(&c, space);
  jpeg_set_quality(&c, std::atoi(a[6]), TRUE);
  int hv[4][2];
  if (std::sscanf(a[5], "%1d%1d,%1d%1d,%1d%1d,%1d%1d", &hv[0][0], &hv[0][1], &hv[1][0], &hv[1][1],
                  &hv[2][0], &hv[2][1], &hv[3][0], &hv[3][1]) != 2 * nc)
    return 3;
  for (int i = 0; i < nc; ++i) {
    c.comp_info[i].h_samp_factor = hv[i][0];
    c.comp_info[i].v_samp_factor = hv[i][1];
  }
  if (std::atoi(a[7])) jpeg_simple_progression(&c);
  c.arith_code = std::atoi(a[8]) ? TRUE : FALSE;
  c.restart_interval = restart;
  if (dac[0] >= 0) {
    for (int i = 0; i < NUM_ARITH_TBLS; ++i) {
      c.arith_dc_L[i] = static_cast<UINT8>(dac[0]);
      c.arith_dc_U[i] = static_cast<UINT8>(dac[1]);
      c.arith_ac_K[i] = static_cast<UINT8>(dac[2]);
    }
  }
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = px.data() + static_cast<size_t>(c.next_scanline) * w * nc;
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
  const int nc = c.num_components == 4 ? 4 : 3;
  c.out_color_space = nc == 4 ? JCS_CMYK : JCS_RGB;
  jpeg_start_decompress(&c);
  int whc[3] = {static_cast<int>(c.output_width), static_cast<int>(c.output_height), nc};
  std::vector<unsigned char> px(static_cast<size_t>(whc[0]) * whc[1] * nc);
  while (c.output_scanline < c.output_height) {
    JSAMPROW row = px.data() + static_cast<size_t>(c.output_scanline) * whc[0] * nc;
    jpeg_read_scanlines(&c, &row, 1);
  }
  jpeg_finish_decompress(&c);
  jpeg_destroy_decompress(&c);
  std::fclose(f);
  FILE* out = std::fopen(a[3], "wb");
  if (!out) return 2;
  std::fwrite(whc, sizeof(int), 3, out);
  std::fwrite(px.data(), 1, px.size(), out);
  std::fclose(out);
  return 0;
}

int main(int argc, char** argv) {
  if (argc >= 10 && std::string_view(argv[1]) == "encode") return encode(argc, argv);
  if (argc == 4 && std::string_view(argv[1]) == "decode") return decode(argv);
  std::fprintf(stderr, "usage: see the comment at the top of libjpeg_tool.cpp\n");
  return 1;
}
