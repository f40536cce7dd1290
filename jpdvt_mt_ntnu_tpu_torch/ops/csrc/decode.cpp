// Image decode for the port's service, eval harness and datasets: PNG
// scanline filters, JPEG (every stream libjpeg's 8-bit decode takes, below),
// and the ADM center crop with [-1, 1] output.
//
// The port's counterpart of native/src/decode.cpp. It includes no image
// library header and links none: the PNG container (chunks, zlib) is read
// in Python (ops/native.py) and only its five scanline filters are undone
// here (jp_png_unfilter); JPEG is decoded whole here. The decoder holds no
// global state, so threads decode in parallel.
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
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

struct ImageU8 {
  int w = 0, h = 0;
  std::vector<uint8_t> rgb;  // h*w*3
};

// ------------------------------ JPEG -------------------------------------
//
// A whole-image decoder: every scan's coefficients (or, in a lossless frame,
// samples) go into one buffer per component, then the IDCT, the upsampling
// and the colour conversion run once over the image. Each step is
// libjpeg-turbo's integer arithmetic with its default decompression
// settings (JDCT_ISLOW, fancy upsampling, block smoothing, out_color_space
// JCS_RGB), so the pixels are the same bits:
//   - entropy decoding: Huffman (jdhuff.c, jdphuff.c, jdlhuff.c) and
//     arithmetic (jdarith.c, T.81 Annex D), sequential and progressive;
//     a Huffman frame without its tables gets the standard ones in slots 0
//     and 1 (std_huff_tables, as Motion-JPEG frames need);
//   - jidctint.c jpeg_idct_islow (CONST_BITS 13, PASS1_BITS 2, the
//     all-zero column and row shortcuts) and jdmaster.c's range-limit table;
//   - jdcoefct.c decompress_smooth_data: a progressive image whose scans
//     leave one of the first ten coefficients incomplete has them estimated
//     from the DC values of a 5 x 5 block neighbourhood (SAVED_COEFS 10);
//   - jdlossls.c: a lossless frame's predictors 1-7 and point transform;
//   - jdsample.c: h2v1, h2v2 and h1v2 triangle filters where the component
//     is more than two samples wide (h1v2: always), plain replication
//     otherwise, int_upsample for every other integral ratio; the rows
//     above the first and below the last repeat them (jdmainct.c); a
//     lossless frame replicates only (its DCT size is 1);
//   - jdcolor.c's fixed-point YCbCr -> RGB tables (SCALEBITS 16), and
//     ycck_cmyk_convert.
// The colour space is jdapimin.c's guess: JFIF means YCbCr, else the Adobe
// APP14 transform flag, else component ids 'R','G','B' mean RGB (and in a
// lossless frame ids 1, 2, 3 or unknown ones too). Four components are CMYK
// (YCCK where Adobe's flag is not 0), turned into RGB as PIL does: it reads
// libjpeg's CMYK inverted (Adobe's convention) and applies its cmyk2rgb.
// Refused by name as libjpeg's 8-bit decode refuses them: other precisions
// than 8 bits, hierarchical frames, lossless arithmetic coding (SOF11), DNL,
// 2 components, and a lossless frame whose colours need converting. Truncated
// or corrupt entropy data raises with the byte offset, where libjpeg warns
// and fills with zeros; so does a stream without its EOI marker.

struct JpegError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw JpegError{msg}; }

[[noreturn]] void fail_at(const std::string& what, size_t offset) {
  fail(what + " at byte offset " + std::to_string(offset));
}

// Zigzag index -> natural (row-major) index.
const uint8_t kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// T.81 Table D.2 as jaricom.c packs it: Qe << 16 | next MPS index << 8 |
// switch-MPS << 7 | next LPS index. Entry 113 is the fixed 0.5 estimate.
#define V(qe, lps, mps, sw) ((uint32_t{qe} << 16) | (mps << 8) | (sw << 7) | lps)
const uint32_t kAritab[114] = {
    V(0x5a1d, 1, 1, 1),     V(0x2586, 14, 2, 0),    V(0x1114, 16, 3, 0),
    V(0x080b, 18, 4, 0),    V(0x03d8, 20, 5, 0),    V(0x01da, 23, 6, 0),
    V(0x00e5, 25, 7, 0),    V(0x006f, 28, 8, 0),    V(0x0036, 30, 9, 0),
    V(0x001a, 33, 10, 0),   V(0x000d, 35, 11, 0),   V(0x0006, 9, 12, 0),
    V(0x0003, 10, 13, 0),   V(0x0001, 12, 13, 0),   V(0x5a7f, 15, 15, 1),
    V(0x3f25, 36, 16, 0),   V(0x2cf2, 38, 17, 0),   V(0x207c, 39, 18, 0),
    V(0x17b9, 40, 19, 0),   V(0x1182, 42, 20, 0),   V(0x0cef, 43, 21, 0),
    V(0x09a1, 45, 22, 0),   V(0x072f, 46, 23, 0),   V(0x055c, 48, 24, 0),
    V(0x0406, 49, 25, 0),   V(0x0303, 51, 26, 0),   V(0x0240, 52, 27, 0),
    V(0x01b1, 54, 28, 0),   V(0x0144, 56, 29, 0),   V(0x00f5, 57, 30, 0),
    V(0x00b7, 59, 31, 0),   V(0x008a, 60, 32, 0),   V(0x0068, 62, 33, 0),
    V(0x004e, 63, 34, 0),   V(0x003b, 32, 35, 0),   V(0x002c, 33, 9, 0),
    V(0x5ae1, 37, 37, 1),   V(0x484c, 64, 38, 0),   V(0x3a0d, 65, 39, 0),
    V(0x2ef1, 67, 40, 0),   V(0x261f, 68, 41, 0),   V(0x1f33, 69, 42, 0),
    V(0x19a8, 70, 43, 0),   V(0x1518, 72, 44, 0),   V(0x1177, 73, 45, 0),
    V(0x0e74, 74, 46, 0),   V(0x0bfb, 75, 47, 0),   V(0x09f8, 77, 48, 0),
    V(0x0861, 78, 49, 0),   V(0x0706, 79, 50, 0),   V(0x05cd, 48, 51, 0),
    V(0x04de, 50, 52, 0),   V(0x040f, 50, 53, 0),   V(0x0363, 51, 54, 0),
    V(0x02d4, 52, 55, 0),   V(0x025c, 53, 56, 0),   V(0x01f8, 54, 57, 0),
    V(0x01a4, 55, 58, 0),   V(0x0160, 56, 59, 0),   V(0x0125, 57, 60, 0),
    V(0x00f6, 58, 61, 0),   V(0x00cb, 59, 62, 0),   V(0x00ab, 61, 63, 0),
    V(0x008f, 61, 32, 0),   V(0x5b12, 65, 65, 1),   V(0x4d04, 80, 66, 0),
    V(0x412c, 81, 67, 0),   V(0x37d8, 82, 68, 0),   V(0x2fe8, 83, 69, 0),
    V(0x293c, 84, 70, 0),   V(0x2379, 86, 71, 0),   V(0x1edf, 87, 72, 0),
    V(0x1aa9, 87, 73, 0),   V(0x174e, 72, 74, 0),   V(0x1424, 72, 75, 0),
    V(0x119c, 74, 76, 0),   V(0x0f6b, 74, 77, 0),   V(0x0d51, 75, 78, 0),
    V(0x0bb6, 77, 79, 0),   V(0x0a40, 77, 48, 0),   V(0x5832, 80, 81, 1),
    V(0x4d1c, 88, 82, 0),   V(0x438e, 89, 83, 0),   V(0x3bdd, 90, 84, 0),
    V(0x34ee, 91, 85, 0),   V(0x2eae, 92, 86, 0),   V(0x299a, 93, 87, 0),
    V(0x2516, 86, 71, 0),   V(0x5570, 88, 89, 1),   V(0x4ca9, 95, 90, 0),
    V(0x44d9, 96, 91, 0),   V(0x3e22, 97, 92, 0),   V(0x3824, 99, 93, 0),
    V(0x32b4, 99, 94, 0),   V(0x2e17, 93, 86, 0),   V(0x56a8, 95, 96, 1),
    V(0x4f46, 101, 97, 0),  V(0x47e5, 102, 98, 0),  V(0x41cf, 103, 99, 0),
    V(0x3c3d, 104, 100, 0), V(0x375e, 99, 93, 0),   V(0x5231, 105, 102, 0),
    V(0x4c0f, 106, 103, 0), V(0x4639, 107, 104, 0), V(0x415e, 103, 99, 0),
    V(0x5627, 105, 106, 1), V(0x50e7, 108, 107, 0), V(0x4b85, 109, 103, 0),
    V(0x5597, 110, 109, 0), V(0x504f, 111, 107, 0), V(0x5a10, 110, 111, 1),
    V(0x5522, 112, 109, 0), V(0x59eb, 112, 111, 1), V(0x5a1d, 113, 113, 0)};
#undef V

// The standard tables of T.81 K.3 (jstdhuff.c): DC and AC luminance (slot
// 0), DC and AC chrominance (slot 1); counts of code lengths 1-16, values.
const uint8_t kStdDcCounts[2][17] = {{0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
                                     {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
const uint8_t kStdDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdAcCounts[2][17] = {
    {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
    {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
const uint8_t kStdAcVals[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
     0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
     0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
     0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
     0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
     0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
     0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
     0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
     0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
     0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
     0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
     0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
     0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
     0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
     0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
     0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
     0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
     0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
     0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
     0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
     0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
     0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
     0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  int max_sym = 0;
  uint8_t look_len[1 << kLookBits];  // 0: the code is longer than kLookBits
  uint8_t look_sym[1 << kLookBits];
  int32_t maxcode[18];    // largest code of each length, -1 if none
  int32_t valoffset[18];  // index of a length's first value, minus its code
  uint8_t vals[256];
};

// jdhuff.c jpeg_make_d_derived_tbl.
void build_huffman(Huffman* h, const uint8_t counts[17], const uint8_t* vals, int nvals,
                   size_t offset) {
  int p = 0;
  uint8_t sizes[257];
  uint32_t codes[257];
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < counts[l]; ++i) sizes[p++] = static_cast<uint8_t>(l);
  sizes[p] = 0;
  uint32_t code = 0;
  int si = sizes[0];
  p = 0;
  while (sizes[p]) {
    while (sizes[p] == si) codes[p++] = code++;
    if (code >= (1u << si)) fail_at("corrupt JPEG: bad Huffman table", offset);
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (counts[l]) {
      h->valoffset[l] = p - static_cast<int32_t>(codes[p]);
      p += counts[l];
      h->maxcode[l] = static_cast<int32_t>(codes[p - 1]);
    } else {
      h->maxcode[l] = -1;
    }
  }
  h->maxcode[17] = 0x7FFFFFFF;
  std::memset(h->look_len, 0, sizeof h->look_len);
  p = 0;
  for (int l = 1; l <= kLookBits; ++l) {
    for (int i = 0; i < counts[l]; ++i, ++p) {
      uint32_t first = codes[p] << (kLookBits - l);
      for (uint32_t j = 0; j < (1u << (kLookBits - l)); ++j) {
        h->look_len[first + j] = static_cast<uint8_t>(l);
        h->look_sym[first + j] = vals[p];
      }
    }
  }
  std::memcpy(h->vals, vals, nvals);
  h->max_sym = 0;
  for (int i = 0; i < nvals; ++i) h->max_sym = std::max<int>(h->max_sym, vals[i]);
  h->defined = true;
}

// The offset just past the marker at or after `from`, which must be RSTn
// (`expect`); garbage before it is skipped as libjpeg skips it.
size_t restart_marker(const uint8_t* d, size_t n, size_t from, int expect) {
  size_t q = from;
  while (q + 1 < n && !(d[q] == 0xFF && d[q + 1] != 0 && d[q + 1] != 0xFF)) ++q;
  if (q + 1 >= n || d[q + 1] != 0xD0 + expect)
    fail_at("corrupt JPEG: expected restart marker RST" + std::to_string(expect), q);
  return q + 2;
}

// The entropy-coded bits of one Huffman scan or restart interval. Past the
// next marker (or the end of the data) it reads zeros and counts them; a
// decode that consumes one of them is truncated or corrupt.
struct BitReader {
  const uint8_t* d;
  size_t n;
  size_t pos;           // next byte to read
  size_t marker = 0;    // offset of the marker that ended the data, once met
  bool at_marker = false;
  uint64_t buf = 0;
  int cnt = 0;          // valid bits in buf (from the top)
  int pad = 0;          // how many of them are zeros fed past the end

  void fill() {
    while (cnt <= 56) {
      uint64_t b = 0;
      if (!at_marker) {
        if (pos >= n) {
          at_marker = true;
          marker = n;
        } else if (d[pos] != 0xFF) {
          b = d[pos++];
        } else {
          size_t q = pos + 1;
          while (q < n && d[q] == 0xFF) ++q;  // fill bytes, as libjpeg skips them
          if (q < n && d[q] == 0) {           // a stuffed 0xFF data byte
            b = 0xFF;
            pos = q + 1;
          } else {
            at_marker = true;
            marker = pos;
          }
        }
      }
      if (at_marker) pad += 8;
      buf |= b << (56 - cnt);
      cnt += 8;
    }
  }

  void check(size_t scan_start) const {
    if (cnt < pad)
      fail_at("truncated or corrupt JPEG entropy data (the scan from byte offset " +
                  std::to_string(scan_start) + " ends early)",
              at_marker ? marker : pos);
  }

  size_t end() const { return at_marker ? marker : pos; }

  int bits(int k) {  // k in 0..16
    if (k == 0) return 0;
    if (cnt < k) fill();
    int v = static_cast<int>(buf >> (64 - k));
    buf <<= k;
    cnt -= k;
    return v;
  }

  int bit() { return bits(1); }

  int decode(const Huffman& h) {
    if (cnt < 16) fill();
    uint32_t look = static_cast<uint32_t>(buf >> (64 - kLookBits));
    int l = h.look_len[look];
    if (l) {
      buf <<= l;
      cnt -= l;
      return h.look_sym[look];
    }
    uint32_t code = static_cast<uint32_t>(buf >> (64 - kLookBits));
    l = kLookBits;
    while (static_cast<int32_t>(code) > h.maxcode[l]) {
      ++l;
      if (l > 16) fail_at("corrupt JPEG: bad Huffman code", pos);
      code = static_cast<uint32_t>(buf >> (64 - l));
    }
    buf <<= l;
    cnt -= l;
    return h.vals[h.valoffset[l] + static_cast<int32_t>(code)];
  }

  // Drop the bits left of this interval and step over the next marker.
  void restart(int expect) {
    pos = restart_marker(d, n, end(), expect);
    at_marker = false;
    buf = 0;
    cnt = pad = 0;
  }
};

// jdarith.c's decoder: the C and A registers and the bit counter. A marker
// met inside the data feeds zeros from then on, which is legal in
// arithmetic coding (T.81 D.2.6), so truncation is not detectable here.
struct ArithReader {
  const uint8_t* d;
  size_t n;
  size_t pos;
  size_t marker = 0;
  bool at_marker = false;
  int64_t c = 0, a = 0;
  int ct = -16;  // -16: the two initial bytes are still to be read

  size_t end() const { return at_marker ? marker : pos; }

  int byte() {
    if (at_marker) return 0;
    if (pos >= n) {
      at_marker = true;
      marker = n;
      return 0;
    }
    int v = d[pos++];
    if (v != 0xFF) return v;
    size_t q = pos;
    while (q < n && d[q] == 0xFF) ++q;  // extra 0xFF bytes are swallowed
    if (q < n && d[q] == 0) {           // a stuffed zero: the data byte 0xFF
      pos = q + 1;
      return 0xFF;
    }
    at_marker = true;
    marker = pos - 1;
    return 0;
  }

  // jdarith.c arith_decode: one binary decision with the statistics bin st.
  int decode(uint8_t* st) {
    while (a < 0x8000) {  // renormalisation and data input, D.2.6
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;  // the 2 initial bytes are in
      }
      a <<= 1;
    }
    int sv = *st;
    uint32_t qe = kAritab[sv & 0x7F];
    const int nl = qe & 0xFF;
    qe >>= 8;
    const int nm = qe & 0xFF;
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {  // conditional LPS exchange
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {  // conditional MPS exchange
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  void restart(int expect) {
    pos = restart_marker(d, n, end(), expect);
    at_marker = false;
    c = a = 0;
    ct = -16;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;      // blocks (lossless: samples) that hold the component
  int stride = 0;          // blocks per row of coef (MCU-padded)
  int dw = 0, dh = 0;      // downsampled width and height
  std::vector<int16_t> coef;
  std::vector<uint16_t> samples;  // lossless: dw x dh, before the point transform
  bool scanned = false, latched = false;
  int32_t q[64];           // the quantisation table, natural order
  int coef_bits[64];       // progressive: -1 until a scan sends the coefficient
  int dc_tbl = 0, ac_tbl = 0, last_dc = 0, dc_context = 0;
  int pt = 0;              // lossless: the point transform of its scan
  bool first_row = true;   // lossless: the next row uses the first row's predictor
  int16_t* block(int by, int bx) {
    return coef.data() + (static_cast<size_t>(by) * stride + bx) * 64;
  }
};

struct Jpeg {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int mcux = 0, mcuy = 0, restart_interval = 0;
  bool progressive = false, arithmetic = false, lossless = false, have_frame = false;
  bool jfif = false, adobe = false, std_tables = false;
  int adobe_transform = -1;
  std::vector<Component> comp;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  // Arithmetic conditioning (DAC; jdmarker.c's defaults) and statistics.
  uint8_t arith_dc_L[16], arith_dc_U[16], arith_ac_K[16];
  uint8_t dc_stats[16][64], ac_stats[16][256];

  Jpeg(const uint8_t* data, size_t len) : d(data), n(len) {
    std::memset(arith_dc_L, 0, sizeof arith_dc_L);
    std::memset(arith_dc_U, 1, sizeof arith_dc_U);
    std::memset(arith_ac_K, 5, sizeof arith_ac_K);
  }

  int u8() {
    if (pos >= n) fail_at("truncated JPEG", pos);
    return d[pos++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  // The next marker code; garbage before it, and stuffed FF 00 pairs left of
  // an entropy-coded segment, are skipped (libjpeg warns).
  int next_marker() {
    for (;;) {
      while (pos < n && d[pos] != 0xFF) ++pos;
      while (pos < n && d[pos] == 0xFF) ++pos;
      if (pos >= n) fail_at("truncated JPEG: no EOI marker", n);
      int m = d[pos++];
      if (m) return m;
    }
  }

  // The frame header; the buffers it sizes are allocated by alloc_buffers,
  // which a probe never calls.
  void read_sof(int marker) {
    size_t at = pos - 2;
    if (have_frame) fail_at("corrupt JPEG: a second frame header", at);
    int len = u16();
    int precision = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    if (len != 8 + 3 * ncomp) fail_at("corrupt JPEG: bad SOF length", at);
    if (precision != 8)
      fail(std::to_string(precision) + "-bit JPEG (12-bit JPEG is not ported; libjpeg's "
           "8-bit decode refuses it too)");
    if (height == 0)
      fail("JPEG whose height is given by a DNL marker (DNL is not ported)");
    if (width == 0) fail_at("corrupt JPEG: image width 0", at);
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      fail(std::to_string(ncomp) + "-component JPEG (the port decodes 1, 3 or 4; libjpeg "
           "converts no other count to RGB)");
    comp.resize(ncomp);
    for (auto& c : comp) {
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail_at("corrupt JPEG: bad sampling factors or table", at);
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    progressive = marker == 0xC2 || marker == 0xCA;
    arithmetic = marker >= 0xC9;
    lossless = marker == 0xC3;
    const int unit = lossless ? 1 : 8;  // a lossless data unit is one sample
    mcux = (width + unit * hmax - 1) / (unit * hmax);
    mcuy = (height + unit * vmax - 1) / (unit * vmax);
    for (auto& c : comp) {
      if (hmax % c.h || vmax % c.v)
        fail("JPEG with fractional sampling ratios (libjpeg refuses them too)");
      c.dw = static_cast<int>((static_cast<long>(width) * c.h + hmax - 1) / hmax);
      c.dh = static_cast<int>((static_cast<long>(height) * c.v + vmax - 1) / vmax);
      c.bw = (c.dw + unit - 1) / unit;
      c.bh = (c.dh + unit - 1) / unit;
      c.stride = mcux * c.h;
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
    }
    have_frame = true;
  }

  void alloc_buffers() {
    for (auto& c : comp) {
      if (lossless)
        c.samples.assign(static_cast<size_t>(c.dw) * c.dh, 0);
      else
        c.coef.assign(static_cast<size_t>(c.stride) * mcuy * c.v * 64, 0);
    }
  }

  void read_dht() {
    size_t end = pos + u16();
    while (pos < end) {
      size_t at = pos;
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail_at("corrupt JPEG: bad Huffman table id", at);
      uint8_t counts[17] = {0};
      int total = 0;
      for (int l = 1; l <= 16; ++l) total += counts[l] = static_cast<uint8_t>(u8());
      if (total > 256 || pos + total > end)
        fail_at("corrupt JPEG: bad Huffman table length", at);
      uint8_t vals[256];
      for (int i = 0; i < total; ++i) vals[i] = static_cast<uint8_t>(u8());
      build_huffman(tc ? &ac[th] : &dc[th], counts, vals, total, at);
    }
    if (pos != end) fail_at("corrupt JPEG: bad DHT length", pos);
  }

  // jdmarker.c get_dac: arithmetic conditioning, L and U of a DC table, K of
  // an AC table.
  void read_dac() {
    size_t at = pos - 2;
    size_t end = pos + u16();
    while (pos + 2 <= end) {
      int index = u8(), val = u8();
      if (index >= 32) fail_at("corrupt JPEG: bad DAC table index", at);
      if (index >= 16) {
        arith_ac_K[index - 16] = static_cast<uint8_t>(val);
      } else {
        arith_dc_L[index] = static_cast<uint8_t>(val & 15);
        arith_dc_U[index] = static_cast<uint8_t>(val >> 4);
        if (arith_dc_L[index] > arith_dc_U[index]) fail_at("corrupt JPEG: bad DAC value", at);
      }
    }
    if (pos != end) fail_at("corrupt JPEG: bad DAC length", at);
  }

  void read_dqt() {
    size_t end = pos + u16();
    while (pos < end) {
      int pq_tq = u8();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (pq > 1 || tq > 3) fail_at("corrupt JPEG: bad quantisation table", pos - 1);
      for (int i = 0; i < 64; ++i) qt[tq][kNatural[i]] = static_cast<uint16_t>(pq ? u16() : u8());
      qt_defined[tq] = true;
    }
    if (pos != end) fail_at("corrupt JPEG: bad DQT length", pos);
  }

  void read_app(int marker) {
    size_t start = pos;
    int len = u16();
    if (len < 2 || start + len > n) fail_at("truncated JPEG marker segment", start);
    const uint8_t* p = d + start + 2;
    size_t dl = len - 2;
    if (marker == 0xE0 && dl >= 14 && !std::memcmp(p, "JFIF\0", 5)) jfif = true;
    if (marker == 0xEE && dl >= 12 && !std::memcmp(p, "Adobe", 5)) {
      adobe = true;
      adobe_transform = p[11];
    }
    pos = start + len;
  }

  void skip_segment() {
    size_t start = pos;
    int len = u16();
    if (len < 2 || start + len > n) fail_at("truncated JPEG marker segment", start);
    pos = start + len;
  }

  // The quantisation table is copied at the component's first scan, as
  // jdinput.c latch_quant_tables does; a lossless frame has none.
  void latch(Component& c) {
    c.scanned = true;
    if (c.latched || lossless) return;
    if (!qt_defined[c.tq]) fail("corrupt JPEG: a component's quantisation table is missing");
    for (int i = 0; i < 64; ++i) c.q[i] = qt[c.tq][i];
    c.latched = true;
  }

  // jdhuff.c std_huff_tables: slots 0 and 1 still empty when decompression
  // starts get the standard tables (Motion-JPEG frames leave them out).
  void fill_std_tables() {
    if (std_tables) return;
    std_tables = true;
    for (int t = 0; t < 2; ++t) {
      if (!dc[t].defined) build_huffman(&dc[t], kStdDcCounts[t], kStdDcVals, 12, 0);
      if (!ac[t].defined) build_huffman(&ac[t], kStdAcCounts[t], kStdAcVals[t], 162, 0);
    }
  }

  template <class Block, class Restart>
  void walk(std::vector<Component*>& sc, Block&& block, Restart&& restart);
  void read_sos();
  void decode_scan(std::vector<Component*>& sc, int ss, int se, int ah, int al, size_t at);
  void decode_arith_scan(std::vector<Component*>& sc, int ss, int se, int ah, int al);
  int arith_dc(ArithReader& ar, Component* c);
  void arith_ac(ArithReader& ar, int tbl, int16_t* blk, int ss, int se, int al, uint8_t* fixed);
  void decode_lossless_scan(std::vector<Component*>& sc, int psv, int pt, size_t at);
  bool smoothing_ok() const;
  void smooth_idct(Component& c, uint8_t* s, int istride, const uint8_t* range);
  void finish(std::vector<uint8_t>* rgb);
  void decode(std::vector<uint8_t>* rgb, bool header_only);
};

void Jpeg::read_sos() {
  size_t at = pos - 2;
  if (!have_frame) fail_at("corrupt JPEG: a scan before the frame header", at);
  int len = u16();
  int ns = u8();
  if (ns < 1 || ns > 4 || len != 6 + 2 * ns) fail_at("corrupt JPEG: bad SOS header", at);
  std::vector<Component*> sc;
  for (int i = 0; i < ns; ++i) {
    int id = u8(), tables = u8();
    Component* c = nullptr;
    for (auto& k : comp)
      if (k.id == id) c = &k;
    if (!c) fail_at("corrupt JPEG: a scan names an unknown component", at);
    for (auto* k : sc)
      if (k == c) fail_at("corrupt JPEG: a scan names a component twice", at);
    c->dc_tbl = tables >> 4;  // arithmetic tables are 0..15, Huffman ones 0..3
    c->ac_tbl = tables & 15;
    if (!arithmetic && (c->dc_tbl > 3 || c->ac_tbl > 3))
      fail_at("corrupt JPEG: bad table in SOS", at);
    sc.push_back(c);
  }
  int ss = u8(), se = u8(), ahal = u8();
  int ah = ahal >> 4, al = ahal & 15;
  if (lossless) {  // Ss is the predictor, Al the point transform
    if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= 8)
      fail_at("corrupt JPEG: bad lossless scan parameters", at);
  } else if (progressive) {
    bool bad = ss > se || se > 63 || al > 13 || (ah && al != ah - 1) ||
               (ss == 0 && se != 0) || (ss > 0 && ns != 1);
    if (bad) fail_at("corrupt JPEG: bad progressive scan parameters", at);
  } else {
    ss = 0;  // libjpeg ignores a sequential scan's spectral fields
    se = 63;
    ah = al = 0;
  }
  if (sc.size() > 1) {
    int blocks = 0;
    for (auto* c : sc) blocks += c->h * c->v;
    if (blocks > 10) fail_at("corrupt JPEG: more than 10 blocks in an MCU", at);
  }
  if (!arithmetic) fill_std_tables();
  const bool need_dc = lossless || !progressive || (ss == 0 && ah == 0);
  const bool need_ac = !lossless && (!progressive || ss > 0);
  for (auto* c : sc) {
    latch(*c);
    if (progressive)
      for (int k = ss; k <= se; ++k) c->coef_bits[k] = al;
    if (arithmetic) continue;
    if (need_dc && !dc[c->dc_tbl].defined)
      fail_at("corrupt JPEG: DC Huffman table " + std::to_string(c->dc_tbl) +
                  " is not defined",
              at);
    if (need_dc && dc[c->dc_tbl].max_sym > (lossless ? 16 : 15))
      fail_at("corrupt JPEG: DC Huffman symbol above " + std::string(lossless ? "16" : "15"),
              at);
    if (need_ac && !ac[c->ac_tbl].defined)
      fail_at("corrupt JPEG: AC Huffman table " + std::to_string(c->ac_tbl) +
                  " is not defined",
              at);
  }
  if (lossless)
    decode_lossless_scan(sc, ss, al, at);
  else if (arithmetic)
    decode_arith_scan(sc, ss, se, ah, al);
  else
    decode_scan(sc, ss, se, ah, al, at);
}

// The blocks of a DCT scan in stream order: a single-component scan is not
// interleaved (one block per MCU over the blocks that hold samples);
// otherwise each MCU holds h x v blocks of each component. `restart(n)`
// runs where restart interval n (mod 8) begins, after the first.
template <class Block, class Restart>
void Jpeg::walk(std::vector<Component*>& sc, Block&& block, Restart&& restart) {
  const bool single = sc.size() == 1;
  const long units = single ? static_cast<long>(sc[0]->bw) * sc[0]->bh
                            : static_cast<long>(mcux) * mcuy;
  int rst = 0;
  for (long u = 0; u < units; ++u) {
    if (restart_interval && u && u % restart_interval == 0) {
      restart(rst);
      rst = (rst + 1) & 7;
    }
    if (single) {
      Component* c = sc[0];
      block(c, c->block(static_cast<int>(u / c->bw), static_cast<int>(u % c->bw)));
    } else {
      int my = static_cast<int>(u / mcux), mx = static_cast<int>(u % mcux);
      for (auto* c : sc)
        for (int by = 0; by < c->v; ++by)
          for (int bx = 0; bx < c->h; ++bx) block(c, c->block(my * c->v + by, mx * c->h + bx));
    }
  }
}

void Jpeg::decode_scan(std::vector<Component*>& sc, int ss, int se, int ah, int al,
                       size_t at) {
  BitReader br{d, n, pos};
  for (auto* c : sc) c->last_dc = 0;
  int eobrun = 0;
  const int p1 = 1 << al, m1 = -1 * (1 << al);

  auto decode_block = [&](Component* c, int16_t* blk) {
    if (!progressive) {
      int s = br.decode(dc[c->dc_tbl]);
      if (s) s = extend(br.bits(s), s);
      c->last_dc += s;
      blk[0] = static_cast<int16_t>(c->last_dc);
      const Huffman& t = ac[c->ac_tbl];
      for (int k = 1; k < 64; ++k) {
        int rs = br.decode(t);
        int r = rs >> 4, sz = rs & 15;
        if (sz) {
          k += r;
          if (k > 63) fail_at("corrupt JPEG: coefficient index past 63", br.pos);
          blk[kNatural[k]] = static_cast<int16_t>(extend(br.bits(sz), sz));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
      return;
    }
    if (ss == 0) {  // DC scans, interleaved or not
      if (ah == 0) {
        int s = br.decode(dc[c->dc_tbl]);
        if (s) s = extend(br.bits(s), s);
        c->last_dc += s;
        blk[0] = static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(c->last_dc) << al));
      } else if (br.bit()) {
        blk[0] = static_cast<int16_t>(blk[0] | p1);
      }
      return;
    }
    const Huffman& t = ac[c->ac_tbl];
    if (ah == 0) {  // AC first
      if (eobrun > 0) {
        --eobrun;
        return;
      }
      for (int k = ss; k <= se; ++k) {
        int rs = br.decode(t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          if (k > se) fail_at("corrupt JPEG: coefficient index past the band", br.pos);
          blk[kNatural[k]] =
              static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(extend(br.bits(s), s)) << al));
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun = (1 << r) - 1;
          if (r) eobrun += br.bits(r);
          break;
        }
      }
      return;
    }
    // AC refinement (jdphuff.c decode_mcu_AC_refine).
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int rs = br.decode(t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) fail_at("corrupt JPEG: bad refinement coefficient size", br.pos);
          s = br.bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.bits(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (br.bit() && (*coef & p1) == 0)
              *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) {
          if (k > se) fail_at("corrupt JPEG: coefficient index past the band", br.pos);
          blk[kNatural[k]] = static_cast<int16_t>(s);
        }
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0 && br.bit() && (*coef & p1) == 0)
          *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
      }
      --eobrun;
    }
  };

  walk(
      sc,
      [&](Component* c, int16_t* blk) {
        decode_block(c, blk);
        br.check(at);
      },
      [&](int rst) {
        br.restart(rst);
        for (auto* c : sc) c->last_dc = 0;
        eobrun = 0;
      });
  pos = br.end();
}

// jdarith.c, Figures F.19-F.24: a DC difference, its context kept per
// component.
int Jpeg::arith_dc(ArithReader& ar, Component* c) {
  const int tbl = c->dc_tbl;
  uint8_t* st = dc_stats[tbl] + c->dc_context;
  if (ar.decode(st) == 0) {
    c->dc_context = 0;
    return 0;
  }
  const int sign = ar.decode(st + 1);
  st += 2 + sign;
  int m = ar.decode(st);
  if (m) {
    st = dc_stats[tbl] + 20;  // X1
    while (ar.decode(st)) {
      if ((m <<= 1) == 0x8000)
        fail_at("corrupt JPEG: arithmetic-coded magnitude overflows", ar.end());
      ++st;
    }
  }
  if (m < static_cast<int>((1L << arith_dc_L[tbl]) >> 1))
    c->dc_context = 0;
  else if (m > static_cast<int>((1L << arith_dc_U[tbl]) >> 1))
    c->dc_context = 12 + sign * 4;
  else
    c->dc_context = 4 + sign * 4;
  int v = m;
  st += 14;
  while (m >>= 1)
    if (ar.decode(st)) v |= m;
  v += 1;
  return sign ? -v : v;
}

// The AC coefficients ss..se of one block (jdarith.c decode_mcu's second
// half, and decode_mcu_AC_first), scaled by 2^al.
void Jpeg::arith_ac(ArithReader& ar, int tbl, int16_t* blk, int ss, int se, int al,
                    uint8_t* fixed) {
  uint8_t* stats = ac_stats[tbl];
  for (int k = ss; k <= se; ++k) {
    uint8_t* st = stats + 3 * (k - 1);
    if (ar.decode(st)) break;  // end of block
    while (ar.decode(st + 1) == 0) {
      st += 3;
      if (++k > se) fail_at("corrupt JPEG: arithmetic-coded coefficient past the band", ar.end());
    }
    const int sign = ar.decode(fixed);
    st += 2;
    int m = ar.decode(st);
    if (m && ar.decode(st)) {
      m <<= 1;
      st = stats + (k <= arith_ac_K[tbl] ? 189 : 217);
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000)
          fail_at("corrupt JPEG: arithmetic-coded magnitude overflows", ar.end());
        ++st;
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    blk[kNatural[k]] = static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(v) << al));
  }
}

void Jpeg::decode_arith_scan(std::vector<Component*>& sc, int ss, int se, int ah, int al) {
  ArithReader ar{d, n, pos};
  uint8_t fixed = 113;  // the fixed 0.5 estimate: its state never moves
  const bool dc_first = !progressive || (ss == 0 && ah == 0);
  const bool has_ac = !progressive || ss > 0;
  auto reset = [&] {  // at the scan's start and at each restart
    for (auto* c : sc) {
      if (dc_first) {
        std::memset(dc_stats[c->dc_tbl], 0, sizeof dc_stats[0]);
        c->last_dc = c->dc_context = 0;
      }
      if (has_ac) std::memset(ac_stats[c->ac_tbl], 0, sizeof ac_stats[0]);
    }
  };
  reset();
  const int p1 = 1 << al, m1 = -1 * (1 << al);
  auto block = [&](Component* c, int16_t* blk) {
    if (!progressive) {
      c->last_dc = (c->last_dc + arith_dc(ar, c)) & 0xFFFF;
      blk[0] = static_cast<int16_t>(c->last_dc);
      arith_ac(ar, c->ac_tbl, blk, 1, 63, 0, &fixed);
      return;
    }
    if (ss == 0) {
      if (ah == 0) {
        c->last_dc = (c->last_dc + arith_dc(ar, c)) & 0xFFFF;
        blk[0] = static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(c->last_dc) << al));
      } else if (ar.decode(&fixed)) {
        blk[0] = static_cast<int16_t>(blk[0] | p1);
      }
      return;
    }
    if (ah == 0) {
      arith_ac(ar, c->ac_tbl, blk, ss, se, al, &fixed);
      return;
    }
    // AC refinement (decode_mcu_AC_refine): past the block's own end of
    // band (the last coefficient already nonzero) an end-of-block may come.
    int kex = se;
    while (kex > 0 && !blk[kNatural[kex]]) --kex;
    uint8_t* stats = ac_stats[c->ac_tbl];
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = stats + 3 * (k - 1);
      if (k > kex && ar.decode(st)) break;
      for (;;) {
        int16_t* coef = blk + kNatural[k];
        if (*coef) {  // previously nonzero: a correction bit
          if (ar.decode(st + 2)) *coef = static_cast<int16_t>(*coef + (*coef < 0 ? m1 : p1));
          break;
        }
        if (ar.decode(st + 1)) {  // newly nonzero
          *coef = static_cast<int16_t>(ar.decode(&fixed) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se)
          fail_at("corrupt JPEG: arithmetic-coded coefficient past the band", ar.end());
      }
    }
  };
  walk(sc, block, [&](int rst) {
    ar.restart(rst);
    reset();
  });
  pos = ar.end();
}

// A lossless scan (jddiffct.c, jdlhuff.c, jdlossls.c): Huffman-coded
// differences, one per sample, undone row by row with predictor psv. The
// first row, and the first after a restart, predicts from 2^(7 - pt) and
// then from the left; a restart takes effect for the whole iMCU row it
// falls in, as libjpeg applies it when that row is undifferenced.
void Jpeg::decode_lossless_scan(std::vector<Component*>& sc, int psv, int pt, size_t at) {
  BitReader br{d, n, pos};
  const bool single = sc.size() == 1;
  const int per_row = single ? sc[0]->dw : mcux;  // MCUs in an MCU row
  if (restart_interval % per_row)
    fail("lossless JPEG whose restart interval is not a whole number of MCU rows "
         "(libjpeg refuses it too)");
  const int rows_per_restart = restart_interval / per_row;
  int rows_to_go = rows_per_restart, rst = 0;
  std::vector<std::vector<int>> diff(sc.size());
  std::vector<int> width(sc.size());  // coded samples per row, padding included
  for (size_t k = 0; k < sc.size(); ++k) {
    width[k] = single ? sc[k]->dw : mcux * sc[k]->h;
    diff[k].assign(static_cast<size_t>(width[k]) * sc[k]->v, 0);
    sc[k]->pt = pt;
  }
  auto sample = [&](Component* c) {
    int s = br.decode(dc[c->dc_tbl]);
    if (s == 16) return 32768;
    return s ? extend(br.bits(s), s) : 0;
  };
  const int init = 1 << (7 - pt);
  for (int i = 0; i < mcuy; ++i) {
    bool reset = i == 0;
    const int mcu_rows = single ? std::min(sc[0]->v, sc[0]->dh - i * sc[0]->v) : 1;
    for (int r = 0; r < mcu_rows; ++r) {
      if (restart_interval) {
        if (rows_to_go == 0) {
          br.restart(rst);
          rst = (rst + 1) & 7;
          reset = true;
          rows_to_go = rows_per_restart;
        }
        --rows_to_go;
      }
      for (int m = 0; m < per_row; ++m) {
        if (single) {
          diff[0][static_cast<size_t>(r) * width[0] + m] = sample(sc[0]);
        } else {
          for (size_t k = 0; k < sc.size(); ++k)
            for (int y = 0; y < sc[k]->v; ++y)
              for (int x = 0; x < sc[k]->h; ++x)
                diff[k][static_cast<size_t>(y) * width[k] + m * sc[k]->h + x] = sample(sc[k]);
        }
        br.check(at);
      }
    }
    for (size_t k = 0; k < sc.size(); ++k) {
      Component& c = *sc[k];
      if (reset) c.first_row = true;
      const int rows = std::min(c.v, c.dh - i * c.v);
      for (int y = 0; y < rows; ++y) {
        const int row = i * c.v + y;
        const int* df = diff[k].data() + static_cast<size_t>(y) * width[k];
        uint16_t* out = c.samples.data() + static_cast<size_t>(row) * c.dw;
        if (c.first_row) {  // jpeg_undifference_first_row
          int ra = (df[0] + init) & 0xFFFF;
          out[0] = static_cast<uint16_t>(ra);
          for (int x = 1; x < c.dw; ++x) out[x] = static_cast<uint16_t>(ra = (df[x] + ra) & 0xFFFF);
          c.first_row = false;
          continue;
        }
        const uint16_t* prev = out - c.dw;
        int rb = prev[0], rc = 0;
        int ra = (df[0] + rb) & 0xFFFF;
        out[0] = static_cast<uint16_t>(ra);
        for (int x = 1; x < c.dw; ++x) {
          rc = rb;
          rb = prev[x];
          int p;
          switch (psv) {
            case 1: p = ra; break;
            case 2: p = rb; break;
            case 3: p = rc; break;
            case 4: p = ra + rb - rc; break;
            case 5: p = ra + ((rb - rc) >> 1); break;
            case 6: p = rb + ((ra - rc) >> 1); break;
            default: p = (ra + rb) >> 1; break;
          }
          out[x] = static_cast<uint16_t>(ra = (df[x] + p) & 0xFFFF);
        }
      }
    }
  }
  pos = br.end();
}

// jidctint.c jpeg_idct_islow, into an 8 x 8 tile of `out` (row stride ostride).
constexpr int kConstBits = 13, kPass1Bits = 2;

inline int32_t descale(int64_t x, int n) { return static_cast<int32_t>((x + (int64_t{1} << (n - 1))) >> n); }

struct RangeLimit {
  uint8_t t[1024];  // jdmaster.c's post-IDCT table, indexed by x & 1023
  RangeLimit() {
    for (int i = 0; i < 1024; ++i)
      t[i] = static_cast<uint8_t>(i < 128 ? i + 128 : i < 512 ? 255 : i < 896 ? 0 : i - 896);
  }
};

void idct_islow(const int16_t* in, const int32_t* q, uint8_t* out, size_t ostride,
                const uint8_t* range) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const int32_t* qp = q + c;
    int32_t* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int32_t dcval = static_cast<int32_t>(static_cast<uint32_t>(ip[0] * qp[0]) << kPass1Bits);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dcval;
      continue;
    }
    int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * 4433;
    int64_t tmp2 = z1 + z3 * -15137;
    int64_t tmp3 = z1 + z2 * 6270;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * 9633;
    tmp0 *= 2446;
    tmp1 *= 16819;
    tmp2 *= 25172;
    tmp3 *= 12299;
    z1 *= -7373;
    z2 *= -20995;
    z3 *= -16069;
    z4 *= -3196;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    wp[0] = descale(tmp10 + tmp3, sh);
    wp[56] = descale(tmp10 - tmp3, sh);
    wp[8] = descale(tmp11 + tmp2, sh);
    wp[48] = descale(tmp11 - tmp2, sh);
    wp[16] = descale(tmp12 + tmp1, sh);
    wp[40] = descale(tmp12 - tmp1, sh);
    wp[24] = descale(tmp13 + tmp0, sh);
    wp[32] = descale(tmp13 - tmp0, sh);
  }
  const int sh = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int32_t* wp = ws + 8 * r;
    uint8_t* op = out + r * ostride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      uint8_t v = range[descale(wp[0], kPass1Bits + 3) & 1023];
      for (int c = 0; c < 8; ++c) op[c] = v;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * 4433;
    int64_t tmp2 = z1 + z3 * -15137;
    int64_t tmp3 = z1 + z2 * 6270;
    int64_t tmp0 = (static_cast<int64_t>(wp[0]) + wp[4]) * (1 << kConstBits);
    int64_t tmp1 = (static_cast<int64_t>(wp[0]) - wp[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * 9633;
    tmp0 *= 2446;
    tmp1 *= 16819;
    tmp2 *= 25172;
    tmp3 *= 12299;
    z1 *= -7373;
    z2 *= -20995;
    z3 *= -16069;
    z4 *= -3196;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = range[descale(tmp10 + tmp3, sh) & 1023];
    op[7] = range[descale(tmp10 - tmp3, sh) & 1023];
    op[1] = range[descale(tmp11 + tmp2, sh) & 1023];
    op[6] = range[descale(tmp11 - tmp2, sh) & 1023];
    op[2] = range[descale(tmp12 + tmp1, sh) & 1023];
    op[5] = range[descale(tmp12 - tmp1, sh) & 1023];
    op[3] = range[descale(tmp13 + tmp0, sh) & 1023];
    op[4] = range[descale(tmp13 - tmp0, sh) & 1023];
  }
}

// jdcoefct.c smoothing_ok: every component has its DC and nonzero
// quantisers at the ten positions, and some first AC coefficient is not
// known to full precision.
bool Jpeg::smoothing_ok() const {
  if (!progressive) return false;
  static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
  bool useful = false;
  for (const auto& c : comp) {
    if (!c.latched || c.coef_bits[0] < 0) return false;
    for (int p : kPos)
      if (c.q[p] == 0) return false;
    for (int k = 1; k < 10; ++k)
      if (c.coef_bits[k] != 0) useful = true;
  }
  return useful;
}

// jdcoefct.c decompress_smooth_data (libjpeg-turbo 2.1+): each block's
// first nine AC coefficients that are still zero and not known exactly,
// and with DC scans alone its DC too, are estimated from the DC values of
// its 5 x 5 neighbourhood, then the block goes through the IDCT. The rows
// and columns past the image repeat the edge as libjpeg's buffer pointers
// do, iMCU row by iMCU row.
void Jpeg::smooth_idct(Component& c, uint8_t* s, int istride, const uint8_t* range) {
  const int* bits = c.coef_bits;
  bool change_dc = true;
  for (int k = 1; k < 10; ++k) change_dc = change_dc && bits[k] == -1;
  const int64_t Q00 = c.q[0], Q01 = c.q[1], Q10 = c.q[8], Q20 = c.q[16], Q11 = c.q[9],
                Q02 = c.q[2], Q03 = c.q[3], Q12 = c.q[10], Q21 = c.q[17], Q30 = c.q[24];
  auto pred = [](int64_t num, int64_t q, int al) {
    int p = static_cast<int>(((q << 7) + (num >= 0 ? num : -num)) / (q << 8));
    if (al > 0 && p >= (1 << al)) p = (1 << al) - 1;
    return static_cast<int16_t>(num >= 0 ? p : -p);
  };
  const int last = mcuy - 1;  // the last iMCU row
  const int last_col = c.bw - 1;
  int16_t ws[64];
  for (int by = 0; by < c.bh; ++by) {
    const int i = by / c.v, br = by % c.v;
    int rows = c.v;
    if (i == last) {
      rows = c.bh % c.v;
      if (!rows) rows = c.v;
    }
    // decompress_smooth_data's row bounds: it counts image block rows as
    // iMCU row x (this iMCU row's block rows) + block row, over that count x
    // the iMCU rows. So the padding rows of the last iMCU row serve as
    // neighbours from above, and within the last iMCU row the count is off
    // where it holds fewer than v block rows; the pixels are libjpeg's.
    const int ibr = i * rows + br, ibrs = rows * mcuy;
    const int prev = ibr > 0 ? by - 1 : by;
    const int pprev = ibr > 1 ? by - 2 : prev;
    const int next = ibr < ibrs - 1 ? by + 1 : by;
    const int nnext = ibr < ibrs - 2 ? by + 2 : next;
    const int16_t* r1 = c.block(pprev, 0);
    const int16_t* r2 = c.block(prev, 0);
    const int16_t* r3 = c.block(by, 0);
    const int16_t* r4 = c.block(next, 0);
    const int16_t* r5 = c.block(nnext, 0);
    for (int bx = 0; bx <= last_col; ++bx) {
      // The DC values of the 5 x 5 neighbourhood, DC13 this block's; the
      // columns past the image repeat its edge.
      auto dc = [&](const int16_t* row, int dx) {
        return static_cast<int>(row[std::clamp(bx + dx, 0, last_col) * 64]);
      };
      const int DC01 = dc(r1, -2), DC02 = dc(r1, -1), DC03 = dc(r1, 0), DC04 = dc(r1, 1),
                DC05 = dc(r1, 2), DC06 = dc(r2, -2), DC07 = dc(r2, -1), DC08 = dc(r2, 0),
                DC09 = dc(r2, 1), DC10 = dc(r2, 2), DC11 = dc(r3, -2), DC12 = dc(r3, -1),
                DC13 = dc(r3, 0), DC14 = dc(r3, 1), DC15 = dc(r3, 2), DC16 = dc(r4, -2),
                DC17 = dc(r4, -1), DC18 = dc(r4, 0), DC19 = dc(r4, 1), DC20 = dc(r4, 2),
                DC21 = dc(r5, -2), DC22 = dc(r5, -1), DC23 = dc(r5, 0), DC24 = dc(r5, 1),
                DC25 = dc(r5, 2);
      std::memcpy(ws, c.block(by, bx), sizeof ws);
      if (bits[1] != 0 && ws[1] == 0)  // AC01
        ws[1] = pred(Q00 * (change_dc ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 -
                                         13 * DC09 + 3 * DC10 - 3 * DC11 + 38 * DC12 -
                                         38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 -
                                         13 * DC19 + 3 * DC20 - DC21 - DC22 + DC24 + DC25)
                                      : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15)),
                     Q01, bits[1]);
      if (bits[2] != 0 && ws[8] == 0)  // AC10
        ws[8] = pred(Q00 * (change_dc ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 +
                                         13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 + DC16 -
                                         13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
                                         3 * DC22 + 3 * DC23 + 3 * DC24 + DC25)
                                      : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23)),
                     Q10, bits[2]);
      if (bits[3] != 0 && ws[16] == 0)  // AC20
        ws[16] = pred(Q00 * (change_dc ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 -
                                          14 * DC13 - 5 * DC14 + 2 * DC17 + 7 * DC18 +
                                          2 * DC19 + DC23)
                                       : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23)),
                      Q20, bits[3]);
      if (bits[4] != 0 && ws[9] == 0)  // AC11
        ws[9] = pred(Q00 * (change_dc ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 +
                                         9 * DC19 + DC21 - DC25)
                                      : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 +
                                         DC22 - DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09)),
                     Q11, bits[4]);
      if (bits[5] != 0 && ws[2] == 0)  // AC02
        ws[2] = pred(Q00 * (change_dc ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 -
                                         14 * DC13 + 7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 +
                                         2 * DC19)
                                      : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15)),
                     Q02, bits[5]);
      if (change_dc) {
        if (bits[6] != 0 && ws[3] == 0)  // AC03
          ws[3] = pred(Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19), Q03, bits[6]);
        if (bits[7] != 0 && ws[10] == 0)  // AC12
          ws[10] = pred(Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19), Q12, bits[7]);
        if (bits[8] != 0 && ws[17] == 0)  // AC21
          ws[17] = pred(Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19), Q21, bits[8]);
        if (bits[9] != 0 && ws[24] == 0)  // AC30
          ws[24] = pred(Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19), Q30, bits[9]);
        ws[0] = pred(Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 +
                            6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 +
                            42 * DC12 + 152 * DC13 + 42 * DC14 - 8 * DC15 - 6 * DC16 +
                            6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 - 2 * DC21 -
                            6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25),
                     Q00, 0);
      }
      idct_islow(ws, c.q, s + (static_cast<size_t>(by) * 8 * istride + bx * 8), istride, range);
    }
  }
}

// One component's samples brought to the full width x height (jdsample.c);
// without `fancy` every ratio replicates.
std::vector<uint8_t> upsample(const std::vector<uint8_t>& in, int istride, int dw, int dh,
                              int hx, int vx, int width, int height, bool fancy) {
  std::vector<uint8_t> out(static_cast<size_t>(width) * height);
  auto row = [&](int r) {
    return in.data() + static_cast<size_t>(std::clamp(r, 0, dh - 1)) * istride;
  };
  const bool fancy_h2 = fancy && hx == 2 && dw > 2;  // else h2 replicates
  std::vector<int> sums(dw);
  std::vector<uint8_t> tmp(2 * static_cast<size_t>(dw));
  for (int y = 0; y < height; ++y) {
    uint8_t* o = out.data() + static_cast<size_t>(y) * width;
    const int r = y / vx;
    if (vx == 2 && ((fancy && hx == 1) || fancy_h2)) {
      // Vertical triangle: the nearer input row 3/4, the next nearer 1/4.
      const uint8_t* near = row(r);
      const uint8_t* far = row(y % 2 ? r + 1 : r - 1);
      if (hx == 1) {  // h1v2_fancy_upsample
        const int bias = y % 2 ? 2 : 1;
        for (int x = 0; x < width; ++x)
          o[x] = static_cast<uint8_t>((near[x] * 3 + far[x] + bias) >> 2);
        continue;
      }
      // h2v2_fancy_upsample
      for (int c = 0; c < dw; ++c) sums[c] = near[c] * 3 + far[c];
      tmp[0] = static_cast<uint8_t>((sums[0] * 4 + 8) >> 4);
      tmp[1] = static_cast<uint8_t>((sums[0] * 3 + sums[1] + 7) >> 4);
      for (int c = 1; c < dw - 1; ++c) {
        tmp[2 * c] = static_cast<uint8_t>((sums[c] * 3 + sums[c - 1] + 8) >> 4);
        tmp[2 * c + 1] = static_cast<uint8_t>((sums[c] * 3 + sums[c + 1] + 7) >> 4);
      }
      const int c = dw - 1;
      tmp[2 * c] = static_cast<uint8_t>((sums[c] * 3 + sums[c - 1] + 8) >> 4);
      tmp[2 * c + 1] = static_cast<uint8_t>((sums[c] * 4 + 7) >> 4);
      std::memcpy(o, tmp.data(), width);
      continue;
    }
    const uint8_t* ip = row(r);
    if (vx == 1 && fancy_h2) {  // h2v1_fancy_upsample
      tmp[0] = ip[0];
      tmp[1] = static_cast<uint8_t>((ip[0] * 3 + ip[1] + 2) >> 2);
      for (int c = 1; c < dw - 1; ++c) {
        tmp[2 * c] = static_cast<uint8_t>((ip[c] * 3 + ip[c - 1] + 1) >> 2);
        tmp[2 * c + 1] = static_cast<uint8_t>((ip[c] * 3 + ip[c + 1] + 2) >> 2);
      }
      const int c = dw - 1;
      tmp[2 * c] = static_cast<uint8_t>((ip[c] * 3 + ip[c - 1] + 1) >> 2);
      tmp[2 * c + 1] = ip[c];
      std::memcpy(o, tmp.data(), width);
      continue;
    }
    for (int x = 0; x < width; ++x) o[x] = ip[x / hx];  // h2v1/h2v2_upsample, int_upsample
  }
  return out;
}

// jdcolor.c build_ycc_rgb_table and ycc_rgb_convert, one pixel.
struct YccTables {
  static constexpr int kScale = 16;
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    constexpr int64_t kHalf = int64_t{1} << (kScale - 1);
    auto fix = [](double x) { return static_cast<int64_t>(x * (1 << kScale) + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
  }
  void rgb(int y, int cb, int cr, uint8_t* o) const {
    o[0] = clamp8(y + cr_r[cr]);
    o[1] = clamp8(y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> kScale));
    o[2] = clamp8(y + cb_b[cb]);
  }
  static uint8_t clamp8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }
};

void Jpeg::finish(std::vector<uint8_t>* rgb) {
  static const RangeLimit range;
  static const YccTables ycc;
  // The colour space (jdapimin.c default_decompress_parms); libjpeg's
  // lossless mode converts none, so such a frame must be RGB, grey or CMYK.
  bool convert = false;  // YCbCr -> RGB, or YCCK -> CMYK
  if (ncomp == 3) {
    const int a = comp[0].id, b = comp[1].id, c = comp[2].id;
    if (jfif)
      convert = true;
    else if (adobe)
      convert = adobe_transform != 0;
    else if (a == 'R' && b == 'G' && c == 'B')
      convert = false;
    else
      convert = !lossless;  // ids 1, 2, 3 or unknown: YCbCr, lossless RGB
  } else if (ncomp == 4) {
    convert = adobe && adobe_transform != 0;  // YCCK
  }
  if (lossless && convert)
    fail(std::string("lossless JPEG in ") + (ncomp == 3 ? "YCbCr" : "YCCK") +
         " (libjpeg converts no colour space in lossless mode and refuses it too)");
  const bool smooth = smoothing_ok();
  std::vector<std::vector<uint8_t>> planes;
  for (auto& c : comp) {
    if (!c.scanned) fail("corrupt JPEG: a component no scan decodes");
    int istride;
    std::vector<uint8_t> s;
    if (lossless) {  // jdlossls.c: the point transform undone, 8 bits kept
      istride = c.dw;
      s.resize(c.samples.size());
      for (size_t i = 0; i < s.size(); ++i) s[i] = static_cast<uint8_t>(c.samples[i] << c.pt);
    } else {
      istride = c.bw * 8;
      s.resize(static_cast<size_t>(istride) * c.bh * 8);
      if (smooth) {
        smooth_idct(c, s.data(), istride, range.t);
      } else {
        for (int by = 0; by < c.bh; ++by)
          for (int bx = 0; bx < c.bw; ++bx)
            idct_islow(c.block(by, bx), c.q, s.data() + (static_cast<size_t>(by) * 8 * istride + bx * 8),
                       istride, range.t);
      }
    }
    int hx = hmax / c.h, vx = vmax / c.v;
    if (hx == 1 && vx == 1) {
      std::vector<uint8_t> full(static_cast<size_t>(width) * height);
      for (int y = 0; y < height; ++y)
        std::memcpy(full.data() + static_cast<size_t>(y) * width, s.data() + static_cast<size_t>(y) * istride, width);
      planes.push_back(std::move(full));
    } else {
      planes.push_back(upsample(s, istride, c.dw, c.dh, hx, vx, width, height, !lossless));
    }
  }
  size_t npx = static_cast<size_t>(width) * height;
  rgb->resize(npx * 3);
  uint8_t* o = rgb->data();
  if (ncomp == 1) {
    for (size_t i = 0; i < npx; ++i) o[3 * i] = o[3 * i + 1] = o[3 * i + 2] = planes[0][i];
    return;
  }
  const uint8_t *p0 = planes[0].data(), *p1 = planes[1].data(), *p2 = planes[2].data();
  if (ncomp == 3) {
    for (size_t i = 0; i < npx; ++i) {
      if (convert) {
        ycc.rgb(p0[i], p1[i], p2[i], o + 3 * i);
      } else {
        o[3 * i] = p0[i];
        o[3 * i + 1] = p1[i];
        o[3 * i + 2] = p2[i];
      }
    }
    return;
  }
  // CMYK: YCCK becomes 255 minus its RGB, K unchanged (ycck_cmyk_convert).
  // PIL reads libjpeg's CMYK inverted (CMYK;I: Adobe's convention) and its
  // cmyk2rgb gives K' - K' * C' / 255 in 8-bit fixed point, where C' and
  // K' are the raw samples (the inversions cancel).
  const uint8_t* p3 = planes[3].data();
  auto muldiv255 = [](int a, int b) {
    int t = a * b + 128;
    return ((t >> 8) + t) >> 8;
  };
  for (size_t i = 0; i < npx; ++i) {
    uint8_t cmy[3] = {p0[i], p1[i], p2[i]};
    if (convert) {
      uint8_t t[3];
      ycc.rgb(p0[i], p1[i], p2[i], t);
      for (int k = 0; k < 3; ++k) cmy[k] = static_cast<uint8_t>(255 - t[k]);
    }
    const int k = p3[i];
    for (int j = 0; j < 3; ++j) o[3 * i + j] = YccTables::clamp8(k - muldiv255(255 - cmy[j], k));
  }
}

// Parse the markers; with header_only stop at the frame header.
void Jpeg::decode(std::vector<uint8_t>* rgb, bool header_only) {
  if (n < 3 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG (no SOI marker)");
  pos = 2;
  for (;;) {
    int m = next_marker();
    size_t at = pos - 2;
    switch (m) {
      case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC9: case 0xCA:
        read_sof(m);
        if (header_only) return;
        alloc_buffers();
        break;
      case 0xCB:
        fail("lossless arithmetic-coded JPEG (SOF11; libjpeg refuses it too)");
      case 0xC5: case 0xC6: case 0xC7: case 0xCD: case 0xCE: case 0xCF: case 0xDE:
      case 0xDF:
        fail("hierarchical JPEG (libjpeg refuses it too)");
      case 0xC4: read_dht(); break;
      case 0xCC: read_dac(); break;
      case 0xDB: read_dqt(); break;
      case 0xDD: {
        if (u16() != 4) fail_at("corrupt JPEG: bad DRI length", at);
        restart_interval = u16();
        break;
      }
      case 0xDA: read_sos(); break;
      case 0xDC: fail("JPEG with a DNL marker (DNL is not ported)");
      case 0xD9:
        if (!have_frame) fail_at("corrupt JPEG: EOI before any frame", at);
        finish(rgb);
        return;
      default:
        if (m >= 0xE0 && m <= 0xEF) {
          read_app(m);
        } else if (m == 0xFE || (m >= 0xF0 && m <= 0xFD)) {
          skip_segment();
        } else if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
          // a stray RSTn or TEM carries no segment
        } else {
          char hex[8];
          std::snprintf(hex, sizeof hex, "0x%02X", m);
          fail_at(std::string("corrupt JPEG: unknown marker ") + hex, at);
        }
    }
  }
}

void decode_jpeg(const uint8_t* data, size_t len, ImageU8* out, bool header_only) {
  Jpeg j(data, len);
  j.decode(&out->rgb, header_only);
  if (header_only && !j.have_frame) fail("corrupt JPEG: no frame header");
  out->w = j.width;
  out->h = j.height;
}

void set_msg(char* msg, int msg_len, const std::string& s) {
  if (msg && msg_len > 0) {
    std::strncpy(msg, s.c_str(), msg_len - 1);
    msg[msg_len - 1] = 0;
  }
}

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

// The three JPEG entry points return 0, or with a message in `msg`
// (msg_len bytes): -1 for a stream libjpeg refuses too, naming the feature
// or the corrupt byte offset; -8 when memory runs out.
template <typename F>
int guarded(char* msg, int msg_len, F&& f) {
  try {
    return f();
  } catch (const JpegError& e) {
    set_msg(msg, msg_len, e.msg);
    return -1;
  } catch (const std::bad_alloc&) {
    set_msg(msg, msg_len, "out of memory decoding a JPEG");
    return -8;
  }
}

}  // namespace

extern "C" {

// Bit 0: PNG, bit 1: JPEG; both always (kept for the callers that ask).
int jp_formats() { return 3; }

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


// Decode a JPEG and ADM-center-crop it, as jp_center_crop.
int jp_jpeg_center_crop(const uint8_t* data, long len, int image_size, float* out,
                        char* msg, int msg_len) {
  return guarded(msg, msg_len, [&] {
    ImageU8 img;
    decode_jpeg(data, static_cast<size_t>(len), &img, false);
    return adm_center_crop(&img, image_size, out);
  });
}

// Decode a JPEG to RGB into `out`, which holds w * h * 3 bytes for the
// (w, h) that jp_jpeg_probe gave; -7 when the decoded size is not (w, h).
int jp_jpeg_decode(const uint8_t* data, long len, int w, int h, uint8_t* out, char* msg,
                   int msg_len) {
  return guarded(msg, msg_len, [&] {
    ImageU8 img;
    decode_jpeg(data, static_cast<size_t>(len), &img, false);
    if (img.w != w || img.h != h) return -7;
    std::memcpy(out, img.rgb.data(), img.rgb.size());
    return 0;
  });
}

// A JPEG's width and height from its frame header.
int jp_jpeg_probe(const uint8_t* data, long len, int* w, int* h, char* msg, int msg_len) {
  return guarded(msg, msg_len, [&] {
    ImageU8 img;
    decode_jpeg(data, static_cast<size_t>(len), &img, true);
    *w = img.w;
    *h = img.h;
    return 0;
  });
}

}  // extern "C"
