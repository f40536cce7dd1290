// Image decode for the port's service, eval harness and datasets: PNG
// scanline filters, JPEG (baseline, extended sequential and progressive
// Huffman streams, below), and the ADM center crop with [-1, 1] output.
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
// A whole-image decoder: every scan's coefficients go into one buffer per
// component (sequential single- and multi-scan, and progressive), then the
// IDCT, the upsampling and the colour conversion run once over the image.
// Each step is libjpeg-turbo's integer arithmetic with its default
// decompression settings (JDCT_ISLOW, fancy upsampling, out_color_space
// JCS_RGB), so the pixels are the same bits:
//   - jidctint.c jpeg_idct_islow (CONST_BITS 13, PASS1_BITS 2, the
//     all-zero column and row shortcuts) and jdmaster.c's range-limit table;
//   - jdsample.c: h2v1, h2v2 and h1v2 triangle filters where the component
//     is more than two samples wide (h1v2: always), plain replication
//     otherwise, int_upsample for every other integral ratio; the rows
//     above the first and below the last repeat them (jdmainct.c);
//   - jdcolor.c's fixed-point YCbCr -> RGB tables (SCALEBITS 16).
// The colour space is jdapimin.c's guess: JFIF means YCbCr, else the Adobe
// APP14 transform flag, else component ids 'R','G','B' mean RGB.
// Refused by name, and reported apart (not_ported) because libjpeg-turbo
// decodes them: arithmetic coding, lossless frames, 4 components
// (CMYK/YCCK), a progressive stream that leaves one of its first ten
// coefficients unrefined (libjpeg would smooth its blocks) and a scan
// without its Huffman tables (libjpeg supplies Motion-JPEG's defaults).
// Refused by name as libjpeg's 8-bit decode refuses them: other precisions
// than 8 bits, hierarchical frames, DNL, 2 components. Truncated or corrupt
// entropy data raises with the byte offset, where libjpeg warns and fills
// with zeros; so does a stream without its EOI marker.

struct JpegError {
  std::string msg;
  bool not_ported;
};

[[noreturn]] void fail(const std::string& msg) { throw JpegError{msg, false}; }

[[noreturn]] void not_ported(const std::string& msg) { throw JpegError{msg, true}; }

[[noreturn]] void fail_at(const std::string& what, size_t offset) {
  fail(what + " at byte offset " + std::to_string(offset));
}

// Zigzag index -> natural (row-major) index.
const uint8_t kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  uint8_t look_len[1 << kLookBits];  // 0: the code is longer than kLookBits
  uint8_t look_sym[1 << kLookBits];
  int32_t maxcode[18];    // largest code of each length, -1 if none
  int32_t valoffset[18];  // index of a length's first value, minus its code
  uint8_t vals[256];
};

// jdhuff.c jpeg_make_d_derived_tbl.
void build_huffman(Huffman* h, const uint8_t counts[17], const uint8_t* vals, int nvals,
                   bool dc, size_t offset) {
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
  if (dc)
    for (int i = 0; i < nvals; ++i)
      if (vals[i] > 15) fail_at("corrupt JPEG: DC Huffman symbol above 15", offset);
  h->defined = true;
}

// The entropy-coded bits of one scan or restart interval. Past the next
// marker (or the end of the data) it reads zeros and counts them; a decode
// that consumes one of them is truncated or corrupt.
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

  // Drop the bits left of this interval and step over the next marker,
  // which must be RSTn; garbage before it is skipped as libjpeg skips it.
  void restart(int expect) {
    size_t q = at_marker ? marker : pos;
    while (q + 1 < n && !(d[q] == 0xFF && d[q + 1] != 0 && d[q + 1] != 0xFF)) ++q;
    if (q + 1 >= n || d[q + 1] != 0xD0 + expect)
      fail_at("corrupt JPEG: expected restart marker RST" + std::to_string(expect), q);
    pos = q + 2;
    at_marker = false;
    buf = 0;
    cnt = pad = 0;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;      // blocks that hold the component's samples
  int stride = 0;          // blocks per row of coef (MCU-padded)
  int dw = 0, dh = 0;      // downsampled width and height
  std::vector<int16_t> coef;
  bool latched = false;
  int32_t q[64];           // the quantisation table, natural order
  int coef_bits[64];       // progressive: -1 until a scan sends the coefficient
  int dc_tbl = 0, ac_tbl = 0, last_dc = 0;
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
  bool progressive = false, have_frame = false;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  std::vector<Component> comp;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];

  Jpeg(const uint8_t* data, size_t len) : d(data), n(len) {}

  int u8() {
    if (pos >= n) fail_at("truncated JPEG", pos);
    return d[pos++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  // The next marker code; garbage before it is skipped (libjpeg warns).
  int next_marker() {
    while (pos < n && d[pos] != 0xFF) ++pos;
    while (pos < n && d[pos] == 0xFF) ++pos;
    if (pos >= n) fail_at("truncated JPEG: no EOI marker", n);
    return d[pos++];
  }

  // The frame header; the coefficient buffers it sizes are allocated by
  // alloc_coefficients, which a probe never calls.
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
    if (ncomp == 4) not_ported("4-component (CMYK/YCCK) JPEG (CMYK/YCCK is not ported)");
    if (ncomp != 1 && ncomp != 3)
      fail(std::to_string(ncomp) + "-component JPEG (the port decodes 1 or 3)");
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
    progressive = marker == 0xC2;
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comp) {
      if (hmax % c.h || vmax % c.v)
        fail("JPEG with fractional sampling ratios (libjpeg refuses them too)");
      c.dw = static_cast<int>((static_cast<long>(width) * c.h + hmax - 1) / hmax);
      c.dh = static_cast<int>((static_cast<long>(height) * c.v + vmax - 1) / vmax);
      c.bw = (c.dw + 7) / 8;
      c.bh = (c.dh + 7) / 8;
      c.stride = mcux * c.h;
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
    }
    have_frame = true;
  }

  void alloc_coefficients() {
    for (auto& c : comp) c.coef.assign(static_cast<size_t>(c.stride) * mcuy * c.v * 64, 0);
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
      build_huffman(tc ? &ac[th] : &dc[th], counts, vals, total, tc == 0, at);
    }
    if (pos != end) fail_at("corrupt JPEG: bad DHT length", pos);
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

  void latch(Component& c) {
    if (c.latched) return;
    if (!qt_defined[c.tq]) fail("corrupt JPEG: a component's quantisation table is missing");
    for (int i = 0; i < 64; ++i) c.q[i] = qt[c.tq][i];
    c.latched = true;
  }

  void read_sos();
  void decode_scan(std::vector<Component*>& sc, int ss, int se, int ah, int al, size_t at);
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
    c->dc_tbl = tables >> 4;
    c->ac_tbl = tables & 15;
    if (c->dc_tbl > 3 || c->ac_tbl > 3) fail_at("corrupt JPEG: bad table in SOS", at);
    sc.push_back(c);
  }
  int ss = u8(), se = u8(), ahal = u8();
  int ah = ahal >> 4, al = ahal & 15;
  if (progressive) {
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
  for (auto* c : sc) {
    latch(*c);
    if (progressive) {
      for (int k = ss; k <= se; ++k) c->coef_bits[k] = al;
    }
    // libjpeg-turbo supplies the standard tables where a Motion-JPEG frame
    // has none; the port does not.
    if ((!progressive || (ss == 0 && ah == 0)) && !dc[c->dc_tbl].defined)
      not_ported("JPEG scan without its DC Huffman table (Motion-JPEG default tables are "
                 "not ported)");
    if ((!progressive || ss > 0) && !ac[c->ac_tbl].defined)
      not_ported("JPEG scan without its AC Huffman table (Motion-JPEG default tables are "
                 "not ported)");
  }
  decode_scan(sc, ss, se, ah, al, at);
}

void Jpeg::decode_scan(std::vector<Component*>& sc, int ss, int se, int ah, int al,
                       size_t at) {
  BitReader br{d, n, pos};
  for (auto* c : sc) c->last_dc = 0;
  int eobrun = 0;
  // A single-component scan is not interleaved: one block per MCU over the
  // blocks that hold samples. Otherwise each MCU holds h x v blocks of each.
  bool single = sc.size() == 1;
  long units = single ? static_cast<long>(sc[0]->bw) * sc[0]->bh
                      : static_cast<long>(mcux) * mcuy;
  int rst = 0;
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

  for (long u = 0; u < units; ++u) {
    if (restart_interval && u && u % restart_interval == 0) {
      br.restart(rst);
      rst = (rst + 1) & 7;
      for (auto* c : sc) c->last_dc = 0;
      eobrun = 0;
    }
    if (single) {
      Component* c = sc[0];
      decode_block(c, c->block(static_cast<int>(u / c->bw), static_cast<int>(u % c->bw)));
    } else {
      int my = static_cast<int>(u / mcux), mx = static_cast<int>(u % mcux);
      for (auto* c : sc)
        for (int by = 0; by < c->v; ++by)
          for (int bx = 0; bx < c->h; ++bx)
            decode_block(c, c->block(my * c->v + by, mx * c->h + bx));
    }
    br.check(at);
  }
  pos = br.at_marker ? br.marker : br.pos;
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

// One component's samples brought to the full width x height (jdsample.c).
std::vector<uint8_t> upsample(const std::vector<uint8_t>& in, int istride, int dw, int dh,
                              int hx, int vx, int width, int height) {
  std::vector<uint8_t> out(static_cast<size_t>(width) * height);
  auto row = [&](int r) {
    return in.data() + static_cast<size_t>(std::clamp(r, 0, dh - 1)) * istride;
  };
  const bool fancy_h2 = hx == 2 && dw > 2;  // else h2 replicates
  std::vector<int> sums(dw);
  std::vector<uint8_t> tmp(2 * static_cast<size_t>(dw));
  for (int y = 0; y < height; ++y) {
    uint8_t* o = out.data() + static_cast<size_t>(y) * width;
    const int r = y / vx;
    if (vx == 2 && (hx == 1 || fancy_h2)) {
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

void Jpeg::finish(std::vector<uint8_t>* rgb) {
  static const RangeLimit range;
  if (progressive) {
    for (auto& c : comp)
      for (int k = 0; k < 10; ++k)
        if (c.coef_bits[k] != 0)
          not_ported("progressive JPEG whose scans leave coefficient " + std::to_string(k) +
                     " unrefined (libjpeg smooths such blocks; block smoothing is not "
                     "ported)");
  }
  std::vector<std::vector<uint8_t>> planes;
  for (auto& c : comp) {
    if (!c.latched) fail("corrupt JPEG: a component no scan decodes");
    int istride = c.bw * 8;
    std::vector<uint8_t> s(static_cast<size_t>(istride) * c.bh * 8);
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx)
        idct_islow(c.block(by, bx), c.q, s.data() + (static_cast<size_t>(by) * 8 * istride + bx * 8),
                   istride, range.t);
    int hx = hmax / c.h, vx = vmax / c.v;
    if (hx == 1 && vx == 1) {
      std::vector<uint8_t> full(static_cast<size_t>(width) * height);
      for (int y = 0; y < height; ++y)
        std::memcpy(full.data() + static_cast<size_t>(y) * width, s.data() + static_cast<size_t>(y) * istride, width);
      planes.push_back(std::move(full));
    } else {
      planes.push_back(upsample(s, istride, c.dw, c.dh, hx, vx, width, height));
    }
  }
  size_t npx = static_cast<size_t>(width) * height;
  rgb->resize(npx * 3);
  uint8_t* o = rgb->data();
  if (ncomp == 1) {
    for (size_t i = 0; i < npx; ++i) o[3 * i] = o[3 * i + 1] = o[3 * i + 2] = planes[0][i];
    return;
  }
  bool is_rgb;
  if (jfif)
    is_rgb = false;
  else if (adobe)
    is_rgb = adobe_transform == 0;
  else
    is_rgb = comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
  if (is_rgb) {
    for (size_t i = 0; i < npx; ++i)
      for (int k = 0; k < 3; ++k) o[3 * i + k] = planes[k][i];
    return;
  }
  // jdcolor.c build_ycc_rgb_table and ycc_rgb_convert.
  constexpr int kScale = 16;
  constexpr int64_t kHalf = int64_t{1} << (kScale - 1);
  auto fix = [](double x) { return static_cast<int64_t>(x * (1 << kScale) + 0.5); };
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  for (int i = 0; i < 256; ++i) {
    int64_t x = i - 128;
    cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kScale);
    cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kScale);
    cr_g[i] = -fix(0.71414) * x;
    cb_g[i] = -fix(0.34414) * x + kHalf;
  }
  auto clamp8 = [](int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); };
  const uint8_t *py = planes[0].data(), *pb = planes[1].data(), *pr = planes[2].data();
  for (size_t i = 0; i < npx; ++i) {
    int y = py[i], cb = pb[i], cr = pr[i];
    o[3 * i] = clamp8(y + cr_r[cr]);
    o[3 * i + 1] = clamp8(y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> kScale));
    o[3 * i + 2] = clamp8(y + cb_b[cb]);
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
      case 0xC0: case 0xC1: case 0xC2:
        read_sof(m);
        if (header_only) return;
        alloc_coefficients();
        break;
      case 0xC3: case 0xC7: case 0xCB: case 0xCF:
        not_ported("lossless JPEG (lossless JPEG is not ported)");
      case 0xC5: case 0xC6: case 0xDE: case 0xDF:
        fail("hierarchical JPEG (hierarchical JPEG is not ported)");
      case 0xC9: case 0xCA: case 0xCC: case 0xCD: case 0xCE:
        not_ported("arithmetic-coded JPEG (arithmetic coding is not ported)");
      case 0xC4: read_dht(); break;
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
// or the corrupt byte offset; -9 for a feature libjpeg decodes and the port
// does not; -8 when memory runs out.
template <typename F>
int guarded(char* msg, int msg_len, F&& f) {
  try {
    return f();
  } catch (const JpegError& e) {
    set_msg(msg, msg_len, e.msg);
    return e.not_ported ? -9 : -1;
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
